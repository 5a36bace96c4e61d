"""Port vs JAX: one CP level, forward and backward (kernels G1/G4's twins
against the Pallas kernels K1/K2 in interpret mode, and against the XLA
level encode in f32)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models.cp_field import CPGridEncoder as JaxEncoder
from nerfacc_tpu.ops.cp_level import cp_level_encode as jax_cp_level_encode
from nerfacc_tpu_torch.ops.cp_level import (
    cp_level_backward_plain,
    cp_level_encode,
    cp_level_encode_plain,
)


def _inputs(seed, n, R, rank):
    rng = np.random.default_rng(seed)
    u = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    u[:3] = [[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.5, 0.5, 0.5]]  # edges
    lines = (1.0 + 0.1 * rng.standard_normal((3, R, rank))).astype(np.float32)
    return u, lines


# N = 1100 is not a multiple of the kernel's 1024-sample block
@pytest.mark.parametrize("R,rank,n", [(16, 8, 37), (64, 16, 1100), (512, 8, 300)])
def test_cp_level_bf16_matches_pallas_kernel(R, rank, n):
    u, lines = _inputs(R, n, R, rank)
    ref = np.asarray(jax_cp_level_encode(jnp.asarray(u), jnp.asarray(lines), True))
    out = cp_level_encode(torch.tensor(u), torch.tensor(lines), torch.bfloat16)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("R", [16, 64, 512])
def test_cp_level_f32_matches_xla_level(R):
    u, lines = _inputs(R + 1, 257, R, 8)
    enc = JaxEncoder(resolutions=(R,), ranks=(8,), compute_dtype=jnp.float32)
    ref = np.asarray(
        enc._level_encode(jnp.asarray(u), jnp.asarray(lines), R=R, kernel="xla")
    )
    out = cp_level_encode(torch.tensor(u), torch.tensor(lines), torch.float32)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_cp_level_edges_pick_table_rows():
    """u = 0 is row 0 exactly, u = 1 row R-1 (the row-R tap is dropped)."""
    _, lines = _inputs(3, 3, 16, 8)
    u = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]])
    t = torch.tensor(lines)
    out = cp_level_encode_plain(u, t, torch.float32)
    torch.testing.assert_close(out[0], t[0, 0] * t[1, 0] * t[2, 0], rtol=0, atol=0)
    torch.testing.assert_close(out[1], t[0, -1] * t[1, -1] * t[2, -1], rtol=0, atol=0)


def test_wrapper_refuses_devices_without_kernel_or_twin():
    u = torch.zeros(4, 3, device="meta")
    lines = torch.zeros(3, 16, 8, device="meta")
    with pytest.raises(ValueError):
        cp_level_encode(u, lines)


def _cotangent(seed, n, rank):
    return np.random.default_rng(seed).standard_normal((n, rank)).astype(np.float32)


# N = 1100 and 300 are not multiples of the TPU kernel's 1024-sample block;
# _inputs puts samples at u = 0, 1 and 0.5.  Both sides round the same
# operands to bf16 (weights, tables, the product cotangent) and sum in f32,
# so only the order of the f32 sums differs.
@pytest.mark.parametrize("R,rank,n", [(16, 8, 37), (64, 16, 1100), (512, 8, 300)])
def test_cp_level_bf16_grads_match_pallas_kernel(R, rank, n):
    u, lines = _inputs(R + 2, n, R, rank)
    g = _cotangent(R, n, rank)
    ref = np.asarray(
        jax.grad(
            lambda l: jnp.sum(jax_cp_level_encode(jnp.asarray(u), l, True) * g)
        )(jnp.asarray(lines))
    )
    out = cp_level_backward_plain(
        torch.tensor(u), torch.tensor(g), torch.tensor(lines), torch.bfloat16
    ).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("R", [16, 64, 512])
def test_cp_level_f32_grads_match_xla_level(R):
    u, lines = _inputs(R + 3, 1100, R, 8)
    g = _cotangent(R + 1, 1100, 8)
    enc = JaxEncoder(resolutions=(R,), ranks=(8,), compute_dtype=jnp.float32)
    ref = np.asarray(
        jax.grad(
            lambda l: jnp.sum(
                enc._level_encode(jnp.asarray(u), l, R=R, kernel="xla") * g
            )
        )(jnp.asarray(lines))
    )
    out = cp_level_backward_plain(
        torch.tensor(u), torch.tensor(g), torch.tensor(lines), torch.float32
    ).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_closed_form_backward_matches_autograd_of_forward_twin():
    u, lines = _inputs(7, 500, 32, 8)
    g = torch.tensor(_cotangent(8, 500, 8))
    t = torch.tensor(lines, requires_grad=True)
    cp_level_encode_plain(torch.tensor(u), t, torch.float32).backward(g)
    out = cp_level_backward_plain(torch.tensor(u), g, t.detach(), torch.float32)
    torch.testing.assert_close(out, t.grad, rtol=1e-5, atol=1e-5 * float(t.grad.abs().max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_is_differentiable_in_lines_only(dtype):
    """The wrapper's output carries a grad_fn whenever the tables need one;
    its backward is the closed-form twin (kernel G4 on the card), and the
    coordinates get no gradient."""
    u, lines = _inputs(9, 200, 16, 8)
    uu = torch.tensor(u, requires_grad=True)
    t = torch.tensor(lines, requires_grad=True)
    out = cp_level_encode(uu, t, dtype)
    assert out.grad_fn is not None
    g = torch.tensor(_cotangent(10, 200, 8))
    out.backward(g)
    assert uu.grad is None
    ref = cp_level_backward_plain(uu.detach(), g, t.detach(), dtype)
    torch.testing.assert_close(t.grad, ref, rtol=0, atol=0)
    with torch.no_grad():
        assert cp_level_encode(uu, t, dtype).grad_fn is None
