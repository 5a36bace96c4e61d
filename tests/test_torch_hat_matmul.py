"""Port vs JAX: the hat-interpolation matmul (kernels G8-G10's plain
versions against the Pallas kernels K3/K3b/K3c in interpret mode), the
autograd wrapper around them, and one CP level of the hat route
(``hat_cp_level``, G8's three-axis instance) against the per-axis
composition."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.ops.hat_matmul import hat_interp_matmul as jax_hat
from nerfacc_tpu_torch.ops import hat_matmul
from nerfacc_tpu_torch.ops.cp_level import _round_bf16
from nerfacc_tpu_torch.ops.hat_matmul import (
    hat_bwd_line_plain,
    hat_bwd_x_plain,
    hat_cp_level,
    hat_interp_matmul,
    hat_interp_matmul_plain,
    hat_level_fwd,
    hat_level_plain,
    hat_taps,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)


def _inputs(R, rank, n, seed=0):
    """Coordinates mostly in [0, 1], some past either end and some on grid
    points (0, 1 and k/(R-1) among them), a table near 1, a cotangent."""
    rng = np.random.default_rng(seed + R)
    x = rng.uniform(0.0, 1.0, n).astype(np.float32)
    k = n // 20  # 5% outside [0, 1], below and above, within 1.5 cells
    push = rng.uniform(1e-3, 1.5, k) / (R - 1)
    x[:k] = np.where(np.arange(k) % 2 == 0, -push, 1.0 + push)
    x[-8:] = rng.integers(0, R, 8) / np.float32(R - 1)
    x[-10:-8] = [0.0, 1.0]
    line = (1.0 + 0.1 * rng.standard_normal((R, rank))).astype(np.float32)
    g = rng.standard_normal((n, rank)).astype(np.float32)
    return x, line, g


def _jax_reference(x, line, g):
    out, vjp = jax.vjp(
        lambda a, b: jax_hat(a, b, True), jnp.asarray(x), jnp.asarray(line)
    )
    dx, dline = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dx), np.asarray(dline)


# n = 300 and 1100 are not multiples of the TPU kernel's 512-sample block;
# (32, 16), (128, 16) and (512, 32) are TiNeuVox's three levels
@pytest.mark.parametrize(
    "R,rank,n",
    [(16, 8, 300), (64, 16, 1100), (512, 32, 2048), (32, 16, 1100), (128, 16, 2048)],
)
def test_plain_versions_match_pallas_kernels(R, rank, n):
    """Forward bitwise (two exact bf16 products, one f32 addition); the
    table gradient within 1e-6 of its largest entry and the coordinate
    gradient within 1e-5 of its (f32 sums in another order)."""
    x, line, g = _inputs(R, rank, n)
    out, dx, dline = _jax_reference(x, line, g)
    tx, tline, tg = map(torch.tensor, (x, line, g))
    np.testing.assert_array_equal(hat_interp_matmul_plain(tx, tline).numpy(), out)
    got = hat_bwd_line_plain(tx, tg, R).numpy()
    np.testing.assert_allclose(got, dline, rtol=0, atol=1e-6 * np.abs(dline).max())
    got = hat_bwd_x_plain(tx, tg, tline).numpy()
    np.testing.assert_allclose(got, dx, rtol=0, atol=1e-5 * np.abs(dx).max())
    # the outside points read the hat's value and slope at the clamped taps
    outside = (x < 0) | (x > 1)
    assert outside.any() and np.abs(dx[outside]).max() > 0


def _g10_tree(x, line, g):
    """Kernel G10's order in float32: each sample's group of cw lanes
    (ceil(rank / 4) rounded up to a power of two, at most 32), lane c adding
    its products in order over columns 4 c .. 4 c + 3, then every 4 cw
    further (each bf16 x bf16 product is exact, so a fused multiply-add is
    one f32 addition), then a butterfly within the group: lane l adds lane
    l ^ o for o = cw / 2, ..., 1.  Returns dx (n,)."""
    f32 = np.float32
    R, rank = line.shape
    cw = 1
    while 4 * cw < rank and cw < 32:
        cw *= 2
    i0, i1, _, _, dw0, dw1 = (a.numpy() for a in hat_taps(torch.tensor(x), R))
    gb = _round_bf16(torch.tensor(g)).numpy()
    table = _round_bf16(torch.tensor(line)).numpy()
    sums = np.zeros((2, x.shape[0], cw), f32)
    for c in range(cw):
        for col in range(4 * c, rank, 4 * cw):
            for k in range(col, min(col + 4, rank)):
                for tap, rows in enumerate((i0, i1)):
                    sums[tap, :, c] += gb[:, k] * table[rows, k]
    lane, o = np.arange(cw), cw // 2
    while o:
        sums = sums + sums[..., lane ^ o]
        o //= 2
    s0, s1 = sums[0, :, 0], sums[1, :, 0]
    dx = ((dw0 * s0 + dw1 * s1) * f32(R - 1)).astype(f32)
    return np.where((dw0 == 0) & (dw1 == 0), f32(0.0), dx)


# (32, 16), (128, 16) and (512, 32) are TiNeuVox's levels; rank 24 runs six
# lanes of eight, two of them idle
@pytest.mark.parametrize("R,rank", [(32, 16), (128, 16), (512, 32), (64, 24)])
def test_g10_tree_order_matches_pallas_kernel(R, rank):
    """Kernel G10's sum order (four columns a lane, a butterfly over the
    group), emulated in float32, against K3c in interpret mode: within 1e-5
    of the largest entry, exactly 0 on grid points, as the plain version."""
    x, line, g = _inputs(R, rank, 1100, seed=4)
    _, dx, _ = _jax_reference(x, line, g)
    got = _g10_tree(x, line, g)
    np.testing.assert_allclose(got, dx, rtol=0, atol=1e-5 * np.abs(dx).max())
    plain = hat_bwd_x_plain(torch.tensor(x), torch.tensor(g), torch.tensor(line)).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * np.abs(plain).max())
    on_grid = (x * np.float32(R - 1)) == np.round(x * np.float32(R - 1))
    assert on_grid.sum() >= 2 and (got[on_grid] == 0).all() and (dx[on_grid] == 0).all()


@pytest.mark.parametrize("R", [16, 64, 512])
def test_coordinate_gradient_is_zero_at_grid_points(R):
    """K3c's rule: dW = -sign(pos - i) is 0 on a grid point and the columns
    at distance exactly 1 are excluded, so dx is exactly 0 there, x = 0 and
    x = 1 included, in JAX and in the port alike; away from grid points it
    is not."""
    rank = 8
    x = np.array([0.0, 1.0, 1.0 / (R - 1), 3.0 / (R - 1), 0.37], np.float32)
    _, line, g = _inputs(R, rank, 40, seed=1)
    g = g[:5]
    _, dx, _ = _jax_reference(x, line, g)
    got = hat_bwd_x_plain(torch.tensor(x), torch.tensor(g), torch.tensor(line)).numpy()
    assert (dx[:4] == 0).all() and (got[:4] == 0).all()
    assert dx[4] != 0 and got[4] == pytest.approx(float(dx[4]), rel=1e-5)


def test_wrapper_gradients_are_the_plain_backwards():
    """On CPU tensors the autograd wrapper runs the plain versions: its
    gradients equal them bit for bit, not autograd of the forward."""
    x, line, g = _inputs(32, 8, 200, seed=2)
    tx = torch.tensor(x, requires_grad=True)
    tline = torch.tensor(line, requires_grad=True)
    out = hat_interp_matmul(tx, tline)
    assert out.grad_fn is not None
    tg = torch.tensor(g)
    out.backward(tg)
    x0, l0 = tx.detach(), tline.detach()
    torch.testing.assert_close(tx.grad, hat_bwd_x_plain(x0, tg, l0), rtol=0, atol=0)
    torch.testing.assert_close(tline.grad, hat_bwd_line_plain(x0, tg, 32), rtol=0, atol=0)


def test_wrapper_skips_the_gradients_nobody_asked_for():
    """Coordinates without ``requires_grad`` get none (the coordinate
    kernel does not run); the table alike."""
    x, line, g = _inputs(32, 8, 64, seed=3)
    tline = torch.tensor(line, requires_grad=True)
    hat_interp_matmul(torch.tensor(x), tline).backward(torch.tensor(g))
    assert tline.grad is not None
    tx = torch.tensor(x, requires_grad=True)
    hat_interp_matmul(tx, torch.tensor(line)).backward(torch.tensor(g))
    assert tx.grad is not None and float(tx.grad.abs().max()) > 0


def test_wrapper_refuses_devices_without_kernel_or_plain_version():
    with pytest.raises(ValueError):
        hat_interp_matmul(torch.zeros(4, device="meta"), torch.zeros(16, 8, device="meta"))


def _level_inputs(R, rank, n, seed=0):
    """One CP level's points (n, 3), each axis drawn as :func:`_inputs`
    draws coordinates (some past either end, some on grid points), its
    three tables (3, R, rank) near 1 and a cotangent (n, rank)."""
    axes = [_inputs(R, rank, n, seed + 10 * a) for a in range(3)]
    x = np.stack([a[0] for a in axes], axis=1)
    x = x[np.random.default_rng(seed).permutation(n)]  # mix the special rows
    lines = np.stack([a[1] for a in axes])
    return x, lines, axes[0][2]


def _per_axis_level(x, lines):
    """The level as the per-axis route composes it: (a_0 * a_1) * a_2."""
    prod = hat_interp_matmul(x[:, 0], lines[0])
    for axis in (1, 2):
        prod = prod * hat_interp_matmul(x[:, axis], lines[axis])
    return prod


# TiNeuVox's three levels, at n that are not multiples of K3's 512 block
@pytest.mark.parametrize("R,rank,n", [(32, 16, 300), (128, 16, 1100), (512, 32, 600)])
def test_level_plain_version_matches_jax_per_axis_composition(R, rank, n):
    """The level's plain version against JAX's hat route: K3 (interpreted)
    per axis, ``prod = a; prod = prod * a`` in axis order, as
    ``CPGridEncoder(use_pallas=True)._level_encode`` composes it.  The
    product and each axis bitwise."""
    x, lines, _ = _level_inputs(R, rank, n)
    jx, jl = jnp.asarray(x), jnp.asarray(lines)
    a = [jax_hat(jx[:, i], jl[i], True) for i in range(3)]
    prod = a[0]
    for i in (1, 2):
        prod = prod * a[i]
    got, axes = hat_level_plain(torch.tensor(x), torch.tensor(lines))
    np.testing.assert_array_equal(got.numpy(), np.asarray(prod))
    for i in range(3):
        np.testing.assert_array_equal(axes[i].numpy(), np.asarray(a[i]))


@pytest.mark.parametrize("R,rank,n", [(32, 16, 300), (128, 16, 1100), (512, 32, 600)])
def test_level_gradients_match_per_axis_autograd(R, rank, n):
    """``hat_cp_level``'s forward and both gradients bitwise equal to
    autograd of the per-axis ``hat_interp_matmul`` composition: its backward
    forms the cotangents autograd of ``(a_0 * a_1) * a_2`` forms and hands
    them to the same per-axis backward passes."""
    x, lines, g = _level_inputs(R, rank, n, seed=1)
    results = []
    for level in (_per_axis_level, hat_cp_level):
        tx = torch.tensor(x, requires_grad=True)
        tl = torch.tensor(lines, requires_grad=True)
        out = level(tx, tl)
        out.backward(torch.tensor(g))
        results.append((out.detach(), tx.grad, tl.grad))
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(results[1][1].abs().max()) > 0


def test_level_without_a_gradient_keeps_only_the_product(monkeypatch):
    """Under ``torch.no_grad``, or with no input requiring a gradient, the
    level asks for the product alone and saves nothing; with a gradient it
    keeps the three axes for the backward."""
    calls = []
    real = hat_matmul.hat_level_fwd

    def spy(x, lines, keep_axes):
        calls.append(keep_axes)
        return real(x, lines, keep_axes)

    monkeypatch.setattr(hat_matmul, "hat_level_fwd", spy)
    x, lines, _ = _level_inputs(32, 16, 200, seed=2)
    tx = torch.tensor(x, requires_grad=True)
    tl = torch.tensor(lines, requires_grad=True)
    with torch.no_grad():
        out = hat_cp_level(tx, tl)
    assert out.grad_fn is None and calls == [False]
    out = hat_cp_level(tx.detach(), tl.detach())
    assert out.grad_fn is None and calls == [False, False]
    out = hat_cp_level(tx, tl)
    assert out.grad_fn is not None and calls == [False, False, True]
    prod, axes = hat_level_fwd(tx.detach(), tl.detach(), keep_axes=False)
    assert axes is None and torch.equal(prod, out.detach())


def test_level_skips_the_gradients_nobody_asked_for(monkeypatch):
    """Points without ``requires_grad`` get no gradient and the coordinate
    kernel does not run; tables likewise."""
    ran = []
    for name in ("hat_bwd_x", "hat_bwd_line"):
        real = getattr(hat_matmul, name)
        monkeypatch.setattr(
            hat_matmul, name, lambda *a, _r=real, _n=name: ran.append(_n) or _r(*a)
        )
    x, lines, g = _level_inputs(32, 16, 200, seed=3)
    tl = torch.tensor(lines, requires_grad=True)
    hat_cp_level(torch.tensor(x), tl).backward(torch.tensor(g))
    assert ran == ["hat_bwd_line"] * 3 and tl.grad is not None
    ran.clear()
    tx = torch.tensor(x, requires_grad=True)
    hat_cp_level(tx, torch.tensor(lines)).backward(torch.tensor(g))
    assert ran == ["hat_bwd_x"] * 3 and float(tx.grad.abs().max()) > 0
