"""Port vs JAX: the dense voxel field's trilinear gather with both halves
of its custom VJP, the encoder's regulariser, and the field, from
numpy-seeded points and the same parameters through the bridge.

Bounds.  The gather in f32 within 1e-6 of JAX's (jitted and eager: XLA sums
the eight corners in another order), its grid and coordinate cotangents
within 1e-6 in relative Frobenius norm, on points in [-0.1, 1.1]^3 with
some exactly on 0, 1 and grid points (JAX's coordinate cotangent ignores
the clip, and at u = 1 its clipped ``i0`` gives a zero fraction: both are
held); the field's f32 outputs within 1e-5 and gradients within 1e-4, its
bf16 outputs within 5e-4 and gradients within 5e-3 (the MLPs round their
operands to bf16 and a last-bit difference of a feature flips a rounding);
the regulariser within 1e-6 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models.voxel_field import VoxelGridEncoder as JaxEncoder
from nerfacc_tpu.models.voxel_field import VoxelRadianceField as JaxField
from nerfacc_tpu.models.voxel_field import _trilinear_gather
from nerfacc_tpu_torch.models.voxel_field import (
    VoxelGridEncoder,
    VoxelRadianceField,
    trilinear_gather,
)
from nerfacc_tpu_torch.utils.jax_bridge import (
    field_params_from_numpy,
    field_params_to_numpy,
    voxel_field_params_from_numpy,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
SMALL = dict(resolutions=(6, 9), channels=(3, 2))
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _coords(shape, seed=0, n=3000):
    """(n, 3) coordinates in [-0.1, 1.1]^3: some exactly 0 or 1 on an axis,
    some on grid points of ``shape``."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    u[:40, 0], u[40:80, 1], u[80:120, 2] = 1.0, 0.0, 1.0
    u[120:160] = 1.0
    res = np.asarray(shape[:3], np.float32) - 1
    u[160:400] = (np.round(rng.uniform(0, 1, (240, 3)) * res) / res).astype(np.float32)
    return u


@pytest.mark.parametrize("jit", [True, False], ids=["jit", "eager"])
@pytest.mark.parametrize("shape", [(5, 6, 7, 3), (4, 4, 4, 1)])
def test_trilinear_gather_and_its_vjp_match_jax(shape, jit):
    rng = np.random.default_rng(1)
    grid = rng.standard_normal(shape).astype(np.float32)
    u = _coords(shape)
    g = rng.standard_normal((len(u), shape[-1])).astype(np.float32)

    def loss(gr, uu):
        out = _trilinear_gather(gr, uu)
        return jnp.sum(out * g), out

    fn = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)
    (_, ref), (dgrid, du) = (jax.jit(fn) if jit else fn)(jnp.asarray(grid), jnp.asarray(u))
    tg = torch.tensor(grid, requires_grad=True)
    tu = torch.tensor(u, requires_grad=True)
    out = trilinear_gather(tg, tu)
    (out * torch.tensor(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    for got, want in ((tg.grad, dgrid), (tu.grad, du)):
        want = np.asarray(want)
        assert np.linalg.norm(got.numpy() - want) <= 1e-6 * np.linalg.norm(want)
    du = np.asarray(du)
    outside = (u < 0) | (u > 1)
    assert np.abs(du[outside]).max() > 0  # the clip's subgradient is ignored
    # u = 1: both x corners are the last cell, so the x cotangent vanishes
    # but for the rounding of the corner sum
    scale = np.abs(du).max()
    assert np.abs(du[:40, 0]).max() <= 1e-6 * scale
    assert np.abs(tu.grad[:40, 0].numpy()).max() <= 1e-6 * scale


def test_regularizer_and_bridge_match_jax():
    """The grids' total variation and its gradient; the bridge's round trip,
    bitwise; the port's init ``0.1 N(0, 1)`` and the JAX field's chunk."""
    jenc = JaxEncoder(**SMALL)
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0)))
    ref, grads = jax.jit(jax.value_and_grad(jenc.param_regularizer))(
        jax.tree.map(jnp.asarray, params))
    grids = [torch.tensor(g, requires_grad=True) for g in params["grids"]]
    out = VoxelGridEncoder(**SMALL).param_regularizer(grids)
    assert float(out.detach()) == pytest.approx(float(ref), rel=1e-6)
    out.backward()
    for t, g in zip(grids, grads["grids"]):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0, atol=1e-6 * np.abs(g).max())
    jfield = JaxField(aabb=AABB, **SMALL)
    tree = jax.tree.map(np.asarray, jfield.init(jax.random.PRNGKey(1)))
    back = field_params_to_numpy(field_params_from_numpy(tree, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    field = VoxelRadianceField(AABB).init(torch.Generator().manual_seed(0))
    for grid, R in zip(field.encoder.grids, (64, 128)):
        assert grid.shape == (R, R, R, 4)
        grid = grid.detach()
        assert abs(float(grid.std()) - 0.1) < 0.01 and abs(float(grid.mean())) < 0.01
    assert field.max_eval_chunk == JaxField(aabb=AABB).max_eval_chunk == 2**21
    assert field.encoder.output_dim == 8


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_field_matches_jitted_jax(dtype):
    """rgb, density (zero outside the box, the quotient map) and every
    parameter's gradient, and the regulariser through the state dict."""
    jdt, tdt = DTYPES[dtype]
    jfield = JaxField(aabb=AABB, compute_dtype=jdt, **SMALL)
    params = jax.tree.map(np.asarray, jfield.init(jax.random.PRNGKey(2)))
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.7, 1.7, (2048, 3)).astype(np.float32)
    d = rng.standard_normal((len(x), 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    g_rgb = rng.standard_normal((len(x), 3)).astype(np.float32)
    g_sigma = rng.standard_normal((len(x), 1)).astype(np.float32)

    def loss(p):
        rgb, sigma = jfield(p, jnp.asarray(x), jnp.asarray(d))
        return jnp.sum(rgb * g_rgb) + jnp.sum(sigma * g_sigma), (rgb, sigma)

    (_, (ref_rgb, ref_sigma)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    ref_grads = voxel_field_params_from_numpy(jax.tree.map(np.asarray, grads), device="cpu")
    field = VoxelRadianceField(AABB, compute_dtype=tdt, **SMALL)
    field.load_state_dict(voxel_field_params_from_numpy(params, device="cpu"))
    rgb, sigma = field(torch.tensor(x), torch.tensor(d))
    outside = ~(np.abs(x) < 1.5).all(-1)
    assert outside.any() and not sigma.detach().numpy()[outside].any()
    tol = 1e-5 if dtype == "f32" else 5e-4
    for out, ref in ((rgb, ref_rgb), (sigma, ref_sigma)):
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)
    ((rgb * torch.tensor(g_rgb)).sum() + (sigma * torch.tensor(g_sigma)).sum()).backward()
    bound = 1e-4 if dtype == "f32" else 5e-3
    for name, p in field.named_parameters():
        got, want = p.grad.numpy(), ref_grads[name].numpy()
        assert np.linalg.norm(got - want) <= bound * np.linalg.norm(want), (
            name, np.linalg.norm(got - want) / np.linalg.norm(want))
    reg = float(jax.jit(jfield.param_regularizer)(jax.tree.map(jnp.asarray, params)))
    state = voxel_field_params_from_numpy(params, device="cpu")
    assert float(field.param_regularizer(state)) == pytest.approx(reg, rel=1e-6)
