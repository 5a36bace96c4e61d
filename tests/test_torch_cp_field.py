"""Port vs JAX: the CP radiance field, SH encoding and trunc_exp, from the
same parameters through the bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
from nerfacc_tpu.models.encoders import spherical_harmonics_16 as jax_sh16
from nerfacc_tpu.models.ngp import trunc_exp as jax_trunc_exp
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.models.encoders import spherical_harmonics_16
from nerfacc_tpu_torch.models.ngp import trunc_exp
from nerfacc_tpu_torch.utils.jax_bridge import (
    cp_field_params_from_numpy,
    cp_field_params_to_numpy,
)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
SMALL = dict(resolutions=(16, 32, 64), ranks=(8, 8, 8))


def _points(seed, n):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.7, 1.7, (n, 3)).astype(np.float32)  # some outside
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, d


def _fields(seed, jax_dtype, torch_dtype, unbounded=False):
    jfield = JaxField(
        aabb=AABB, unbounded=unbounded, compute_dtype=jax_dtype, **SMALL
    )
    jparams = jfield.init(jax.random.PRNGKey(seed))
    field = CPRadianceField(
        AABB, unbounded=unbounded, compute_dtype=torch_dtype, **SMALL
    )
    field.load_state_dict(
        cp_field_params_from_numpy(jax.tree.map(np.asarray, jparams))
    )
    return jfield, jparams, field


@pytest.mark.parametrize("unbounded", [False, True])
def test_field_f32_matches_jax(unbounded):
    """Bounded: density zeroed outside the AABB.  Unbounded: points far
    outside are contracted into the unit sphere (contract_to_unisphere)."""
    jfield, jparams, field = _fields(0, jnp.float32, torch.float32, unbounded)
    x, d = _points(1, 3000)
    if unbounded:
        x = x * 4.0
    rgb_ref, density_ref = jfield(jparams, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        rgb, density = field(torch.tensor(x), torch.tensor(d))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        density.numpy(), np.asarray(density_ref), rtol=1e-5, atol=1e-5
    )
    outside = (np.abs(x) >= 1.5).any(-1)
    assert outside.any()
    assert (density.numpy()[outside] == 0).all() != unbounded


def test_field_bf16_near_jax_default():
    """The port's bf16 encoder follows the Pallas kernel (bf16 weights and
    table values, f32 sums and products); the JAX default (XLA) path rounds
    each level's dot output to bf16 and multiplies in bf16.  Those extra
    roundings (~0.4% per feature) pass through two MLPs: rgb within 2e-2,
    density within 5e-2 relative.  Per-level bf16 agreement with the Pallas
    kernel itself is pinned in test_torch_cp_level.py."""
    jfield, jparams, field = _fields(2, jnp.bfloat16, torch.bfloat16)
    x, d = _points(3, 3000)
    rgb_ref, density_ref = jfield(jparams, jnp.asarray(x), jnp.asarray(d))
    with torch.no_grad():
        rgb, density = field(torch.tensor(x), torch.tensor(d))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(rgb_ref), atol=2e-2)
    np.testing.assert_allclose(
        density.numpy(), np.asarray(density_ref), rtol=5e-2, atol=1e-6
    )


def test_sh16_and_trunc_exp_match_jax():
    _, d = _points(4, 500)
    np.testing.assert_allclose(
        spherical_harmonics_16(torch.tensor(d)).numpy(),
        np.asarray(jax_sh16(jnp.asarray(d))), rtol=1e-6, atol=1e-6,
    )
    raw = np.array([-5.0, 0.0, 10.0, 29.0, 40.0, 1e4], np.float32)
    out = trunc_exp(torch.tensor(raw)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_trunc_exp(jnp.asarray(raw))), rtol=1e-6)
    assert out[-2] == out[-1] == np.float32(np.exp(np.float32(30.0)))  # the cap


def test_init_distributions_and_bridge_round_trip():
    field = CPRadianceField(AABB, **SMALL).init(torch.Generator().manual_seed(0))
    lines = torch.cat([p.detach().reshape(-1) for p in field.encoder.lines])
    assert abs(float(lines.mean()) - 1.0) < 0.01
    assert abs(float(lines.std()) - 0.1) < 0.01
    for w in list(field.mlp_base) + list(field.mlp_head):
        w = w.detach()
        a = (6.0 / sum(w.shape)) ** 0.5
        assert float(w.abs().max()) <= a and float(w.abs().max()) > 0.9 * a

    jparams = JaxField(aabb=AABB, **SMALL).init(jax.random.PRNGKey(5))
    tree = jax.tree.map(np.asarray, jparams)
    params = cp_field_params_from_numpy(tree)
    assert set(params) == set(field.state_dict())
    back = cp_field_params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bf16", [False, True])
def test_encoder_levels_concatenate(bf16):
    dtype = torch.bfloat16 if bf16 else torch.float32
    field = CPRadianceField(AABB, compute_dtype=dtype, **SMALL).init(
        torch.Generator().manual_seed(1)
    )
    x, _ = _points(6, 100)
    u, _ = field.normalize(torch.tensor(x))
    with torch.no_grad():
        feats = field.encoder(u)
    assert feats.shape == (100, 24) and torch.isfinite(feats).all()


def test_trunc_exp_gradient_matches_jax_custom_vjp():
    """The backward is g * exp(min(x, 15)) for every x (JAX's custom VJP):
    at 20 it is exp(15), not exp(20), and at 40, past the forward cap, it
    is exp(15), not 0."""
    x = np.array([-5.0, 10.0, 15.0, 20.0, 40.0], np.float32)
    ref = np.asarray(jax.vmap(jax.grad(jax_trunc_exp))(jnp.asarray(x)))
    t = torch.tensor(x, requires_grad=True)
    trunc_exp(t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-6)
    assert t.grad[3] == t.grad[4] == torch.exp(torch.tensor(15.0))
