"""Port vs JAX: the hash-grid NGPRadianceField and NGPDensityField, forward
and every parameter gradient, from the same parameters through the bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models.ngp import NGPDensityField as JaxDensityField
from nerfacc_tpu.models.ngp import NGPRadianceField as JaxField
from nerfacc_tpu.models.ngp import _cubify_aabb as jax_cubify_aabb
from nerfacc_tpu.models.ngp import contract_to_unisphere as jax_contract
from nerfacc_tpu_torch.models.ngp import (
    NGPDensityField,
    NGPRadianceField,
    _cubify_aabb,
    normalize_points,
)
from nerfacc_tpu_torch.utils.jax_bridge import (
    field_params_from_numpy,
    field_params_to_numpy,
    ngp_density_field_params_from_numpy,
    ngp_density_field_params_to_numpy,
    ngp_field_params_from_numpy,
    ngp_field_params_to_numpy,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
SMALL = dict(n_levels=4, log2_hashmap_size=12, max_resolution=64)


def _points(seed, n, scale=1.7):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)  # some outside
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, d


def _run(seed, bf16, unbounded=False, n=3000):
    """Both fields on the same parameters (the table scaled to O(1), so the
    features move the MLPs) and points: (rgb, density, geo feats) of each,
    and the gradient of ``sum(rgb c0) + sum(density c1) + sum(geo c2)`` in
    every parameter, as JAX-shaped numpy trees."""
    jfield = JaxField(
        aabb=AABB, unbounded=unbounded,
        compute_dtype=jnp.bfloat16 if bf16 else jnp.float32, **SMALL,
    )
    jparams = jfield.init(jax.random.PRNGKey(seed))
    jparams["encoder"] = jparams["encoder"] * 1e4
    field = NGPRadianceField(
        AABB, unbounded=unbounded,
        compute_dtype=torch.bfloat16 if bf16 else torch.float32, **SMALL,
    )
    field.load_state_dict(
        ngp_field_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    )
    x, d = _points(seed + 1, n, 6.0 if unbounded else 1.7)
    rng = np.random.default_rng(seed + 2)
    cots = [rng.standard_normal((n, c)).astype(np.float32) for c in (3, 1, 15)]

    def jax_loss(p):
        rgb, density = jfield(p, jnp.asarray(x), jnp.asarray(d))
        _, geo = jfield.query_density(p, jnp.asarray(x), return_feat=True)
        outs = (rgb, density, geo)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cots)), outs

    (_, ref), jgrads = jax.value_and_grad(jax_loss, has_aux=True)(jparams)
    xt, dt = torch.tensor(x), torch.tensor(d)
    rgb, density = field(xt, dt)
    _, geo = field.query_density(xt, return_feat=True)
    outs = (rgb, density, geo)
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cots)).backward()
    grads = ngp_field_params_to_numpy(
        {k: p.grad for k, p in field.named_parameters()}
    )
    return (
        [o.detach().numpy() for o in outs],
        [np.asarray(o) for o in ref],
        grads,
        jax.tree.map(np.asarray, jgrads),
        x,
    )


def _leaves(tree):
    return dict(zip(("encoder", "mlp_base.0", "mlp_base.1", "mlp_head.0",
                     "mlp_head.1", "mlp_head.2"), jax.tree.leaves(tree)))


@pytest.mark.parametrize("unbounded", [False, True])
def test_ngp_field_f32_matches_jax(unbounded):
    """f32: rgb, density and geo features within 1e-5 (the CP field's
    bound), every parameter gradient within 1e-5 of its largest entry.
    Bounded: density zeroed outside the (cubified) AABB."""
    outs, ref, grads, jgrads, x = _run(0, False, unbounded)
    for name, o, r in zip(("rgb", "density", "geo"), outs, ref):
        np.testing.assert_allclose(o, r, rtol=1e-5, atol=1e-5, err_msg=name)
    got, want = _leaves(grads), _leaves(jgrads)
    for name in want:
        g, w = got[name], want[name]
        assert g.shape == w.shape and np.abs(w).max() > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)
    outside = (np.abs(x) >= 1.5).any(-1)
    assert outside.any()
    assert (outs[1][outside] == 0).all() != unbounded


def test_ngp_field_bf16_matches_jax():
    """bf16 MLP operands with f32 results on both sides (the hash features
    are f32 in both): rgb within 2e-2 and density within 5e-2 relative,
    the CP field's bf16 bounds; each gradient leaf within 5e-3 relative
    Frobenius (the bf16 train-step bound: the weight gradients pass through
    a bf16 rounding, where a one-ulp flip moves an entry by 2^-8)."""
    outs, ref, grads, jgrads, _ = _run(3, True)
    np.testing.assert_allclose(outs[0], ref[0], atol=2e-2)
    np.testing.assert_allclose(outs[1], ref[1], rtol=5e-2, atol=1e-6)
    np.testing.assert_allclose(outs[2], ref[2], rtol=5e-2, atol=5e-2)
    got, want = _leaves(grads), _leaves(jgrads)
    for name in want:
        rel = np.linalg.norm(got[name] - want[name]) / np.linalg.norm(want[name])
        assert rel <= 5e-3, (name, rel)


def test_cubified_aabb_matches_jax():
    aabb = (-1.0, -0.5, 0.0, 2.0, 1.5, 1.0)
    np.testing.assert_array_equal(
        _cubify_aabb(aabb).numpy(), np.asarray(jax_cubify_aabb(jnp.asarray(aabb)))
    )
    field = NGPRadianceField(aabb, **SMALL)
    np.testing.assert_array_equal(field.aabb.numpy(), [-1.0, -1.0, -1.0, 2.0, 2.0, 2.0])


def test_init_distributions_and_bridge_round_trip():
    field = NGPRadianceField(AABB, **SMALL).init(torch.Generator().manual_seed(0))
    table = field.encoder.table.detach()
    assert table.shape == (4, 4096, 2) and float(table.abs().max()) <= 1e-4
    assert field.base_dims == [8, 64, 16] and field.head_dims == [31, 64, 64, 3]
    for w in list(field.mlp_base) + list(field.mlp_head):
        a = (6.0 / sum(w.shape)) ** 0.5
        assert a * 0.9 < float(w.detach().abs().max()) <= a

    jfield = JaxField(aabb=AABB, **SMALL)
    tree = jax.tree.map(np.asarray, jfield.init(jax.random.PRNGKey(5)))
    params = ngp_field_params_from_numpy(tree, device="cpu")
    assert set(params) == set(field.state_dict())
    back = ngp_field_params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_full_width_defaults_match_jax():
    """The port's defaults are the JAX field's full width (built on the
    meta device: the 2^19-row table is not allocated)."""
    jfield = JaxField(aabb=AABB)
    with torch.device("meta"):
        field = NGPRadianceField(AABB)
    enc = field.encoder
    assert enc.table.shape == (16, 2**19, 2)
    assert enc.resolutions == jfield.encoder.resolutions
    assert field.base_dims == [32, 64, 16] and field.head_dims == [31, 64, 64, 3]
    assert field.compute_dtype == torch.bfloat16


PROP_AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)  # the unbounded example's box


@pytest.mark.parametrize("unbounded", [False, True])
def test_ngp_density_field_f32_matches_jax(unbounded):
    """The proposal field's levels and resolutions (5 levels, 16..128) with
    a 2^12-row table (the full 2^17 only slows the JAX gradient), f32,
    from the same parameters (the table scaled to O(1)).
    The hash features of the same encoder coordinates bitwise against the
    jitted JAX encoder.  The density against the jitted JAX field:
    unbounded within 1e-6 relative (the contracted coordinates are bitwise
    those of the jitted field, see
    :func:`test_box_map_matches_jitted_jax_bitwise`; the MLP sums in another
    order), bounded within 1e-5 (jitted XLA divides by the constant box as a
    product with its reciprocal, the port keeps the quotient, see
    ``normalize_points``: ~1/3 of the coordinates differ in the last bit,
    and a feature moves by up to ~2.5e-5); every gradient leaf of
    ``sum(sin(density))`` within 1e-5 of its largest entry.  Bounded, the
    density is 0 outside the uncubified box; the bridge round-trips."""
    aabb = (-1.5, -1.0, -1.0, 1.5, 1.0, 1.0)  # not a cube: no cubification
    small = dict(log2_hashmap_size=12)
    jfield = JaxDensityField(aabb=aabb, unbounded=unbounded, compute_dtype=jnp.float32, **small)
    jparams = jfield.init(jax.random.PRNGKey(3))
    jparams["encoder"] = jparams["encoder"] * 1e4
    tree = jax.tree.map(np.asarray, jparams)
    field = NGPDensityField(aabb, unbounded=unbounded, compute_dtype=torch.float32, **small)
    field.load_state_dict(ngp_density_field_params_from_numpy(tree, device="cpu"))
    assert field.encoder.resolutions == jfield.encoder.resolutions
    assert field.base_dims == [10, 64, 1]
    x, _ = _points(4, 3000, 6.0 if unbounded else 1.7)
    want = jax.jit(jfield)(jparams, jnp.asarray(x))
    want_grads = jax.jit(jax.grad(lambda p: jnp.sum(jnp.sin(jfield(p, jnp.asarray(x))))))(jparams)
    got = field(torch.tensor(x))
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6 if unbounded else 1e-5, atol=1e-30)
    u, _ = normalize_points(torch.tensor(x), field.aabb, unbounded)
    want_feats = jax.jit(lambda t, v: jfield.encoder(t, v))(jparams["encoder"], jnp.asarray(u.numpy()))
    np.testing.assert_array_equal(field.encoder(u).detach().numpy(), np.asarray(want_feats))
    grads = ngp_density_field_params_to_numpy({k: p.grad for k, p in field.named_parameters()})
    for g, w in zip(jax.tree.leaves(grads), jax.tree.leaves(jax.tree.map(np.asarray, want_grads))):
        assert g.shape == w.shape and np.abs(w).max() > 0
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    outside = ((x < np.array(aabb[:3])) | (x > np.array(aabb[3:]))).any(-1)
    assert outside.any() and (~outside).any()
    assert (got.detach().numpy()[outside] == 0).all() != unbounded
    back = field_params_to_numpy(field.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    for k, v in field_params_from_numpy(tree, device="cpu").items():
        assert torch.equal(v, field.state_dict()[k]), k


def test_ngp_density_field_init_and_defaults_match_jax():
    """JAX's defaults (built on the meta device for the shapes) and the
    init's distributions: table within 1e-4, MLP weights Glorot-uniform."""
    jfield = JaxDensityField(aabb=PROP_AABB)
    with torch.device("meta"):
        meta = NGPDensityField(PROP_AABB)
    assert meta.encoder.table.shape == (5, 2**17, 2)
    assert meta.compute_dtype == torch.bfloat16 and not meta.unbounded
    assert meta.encoder.resolutions == jfield.encoder.resolutions
    field = NGPDensityField(PROP_AABB, log2_hashmap_size=10).init(torch.Generator().manual_seed(0))
    assert float(field.encoder.table.detach().abs().max()) <= 1e-4
    for w in field.mlp_base:
        a = (6.0 / sum(w.shape)) ** 0.5
        assert a * 0.9 < float(w.detach().abs().max()) <= a
    np.testing.assert_array_equal(field.aabb.numpy(), PROP_AABB)


@pytest.mark.parametrize("aabb", [
    (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0), (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
    (-1.5, -1.0, -1.0, 1.5, 1.0, 1.0), (-0.5, 0.0, 0.0, 1.5, 2.0, 2.0),
], ids=["unit", "cube", "box", "shifted"])
def test_box_map_matches_jitted_jax_bitwise(aabb):
    """The unbounded ``normalize_points`` against the jitted JAX contraction
    over a constant box, bit for bit on points out to 6 from the origin:
    the box map's ``* 2 - 1`` in the form XLA folds and fuses for that box
    (the unit box's map is the identity).  The bounded map is the quotient,
    as the eager JAX field computes it."""
    x = np.random.default_rng(5).uniform(-6, 6, (20000, 3)).astype(np.float32)
    box = jnp.asarray(aabb, jnp.float32)
    want_u = jax.jit(lambda p: jax_contract(p, box))(jnp.asarray(x))
    want_b = (jnp.asarray(x) - box[:3]) / (box[3:] - box[:3])
    t = torch.tensor(aabb)
    got_u, _ = normalize_points(torch.tensor(x), t, True)
    got_b, _ = normalize_points(torch.tensor(x), t, False)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
