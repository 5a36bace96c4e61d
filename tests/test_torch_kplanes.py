"""Port vs JAX: the K-Planes encoder and field against the jitted JAX ones
(the trainer jits them; eager JAX rounds each bf16 product and differs from
the jitted encoder in ~97% of entries), from numpy-seeded points and the
same parameters through the bridge.

Bounds.  f32: the encoder within 1e-6 of JAX's, the field's outputs within
1e-5 and its gradients 1e-4 in relative Frobenius norm.  bf16: the port
takes the jitted level's roundings (hat weights, each plane's first lerp,
its second lerp and the running product but its last multiply, rounded to
bf16; see ``KPlanesEncoder.level``), which leaves at most 1e-3 of the
entries unequal, each within 5e-2 of its value (a plane feature one bf16
ulp apart, 2^-8 of it, through the product of six); the gradients, which
JAX's autodiff takes through bf16, within 5e-3 in relative Frobenius norm
(PERF.md section 2)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models.kplanes import KPlanesEncoder as JaxEncoder
from nerfacc_tpu.models.kplanes import KPlanesRadianceField as JaxField
from nerfacc_tpu_torch.models.kplanes import KPlanesEncoder, KPlanesRadianceField
from nerfacc_tpu_torch.utils.jax_bridge import (
    field_params_from_numpy,
    field_params_to_numpy,
    kplanes_field_params_from_numpy,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
SMALL = dict(resolutions=(8, 16), ranks=(4, 4))
N = 2048
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _planes(seed=0, amplitude=0.1):
    """JAX-initialised planes with the time planes moved off their exact 1
    (as training moves them), as numpy."""
    planes = JaxEncoder(**SMALL).init(jax.random.PRNGKey(seed))["planes"]
    rng = np.random.default_rng(seed + 1)
    out = []
    for p in planes:
        p = np.array(p)
        p[3:] += amplitude * rng.standard_normal(p[3:].shape).astype(np.float32)
        out.append(p)
    return out


def _points(seed=0, n=N):
    """(n, 4) points in [-0.05, 1.05]^4: some outside, clamped."""
    return np.random.default_rng(seed).uniform(-0.05, 1.05, (n, 4)).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("activation", ["none", "tanh"])
def test_encoder_matches_jitted_jax(dtype, activation):
    """Forward and the planes' gradient under one cotangent."""
    jdt, tdt = DTYPES[dtype]
    jenc = JaxEncoder(compute_dtype=jdt, plane_activation=activation, **SMALL)
    planes, q = _planes(), _points()
    cot = np.random.default_rng(3).standard_normal((N, 8)).astype(np.float32)

    def loss(planes):
        out = jenc({"planes": planes}, jnp.asarray(q))
        return jnp.sum(out * cot), out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        [jnp.asarray(p) for p in planes])
    ref = np.asarray(ref)
    enc = KPlanesEncoder(compute_dtype=tdt, plane_activation=activation, **SMALL)
    tplanes = [torch.tensor(p, requires_grad=True) for p in planes]
    out = enc(torch.tensor(q), tplanes)
    got = out.detach().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    else:
        unequal = got != ref
        assert unequal.mean() <= 1e-3, unequal.mean()
        np.testing.assert_allclose(got, ref, rtol=5e-2, atol=0)
    (out * torch.tensor(cot)).sum().backward()
    bound = 1e-4 if dtype == "f32" else 5e-3
    for p, g in zip(tplanes, grads):
        g = np.asarray(g)
        assert np.linalg.norm(p.grad.numpy() - g) <= bound * np.linalg.norm(g)


@pytest.mark.parametrize("amp_prior", [0.0, 0.5])
def test_param_regularizer_matches_jax(amp_prior):
    """TV over both axes of every plane, the time planes' second difference
    and the amplitude prior, within 1e-6 relative, and its gradient."""
    jenc = JaxEncoder(amp_prior=amp_prior, **SMALL)
    planes = _planes(1, amplitude=0.3)
    ref, grads = jax.jit(jax.value_and_grad(lambda p: jenc.param_regularizer({"planes": p})))(
        [jnp.asarray(p) for p in planes])
    enc = KPlanesEncoder(amp_prior=amp_prior, **SMALL)
    tplanes = [torch.tensor(p, requires_grad=True) for p in planes]
    out = enc.param_regularizer(tplanes)
    assert float(out) == pytest.approx(float(ref), rel=1e-6)
    out.backward()
    for p, g in zip(tplanes, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-6 * np.abs(np.asarray(g)).max())
    field = KPlanesRadianceField(AABB, amp_prior=amp_prior, device="cpu", **SMALL)
    params = {f"encoder.planes.{i}": p for i, p in enumerate(tplanes)}
    assert float(field.param_regularizer(params)) == pytest.approx(float(ref), rel=1e-6)


@pytest.mark.parametrize("widths", [((32, 64), (16, 16)), ((8, 16), (4, 4)),
                                    ((64, 128, 256), (32, 32, 32))])
def test_max_eval_chunk_matches_jax(widths):
    """The occupancy refresh's chunk: 2^16 at the default widths."""
    resolutions, ranks = widths
    field = KPlanesRadianceField(AABB, resolutions=resolutions, ranks=ranks, device="meta")
    want = JaxField(resolutions=resolutions, ranks=ranks).max_eval_chunk
    assert field.max_eval_chunk == want
    if widths[0] == (32, 64):
        assert want == 2**16


def _field_samples(seed=0, n=1024):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.7, 1.7, (n, 3)).astype(np.float32)
    t = rng.uniform(-0.05, 1.05, (n, 1)).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, t, d


@pytest.mark.parametrize("unbounded", [False, True], ids=["bounded", "contracted"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_field_matches_jitted_jax(unbounded, dtype):
    """The field's rgb, density and every parameter's gradient: bounded
    (density zero outside the box) and contracted; one frame a point
    through ``query_opacity`` with JAX's draw injected."""
    jdt, tdt = DTYPES[dtype]
    aabb = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0) if unbounded else AABB
    jfield = JaxField(aabb=aabb, unbounded=unbounded, compute_dtype=jdt, **SMALL)
    params = jax.tree.map(np.asarray, jfield.init(jax.random.PRNGKey(2)))
    params["encoder"]["planes"] = _planes(2)
    x, t, d = _field_samples()
    rng = np.random.default_rng(4)
    g_rgb = rng.standard_normal((len(x), 3)).astype(np.float32)
    g_sigma = rng.standard_normal((len(x), 1)).astype(np.float32)

    def loss(p):
        rgb, sigma = jfield(p, jnp.asarray(x), jnp.asarray(t), condition=jnp.asarray(d))
        return jnp.sum(rgb * g_rgb) + jnp.sum(sigma * g_sigma), (rgb, sigma)

    (_, (ref_rgb, ref_sigma)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    ref_grads = kplanes_field_params_from_numpy(jax.tree.map(np.asarray, grads), device="cpu")
    field = KPlanesRadianceField(aabb, unbounded=unbounded, compute_dtype=tdt, device="cpu",
                                 **SMALL)
    field.load_state_dict(kplanes_field_params_from_numpy(params, device="cpu"))
    rgb, sigma = field(torch.tensor(x), torch.tensor(t), torch.tensor(d))
    ref_sigma = np.asarray(ref_sigma)
    if not unbounded:
        inside = (np.abs(x) < 1.5).all(-1)
        assert (~inside).any() and not ref_sigma[~inside].any()
        assert not sigma.detach().numpy()[~inside].any()
    rel = 1e-5 if dtype == "f32" else 5e-2
    for out, ref in ((rgb, ref_rgb), (sigma, ref_sigma)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=rel,
                                   atol=rel * np.abs(ref).max() * 1e-2)
    ((rgb * torch.tensor(g_rgb)).sum() + (sigma * torch.tensor(g_sigma)).sum()).backward()
    bound = 1e-4 if dtype == "f32" else 5e-3
    for name, p in field.named_parameters():
        got, want = p.grad.numpy(), ref_grads[name].numpy()
        assert np.linalg.norm(got - want) <= bound * np.linalg.norm(want), (
            name, np.linalg.norm(got - want) / np.linalg.norm(want))

    timestamps = np.linspace(0.0, 1.0, 5, dtype=np.float32)[:, None]
    key = jax.random.PRNGKey(7)
    ref = np.asarray(jax.jit(jfield.query_opacity, static_argnums=(3,))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(timestamps), 5e-3, key))
    frames = torch.tensor(np.asarray(jax.random.randint(key, (len(x),), 0, 5)))
    out = field.query_opacity(torch.tensor(x), torch.tensor(timestamps), 5e-3, frames)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=rel,
                               atol=rel * np.abs(ref).max() * 1e-2)


def test_bridge_round_trip_and_init():
    """The JAX tree through the dispatching bridge and back, bitwise; the
    port's init: spatial planes ``1 + 0.1 N(0, 1)``, time planes exactly 1."""
    params = jax.tree.map(np.asarray, JaxField(**SMALL).init(jax.random.PRNGKey(0)))
    back = field_params_to_numpy(field_params_from_numpy(params, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    field = KPlanesRadianceField(AABB, device="cpu").init(torch.Generator().manual_seed(0))
    for plane in field.encoder.planes:
        assert plane.shape[:3] == (6, plane.shape[1], plane.shape[1])
        assert torch.equal(plane[3:], torch.ones_like(plane[3:]))
        assert abs(float(plane[:3].std()) - 0.1) < 0.01 and abs(float(plane[:3].mean()) - 1) < 0.01
    assert field.encoder.output_dim == 32 and field.max_eval_chunk == 2**16
    with pytest.raises(ValueError):
        KPlanesEncoder(plane_activation="relu")
