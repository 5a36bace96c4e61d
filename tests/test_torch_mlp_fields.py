"""Port vs JAX: the MLP radiance fields (vanilla NeRF, T-NeRF and NDRT),
their forward, occupancy query and every parameter gradient, from the same
numpy-seeded points and the same parameters through the bridge.

Bounds: the f32 forward within 1e-5 of the output's largest entry, or,
where an output is a sum that cancels far below its terms (the untrained
density head's ~1e-3 from O(1) features), no farther from JAX's float64
forward than twice JAX's own f32 distance from it, with the port's
float64 forward within 1e-9 of JAX's float64 forward; each
parameter gradient within 1e-4 of JAX's in relative Frobenius norm (f32
matmuls in another summation order).  The bf16 vanilla field's leaves are
held to 5e-3, the bound of a bf16 cotangent flip (PERF.md section 2).

The warped fields are held piecewise once their warp moves points by ~0.1:
the warp, its parameters' gradients under a given cotangent, and the NeRF
behind it on the same warped points.  End to end, a last-bit difference
of a warped point (the warp MLP's f32 sums in another order) is multiplied
by up to 2^9 in the degree-10 encoding's arguments (up to ~770 rad), and
its sine and cosine carry that into the output (~2e-5 of its largest entry
for NDRT at its own init) and the warp's gradients (~3e-2); the sines of
the port's encoders are the correctly rounded ones of their f32 arguments,
JAX's within an ulp or two of them."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu.models.mlp as jax_mlp
from nerfacc_tpu.models.mlp import MLP as JaxMLP
from nerfacc_tpu.models.mlp import NDRTNeRFRadianceField as JaxNDRT
from nerfacc_tpu.models.mlp import TNeRFRadianceField as JaxTNeRF
from nerfacc_tpu.models.mlp import VanillaNeRFRadianceField as JaxVanilla
from nerfacc_tpu_torch.models.mlp import (
    MLP,
    NDRTNeRFRadianceField,
    TNeRFRadianceField,
    VanillaNeRFRadianceField,
)
from nerfacc_tpu_torch.utils.jax_bridge import (
    field_params_from_numpy,
    field_params_to_numpy,
    ndrt_field_params_from_numpy,
    tnerf_field_params_from_numpy,
    vanilla_field_params_from_numpy,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

N = 256
NARROW = dict(net_depth=4, net_width=32, skip_layer=2, net_width_condition=16)


def _samples(seed=0, n=N):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    g_rgb = rng.standard_normal((n, 3)).astype(np.float32)
    g_sigma = rng.standard_normal((n, 1)).astype(np.float32)
    return x, t, d, g_rgb, g_sigma


def _scaled(params, scale):
    """The JAX tree with every warp output layer ``scale`` x its near-zero
    init, so that the warp moves points and its gradients do not vanish."""
    params = jax.tree.map(np.asarray, params)
    if "warp" in params:
        params["warp"]["output"]["w"] = params["warp"]["output"]["w"] * scale
    for name in ("warp1", "warp2"):
        for mlp in params.get(name, []):
            mlp["output"]["w"] = mlp["output"]["w"] * scale
    return params


# kind -> (JAX field, port field, bridge, time-dependent)
FIELDS = {
    "vanilla": (lambda dt: JaxVanilla(compute_dtype=dt, **NARROW),
                lambda dt: VanillaNeRFRadianceField(compute_dtype=dt, device="cpu", **NARROW),
                vanilla_field_params_from_numpy, False),
    "tnerf": (lambda dt: JaxTNeRF(compute_dtype=dt),
              lambda dt: TNeRFRadianceField(compute_dtype=dt, device="cpu"),
              tnerf_field_params_from_numpy, True),
    "ndrt": (lambda dt: JaxNDRT(compute_dtype=dt),
             lambda dt: NDRTNeRFRadianceField(compute_dtype=dt, device="cpu"),
             ndrt_field_params_from_numpy, True),
}


# the warp output's scale where the warp moves points by ~0.1-1
WARP_SCALE = {"vanilla": 1.0, "tnerf": 1e3, "ndrt": 1e2}


def _pair(kind, bf16=False, scale=None):
    jmake, make, bridge, timed = FIELDS[kind]
    jfield = jmake(jnp.bfloat16 if bf16 else None)
    scale = WARP_SCALE[kind] if scale is None else scale
    params = _scaled(jfield.init(jax.random.PRNGKey(1)), scale)
    field = make(torch.bfloat16 if bf16 else torch.float32)
    field.load_state_dict(bridge(params, device="cpu"))
    return jfield, params, field, timed


def _assert_close(out, ref, ref64, out64, rel=1e-5):
    """``out`` (the port's f32 result) and ``ref`` (JAX's) within ``rel``
    of ``ref``'s largest entry, or, where JAX's own f32 result lies
    farther than that from ``ref64`` (JAX's float64 result), ``out`` no
    farther from ``ref64`` than twice JAX's distance; ``out64`` (the port's
    float64 result) within 1e-9 of ``ref64``'s largest entry, so that an
    error shared by the port's f32 and float64 paths fails."""
    out, ref = out.detach().numpy(), np.asarray(ref)
    scale = np.abs(ref64).max()
    np.testing.assert_allclose(out64, ref64, rtol=0, atol=1e-9 * scale)
    jax_err = np.abs(ref - ref64).max()
    bound = max(rel * scale, 2 * jax_err)
    assert np.abs(out - ref64).max() <= bound, (np.abs(out - ref64).max(), jax_err)
    assert np.abs(out - ref).max() <= bound, (np.abs(out - ref).max(), jax_err)


def _f64(module, fn, *args):
    """``fn(module64, *args64)`` on a float64 copy of ``module``, as numpy."""
    module64 = copy.deepcopy(module).double()
    out = fn(module64, *(a.double() if a.is_floating_point() else a for a in args))
    return tuple(o.detach().numpy() for o in out) if isinstance(out, tuple) else (
        out.detach().numpy())


def _linear64(p, x, compute_dtype=None):
    return jnp.dot(x, p["w"]) + p["b"]


def jax64(fn, params, *args):
    """``fn(params64, *args64)`` through the JAX package in float64, as
    numpy: the witness independent of the port.  JAX's ``_linear`` asks
    its dots for an f32 result, so it is swapped here for the same product
    and bias in the operands' dtype; every other line is JAX's."""
    def to64(a):
        a = np.asarray(a)
        return jnp.asarray(a, jnp.float64 if np.issubdtype(a.dtype, np.floating) else a.dtype)

    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_mlp, "_linear", _linear64)
        out = jax.jit(fn)(jax.tree.map(to64, params), *map(to64, args))
        return jax.tree.map(np.asarray, out)


def _jax_loss(jfield, timed, x, t, d, g_rgb, g_sigma):
    def loss(p):
        if timed:
            rgb, sigma = jfield(p, x, t, condition=d)
        else:
            rgb, sigma = jfield(p, x, condition=d)
        return jnp.sum(rgb * g_rgb) + jnp.sum(sigma * g_sigma), (rgb, sigma)
    return loss


@pytest.mark.parametrize("kind,bf16,scale", [
    ("vanilla", False, 1.0), ("vanilla", True, 1.0), ("tnerf", False, 1e2),
], ids=["vanilla-f32", "vanilla-bf16", "tnerf"])
def test_field_and_gradients_match_jax(kind, bf16, scale):
    """Forward (rgb and density) and every parameter's gradient of a
    weighted sum of both, against the jitted JAX field; T-NeRF's warp
    output scaled 100x from its init (points move by ~1e-2)."""
    jfield, params, field, timed = _pair(kind, bf16, scale)
    x, t, d, g_rgb, g_sigma = _samples()
    loss = _jax_loss(jfield, timed, *(jnp.asarray(a) for a in (x, t, d, g_rgb, g_sigma)))
    (_, (ref_rgb, ref_sigma)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    ref_grads = FIELDS[kind][2](jax.tree.map(np.asarray, grads), device="cpu")
    args = (torch.tensor(x), torch.tensor(t), torch.tensor(d)) if timed else (
        torch.tensor(x), torch.tensor(d))
    rgb, sigma = field(*args)
    assert rgb.shape == (N, 3) and sigma.shape == (N, 1)
    if bf16:  # one bf16 rounding of an operand moves an output ~2^-9
        for out, ref in ((rgb, ref_rgb), (sigma, ref_sigma)):
            ref = np.asarray(ref)
            np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                                       atol=5e-3 * np.abs(ref).max())
    else:
        outs64 = _f64(field, lambda f, *a: f(*a), *args)
        refs64 = jax64(lambda p, *a: jfield(p, *a[:-1], condition=a[-1]), params,
                       *((x, t, d) if timed else (x, d)))
        for i, (out, ref) in enumerate(((rgb, ref_rgb), (sigma, ref_sigma))):
            _assert_close(out, ref, refs64[i], outs64[i])
    ((rgb * torch.tensor(g_rgb)).sum() + (sigma * torch.tensor(g_sigma)).sum()).backward()
    named = dict(field.named_parameters())
    assert set(named) == set(ref_grads)
    bound = 5e-3 if bf16 else 1e-4
    for name, p in named.items():
        got, want = p.grad.numpy(), ref_grads[name].numpy()
        assert np.abs(want).max() > 0, name
        assert np.linalg.norm(got - want) <= bound * np.linalg.norm(want), (
            name, np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("kind", ["tnerf", "ndrt"])
def test_warp_and_nerf_match_jax(kind):
    """The warp moving points by ~0.1-1 (``WARP_SCALE``):
    the warped points within 1e-6 of their largest coordinate; every warp
    parameter's gradient under one cotangent on the warped points within
    1e-4; the NeRF on JAX's warped points, its forward within 1e-5 and its
    gradients within 1e-4."""
    jfield, params, field, _ = _pair(kind)
    x, t, d, g_rgb, g_sigma = _samples(1)
    g_x = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    warp_fn = jfield._warped if kind == "tnerf" else jfield.warp

    def warp_loss(p):
        y = warp_fn(p, jnp.asarray(x), jnp.asarray(t))
        return jnp.sum(y * g_x), y

    (_, ref_y), grads = jax.jit(jax.value_and_grad(warp_loss, has_aux=True))(jp)
    ref_y = np.asarray(ref_y)
    ref_grads = FIELDS[kind][2](jax.tree.map(np.asarray, grads), device="cpu")
    y = field.warp(torch.tensor(x), torch.tensor(t))
    assert 0.05 < np.abs(ref_y - x).max() < 2.0
    np.testing.assert_allclose(y.detach().numpy(), ref_y, rtol=0, atol=1e-6 * np.abs(ref_y).max())
    (y * torch.tensor(g_x)).sum().backward()
    warp_names = [n for n, _ in field.named_parameters() if not n.startswith("nerf.")]
    assert warp_names
    for name, p in field.named_parameters():
        if name.startswith("nerf."):
            assert p.grad is None, name
            continue
        got, want = p.grad.numpy(), ref_grads[name].numpy()
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), (
            name, np.linalg.norm(got - want) / np.linalg.norm(want))

    loss = _jax_loss(jfield.nerf, False, *(jnp.asarray(a) for a in (ref_y, t, d, g_rgb, g_sigma)))
    (_, (ref_rgb, ref_sigma)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jp["nerf"])
    ref_grads = vanilla_field_params_from_numpy(
        jax.tree.map(np.asarray, grads), device="cpu", prefix="nerf.")
    args = (torch.tensor(ref_y), torch.tensor(d))
    rgb, sigma = field.nerf(*args)
    outs64 = _f64(field.nerf, lambda f, *a: f(*a), *args)
    refs64 = jax64(lambda p, y, d: jfield.nerf(p, y, condition=d), params["nerf"], ref_y, d)
    for i, (out, ref) in enumerate(((rgb, ref_rgb), (sigma, ref_sigma))):
        _assert_close(out, ref, refs64[i], outs64[i])
    ((rgb * torch.tensor(g_rgb)).sum() + (sigma * torch.tensor(g_sigma)).sum()).backward()
    for name, want in ref_grads.items():
        got, want = field.get_parameter(name).grad.numpy(), want.numpy()
        assert np.linalg.norm(got - want) <= 1e-4 * np.linalg.norm(want), (
            name, np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("kind", ["tnerf", "ndrt"])
def test_query_opacity_matches_jax_with_its_frames(kind):
    """``query_opacity`` with JAX's frame draw injected: the frames the JAX
    field draws from its key, ``density * step_size`` within 1e-5, and the
    point's density at that frame's time."""
    jfield, params, field, _ = _pair(kind)
    x = _samples(3)[0]
    timestamps = np.linspace(0.0, 1.0, 7, dtype=np.float32)[:, None]
    key = jax.random.PRNGKey(5)
    ref = np.asarray(jfield.query_opacity(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(timestamps), 5e-3, key))
    frames = torch.tensor(np.asarray(jax.random.randint(key, (N,), 0, 7)))
    args = (torch.tensor(x), torch.tensor(timestamps))
    out = field.query_opacity(*args, 5e-3, frames)
    ref64 = jax64(lambda p, x, ts, fr: jfield.query_density(p, x, ts[fr]) * 5e-3,
                  params, x, timestamps, frames.numpy())
    _assert_close(out, ref, ref64,
                  _f64(field, lambda f, x, ts: f.query_opacity(x, ts, 5e-3, frames), *args))
    density = field.query_density(torch.tensor(x), torch.tensor(timestamps)[frames])
    torch.testing.assert_close(out, density * 5e-3)


@pytest.mark.parametrize("depth,skip,enabled", [
    (8, 4, True), (8, 4, False), (4, 2, True), (5, 2, False), (3, None, False), (0, None, True),
])
def test_mlp_skip_rule_matches_jax(depth, skip, enabled):
    """The concat after layer ``i``'s ReLU for ``i`` a positive multiple of
    the skip, in the order ``[x, inputs]``, each layer's input width and
    ``final_dim``; the forward within 1e-5."""
    jmlp = JaxMLP(input_dim=7, output_dim=3, net_depth=depth, net_width=16, skip_layer=skip,
                  output_enabled=enabled)
    params = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(0)))
    mlp = MLP(7, 3, depth, 16, skip, enabled)
    assert mlp.final_dim == jmlp.final_dim
    assert [tuple(layer.w.shape) for layer in mlp.hidden] == [
        layer["w"].shape for layer in params["hidden"]]
    with torch.no_grad():
        for layer, ref in zip(mlp.hidden, params["hidden"]):
            layer.w.copy_(torch.tensor(ref["w"]))
            layer.b.copy_(torch.tensor(ref["b"] + 0.1))
        if enabled:
            mlp.output.w.copy_(torch.tensor(params["output"]["w"]))
    params["hidden"] = [dict(layer, b=layer["b"] + 0.1) for layer in params["hidden"]]
    x = np.random.default_rng(0).standard_normal((64, 7)).astype(np.float32)
    ref = np.asarray(jmlp(params, jnp.asarray(x)))
    out = mlp(torch.tensor(x)).detach().numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * max(np.abs(ref).max(), 1.0))


@pytest.mark.parametrize("kind", list(FIELDS))
def test_bridge_round_trip_and_init(kind):
    """The JAX tree through the bridge and back, bitwise, through the
    dispatching ``field_params_*``; the port's own init draws JAX's
    distributions: biases zero, each warp output layer in [0, 1e-4]."""
    jfield, params, field, _ = _pair(kind)
    back = field_params_to_numpy(field_params_from_numpy(params, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    field.init(torch.Generator().manual_seed(0))
    for name, p in field.named_parameters():
        if name.endswith(".b"):
            assert not p.any(), name
        elif "output" in name and name.split(".")[0] in ("warp_mlp", "warp1", "warp2"):
            assert 0 <= float(p.min()) and float(p.max()) <= 1e-4 and float(p.max()) > 0, name
        else:  # Xavier-uniform: |w| <= a, and the std a / sqrt(3)
            a = (6.0 / sum(p.shape)) ** 0.5
            assert float(p.abs().max()) <= a and 0.4 * a < float(p.std()) < 0.75 * a, name


def test_vanilla_density_is_relu_and_opacity_linear():
    """The vanilla density is ``relu(sigma)``, not ``trunc_exp``, and its
    ``query_opacity`` is ``density * step_size`` (the JAX field's)."""
    jfield, params, field, _ = _pair("vanilla")
    x = _samples(4)[0]
    ref = np.asarray(jfield.query_opacity(jax.tree.map(jnp.asarray, params), jnp.asarray(x), 1e-2))
    out = field.query_opacity(torch.tensor(x), 1e-2).detach()
    ref64 = jax64(lambda p, x: jfield.query_opacity(p, x, 1e-2), params, x)
    _assert_close(out, ref, ref64,
                  _f64(field, lambda f, x: f.query_opacity(x, 1e-2), torch.tensor(x)))
    raw = field.mlp.query_density(field.posi_encoder(torch.tensor(x))).detach()
    assert (raw < 0).any()
    torch.testing.assert_close(field.query_density(torch.tensor(x)).detach(), raw.clamp_min(0))
