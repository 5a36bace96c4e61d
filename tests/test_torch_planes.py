"""Port vs JAX: the CP field's tri-plane levels (product and TensoRF's VM
mode), the CP field with planes and ``TensoRFRadianceField``, from
numpy-seeded points and the same parameters through the bridge.

Bounds.  A plane level against the jitted JAX level (the trainer jits it):
bf16 bitwise, forward and both table gradients (the port takes the jitted
level's roundings, see ``CPGridEncoder.plane_level``, and sums each texel's
cotangents in sample order, the same from run to run; no row of this seeded
case lies a summation-order rounding from a bf16 tie); f32 within 1e-6 and
the gradients within 1e-5 in relative Frobenius norm (XLA sums the dense
hat dots in another order).  Eager JAX rounds every bf16 product and
differs from the jitted level in most entries: the port sits within 3e-2
of its largest entry.  The fields: f32 outputs within 1e-5 and gradients
within 1e-4 in relative Frobenius norm; bf16 against the JAX field whose
line levels take the TPU kernel (``kernel="fused"``, K1 and K2 in the Pallas
interpreter: the port's line levels follow that kernel's contract, not
XLA's dot), outputs within 5e-4 and gradients within 5e-3 in relative
Frobenius norm (the plane gradients read bitwise, the VM field's MLP
leaves up to 6.5e-4); the regulariser within 1e-6 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu.ops.cp_level as jax_cp_level
from nerfacc_tpu.models.cp_field import CPGridEncoder as JaxEncoder
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
from nerfacc_tpu.models.cp_field import TensoRFRadianceField as JaxTensoRF
from nerfacc_tpu.utils import flops as jax_flops
from nerfacc_tpu_torch.models.cp_field import (
    CPGridEncoder,
    CPRadianceField,
    TensoRFRadianceField,
)
from nerfacc_tpu_torch.utils import flops
from nerfacc_tpu_torch.utils.jax_bridge import field_params_from_numpy, field_params_to_numpy
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
R, RANK = 16, 8
N = 2048


def _points(seed=0, n=N, R=R):
    """(n, 3) points in [0, 1]^3, a sixteenth of them on grid points and
    some on the faces."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    x[: n // 16] = np.round(x[: n // 16] * (R - 1)) / (R - 1)
    x[n // 16 : n // 8, 0] = 1.0
    x[n // 8 : n // 8 + 16, 1] = 0.0
    return x


def _plane_level_case(mode, dtype):
    """The JAX encoder, its tables, points, a cotangent, and the jitted JAX
    level's forward and table gradients under that cotangent."""
    jdt, _ = DTYPES[dtype]
    jenc = JaxEncoder(resolutions=(4,), ranks=(2,), compute_dtype=jdt,
                      plane_resolutions=(R,), plane_ranks=(RANK,), plane_mode=mode)
    params = jax.tree.map(np.asarray, jenc.init(jax.random.PRNGKey(0)))
    tables = [params["planes"][0]] + ([params["plane_lines"][0]] if mode == "vm" else [])
    x = _points()
    width = RANK * (3 if mode == "vm" else 1)
    cot = np.random.default_rng(1).standard_normal((N, width)).astype(np.float32)

    def level(*t):
        return jenc._plane_level_encode(jnp.asarray(x), *t, R=R)

    def loss(*t):
        out = level(*t)
        return jnp.sum(out * cot), out

    argnums = tuple(range(len(tables)))
    (_, ref), grads = jax.jit(jax.value_and_grad(loss, argnums, has_aux=True))(*tables)
    return level, tables, x, cot, np.asarray(ref), [np.asarray(g) for g in grads]


def _port_plane_level(mode, dtype, tables, x, cot):
    """The port's level on the same inputs: its output and table gradients."""
    enc = CPGridEncoder((4,), (2,), DTYPES[dtype][1], plane_resolutions=(R,),
                        plane_ranks=(RANK,), plane_mode=mode)
    tt = [torch.tensor(t, requires_grad=True) for t in tables]
    out = enc.plane_level(torch.tensor(x), *tt)
    (out * torch.tensor(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in tt]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("mode", ["product", "vm"])
def test_plane_level_matches_jitted_jax(mode, dtype):
    """One plane level: forward and the plane (and VM line) gradients under
    one cotangent, against the jitted JAX level; and the forward against
    eager JAX."""
    level, tables, x, cot, ref, grads = _plane_level_case(mode, dtype)
    got, got_grads = _port_plane_level(mode, dtype, tables, x, cot)
    if dtype == "bf16":
        np.testing.assert_array_equal(got, ref)
        for gg, g in zip(got_grads, grads):
            np.testing.assert_array_equal(gg, g)
        eager = np.asarray(level(*tables))
        assert (eager != ref).mean() > 0.1  # the rounding the jitted level drops
        assert np.abs(got - eager).max() <= 3e-2 * np.abs(eager).max()
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        for gg, g in zip(got_grads, grads):
            assert np.linalg.norm(gg - g) <= 1e-5 * np.linalg.norm(g)


def test_bf16_vm_plane_level_is_steady():
    """The vm-bf16 level, 20 times in one process: every forward and table
    gradient bitwise the jitted JAX level's.  The plane gradient once summed
    its texels through ``index_put_``'s accumulation, whose parallel adds on
    the CPU round differently from run to run: one entry of this case, an
    f32 sum a rounding away from a bf16 tie, then read one bf16 ulp off in
    about a third of the runs."""
    _, tables, x, cot, ref, grads = _plane_level_case("vm", "bf16")
    for _ in range(20):
        got, got_grads = _port_plane_level("vm", "bf16", tables, x, cot)
        np.testing.assert_array_equal(got, ref)
        for gg, g in zip(got_grads, grads):
            np.testing.assert_array_equal(gg, g)


def _field_pair(kind, jdt, tdt, seed=2):
    """A JAX field and the port's with its parameters: CP lines with a
    plane level in each mode, or TensoRF's levels, narrowed."""
    small = dict(resolutions=(8, 16), ranks=(4, 4), plane_resolutions=(8, 12),
                 plane_ranks=(4, 2))
    if kind == "tensorf":
        jfield = JaxTensoRF(aabb=AABB, compute_dtype=jdt, **small)
        field = TensoRFRadianceField(AABB, compute_dtype=tdt, **small)
    else:
        jfield = JaxField(aabb=AABB, compute_dtype=jdt, plane_mode=kind, **small)
        field = CPRadianceField(AABB, compute_dtype=tdt, plane_mode=kind, **small)
    if jdt == jnp.bfloat16:  # line levels through the TPU kernel
        object.__setattr__(jfield, "encoder",
                           dataclasses.replace(jfield.encoder, kernel="fused"))
    params = jax.tree.map(np.asarray, jfield.init(jax.random.PRNGKey(seed)))
    field.load_state_dict(field_params_from_numpy(params, device="cpu"))
    return jfield, params, field


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["product", "vm", "tensorf"])
def test_field_matches_jax(kind, dtype, monkeypatch):
    """rgb, density and every parameter's gradient; density zero outside
    the box."""
    jdt, tdt = DTYPES[dtype]
    kernel = jax_cp_level.cp_level_encode
    monkeypatch.setattr(jax_cp_level, "cp_level_encode",
                        lambda u, lines, interpret=False: kernel(u, lines, interpret=True))
    jfield, params, field = _field_pair(kind, jdt, tdt)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.7, 1.7, (1024, 3)).astype(np.float32)
    d = rng.standard_normal((1024, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    g_rgb = rng.standard_normal((len(x), 3)).astype(np.float32)
    g_sigma = rng.standard_normal((len(x), 1)).astype(np.float32)

    def loss(p):
        rgb, sigma = jfield(p, jnp.asarray(x), jnp.asarray(d))
        return jnp.sum(rgb * g_rgb) + jnp.sum(sigma * g_sigma), (rgb, sigma)

    (_, (ref_rgb, ref_sigma)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    ref_grads = field_params_from_numpy(jax.tree.map(np.asarray, grads), device="cpu")
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


@pytest.mark.parametrize("kind", ["product", "vm", "tensorf"])
def test_regularizer_chunk_dims_and_flops_match_jax(kind):
    """``param_regularizer`` (lines, planes along both axes, VM lines) and
    its gradient, ``max_eval_chunk``, ``output_dim``, the FLOP count, and the
    bridge's round trip, bitwise."""
    jfield, params, field = _field_pair(kind, jnp.float32, torch.float32)
    ref, grads = jax.jit(jax.value_and_grad(jfield.param_regularizer))(
        jax.tree.map(jnp.asarray, params))
    ref_grads = field_params_from_numpy(jax.tree.map(np.asarray, grads), device="cpu")
    tparams = {k: v.detach().clone().requires_grad_(True)
               for k, v in field.state_dict().items()}
    out = field.param_regularizer(tparams)
    assert float(out.detach()) == pytest.approx(float(ref), rel=1e-6)
    assert float(field.param_regularizer().detach()) == pytest.approx(float(ref), rel=1e-6)
    out.backward()
    for name, p in tparams.items():
        if name.startswith("encoder."):
            want = ref_grads[name].numpy()
            np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
    assert field.max_eval_chunk == jfield.max_eval_chunk
    assert field.encoder.output_dim == jfield.encoder.output_dim
    assert flops.cp_encoder_flops_per_sample(field.encoder) == \
        jax_flops.cp_encoder_flops_per_sample(jfield.encoder)
    back = field_params_to_numpy(field_params_from_numpy(params, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_tensorf_defaults_and_init_match_jax():
    """TensoRF's levels and mode are the JAX class's (the planes in product
    mode, inherited), at full width: ``output_dim`` 96, ``max_eval_chunk``
    2^16; the port's init draws every table ``1 + 0.1 N(0, 1)``, the VM
    lines too; a bad mode is refused."""
    jfield = JaxTensoRF(aabb=AABB)
    field = TensoRFRadianceField(AABB).to("meta")
    enc = field.encoder
    assert (enc.resolutions, enc.ranks) == (tuple(jfield.resolutions), tuple(jfield.ranks))
    assert (enc.plane_resolutions, enc.plane_ranks) == ((64, 128), (16, 16))
    assert enc.plane_mode == jfield.plane_mode == "product"
    assert enc.output_dim == jfield.encoder.output_dim == 96
    assert field.max_eval_chunk == jfield.max_eval_chunk == 2**16
    assert CPRadianceField(AABB).max_eval_chunk == 2**21
    vm = CPRadianceField(AABB, resolutions=(8,), ranks=(4,), plane_resolutions=(8,),
                         plane_ranks=(4,), plane_mode="vm").init(torch.Generator().manual_seed(0))
    for table in (*vm.encoder.lines, *vm.encoder.planes, *vm.encoder.plane_lines):
        table = table.detach()
        assert abs(float(table.mean()) - 1.0) < 0.03 and abs(float(table.std()) - 0.1) < 0.03
    assert vm.encoder.output_dim == 4 + 3 * 4
    with pytest.raises(ValueError):
        CPGridEncoder(plane_mode="sum")
