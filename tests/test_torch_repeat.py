"""The port's train steps repeat bit for bit, as the JAX package's do.

Kernels G4 (CP line-table gradient) and G7 (hash-table gradient) and their
plain versions sum in fixed point (nerfacc_tpu_torch/ops/ordered_sums.py),
so their results do not depend on the order of the samples; the train
paths' PyTorch scatters (the voxel field's backward, the interlevel loss's
CDF reads, ``segment_sum_sorted``) add each entry's terms in their order.
Each is held here to the JAX package, and one train step per trainer, run
twice from one seed with several PyTorch threads, to itself bit for bit.
The card's side (two calls of G4 and G7, and every train path trained twice)
is tests/test_torch_kernels.py and chip_smoke.py's phase 31.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.data_specs import RayIntervals as JaxIntervals
from nerfacc_tpu.estimators.prop_net import _pdf_loss as jax_pdf_loss
from nerfacc_tpu.models.cp_field import CPGridEncoder as JaxCPEncoder
from nerfacc_tpu.models.encoders import HashGridEncoder as JaxHashEncoder
from nerfacc_tpu.models.voxel_field import _trilinear_gather as jax_trilinear_gather
from nerfacc_tpu.ops.cp_level import cp_level_encode as jax_cp_level_encode
from nerfacc_tpu.ops.sorted_segments import segment_sum_sorted as jax_segment_sum_sorted
from nerfacc_tpu_torch.data.device_sampler import DeviceRaySampler
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
from nerfacc_tpu_torch.data_specs import RayIntervals
from nerfacc_tpu_torch.estimators.prop_net import _pdf_loss
from nerfacc_tpu_torch.models.cp_field import CPDensityField, CPRadianceField
from nerfacc_tpu_torch.models.encoders import HashGridEncoder
from nerfacc_tpu_torch.models.ngp import NGPRadianceField
from nerfacc_tpu_torch.models.voxel_field import VoxelRadianceField, trilinear_gather
from nerfacc_tpu_torch.ops import ordered_sums
from nerfacc_tpu_torch.ops.cp_level import cp_level_backward_plain
from nerfacc_tpu_torch.ops.hash_encode import hash_encode_backward_plain
from nerfacc_tpu_torch.ops.sorted_segments import segment_sum_sorted
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer
from nerfacc_tpu_torch.trainers.ngp_prop import NGPPropTrainer
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def _ray_ordered_u(seed, n_rays=16, per_ray=96):
    """Coordinates in a train step's ray order, normalised to the AABB and
    clamped to [0, 1]: runs of consecutive samples on one row, some on the
    box's faces."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n_rays)
    o = np.stack([4 * np.cos(theta), 4 * np.sin(theta), rng.uniform(-1, 1, n_rays)], -1)
    d = rng.uniform(-0.8, 0.8, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(2.0, 6.0, per_ray)
    pts = (o[:, None] + t[None, :, None] * d[:, None]).reshape(-1, 3)
    return np.clip((pts + 1.5) / 3.0, 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("layout", ["uniform", "ray"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_level_backward_is_invariant_to_the_order_of_samples(layout, dtype):
    """G4's plain version gives the same bits for any order of the samples
    (its terms are summed in int64), and stays within 1e-4 of the largest
    entry of K2 (the JAX package's Pallas kernel, interpreted on the CPU) in
    bf16 and of the XLA level's gradient in f32."""
    R, rank = 64, 16
    rng = np.random.default_rng(7)
    u = (rng.uniform(0, 1, (1500, 3)).astype(np.float32) if layout == "uniform"
         else _ray_ordered_u(7))
    lines = (1.0 + 0.1 * rng.standard_normal((3, R, rank))).astype(np.float32)
    g = rng.standard_normal((u.shape[0], rank)).astype(np.float32)
    tu, tg, tl = torch.tensor(u), torch.tensor(g), torch.tensor(lines)
    out = cp_level_backward_plain(tu, tg, tl, dtype)
    perm = torch.randperm(u.shape[0], generator=torch.Generator().manual_seed(3))
    assert torch.equal(_bits(out), _bits(cp_level_backward_plain(tu[perm], tg[perm], tl, dtype)))
    if dtype == torch.bfloat16:  # K2, interpreted
        def level(lt):
            return jax_cp_level_encode(jnp.asarray(u), lt, True)
    else:
        enc = JaxCPEncoder(resolutions=(R,), ranks=(rank,), compute_dtype=jnp.float32)

        def level(lt):
            return enc._level_encode(jnp.asarray(u), lt, R=R, kernel="xla")
    ref = np.asarray(jax.grad(lambda lt: jnp.sum(level(lt) * g))(jnp.asarray(lines)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("levels,log2_t", [(16, 10), (5, 8)])
def test_hash_table_gradient_is_invariant_to_the_order_of_samples(levels, log2_t):
    """G7's plain version gives the same bits for any order of the samples,
    points outside [0, 1]^3 and a table whose rows collide included, and
    stays within 1e-5 of the largest entry of jax.grad of the JAX
    encoder."""
    kw = dict(n_levels=levels, log2_hashmap_size=log2_t, base_resolution=16,
              max_resolution=256)
    jax_enc, enc = JaxHashEncoder(n_features_per_level=2, **kw), HashGridEncoder(**kw)
    rng = np.random.default_rng(levels)
    x = rng.uniform(-0.1, 1.1, (2000, 3)).astype(np.float32)
    table = rng.uniform(-1.0, 1.0, (levels, 1 << log2_t, 2)).astype(np.float32)
    cot = rng.standard_normal((2000, 2 * levels)).astype(np.float32)
    tx, tc = torch.tensor(x), torch.tensor(cot)
    out = hash_encode_backward_plain(tx, tc, table.shape, enc.resolutions)
    perm = torch.randperm(2000, generator=torch.Generator().manual_seed(4))
    again = hash_encode_backward_plain(tx[perm], tc[perm], table.shape, enc.resolutions)
    assert torch.equal(_bits(out), _bits(again))
    ref = np.asarray(jax.grad(lambda t: jnp.sum(jax_enc(t, jnp.asarray(x)) * cot))(
        jnp.asarray(table)))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_fixed_point_sums_keep_infinities_and_nans():
    """A non-finite term makes its entry what an f64 sum makes it (NaN
    where both infinities meet); the other entries are the fixed-point sums,
    within an f32 rounding of the exact sum."""
    terms = torch.tensor([[1.5, -np.inf], [np.inf, 2.0], [np.nan, 0.25], [np.inf, 1e-3]],
                         dtype=torch.float32)
    rows = torch.tensor([0, 1, 2, 1])
    k = ordered_sums.scale_exponent(
        ordered_sums.exponent_bound(ordered_sums.finite_abs_max(terms)), 4)
    q, special = ordered_sums.quantize(ordered_sums.scale(terms, k))
    acc = torch.zeros((3, 2), dtype=torch.int64).index_add_(0, rows, q)
    sp = torch.zeros((3, 2), dtype=torch.float64).index_add_(0, rows, special)
    out = ordered_sums.from_fixed(acc, sp, k)
    want = torch.tensor([[1.5, -np.inf], [np.inf, 2.001], [np.nan, 0.25]], dtype=torch.float32)
    assert torch.equal(out.isnan(), want.isnan())
    finite = ~want.isnan()
    assert torch.equal(out[finite], want[finite])


@pytest.mark.parametrize("shape", [(5, 6, 7, 3), (3, 3, 3, 2)])
def test_voxel_grid_gradient_matches_jax(shape):
    """The voxel field's trilinear gather: its grid gradient (each voxel's
    terms summed in sample order) within 1e-6 relative Frobenius of the JAX
    package's custom VJP, with many samples on few voxels."""
    rng = np.random.default_rng(2)
    grid = rng.standard_normal(shape).astype(np.float32)
    u = rng.uniform(-0.1, 1.1, (4000, 3)).astype(np.float32)
    g = rng.standard_normal((4000, shape[-1])).astype(np.float32)
    want = np.asarray(jax.grad(lambda gr: jnp.sum(jax_trilinear_gather(gr, jnp.asarray(u)) * g))(
        jnp.asarray(grid)))
    tg = torch.tensor(grid, requires_grad=True)
    (trilinear_gather(tg, torch.tensor(u)) * torch.tensor(g)).sum().backward()
    assert np.linalg.norm(tg.grad.numpy() - want) <= 1e-6 * np.linalg.norm(want)


def test_interlevel_loss_gradient_matches_jax():
    """The interlevel loss reads the key CDF through ``take_along_last`` (a
    sorted sum on the card): its value and the key CDF's gradient against
    JAX's one-hot selections, many query intervals on one key entry."""
    rng = np.random.default_rng(5)
    q = np.sort(rng.uniform(0.0, 6.0, (8, 65)), -1).astype(np.float32)
    k = np.sort(rng.uniform(-1.0, 7.0, (8, 9)), -1).astype(np.float32)
    cq = np.sort(rng.uniform(size=(8, 65)), -1).astype(np.float32)
    ck = np.sort(rng.uniform(size=(8, 9)), -1).astype(np.float32)

    def jloss(ckey):
        return jax_pdf_loss(JaxIntervals(vals=jnp.asarray(q)), jnp.asarray(cq),
                            JaxIntervals(vals=jnp.asarray(k)), ckey)

    want = jloss(jnp.asarray(ck))
    want_grad = jax.grad(lambda c: jnp.sum(jloss(c)))(jnp.asarray(ck))
    tck = torch.tensor(ck, requires_grad=True)
    got = _pdf_loss(RayIntervals(torch.tensor(q)), torch.tensor(cq),
                    RayIntervals(torch.tensor(k)), tck)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tck.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-6)
    idx = torch.tensor(rng.integers(0, 9, (8, 5)))
    key = tck.detach()
    assert torch.equal(ordered_sums.take_along_last(key, idx), key.gather(-1, idx))


def test_segment_sum_sorted_matches_jax():
    """Per-ray sums of a flattened buffer, many samples a ray, some rays
    empty and fill slots at the end: within the rounding of JAX's cumsum
    differences (f32 prefix sums of the whole buffer)."""
    rng = np.random.default_rng(9)
    counts = rng.integers(0, 40, 30)
    counts[[3, 17]] = 0
    ids = np.concatenate([np.repeat(np.arange(30), counts), np.full(11, 30)]).astype(np.int32)
    src = rng.standard_normal((ids.shape[0], 3)).astype(np.float32)
    got = segment_sum_sorted(torch.tensor(src), torch.tensor(ids), 30).numpy()
    want = np.asarray(jax_segment_sum_sorted(jnp.asarray(src), jnp.asarray(ids), 30))
    prefix = np.abs(np.cumsum(src, 0)).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * 2.0**-24 * prefix)
    exact = np.zeros((30, 3))
    np.add.at(exact, ids[ids < 30], src[ids < 30].astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-5)


def _occ_trainer(kind):
    fields = {
        "cp": lambda: CPRadianceField(AABB, resolutions=(16, 32), ranks=(8, 8)),
        "ngp": lambda: NGPRadianceField(AABB, n_levels=4, log2_hashmap_size=10,
                                        max_resolution=64),
        "voxel": lambda: VoxelRadianceField(AABB, resolutions=(8, 16), channels=(2, 2)),
    }
    return NGPOccTrainer(field=fields[kind](), aabb=AABB, grid_resolution=32,
                         sample_budget=2**13, device="cpu")


def _leaves(state):
    """The parameters, the Adam moments and the grid of a train state."""
    out = []

    def walk(obj):
        if torch.is_tensor(obj):
            out.append(obj.detach().clone())
        elif isinstance(obj, torch.optim.Optimizer):
            for group in obj.param_groups:
                for p in group["params"]:
                    out.extend(v.clone() for _, v in sorted(obj.state[p].items()))
        elif hasattr(obj, "_fields"):
            for v in obj:
                walk(v)
        elif isinstance(obj, dict):
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            for v in obj:
                walk(v)
    walk(state)
    return out


@pytest.mark.parametrize("kind", ["cp", "prop", "ngp", "voxel"])
def test_train_step_repeats_bit_for_bit(kind):
    """Two train steps from one seed, run twice with four PyTorch threads
    (where an ``index_put_`` accumulation on the CPU would add in parallel):
    every parameter, Adam moment, the grid and the losses equal bit for
    bit."""
    ds = ProceduralSceneLoader("train", n_train=2, width=16, height=16, num_rays=64,
                               device="cpu")
    batches = [ds[0], ds[0]]
    torch.set_num_threads(4)
    runs = []
    for _ in range(2):
        if kind == "prop":
            trainer = NGPPropTrainer(
                field=CPRadianceField(AABB, resolutions=(16, 32), ranks=(8, 8)),
                prop_fields=[CPDensityField(AABB, resolutions=(8, 16), ranks=(4, 4))],
                prop_samples=[16], num_samples=8, device="cpu")
            state, aux = trainer.train_steps_sampled(
                trainer.init_state(), DeviceRaySampler.from_loader(ds), [True, True])
            losses = torch.cat([aux["loss"], aux["prop_loss"]])
        else:
            trainer = _occ_trainer(kind)
            state, losses = trainer.init_state(), []
            for batch in batches:
                state, aux = trainer.train_step(state, batch)
                losses.append(aux["loss"])
            losses = torch.stack(losses)
        runs.append((_leaves(state), losses.detach().clone()))
    (leaves, losses), (leaves2, losses2) = runs
    assert len(leaves) == len(leaves2) > 0
    assert torch.equal(_bits(losses), _bits(losses2))
    for i, (a, b) in enumerate(zip(leaves, leaves2)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), i
