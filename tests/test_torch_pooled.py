"""Port vs JAX: the occupancy estimator's windowed and pooled entry points
(``traverse_grids_windowed``, ``traverse_grids_pooled``, ``pool_binaries``,
``sampling_padded``, ``sampling_pooled``, ``compact_samples_from_windows``,
``render_rays_occgrid_pooled``, ``make_cursor_eval_chunk``) and the small
public names beside them (``segment_starts`` / ``segment_ends``,
``smooth_l1_loss``, ``tp_allreduce``, ``make_state_specs``,
``setup_compilation_cache``), from numpy-seeded inputs.

Bounds.  Samples are the (ray, orbit candidate) pairs a call emits, in
order: equal.  Their bounds within one ulp of JAX's: the port takes kernel
G2's orbit values, ``near + fl(k * step)``, where XLA fuses the sum into
one rounding.  The termination planes, one fused multiply-add in G2 and
XLA alike, are bitwise JAX's.  JAX's
window phase tests a conservative pooled grid, so its windows may include
some with no sample, which the port leaves out: the two agree wherever
JAX's window budget is not exhausted, and the raw (window, lane) layouts
and overflow counts are compared only there.  The renderers' images are
held within 1e-5 of JAX's, and the expected depths within 1e-5 relative,
when every ray's samples fit one round (the field's exp and sigmoid round
apart in XLA and PyTorch), and within 2e-4
(twice ``early_stop_eps``: where a ray stops between rounds, its rest
carries at most that transmittance) when the rounds split differently.
With ``early_stop_eps=0`` and one round the port's pooled image is its
exact renderer's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu.grid as jgrid
from nerfacc_tpu.estimators.occ_grid import OccGridState as JaxOccState
from nerfacc_tpu.estimators.occ_grid import sampling_padded as jax_sampling_padded
from nerfacc_tpu.estimators.occ_grid import sampling_pooled as jax_sampling_pooled
from nerfacc_tpu.ops.sorted_segments import segment_ends as jax_segment_ends
from nerfacc_tpu.ops.sorted_segments import segment_starts as jax_segment_starts
from nerfacc_tpu.trainers import smooth_l1_loss as jax_smooth_l1_loss
from nerfacc_tpu.utils import rendering as jrender
from nerfacc_tpu_torch import grid as tgrid
from nerfacc_tpu_torch.cuda import _build
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator, OccGridState
from nerfacc_tpu_torch.estimators.occ_grid import sampling as port_sampling
from nerfacc_tpu_torch.estimators.occ_grid import sampling_padded, sampling_pooled
from nerfacc_tpu_torch.ops.sorted_segments import segment_ends, segment_starts
from nerfacc_tpu_torch.trainers import smooth_l1_loss
from nerfacc_tpu_torch.utils import rendering, setup_compilation_cache

STEP = 2e-2
F = 8


def _scene(n_rays=48, res=16, seed=0, occ=0.3):
    """Rays from a sphere of radius 2.5 towards a random grid over +-1, a
    third of them from inside the box, each with a near plane in [0,
    0.05)."""
    rng = np.random.default_rng(seed)
    bins = rng.random((1, res, res, res)) < occ
    aabbs = np.array([[-1.0, -1, -1, 1, 1, 1]], np.float32)
    o = rng.normal(size=(n_rays, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.5
    o[: n_rays // 3] *= 0.2
    d = -o + rng.normal(size=(n_rays, 3)) * 0.3
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    near = rng.uniform(0.0, 0.05, n_rays)
    return bins, aabbs, o.astype(np.float32), d.astype(np.float32), near.astype(np.float32)


def _jt(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _tt(*arrays):
    return [torch.tensor(a) for a in arrays]


def _flat(valid, t0, t1, ray_of_row):
    """(ray ids, starts, ends) of the valid candidates in row-major order."""
    valid = np.asarray(valid)
    rays = np.broadcast_to(np.asarray(ray_of_row)[:, None], valid.shape)
    return rays[valid], np.asarray(t0)[valid], np.asarray(t1)[valid]


def _assert_samples_equal(a, b, maxulp=0):
    """Ray ids equal; bounds bitwise, or within ``maxulp`` ulps."""
    np.testing.assert_array_equal(a[0], b[0])
    for got, want in zip(a[1:], b[1:]):
        if maxulp:
            np.testing.assert_array_max_ulp(got, want, maxulp=maxulp)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cone", [0.0, 0.004])
@pytest.mark.parametrize("windows", ["ample", "sweep"])
def test_windowed_matches_jax(cone, windows):
    """Samples, bounds, termination planes and flags equal JAX's, with
    ample windows and with a sweep of 6 windows that the segments outrun
    (those rays resume at its end, not terminated)."""
    W, Kc = (48, 160) if windows == "ample" else (6, 6)
    bins, aabbs, o, d, near = _scene()
    kw = dict(step_size=STEP, cone_angle=cone, n_windows=W, window_size=F, max_coarse=Kc)
    ref = jgrid.traverse_grids_windowed(*_jt(o, d, bins, aabbs, near), **kw)
    out = tgrid.traverse_grids_windowed(*_tt(o, d, bins, aabbs, near), **kw)
    rows = np.arange(len(o))
    _assert_samples_equal(_flat(out.valid, out.t_starts, out.t_ends, rows),
                          _flat(ref.valid, ref.t_starts, ref.t_ends, rows), maxulp=1)
    np.testing.assert_array_equal(out.terminated.numpy(), np.asarray(ref.terminated))
    np.testing.assert_array_equal(out.termination_planes.numpy(),
                                  np.asarray(ref.termination_planes))
    if windows == "ample":
        assert out.terminated.all()
        padded = tgrid.traverse_grids_padded(*_tt(o, d, bins, aabbs, near), step_size=STEP,
                                             cone_angle=cone)
        assert int(padded.valid.sum()) == int(out.valid.sum())
    else:
        assert not out.terminated.all()


@pytest.mark.parametrize("cone", [0.0, 0.004])
def test_pooled_matches_jax(cone):
    """An ample pool: samples and bounds in order, per-ray counts, the
    termination, no overflow; every window holds a sample, and each
    window's ray, near plane and first orbit index match its bounds."""
    bins, aabbs, o, d, near = _scene(seed=1)
    kw = dict(step_size=STEP, cone_angle=cone, window_budget=4096, window_size=F,
              max_coarse=160)
    ref = jgrid.traverse_grids_pooled(*_jt(o, d, bins, aabbs, near), **kw)
    out = tgrid.traverse_grids_pooled(*_tt(o, d, bins, aabbs, near), **kw)
    _assert_samples_equal(_flat(out.valid, out.t_starts, out.t_ends, out.ray_ids),
                          _flat(ref.valid, ref.t_starts, ref.t_ends, ref.ray_ids), maxulp=1)
    np.testing.assert_array_equal(out.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_array_equal(out.terminated.numpy(), np.asarray(ref.terminated))
    np.testing.assert_array_equal(out.termination_planes.numpy(),
                                  np.asarray(ref.termination_planes))
    assert int(out.window_overflow) == int(ref.window_overflow) == 0
    used = out.ray_ids < len(o)
    assert out.valid[used].any(dim=-1).all() and not out.valid[~used].any()
    t0, _ = tgrid._window_bounds(out.near[used], out.wk[used].long(), F, STEP, cone)
    np.testing.assert_array_equal(t0.numpy(), out.t_starts[used].numpy())
    np.testing.assert_array_equal(out.rays_o[used].numpy(), o[out.ray_ids[used].long()])


def test_pooled_budget_cuts_a_ray_suffix_that_resumes():
    """A pool of 40 windows keeps the first 40 windows of the ample pool;
    the rays it cuts are not terminated, and a second call from their
    termination planes emits exactly the samples that were dropped."""
    bins, aabbs, o, d, near = _scene(seed=2)
    args = _tt(o, d, bins, aabbs, near)
    kw = dict(step_size=STEP, window_size=F, max_coarse=160)
    whole = tgrid.traverse_grids_pooled(*args, window_budget=4096, **kw)
    cut = tgrid.traverse_grids_pooled(*args, window_budget=40, **kw)
    assert int(cut.window_overflow) == int((whole.ray_ids < len(o)).sum()) - 40 > 0
    for a, b in zip(_flat(cut.valid, cut.t_starts, cut.t_ends, cut.ray_ids),
                    _flat(whole.valid[:40], whole.t_starts[:40], whole.t_ends[:40],
                          whole.ray_ids[:40])):
        np.testing.assert_array_equal(a, b)
    lost = cut.counts < whole.counts
    assert lost.any() and not (lost & cut.terminated).any()
    rest = tgrid.traverse_grids_pooled(args[0], args[1], args[2], args[3],
                                       cut.termination_planes, rays_mask=~cut.terminated,
                                       window_budget=4096, **kw)
    np.testing.assert_array_equal((cut.counts + rest.counts).numpy(), whole.counts.numpy())


def test_entry_points_hold_samplings_samples_bitwise():
    """On the port's own terms: ``sampling_padded`` (the whole lattice and
    windowed) and ``sampling_pooled`` with its compaction emit the samples
    of ``sampling`` (the march, kernel G2 on the card), bit for bit."""
    bins, aabbs, o, d, near = _scene(seed=5)
    state = OccGridState(*_tt(aabbs, np.zeros(bins.size, np.float32), bins))
    o, d = _tt(o, d)
    jitter = torch.tensor(near) / STEP
    ref = port_sampling(state, o, d, render_step_size=STEP, near_jitter=jitter)
    want = (ref.ray_indices.numpy(), ref.t_starts.numpy(), ref.t_ends.numpy())
    rows = np.arange(o.shape[0])
    kw = dict(render_step_size=STEP, stratified=True, near_jitter=jitter)
    for windowed in (False, True):
        res = sampling_padded(state, o, d, max_samples=None, windowed=windowed, **kw)
        _assert_samples_equal(_flat(res.valid, res.t_starts, res.t_ends, rows), want)
    ws = sampling_pooled(state, o, d, window_budget=4096, **kw)
    _assert_samples_equal(_flat(ws.valid, ws.t_starts, ws.t_ends, ws.ray_ids), want)
    flat = rendering.compact_samples_from_windows(ws, 1 << 20, o.shape[0])
    _assert_samples_equal((flat.ray_indices.numpy(), flat.t_starts.numpy(),
                           flat.t_ends.numpy()), want)


def test_pool_binaries_matches_jax():
    rng = np.random.default_rng(3)
    bins = rng.random((2, 16, 16, 16)) < 0.05
    for pool, dilation in [(4, 1), (2, 0), (4, 2)]:
        ref = jgrid.pool_binaries(jnp.asarray(bins), pool, dilation)
        out = tgrid.pool_binaries(torch.tensor(bins), pool, dilation)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _density_np(x):
    return 8.0 * np.exp(-4.0 * np.sum(x * x, axis=-1))


def _jax_sigma_fn(o, d):
    def sigma_fn(t0, t1, rid):
        x = o[rid] + (0.5 * (t0 + t1))[..., None] * d[rid]
        return 8.0 * jnp.exp(-4.0 * jnp.sum(x * x, axis=-1))
    return sigma_fn


def _port_sigma_fn(o, d):
    def sigma_fn(t0, t1, rid):
        x = o[rid] + (0.5 * (t0 + t1))[..., None] * d[rid]
        return 8.0 * torch.exp(-4.0 * (x * x).sum(dim=-1))
    return sigma_fn


@pytest.mark.parametrize("windowed", [False, True])
def test_sampling_padded_matches_jax(windowed):
    """Stratified planes from JAX's draw, the visibility filter of a soft
    ball (early stop 1e-2, the alpha threshold at the grid's mean
    occupancy): the kept samples equal JAX's; the estimator's method gives
    the same."""
    bins, aabbs, o, d, near = _scene(seed=4, occ=0.6)
    occs = np.random.default_rng(5).uniform(0.0, 0.02, bins.size).astype(np.float32)
    jstate = JaxOccState(*_jt(aabbs, occs, bins))
    state = OccGridState(*_tt(aabbs, occs, bins))
    key = jax.random.PRNGKey(7)
    jitter = np.asarray(jax.random.uniform(key, (len(o),)))
    kw = dict(render_step_size=STEP, stratified=True, early_stop_eps=1e-2, alpha_thre=1e-2,
              windowed=windowed, n_windows=48, window_size=F, max_coarse=160, max_samples=512)
    ref = jax_sampling_padded(jstate, *_jt(o, d), sigma_fn=_jax_sigma_fn(*_jt(o, d)), key=key,
                              **kw)
    out = sampling_padded(state, *_tt(o, d), sigma_fn=_port_sigma_fn(*_tt(o, d)),
                          near_jitter=torch.tensor(jitter), **kw)
    rows = np.arange(len(o))
    got = _flat(out.valid, out.t_starts, out.t_ends, rows)
    _assert_samples_equal(got, _flat(ref.valid, ref.t_starts, ref.t_ends, rows), maxulp=1)
    assert 0 < len(got[0]) < int(np.asarray(
        jax_sampling_padded(jstate, *_jt(o, d), key=key, **kw).valid).sum())
    est = OccGridEstimator(aabbs[0], 16, max_samples=512, device="cpu")
    est._set_state(state)
    kw.pop("max_samples")
    same = est.sampling_padded(*_tt(o, d), sigma_fn=_port_sigma_fn(*_tt(o, d)),
                               near_jitter=torch.tensor(jitter), **kw)
    assert torch.equal(same.valid, out.valid) and torch.equal(same.t_starts, out.t_starts)


def test_sampling_pooled_and_compaction_match_jax():
    """``sampling_pooled`` from JAX's stratified draw, then
    ``compact_samples_from_windows`` under a budget that cuts: ray ids,
    segment bounds, counts and the first incomplete ray equal JAX's, each
    sample's ray and its per-ray extra too, the bounds within an ulp."""
    bins, aabbs, o, d, near = _scene(seed=6)
    occs = np.zeros(bins.size, np.float32)
    jstate = JaxOccState(*_jt(aabbs, occs, bins))
    state = OccGridState(*_tt(aabbs, occs, bins))
    key = jax.random.PRNGKey(8)
    jitter = torch.tensor(np.asarray(jax.random.uniform(key, (len(o),))))
    kw = dict(render_step_size=STEP, stratified=True, window_budget=2048, window_size=F)
    jws = jax_sampling_pooled(jstate, *_jt(o, d), key=key, **kw)
    ws = sampling_pooled(state, *_tt(o, d), near_jitter=jitter, **kw)
    _assert_samples_equal(_flat(ws.valid, ws.t_starts, ws.t_ends, ws.ray_ids),
                          _flat(jws.valid, jws.t_starts, jws.t_ends, jws.ray_ids), maxulp=1)
    total = int(ws.counts.sum())
    budget = total * 2 // 3
    table = np.arange(len(o), dtype=np.float32) * 0.5 + 1.0
    ref = jrender.compact_samples_from_windows(
        jws, budget, len(o), extras=jnp.asarray(table)[jnp.minimum(jws.ray_ids, len(o) - 1)],
        step_size=STEP)
    out = rendering.compact_samples_from_windows(
        ws, budget, len(o), extras=torch.tensor(table)[ws.ray_ids.clamp(max=len(o) - 1).long()])
    n = int(ref.num_valid)
    assert out.num_valid == n == budget and out.overflow == int(ref.overflow) == total - budget
    assert out.first_incomplete_ray == int(ref.first_incomplete_ray) < len(o)
    for got, want in [(out.ray_indices, ref.ray_indices), (out.rays_o, ref.rays_o),
                      (out.rays_d, ref.rays_d), (out.extras, ref.extras)]:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n])
    for got, want in [(out.t_starts, ref.t_starts), (out.t_ends, ref.t_ends)]:
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want)[:n], maxulp=1)
    np.testing.assert_array_equal(out.seg_starts.numpy(), np.asarray(ref.seg_starts))
    np.testing.assert_array_equal(out.seg_ends.numpy(), np.asarray(ref.seg_ends))


def _jax_field(x, dirs):
    rgb = jax.nn.sigmoid(x * jnp.asarray([1.0, 2.0, 3.0]) + dirs)
    return rgb, 30.0 * jnp.exp(-3.0 * jnp.sum(x * x, axis=-1))


def _port_field(x, dirs):
    rgb = torch.sigmoid(x * torch.tensor([1.0, 2.0, 3.0]) + dirs)
    return rgb, 30.0 * torch.exp(-3.0 * (x * x).sum(dim=-1))


@pytest.mark.parametrize("budget", [1 << 13, 256])
def test_render_rays_occgrid_pooled_matches_jax(budget):
    """A dense ball behind a random grid: colours, opacities and depths
    against JAX's pooled renderer, one round (2^13 samples and 2048
    windows) or many (256 samples a round)."""
    bins, aabbs, o, d, near = _scene(seed=9, occ=0.7)
    jstate = JaxOccState(*_jt(aabbs, np.zeros(bins.size, np.float32), bins))
    state = OccGridState(*_tt(aabbs, np.zeros(bins.size, np.float32), bins))
    bkgd = np.array([0.2, 0.5, 0.8], np.float32)
    kw = dict(render_step_size=STEP, budget=budget, window_budget=min(budget, 2048),
              near_plane=0.01)
    ref = jrender.render_rays_occgrid_pooled(_jax_field, jstate, *_jt(o, d),
                                             render_bkgd=jnp.asarray(bkgd), **kw)
    out = rendering.render_rays_occgrid_pooled(_port_field, state, *_tt(o, d),
                                               render_bkgd=torch.tensor(bkgd), **kw)
    atol = 1e-5 if budget > 4096 else 2e-4
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=atol)
    assert float(out[1].max()) > 1.0 - 1e-3


def test_pooled_renderer_without_early_stop_is_the_exact_renderer():
    """``early_stop_eps=0`` and one round: the port's pooled image equals
    its exact renderer's bit for bit."""
    bins, aabbs, o, d, near = _scene(seed=10, occ=0.7)
    state = OccGridState(*_tt(aabbs, np.zeros(bins.size, np.float32), bins))
    bkgd = torch.tensor([0.2, 0.5, 0.8])
    o, d = _tt(o, d)
    got = rendering.render_rays_occgrid_pooled(_port_field, state, o, d, render_bkgd=bkgd,
                                               render_step_size=STEP, early_stop_eps=0.0)
    samples = rendering.compact_samples(port_sampling(state, o, d, render_step_size=STEP))
    want = rendering.render_rays_with_occgrid(lambda p, dirs, _ids: _port_field(p, dirs), o, d,
                                              samples, bkgd)
    for a, b in zip(got, want[:3]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sample_budget", [1 << 13, 96])
def test_cursor_eval_chunk_matches_jax(sample_budget):
    """The cursor renderer's unnormalised sums against JAX's, in one round
    (2^13 samples and 2048 windows) and in rounds of 96 samples."""
    bins, aabbs, o, d, near = _scene(seed=11, occ=0.7)
    jstate = JaxOccState(*_jt(aabbs, np.zeros(bins.size, np.float32), bins))
    state = OccGridState(*_tt(aabbs, np.zeros(bins.size, np.float32), bins))
    kw = dict(render_step_size=STEP, sample_budget=sample_budget, max_windows=4096,
              window_budget=min(sample_budget, 2048))
    ref = jrender.make_cursor_eval_chunk(_jax_field, jstate, **kw)(*_jt(o, d))
    out = rendering.make_cursor_eval_chunk(_port_field, state, **kw)(*_tt(o, d))
    atol = 1e-5 if sample_budget > 4096 else 2e-4
    for got, want in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


def test_segment_starts_and_ends_match_jax():
    """Sorted ids with empty segments and ``n_rays`` fill slots."""
    rng = np.random.default_rng(12)
    n_rays = 40
    ids = np.sort(rng.choice(np.arange(0, n_rays, 3), 200)).astype(np.int32)
    ids = np.concatenate([ids, np.full(17, n_rays, np.int32)])
    for fn, jfn in [(segment_starts, jax_segment_starts), (segment_ends, jax_segment_ends)]:
        got = fn(torch.tensor(ids), n_rays)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfn(jnp.asarray(ids), n_rays)))


def test_smooth_l1_loss_matches_jax_and_torch():
    rng = np.random.default_rng(13)
    pred, target = (rng.normal(scale=1.5, size=(257, 3)).astype(np.float32) for _ in range(2))
    got = smooth_l1_loss(*_tt(pred, target))
    assert float(got) == pytest.approx(float(jax_smooth_l1_loss(*_jt(pred, target))), rel=1e-6)
    assert torch.equal(got, torch.nn.functional.smooth_l1_loss(*_tt(pred, target)))


def test_tp_allreduce_sums_with_an_identity_backward(tmp_path):
    """A group of one: the sum is the tensor, and the cotangent passes
    through unchanged."""
    import torch.distributed as dist

    from nerfacc_tpu_torch.models.cp_field import tp_allreduce

    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        x = torch.randn(5, 4, requires_grad=True)
        y = tp_allreduce(x * 2.0, dist.group.WORLD)
        g = torch.randn(5, 4)
        y.backward(g)
        assert torch.equal(y.detach(), (x * 2.0).detach())
        assert torch.equal(x.grad, 2.0 * g)
    finally:
        dist.destroy_process_group()


def test_make_state_specs_matches_jax():
    """The sharded entries of a CP trainer's state after one step: the
    line tables along their rank and W1 along its rows, with their Adam
    moments, as JAX's specs cut its params and optax's mu / nu; the rest
    replicated."""
    from jax.sharding import PartitionSpec as P

    from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
    from nerfacc_tpu.parallel.tp import make_state_specs as jax_specs
    from nerfacc_tpu.trainers import NGPOccTrainer as JaxTrainer
    from nerfacc_tpu_torch.models.cp_field import CPRadianceField
    from nerfacc_tpu_torch.parallel.tp import make_state_specs
    from nerfacc_tpu_torch.trainers import NGPOccTrainer

    small = dict(resolutions=(8, 16), ranks=(4, 4))
    aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    jstate = JaxTrainer(field=JaxField(aabb=aabb, **small), aabb=aabb, grid_resolution=8,
                        max_steps=10).init_state()
    leaves = jax.tree.leaves(jax_specs(jstate, "data", "model"),
                             is_leaf=lambda x: isinstance(x, P))
    want = sorted(str(tuple(s)) for s in leaves if tuple(s))
    trainer = NGPOccTrainer(field=CPRadianceField(aabb, **small), aabb=aabb,
                            grid_resolution=8, max_steps=10, device="cpu")
    state = trainer.init_state()
    for p in state.params.values():
        p.grad = torch.zeros_like(p)
    state.opt_state.optimizer.step()  # Adam holds its moments from the first update
    specs = make_state_specs(state)
    got = sorted(str(s) for s in specs.values() if s)
    assert got == want and len(got) == 3 * (len(small["ranks"]) + 1)
    assert specs["params/mlp_base.0"] == ("model", None)
    assert specs["adam/encoder.lines.1/exp_avg_sq"] == (None, None, "model")
    assert specs["adam/encoder.lines.1/step"] == () and specs["occ/binaries"] == ()


def test_setup_compilation_cache_moves_the_build_dir(tmp_path):
    """It sets the kernels' build directory, and builds nothing."""
    try:
        setup_compilation_cache(tmp_path / "kernels")
        assert _build.library_path().parent == tmp_path / "kernels"
        assert not (tmp_path / "kernels").exists()
    finally:
        setup_compilation_cache()
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
