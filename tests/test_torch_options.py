"""Port vs JAX: the public options the port takes since the JAX package's
signatures were matched (tests/test_torch_signatures.py): the fields' widths
and view directions and TiNeuVox's plane levels (forward and gradients,
through the bridge), the static fields' ``query_opacity``, the occupancy
renderers' candidate window, sample budget and carried transmittance,
``ray_aabb_intersect``'s clip, the eval renderer's settings, the trainer's
options, and the small functions, each from numpy-seeded inputs at small
widths with the bound stated where it is held.  The padded train step is
held to JAX's in tests/test_torch_train.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu.ops
from nerfacc_tpu import grid as jgrid
from nerfacc_tpu.data import procedural as jproc
from nerfacc_tpu.estimators.occ_grid import init_occ_grid as jax_init_occ_grid
from nerfacc_tpu.estimators.occ_grid import update_occ_grid as jax_update_occ_grid
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxCP
from nerfacc_tpu.models.encoders import HashGridEncoder as JaxHash
from nerfacc_tpu.models.kplanes import KPlanesRadianceField as JaxKPlanes
from nerfacc_tpu.models.ngp import NGPRadianceField as JaxNGP
from nerfacc_tpu.models.ngp import contract_to_unisphere as jax_contract
from nerfacc_tpu.models.tineuvox import TiNeuVoxRadianceField as JaxTiNeuVox
from nerfacc_tpu.models.voxel_field import VoxelRadianceField as JaxVoxel
from nerfacc_tpu.ops.hat_matmul import hat_interp_matmul as jax_hat
from nerfacc_tpu.ops.sorted_segments import exclusive_sum_sorted as jax_excl
from nerfacc_tpu.ops.sorted_segments import segment_sum_sorted as jax_segsum
from nerfacc_tpu.trainers.ngp_occ import NGPOccTrainer as JaxTrainer
from nerfacc_tpu.trainers.ngp_occ import TrainState as JaxTrainState
from nerfacc_tpu.utils import flops as jflops
from nerfacc_tpu.utils.metrics import psnr as jax_psnr
from nerfacc_tpu.utils.rendering import CompactSamples as JaxCompactSamples
from nerfacc_tpu.utils.rendering import render_image_with_occgrid as jax_render_image
from nerfacc_tpu.utils.rendering import render_rays_with_occgrid as jax_render_rays
from nerfacc_tpu_torch import grid as tgrid
from nerfacc_tpu_torch.data import procedural as tproc
from nerfacc_tpu_torch.estimators.occ_grid import sampling, sampling_padded
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.models.encoders import HashGridEncoder
from nerfacc_tpu_torch.models.kplanes import KPlanesRadianceField
from nerfacc_tpu_torch.models.ngp import NGPRadianceField, contract_to_unisphere
from nerfacc_tpu_torch.models.tineuvox import TiNeuVoxRadianceField
from nerfacc_tpu_torch.models.voxel_field import VoxelRadianceField
from nerfacc_tpu_torch.ops.hash_encode import hash_encode_plain
from nerfacc_tpu_torch.ops.sorted_segments import exclusive_sum_sorted, segment_sum_sorted
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer, TrainState
from nerfacc_tpu_torch.utils import flops
from nerfacc_tpu_torch.utils.jax_bridge import (
    cp_field_params_from_numpy,
    field_params_from_numpy,
    field_params_to_numpy,
    occ_state_from_numpy,
)
from nerfacc_tpu_torch.utils.metrics import psnr
from nerfacc_tpu_torch.utils.rendering import compact_samples, render_image_with_occgrid, \
    render_rays_with_occgrid
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
WIDTHS = dict(hidden_dim=32, geo_feat_dim=7)  # JAX's defaults are 64 and 15
N = 512
STEP = 5e-3
SIZE = 16  # the rendered views' side


# -- the fields at other widths, with and without view directions ----------
# kind -> (JAX field, port field, time-dependent), each at a small size
def _fields(kind, viewdirs):
    kw = dict(WIDTHS, use_viewdirs=viewdirs)
    if kind == "cp":
        small = dict(resolutions=(16, 32), ranks=(8, 8))
        return (JaxCP(aabb=AABB, compute_dtype=jnp.float32, **small, **kw),
                CPRadianceField(AABB, compute_dtype=torch.float32, **small, **kw), False)
    if kind == "ngp":
        small = dict(n_levels=4, log2_hashmap_size=12, max_resolution=64)
        return (JaxNGP(aabb=AABB, compute_dtype=jnp.float32, table_grad="scatter", **small,
                       **kw),
                NGPRadianceField(AABB, compute_dtype=torch.float32, **small, **kw), False)
    if kind == "voxel":
        small = dict(resolutions=(6, 9), channels=(3, 2))
        return (JaxVoxel(aabb=AABB, compute_dtype=jnp.float32, **small, **kw),
                VoxelRadianceField(AABB, compute_dtype=torch.float32, **small, **kw), False)
    if kind == "kplanes":
        small = dict(resolutions=(8, 16), ranks=(4, 4))
        return (JaxKPlanes(aabb=AABB, compute_dtype=jnp.float32, **small, **kw),
                KPlanesRadianceField(AABB, compute_dtype=torch.float32, device="cpu",
                                     **small, **kw), True)
    # TiNeuVox with a tri-plane level after its line levels; the JAX field
    # on its hat-matmul route (K3 interpreted, see interpret_k3)
    small = dict(resolutions=(16, 32), ranks=(8, 8), plane_resolutions=(8,),
                 plane_ranks=(4,))
    jfield = JaxTiNeuVox(aabb=AABB, compute_dtype=jnp.float32, **small, **kw)
    object.__setattr__(jfield, "encoder", dataclasses.replace(jfield.encoder, use_pallas=True))
    return (jfield, TiNeuVoxRadianceField(AABB, compute_dtype=torch.float32, device="cpu",
                                          **small, **kw), True)


@pytest.fixture
def interpret_k3(monkeypatch):
    """The JAX encoder's hat route reaches K3 through ``nerfacc_tpu.ops``,
    which runs only interpreted on a CPU."""
    monkeypatch.setattr(
        nerfacc_tpu.ops, "hat_interp_matmul", lambda x, line: jax_hat(x, line, True)
    )


def _jax_params(kind, jfield, seed):
    params = jfield.init(jax.random.PRNGKey(seed))
    if kind == "ngp":  # an O(1) table, so the features move the MLPs
        params["encoder"] = params["encoder"] * 1e4
    if kind == "tineuvox":  # a warp of ~0.1 from the rigid 1e-4 init
        params["deform"][-1] = params["deform"][-1] * 3e3
    return jax.tree.map(np.asarray, params)


def _samples(seed, n=N):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.7, 1.7, (n, 3)).astype(np.float32)  # some outside the box
    t = rng.uniform(0.0, 1.0, (n, 1)).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, t, d


@pytest.mark.parametrize("viewdirs", [True, False], ids=["viewdirs", "no-viewdirs"])
@pytest.mark.parametrize("kind", ["cp", "ngp", "voxel", "kplanes", "tineuvox"])
def test_field_widths_and_viewdirs_match_jax(interpret_k3, kind, viewdirs):
    """rgb and density at hidden 32 and 7 geometry features, with and
    without view directions, and every parameter's gradient of a weighted
    sum of both, from JAX's parameters through the bridge (which carries
    them back bitwise), JAX's side jitted.  f32 fields: outputs within 1e-5
    (readings up to 3.5e-7 of the largest), gradients within 1e-4 of each
    leaf's largest entry (readings up to 1.1e-6 of it); TiNeuVox's line
    levels round their hat weights to bf16, and a last-bit difference of the
    warped points flips some of them (tests/test_torch_tineuvox.py):
    outputs within 2e-3 of the largest, gradients within 1e-3 of each
    leaf's largest (readings 1.5e-4 and 8.9e-5 of it)."""
    jfield, field, dynamic = _fields(kind, viewdirs)
    tree = _jax_params(kind, jfield, 3)
    field.load_state_dict(field_params_from_numpy(tree, device="cpu"))
    back = field_params_to_numpy(field_params_from_numpy(tree, device="cpu"))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert field.head_dims[0] == (16 if viewdirs else 0) + 7
    x, t, d = _samples(4)
    rng = np.random.default_rng(5)
    c_rgb = rng.standard_normal((N, 3)).astype(np.float32)
    c_den = rng.standard_normal((N, 1)).astype(np.float32)
    args = (x, t, d) if dynamic else (x, d)

    def loss(p):
        rgb, density = jfield(p, *map(jnp.asarray, args))
        return jnp.sum(rgb * c_rgb) + jnp.sum(density * c_den), (rgb, density)

    (_, ref), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.tree.map(jnp.asarray, tree))
    ref_grads = field_params_from_numpy(jax.tree.map(np.asarray, jgrads), device="cpu")
    targs = [torch.tensor(a) for a in args]
    if not viewdirs:
        targs[-1] = None  # the directions are not read
    rgb, density = field(*targs)
    ((rgb * torch.tensor(c_rgb)).sum() + (density * torch.tensor(c_den)).sum()).backward()
    out_tol, grad_tol = (2e-3, 1e-3) if kind == "tineuvox" else (1e-5, 1e-4)
    for got, want in ((rgb, ref[0]), (density, ref[1])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=out_tol,
                                   atol=out_tol * max(np.abs(want).max(), 1.0))
    for name, p in field.named_parameters():
        want = ref_grads[name].numpy()
        assert np.abs(want).max() > 0, name
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=0,
                                   atol=grad_tol * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("kind", ["cp", "ngp", "voxel"])
def test_static_query_opacity_matches_jax(kind):
    """``query_opacity(x, step)`` = density x step, the JAX field's, within
    1e-5 relative."""
    jfield, field, _ = _fields(kind, True)
    tree = _jax_params(kind, jfield, 6)
    field.load_state_dict(field_params_from_numpy(tree, device="cpu"))
    x, _, _ = _samples(7)
    ref = np.asarray(jfield.query_opacity(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), 1e-2))
    with torch.no_grad():
        out = field.query_opacity(torch.tensor(x), 1e-2).numpy()
    assert out.shape == ref.shape == (N, 1) and ref.max() > 0
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * ref.max())


def test_tineuvox_plane_levels_regulariser_and_refresh_chunk():
    """TiNeuVox's plane levels: the regulariser sums the planes' total
    variation (1e-6 relative, JAX's), and the refresh chunk is JAX's."""
    jfield, field, _ = _fields("tineuvox", True)
    tree = _jax_params("tineuvox", jfield, 8)
    field.load_state_dict(field_params_from_numpy(tree, device="cpu"))
    ref = float(jfield.param_regularizer(jax.tree.map(jnp.asarray, tree)))
    assert float(field.param_regularizer()) == pytest.approx(ref, rel=1e-6)
    state = {k: v * 2 for k, v in field.state_dict().items()}
    assert float(field.param_regularizer(state)) == pytest.approx(4 * ref, rel=1e-6)
    big = dict(plane_resolutions=(64,), plane_ranks=(16,))
    assert (TiNeuVoxRadianceField(device="meta", **big).max_eval_chunk
            == JaxTiNeuVox(**big).max_eval_chunk < 2**21)
    assert TiNeuVoxRadianceField(device="meta").max_eval_chunk == 2**21


# -- the occupancy renderers --------------------------------------------------
@pytest.fixture(scope="module")
def carried():
    """A small f32 CP field initialised in JAX and a 32^3 grid refreshed
    there, the port's trainer and state carrying both, and a test view of
    the procedural scene (SIZE x SIZE, from both loaders' identical rays)."""
    small = dict(resolutions=(16, 32, 64), ranks=(8, 8, 8))
    jfield = JaxCP(aabb=AABB, compute_dtype=jnp.float32, **small)
    jparams = jfield.init(jax.random.PRNGKey(3))
    jstate = jax_update_occ_grid(
        jax_init_occ_grid(jnp.asarray(AABB), 32, 1), jax.random.PRNGKey(4), jnp.asarray(0),
        lambda x: jfield.query_density(jparams, x)[..., 0] * STEP, dense=True,
    )
    trainer_kw = dict(aabb=AABB, grid_resolution=32, render_step_size=STEP)
    trainer = NGPOccTrainer(field=CPRadianceField(AABB, compute_dtype=torch.float32, **small),
                            device="cpu", **trainer_kw)
    state = TrainState(
        cp_field_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"), None,
        occ_state_from_numpy(*(np.asarray(a) for a in (jstate.aabbs, jstate.occs,
                                                       jstate.binaries)), device="cpu"),
        0,
    )
    data = tproc.ProceduralSceneLoader(split="test", n_test=1, width=SIZE, height=SIZE,
                                       device="cpu")[0]
    return jfield, jparams, jstate, trainer, state, data


@pytest.mark.parametrize("max_samples,budget", [(1024, 2**18), (600, 2**18), (None, 9000)],
                         ids=["defaults", "cut-rays", "budget-cut"])
def test_render_image_with_occgrid_matches_jax(carried, max_samples, budget):
    """JAX's ``render_image_with_occgrid`` at its defaults (1024 candidates a
    ray from the near plane, a 2^18 budget a chunk), with 600 candidates,
    and with the whole orbit (JAX: a lattice past every orbit) cut at a
    9000-sample budget, against the port's: colours and opacities within
    2e-5 (readings up to 8.9e-6: the two libraries sum each ray's weights
    in another order) and the depth sums (depth x opacity, t up to ~6.6)
    within 1e-4 (readings up to 2.7e-5).  The defaults cut rays: they
    render another image than the whole orbit."""
    jfield, jparams, jstate, trainer, state, data = carried
    chunk = SIZE * SIZE
    kw = dict(render_step_size=STEP, chunk=chunk, sample_budget=budget)
    ref = jax_render_image(
        lambda p, d: (lambda rgb, den: (rgb, den[..., 0]))(*jfield(jparams, p, d)),
        jstate, jnp.asarray(data["rays_o"].numpy()), jnp.asarray(data["rays_d"].numpy()),
        render_bkgd=jnp.asarray(data["color_bkgd"].numpy()),
        max_samples=1400 if max_samples is None else max_samples, **kw,
    )
    with torch.no_grad():
        out = render_image_with_occgrid(
            trainer._field_fn(state, data), state.occ_state, data["rays_o"], data["rays_d"],
            data["color_bkgd"], max_samples=max_samples, **kw,
        )
        whole = trainer.render_rays(state, data)
    for got, want in zip(out[:2], ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-5)
    # the depth sums: the expected depth divides them by the opacity
    np.testing.assert_allclose((out[2] * out[1]).numpy(), np.asarray(ref[2] * ref[1]), rtol=0,
                               atol=1e-4)
    cut = float((out[0] - whole[0]).abs().max())
    if max_samples is None:
        assert whole[3] > budget == out[3] and cut > 1e-2
    else:
        assert out[3] < whole[3] and cut > 1e-2


def _split_rounds(whole, counts):
    """A march's samples as two rounds: each ray's first ``counts`` samples,
    then the rest (the whole march's bounds, so the field sees the same
    points), and the mask of the first round's samples."""
    n = whole.counts.long()
    ray_of = whole.ray_indices.long()
    slot = torch.arange(ray_of.shape[0]) - (torch.cumsum(n, 0) - n)[ray_of]
    first = slot < counts.long()[ray_of]

    def part(mask, c):
        return whole._replace(ray_indices=whole.ray_indices[mask], t_starts=whole.t_starts[mask],
                              t_ends=whole.t_ends[mask], counts=c.to(whole.counts.dtype))

    return part(first, counts), part(~first, n - counts.long()), first


def test_prefix_trans_two_rounds_match_one(carried):
    """``render_rays_with_occgrid`` over each ray's samples among its first
    700 orbit candidates, then over the rest carrying the first round's
    transmittance ``exp(-sum min(sigma delta, 40))`` as ``prefix_trans``,
    sums to one round over the whole orbit (unnormalised depths): within
    1e-5 of the largest output (readings up to 8.8e-7).  The gradients of
    both rounds' summed outputs equal the one round's: the first round's
    colours' bitwise, the second round's densities' and colours' within
    1e-5 of the largest (readings ~2e-7), while the first round's densities
    reach the second round only through the carried transmittance, which
    carries no gradient.  (The eval renderer carries ``1 - opacity``, whose
    sum of ``1 - exp(-x)`` terms loses digits where many samples are nearly
    empty.)  The carried transmittance per sample
    (``prefix_trans_samples``) gives the per-ray form's outputs bitwise, and
    JAX's ``render_rays_with_occgrid`` gives the second round's colours and
    opacities within 1e-5 and its depth sums within 1e-4 (readings 3.0e-6,
    2.7e-6 and 1.3e-5)."""
    jfield, jparams, jstate, trainer, state, data = carried
    occ = state.occ_state
    o, d, bkgd = data["rays_o"], data["rays_d"], data["color_bkgd"]
    n_rays = o.shape[0]
    field_fn = trainer._field_fn(state, data)
    whole = sampling(occ, o, d, render_step_size=STEP)
    first = sampling(occ, o, d, render_step_size=STEP, max_samples=700)
    a_res, b_res, in_a = _split_rounds(whole, first.counts)
    assert torch.equal(a_res.t_starts, first.t_starts)
    assert 0 < first.ray_indices.shape[0] < whole.ray_indices.shape[0]
    leaves = {}

    def render(name, res, **kw):
        def fn(positions, dirs, _ids):
            with torch.no_grad():
                rgb, sigma = field_fn(positions, dirs)
            leaves[name] = (rgb.requires_grad_(True), sigma.requires_grad_(True))
            return leaves[name]
        return render_rays_with_occgrid(fn, o, d, compact_samples(res), expected_depths=False,
                                        **kw)[:3]

    one = render("one", whole)
    a = render("a", a_res)
    sd = (leaves["a"][1].detach() * (a_res.t_ends - a_res.t_starts)).clamp(max=40.0)
    prefix = torch.exp(-torch.zeros(n_rays).index_add_(0, a_res.ray_indices.long(), sd))[:, None]
    b = render("b", b_res, prefix_trans=prefix)
    c = torch.rand(n_rays, 5, generator=torch.Generator().manual_seed(0))
    sum(((x * c[:, i : i + w]).sum() for x, i, w in zip(one, (0, 3, 4), (3, 1, 1)))).backward()
    sum(((x + y) * c[:, i : i + w]).sum()
        for x, y, i, w in zip(a, b, (0, 3, 4), (3, 1, 1))).backward()
    for got, want in zip((a[0] + b[0], a[1] + b[1], a[2] + b[2]), one):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                                   atol=1e-5 * float(want.abs().max()))
    for k, name in ((0, "rgb"), (1, "sigma")):
        g_one = leaves["one"][k].grad
        np.testing.assert_allclose(leaves["b"][k].grad.numpy(), g_one[~in_a].numpy(), rtol=0,
                                   atol=1e-5 * float(g_one.abs().max()), err_msg=name)
    assert torch.equal(leaves["a"][0].grad, leaves["one"][0].grad[in_a])
    samples = compact_samples(b_res)
    per_sample = render_rays_with_occgrid(
        lambda p, dd, _ids: field_fn(p, dd), o, d, samples, bkgd, expected_depths=False,
        prefix_trans_samples=prefix[samples.ray_indices.long(), 0])
    per_ray = render_rays_with_occgrid(lambda p, dd, _ids: field_fn(p, dd), o, d, samples,
                                       bkgd, expected_depths=False, prefix_trans=prefix)
    for got, want in zip(per_sample[:3], per_ray[:3]):
        assert torch.equal(got, want)
    n = samples.ray_indices.shape[0]
    jsamples = JaxCompactSamples(
        *(jnp.asarray(v.numpy()) for v in samples[:3]), jnp.ones((n,), bool), n, 0,
        n_rays, jnp.asarray(samples.seg_starts.numpy()),
        jnp.asarray(samples.seg_ends.numpy()), None, None, None)
    ref = jax.jit(lambda oo, dd, smp, bg, pt: jax_render_rays(
        lambda p, di, _r: (lambda rgb, den: (rgb, den[..., 0]))(*jfield(jparams, p, di)),
        oo, dd, smp, render_bkgd=bg, expected_depths=False, prefix_trans=pt))(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()), jsamples, jnp.asarray(bkgd.numpy()),
        jnp.asarray(prefix.numpy()))
    for got, want, tol in zip(per_ray[:3], ref, (1e-5, 1e-5, 1e-4)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("eps,max_samples", [(1e-4, 1024), (1e-2, 256)],
                         ids=["defaults", "eps1e-2-256"])
def test_render_view_follows_the_trainer_settings(carried, eps, max_samples):
    """``render_view`` at the trainer's ``early_stop_eps`` and
    ``max_samples_per_ray`` against the JAX trainer's classic renderer
    (``eval_renderer=""``, its ``_render_chunk``) on the same parameters,
    grid and view: colours within 1e-5.  The port's three renderer names
    all render it."""
    jfield, jparams, jstate, _, state, data = carried
    small = dict(resolutions=(16, 32, 64), ranks=(8, 8, 8))
    kw = dict(aabb=AABB, grid_resolution=32, render_step_size=STEP, early_stop_eps=eps,
              max_samples_per_ray=max_samples)
    jtrainer = JaxTrainer(field=jfield, eval_renderer="", **kw)
    jstate_full = JaxTrainState(jparams, None, jstate, None, None)
    jdata = {k: np.asarray(v.numpy()) for k, v in data.items()}
    ref = jtrainer.render_image(jstate_full, jdata, chunk=SIZE * SIZE)
    colors = []
    for renderer in ("cursor", "pooled", ""):
        trainer = NGPOccTrainer(
            field=CPRadianceField(AABB, compute_dtype=torch.float32, **small), device="cpu",
            eval_renderer=renderer, cursor_max_windows=1 << 10, eval_sample_budget=4096, **kw)
        colors.append(trainer.render_view(state, data, chunk=SIZE * SIZE)[0])
    np.testing.assert_allclose(colors[0].numpy(), ref, rtol=0, atol=1e-5)
    assert torch.equal(colors[0], colors[1]) and torch.equal(colors[0], colors[2])


# -- the trainer's options ---------------------------------------------------
def test_trainer_takes_jax_options_and_refuses_what_jax_refuses():
    """The TPU-only knobs are taken; an unknown traversal raises; a
    time-dependent trainer without frame times raises at its occupancy
    update, as JAX's assert does; frame times make a trainer
    time-dependent."""
    small = dict(resolutions=(8,), ranks=(4,))
    knobs = dict(n_windows=32, window_size=4, window_budget=1000, fine_probes=4,
                 compaction="sort", dynamic_budget=False, budget_granularity=1024,
                 budget_headroom=1.5, cursor_max_windows=1 << 12, eval_sample_budget=2**12,
                 eval_renderer="pooled", traversal="windowed", windowed=True)
    trainer = NGPOccTrainer(field=CPRadianceField(AABB, **small), aabb=AABB, grid_resolution=8,
                            device="cpu", **knobs)
    assert not trainer.time_dependent
    with pytest.raises(ValueError, match="traversal"):
        NGPOccTrainer(field=CPRadianceField(AABB, **small), aabb=AABB, device="cpu",
                      traversal="cursor")
    dynamic = NGPOccTrainer(field=TiNeuVoxRadianceField(AABB, device="cpu", **small),
                            aabb=AABB, grid_resolution=8, time_dependent=True, device="cpu")
    with pytest.raises(ValueError, match="timestamps"):
        dynamic.refresh_occ_grid(dynamic.init_state(), 0)
    timed = NGPOccTrainer(field=TiNeuVoxRadianceField(AABB, device="cpu", **small), aabb=AABB,
                          grid_resolution=8, timestamps=np.zeros((3, 1), np.float32),
                          device="cpu")
    assert timed.time_dependent


# -- the small functions -------------------------------------------------------
def test_ray_aabb_intersect_clips_before_the_miss_fill():
    """JAX's clip to [near_plane, far_plane] and ``miss_value``, bitwise, on
    rays that hit, miss, start inside and run along an axis."""
    rng = np.random.default_rng(9)
    o = rng.uniform(-3, 3, (400, 3)).astype(np.float32)
    d = rng.standard_normal((400, 3)).astype(np.float32)
    d[:40, 1:] = 0.0  # along x
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    aabbs = np.array([[-1, -1, -1, 1, 1, 1], [-2, -0.5, -2, 2, 0.5, 2]], np.float32)
    for kw in ({}, dict(near_plane=0.5, far_plane=3.0, miss_value=-1.0),
               dict(near_plane=1.0, miss_value=0.0)):
        ref = jgrid.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(aabbs), **kw)
        out = tgrid.ray_aabb_intersect(torch.tensor(o), torch.tensor(d), torch.tensor(aabbs),
                                       **kw)
        for got, want in zip(out, ref):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert out[2].any() and not out[2].all()


def test_small_functions_match_jax():
    """``psnr(data_range)`` within 1e-12; ``contract_to_unisphere`` with
    ``eps`` and ``derivative`` within 2e-6 relative (the port rounds the box
    map as jitted XLA does, eager JAX apart); ``exclusive_sum_sorted``
    (``nonnegative``, the bounds found from the ids) and
    ``segment_sum_sorted`` (the bounds given) within 1e-5 relative;
    ``cp_field_flops_per_sample(backward)`` equal; ``compact_samples`` of
    ``sampling_padded``'s padded layout, as JAX's takes it, bitwise that of
    the march with the same candidate window, ``valid`` all true."""
    rng = np.random.default_rng(11)
    img, ref = rng.uniform(0, 2, (2, 8, 8, 3))
    for data_range in (1.0, 2.0, 255.0):
        assert psnr(torch.tensor(img), torch.tensor(ref), data_range) == pytest.approx(
            jax_psnr(img, ref, data_range), rel=1e-12)

    x = (rng.standard_normal((2000, 3)) * 2).astype(np.float32)
    x[:5] = 0.0
    aabb = np.array([-1, -1, -1, 1, 1, 1], np.float32)
    for kw in (dict(), dict(eps=1e-3), dict(derivative=True), dict(eps=0.5, derivative=True)):
        want = np.asarray(jax.jit(lambda p: jax_contract(p, jnp.asarray(aabb), **kw))(x))
        got = contract_to_unisphere(torch.tensor(x), torch.tensor(aabb), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)

    counts = rng.integers(0, 9, 60)
    ids = np.repeat(np.arange(60), counts).astype(np.int32)
    vals = rng.uniform(0, 3, ids.shape[0]).astype(np.float32)
    want = np.asarray(jax_excl(jnp.asarray(vals), jnp.asarray(ids), 60, None, None, True))
    got = exclusive_sum_sorted(torch.tensor(vals), torch.tensor(ids), 60,
                               nonnegative=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ends = np.cumsum(counts)
    starts, last = (ends - counts).astype(np.int32), (ends - 1).astype(np.int32)
    src = rng.standard_normal((ids.shape[0], 2)).astype(np.float32)
    want = np.asarray(jax_segsum(jnp.asarray(src), jnp.asarray(ids), 60, jnp.asarray(starts),
                                 jnp.asarray(last)))
    got = segment_sum_sorted(torch.tensor(src), torch.tensor(ids), 60, torch.tensor(starts),
                             torch.tensor(last)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    occ = occ_state_from_numpy(np.array([[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]], np.float32),
                               *(lambda o: (o, o > 0.5))(rng.uniform(0, 1, (1, 8, 8, 8))
                                                          .astype(np.float32)), device="cpu")
    o = torch.tensor(rng.uniform(-3, 3, (64, 3)).astype(np.float32))
    d = torch.nn.functional.normalize(-o + torch.tensor(rng.uniform(-0.5, 0.5, (64, 3))
                                                        .astype(np.float32)), dim=-1)
    kw = dict(render_step_size=0.05, max_samples=60)
    for got, want in zip(compact_samples(sampling_padded(occ, o, d, **kw), 500),
                         compact_samples(sampling(occ, o, d, **kw), 500)):
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want)
        else:
            assert got == want
    ref = compact_samples(sampling(occ, o, d, **kw), 500)
    assert ref.valid.all() and ref.num_valid == 500 and ref.overflow > 0

    for viewdirs in (True, False):
        kw = dict(WIDTHS, use_viewdirs=viewdirs, plane_resolutions=(8,), plane_ranks=(4,))
        jfield = JaxCP(aabb=AABB, **kw)
        field = CPRadianceField(AABB, **kw)
        for backward in (True, False):
            assert (flops.cp_field_flops_per_sample(field, backward)
                    == jflops.cp_field_flops_per_sample(jfield, backward))


def test_hash_table_dtype_follows_init():
    """``HashGridEncoder.init(generator, dtype)``: the table takes JAX's
    dtype and range, and the plain encode of a bf16 table agrees with the
    JAX encoder's on the same table within bf16's rounding, 4e-3 of the
    largest feature (reading 0: both sum the corners in f32)."""
    enc = HashGridEncoder(n_levels=2, log2_hashmap_size=8, max_resolution=32)
    enc.init(torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    jenc = JaxHash(n_levels=2, n_features_per_level=2, log2_hashmap_size=8,
                   base_resolution=16, max_resolution=32, table_grad="scatter")
    jtable = jenc.init(jax.random.PRNGKey(0), jnp.bfloat16)
    assert enc.table.dtype == torch.bfloat16 and jtable.dtype == jnp.bfloat16
    assert tuple(enc.table.shape) == jtable.shape
    top = float(torch.tensor(1e-4).bfloat16())  # 1e-4 rounded to bf16
    assert 0 < float(enc.table.detach().abs().max()) <= top
    assert float(jnp.abs(jtable).max()) <= top
    table = enc.table.detach() * 1e4
    u = np.random.default_rng(12).uniform(0, 1, (300, 3)).astype(np.float32)
    got = hash_encode_plain(torch.tensor(u), table, enc.resolutions).float().numpy()
    want = np.asarray(jenc(jnp.asarray(table.float().numpy()).astype(jnp.bfloat16),
                           jnp.asarray(u)), np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=4e-3 * np.abs(want).max())
    enc.init(torch.Generator().manual_seed(0))
    assert enc.table.dtype == torch.float32


def test_procedural_options_match_jax(monkeypatch):
    """The loaders' scene options give JAX's scene: equal blobs and rays,
    the ground truth within 1/255; the dynamic scenes' ``query_density_t``
    / ``query_rgb_t`` within 1e-5 relative at two times."""
    monkeypatch.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
    view = dict(split="test", n_test=1, width=8, height=8)
    cases = [
        (jproc.ProceduralSceneLoader, tproc.ProceduralSceneLoader,
         dict(num_blobs=10, aabb_half=1.0, gt_samples=96)),
        (jproc.ProceduralOpaqueSceneLoader, tproc.ProceduralOpaqueSceneLoader,
         dict(num_blobs=9, gt_samples=96)),
        (jproc.ProceduralUnboundedSceneLoader, tproc.ProceduralUnboundedSceneLoader,
         dict(num_blobs=6, gt_samples=64, gt_far_samples=32, content_radius=5.5,
              num_far_blobs=5)),
        (jproc.ProceduralDynamicSceneLoader, tproc.ProceduralDynamicSceneLoader,
         dict(num_blobs=7, gt_samples=64)),
        (jproc.ProceduralLocalDynamicSceneLoader, tproc.ProceduralLocalDynamicSceneLoader,
         dict(num_blobs=8, gt_samples=64)),
    ]
    x = np.random.default_rng(13).uniform(-1.2, 1.2, (500, 3)).astype(np.float32)
    for jcls, tcls, kw in cases:
        jds, ds = jcls(**view, **kw), tcls(**view, **kw, device="cpu")
        np.testing.assert_array_equal(ds.aabb, np.asarray(jds.aabb))
        for name in ("blob_centers", "blob_scales", "blob_density"):
            np.testing.assert_array_equal(getattr(ds, name).numpy(),
                                          np.asarray(getattr(jds, name)))
        ref, out = jds[0], ds[0]
        for key in ("rays_o", "rays_d"):
            np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
        np.testing.assert_allclose(out["rgb"].numpy(), np.asarray(ref["rgb"]),
                                   atol=1 / 255 + 1e-6)
        if not hasattr(jds, "query_density_t"):
            continue
        for t in (0.3, 0.8):
            for query in ("query_density_t", "query_rgb_t"):
                want = np.asarray(getattr(jds, query)(jnp.asarray(x), t))
                got = getattr(ds, query)(torch.tensor(x), t).numpy()
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           atol=1e-5 * np.abs(want).max())
