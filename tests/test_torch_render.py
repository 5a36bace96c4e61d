"""Port vs JAX, the whole slice: procedural test views rendered through
NGPOccTrainer.render_image against nerfacc_tpu's render_image_with_occgrid,
from the same parameters, occupancy grid and rays."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu import grid as jgrid
from nerfacc_tpu.data.procedural import ProceduralSceneLoader as JaxLoader
from nerfacc_tpu.estimators.occ_grid import init_occ_grid as jax_init_occ_grid
from nerfacc_tpu.estimators.occ_grid import update_occ_grid as jax_update_occ_grid
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
from nerfacc_tpu.utils.rendering import compact_samples as jax_compact_samples
from nerfacc_tpu.utils.rendering import render_image_with_occgrid
from nerfacc_tpu.utils.rendering import render_rays_occgrid_test as jax_render_rays_occgrid_test
from nerfacc_tpu_torch.grid import MarchResult
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer, TrainState
from nerfacc_tpu_torch.utils.rendering import (
    compact_samples,
    render_rays_occgrid_test,
)
from nerfacc_tpu_torch.utils.rendering import (
    render_image_with_occgrid as render_image_with_occgrid_port,
)
from nerfacc_tpu_torch.utils.jax_bridge import (
    cp_field_params_from_numpy,
    occ_state_from_numpy,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
SMALL = dict(resolutions=(16, 32, 64), ranks=(8, 8, 8))
STEP = 5e-3
SIZE = 24
DENSE = 50.0  # the early-stop test's density scale: most blob rays saturate


@pytest.fixture(scope="module")
def loaders():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
        jax_ds = JaxLoader(split="test", width=SIZE, height=SIZE)
    return jax_ds, ProceduralSceneLoader(split="test", width=SIZE, height=SIZE, device="cpu")


def test_loaders_give_equal_rays_and_ground_truth(loaders):
    jax_ds, ds = loaders
    assert len(ds) == len(jax_ds) == 4
    for i in range(len(ds)):
        ref, out = jax_ds[i], ds[i]
        for key in ("rays_o", "rays_d", "color_bkgd"):
            np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]))
        np.testing.assert_allclose(
            out["rgb"].numpy(), np.asarray(ref["rgb"]), atol=1 / 255 + 1e-6
        )
        assert float(out["rgb"].std()) > 0.05  # the blobs are in view


@pytest.fixture(scope="module")
def carried_field():
    """A small f32 CP field initialised in JAX and a grid refreshed there,
    and the port's trainer and state carrying both across."""
    jfield = JaxField(aabb=AABB, compute_dtype=jnp.float32, **SMALL)
    jparams = jfield.init(jax.random.PRNGKey(3))
    jstate = jax_update_occ_grid(
        jax_init_occ_grid(jnp.asarray(AABB), 32, 1),
        jax.random.PRNGKey(4),
        jnp.asarray(0),
        lambda x: jfield.query_density(jparams, x)[..., 0] * STEP,
        dense=True,
    )
    occupied = float(jnp.mean(jstate.binaries))
    assert 0.05 < occupied < 0.95

    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, compute_dtype=torch.float32, **SMALL),
        aabb=AABB, grid_resolution=32, render_step_size=STEP, device="cpu",
    )
    state = TrainState(
        params=cp_field_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu"),
        opt_state=None,
        occ_state=occ_state_from_numpy(
            *(np.asarray(a) for a in (jstate.aabbs, jstate.occs, jstate.binaries)),
            device="cpu",
        ),
        step=0,
    )

    def field_fn(p, d):
        rgb, density = jfield(jparams, p, d)
        return rgb, density[..., 0]

    return field_fn, jstate, trainer, state


def test_render_image_matches_jax(loaders, carried_field):
    """The exact renderer (``render_rays``) against JAX's full-lattice
    render at 1e-4; ``render_image``, the eval renderer's image, bitwise
    equal to :func:`render_rays_occgrid_test` at the trainer's settings and
    within 2e-4 of the exact renderer (it stops rays at 1 - 1e-4 opacity)."""
    jax_ds, ds = loaders
    field_fn, jstate, trainer, state = carried_field
    for i in (0, 2):
        ref_data, data = jax_ds[i], ds[i]
        colors, opacities, depths, n_samples = trainer.render_rays(state, data)
        chunk = SIZE * SIZE // 2
        # the JAX lattice covers every orbit (t up to ~6.6 from radius 4);
        # its budget covers every chunk's samples
        ref, _, _ = render_image_with_occgrid(
            field_fn, jstate, jnp.asarray(ref_data["rays_o"]),
            jnp.asarray(ref_data["rays_d"]),
            render_bkgd=jnp.asarray(ref_data["color_bkgd"]),
            render_step_size=STEP, max_samples=1400, chunk=chunk,
            sample_budget=2**18,
        )
        assert n_samples < 2**18 and n_samples > 10 * SIZE * SIZE
        np.testing.assert_allclose(colors.numpy(), ref, atol=1e-4, rtol=0)
        image = trainer.render_image(state, data)
        with torch.no_grad():
            early = render_rays_occgrid_test(
                trainer._field_fn(state, data), state.occ_state, data["rays_o"],
                data["rays_d"], render_bkgd=data["color_bkgd"],
                render_step_size=STEP, early_stop_eps=1e-4, window=128,
                max_iters=1024 // 32,
            )[0]
        np.testing.assert_array_equal(image.numpy(), early.numpy())
        np.testing.assert_allclose(image.numpy(), colors.numpy(), atol=2e-4, rtol=0)
        assert ((opacities >= 0) & (opacities <= 1 + 1e-4)).all()
        assert torch.isfinite(depths).all()


@pytest.mark.parametrize("view,window", [(0, 128), (1, 64)])
def test_early_stop_renderer_matches_jax(loaders, carried_field, view, window):
    """``render_rays_occgrid_test`` against JAX's on the carried field and
    grid: colours, opacities and depths within 1e-5, and the same number
    of rounds (JAX's loop with that many rounds is its whole result, with
    one fewer it is not).  Both fields' densities are scaled by ``DENSE``,
    so that rays saturate and stop early, and the renderer renders fewer
    samples than the exact one."""
    jax_ds, ds = loaders
    jax_fn, jstate, trainer, state = carried_field
    ref_data, data = jax_ds[view], ds[view]
    port_fn = trainer._field_fn(state, data)

    def dense(fn):
        def field_fn(p, d):
            rgb, sigma = fn(p, d)
            return rgb, sigma * DENSE
        return field_fn

    kw = dict(render_step_size=STEP, early_stop_eps=1e-4, window=window)
    with torch.no_grad():
        colors, opacities, depths, stats = render_rays_occgrid_test(
            dense(port_fn), state.occ_state, data["rays_o"],
            data["rays_d"], render_bkgd=data["color_bkgd"], max_iters=64,
            return_stats=True, **kw,
        )

    def jax_render(max_iters):
        return [np.asarray(a) for a in jax_render_rays_occgrid_test(
            dense(jax_fn), jstate, jnp.asarray(ref_data["rays_o"]),
            jnp.asarray(ref_data["rays_d"]), jnp.asarray(ref_data["color_bkgd"]),
            max_iters=max_iters, **kw,
        )]

    ref = jax_render(64)
    for got, want in zip((colors, opacities, depths), ref):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert int(stats["counts"].sum()) == stats["n_samples"]
    rounds = stats["n_rounds"]
    assert 2 < rounds < 64
    for got, want in zip(jax_render(rounds), ref):
        np.testing.assert_array_equal(got, want)
    assert any(not np.array_equal(a, b) for a, b in zip(jax_render(rounds - 1), ref))
    exact = render_image_with_occgrid_port(
        dense(port_fn), state.occ_state, data["rays_o"], data["rays_d"],
        data["color_bkgd"], render_step_size=STEP, max_samples=None, sample_budget=None,
    )
    assert (opacities > 1 - 1e-4).float().mean() > 0.1
    assert stats["n_samples"] < exact[3]


def test_trainer_eval_path_on_the_port_alone():
    """The slice's entry points end to end, port only: init, dense
    refreshes, then eval_metrics over the test views."""
    ds = ProceduralSceneLoader(split="test", width=16, height=16, n_test=2, device="cpu")
    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, **SMALL), aabb=AABB, grid_resolution=32,
        device="cpu",
    )
    state = trainer.init_state()
    assert not state.occ_state.binaries.any()
    for step in range(2):
        state = trainer.refresh_occ_grid(state, step)
    share = float(state.occ_state.binaries.float().mean())
    assert 0.0 < share < 1.0
    again = trainer.refresh_occ_grid(trainer.init_state(), 0)
    torch.testing.assert_close(  # a refresh is reproducible from (seed, step)
        again.occ_state.occs,
        trainer.refresh_occ_grid(trainer.init_state(), 0).occ_state.occs,
        rtol=0, atol=0,
    )
    m = trainer.eval_metrics(state, ds)
    assert len(m["views"]) == 2 and np.isfinite(m["psnr"])
    for v in m["views"]:
        assert v["finite"] and v["n_samples"] > 0 and v["n_rays"] == 256
        assert 0.0 <= v["opacity_min"] <= v["opacity_max"] <= 1.0 + 1e-4


@pytest.mark.parametrize("budget_share", [0.37, 0.5, 1.0, 1.5])
def test_budgeted_compaction_matches_jax(budget_share):
    """compact_samples(samples, budget) against JAX's compact_samples(res,
    budget) on the same traversal: the kept slots, the counts and the
    segment bounds, with a budget below and above the demand."""
    rng = np.random.default_rng(3)
    n_rays = 96
    theta = rng.uniform(0, 2 * np.pi, n_rays)
    o = np.stack([4 * np.cos(theta), 4 * np.sin(theta), rng.uniform(-1, 1, n_rays)], -1)
    d = rng.uniform(-1.5, 1.5, (n_rays, 3)) - o
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    binaries = rng.uniform(size=(1, 32, 32, 32)) < 0.3
    res = jgrid.traverse_grids_padded(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(binaries),
        jnp.asarray([AABB], jnp.float32), step_size=STEP, max_samples=1400,
    )
    valid = np.asarray(res.valid)
    total = int(valid.sum())
    budget = int(budget_share * total)
    ray, k = np.nonzero(valid)
    samples = MarchResult(  # the same traversal, packed in (ray, orbit) order
        torch.tensor(ray, dtype=torch.int32),
        torch.tensor(np.asarray(res.t_starts)[ray, k]),
        torch.tensor(np.asarray(res.t_ends)[ray, k]),
        torch.tensor(valid.sum(-1), dtype=torch.int32),
        torch.tensor(np.asarray(res.termination_planes)),
        torch.tensor(np.asarray(res.terminated)),
    )
    out = compact_samples(samples, budget)
    ref = jax_compact_samples(res, budget)
    keep = min(total, budget)
    assert out.num_valid == int(ref.num_valid) == keep
    assert out.overflow == int(ref.overflow) == total - keep
    assert out.first_incomplete_ray == int(ref.first_incomplete_ray)
    if budget < total:
        assert out.first_incomplete_ray < n_rays
    np.testing.assert_array_equal(out.ray_indices.numpy(), np.asarray(ref.ray_indices)[:keep])
    np.testing.assert_array_equal(out.t_starts.numpy(), np.asarray(ref.t_starts)[:keep])
    np.testing.assert_array_equal(out.t_ends.numpy(), np.asarray(ref.t_ends)[:keep])
    np.testing.assert_array_equal(out.seg_starts.numpy(), np.asarray(ref.seg_starts))
    np.testing.assert_array_equal(out.seg_ends.numpy(), np.asarray(ref.seg_ends))
    assert (np.asarray(ref.ray_indices)[keep:] == n_rays).all()  # JAX's fill


def test_renderers_take_jax_signatures(loaders, carried_field):
    """The two settled divergences of ``utils/rendering.py``, each called as
    the JAX package calls it: ``render_rays_with_occgrid``'s callback takes
    ``(positions, dirs, ray_indices)``, the ids those of the samples' rays,
    and its colours equal JAX's on the same packed samples (within 1e-5);
    ``render_rays_occgrid_test`` returns JAX's three values (their stats
    only with ``return_stats``)."""
    from nerfacc_tpu.utils.rendering import CompactSamples as JaxCompactSamples
    from nerfacc_tpu.utils.rendering import render_rays_with_occgrid as jax_render_rays
    from nerfacc_tpu_torch.grid import march
    from nerfacc_tpu_torch.utils.rendering import render_rays_with_occgrid

    jax_fn, jstate, trainer, state = carried_field
    jax_ds, ds = loaders
    data = ds[0]
    o, d = data["rays_o"][:200], data["rays_d"][:200]
    samples = compact_samples(march(o, d, state.occ_state.binaries, state.occ_state.aabbs,
                                    step_size=STEP))
    port_fn = trainer._field_fn(state, data)
    seen = []

    def rgb_sigma_fn(positions, dirs, ray_indices):
        seen.append(ray_indices)
        return port_fn(positions, dirs)

    colors = render_rays_with_occgrid(rgb_sigma_fn, o, d, samples, data["color_bkgd"])[0]
    torch.testing.assert_close(seen[0], samples.ray_indices.long(), rtol=0, atol=0)
    n = samples.ray_indices.shape[0]
    jsamples = JaxCompactSamples(
        jnp.asarray(samples.ray_indices.numpy()), jnp.asarray(samples.t_starts.numpy()),
        jnp.asarray(samples.t_ends.numpy()), jnp.ones((n,), bool), n, 0, 200,
        jnp.asarray(samples.seg_starts.numpy()), jnp.asarray(samples.seg_ends.numpy()),
        None, None, None)
    want = jax_render_rays(lambda p, dd, rid: jax_fn(p, dd), jnp.asarray(o.numpy()),
                           jnp.asarray(d.numpy()), jsamples,
                           render_bkgd=jnp.asarray(data["color_bkgd"].numpy()))[0]
    np.testing.assert_allclose(colors.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)

    kw = dict(render_step_size=STEP, window=64, max_iters=4)
    with torch.no_grad():
        out = render_rays_occgrid_test(port_fn, state.occ_state, o, d, **kw)
        stats = render_rays_occgrid_test(port_fn, state.occ_state, o, d, return_stats=True,
                                         **kw)[3]
    ref = jax_render_rays_occgrid_test(jax_fn, jstate, jnp.asarray(o.numpy()),
                                       jnp.asarray(d.numpy()), **kw)
    assert len(out) == len(ref) == 3 and stats["n_rounds"] == 4
    for got, w in zip(out, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-5, rtol=0)
