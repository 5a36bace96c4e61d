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
from nerfacc_tpu_torch.grid import MarchResult
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer, TrainState
from nerfacc_tpu_torch.utils.rendering import compact_samples
from nerfacc_tpu_torch.utils.jax_bridge import (
    cp_field_params_from_numpy,
    occ_state_from_numpy,
)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
SMALL = dict(resolutions=(16, 32, 64), ranks=(8, 8, 8))
STEP = 5e-3
SIZE = 24


@pytest.fixture(scope="module")
def loaders():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
        jax_ds = JaxLoader(split="test", width=SIZE, height=SIZE)
    return jax_ds, ProceduralSceneLoader(split="test", width=SIZE, height=SIZE)


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


def test_render_image_matches_jax(loaders):
    jax_ds, ds = loaders
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
        aabb=AABB, grid_resolution=32, render_step_size=STEP,
    )
    state = TrainState(
        params=cp_field_params_from_numpy(jax.tree.map(np.asarray, jparams)),
        opt_state=None,
        occ_state=occ_state_from_numpy(
            *(np.asarray(a) for a in (jstate.aabbs, jstate.occs, jstate.binaries))
        ),
        step=0,
    )

    def field_fn(p, d):
        rgb, density = jfield(jparams, p, d)
        return rgb, density[..., 0]

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
        np.testing.assert_array_equal(
            trainer.render_image(state, data).numpy(), colors.numpy()
        )
        assert ((opacities >= 0) & (opacities <= 1 + 1e-4)).all()
        assert torch.isfinite(depths).all()


def test_trainer_eval_path_on_the_port_alone():
    """The slice's entry points end to end, port only: init, dense
    refreshes, then eval_metrics over the test views."""
    ds = ProceduralSceneLoader(split="test", width=16, height=16, n_test=2)
    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, **SMALL), aabb=AABB, grid_resolution=32
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
