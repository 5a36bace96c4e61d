"""Port vs JAX, the occupancy trainer's unbounded configuration and its
occupancy-update modes: a few NGPOccTrainer steps against the JAX trainer's
padded-traversal steps from the same parameters, batches and draws (the
dense refresh of warmup, then the sampled or the striped update), the
``alpha_thre`` that changes no sample, and one view of the eval renderer."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.data.procedural import ProceduralUnboundedSceneLoader as JaxUnbounded
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JaxOccGridEstimator
from nerfacc_tpu.estimators.occ_grid import sampling_padded as jax_sampling_padded
from nerfacc_tpu.trainers.ngp_occ import NGPOccTrainer as JaxTrainer
from nerfacc_tpu.utils.rendering import render_rays_occgrid_test as jax_render_rays_occgrid_test
from nerfacc_tpu_torch.estimators.occ_grid import cells_evaluated, update_mode
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer, TrainState
from nerfacc_tpu_torch.utils.jax_bridge import cp_field_params_from_numpy, occ_state_from_numpy
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
SMALL = dict(resolutions=(8, 16), ranks=(4, 4))
GRID = 8
N_RAYS = 16
# the occupancy example's unbounded branch (examples/train_ngp_nerf_occ.py)
UNBOUNDED = dict(grid_nlvl=4, render_step_size=1e-3, cone_angle=0.004, alpha_thre=1e-2,
                 near_plane=0.2)
# the JAX trainer's padded traversal over 1400 candidates a ray: past every
# orbit here (at most ~1090 from near 0.2 to the level-3 box +-8), so it is
# the whole orbit, which the port marches
JAX_ONLY = dict(traversal="padded", windowed=False, max_samples_per_ray=1400,
                dynamic_budget=False)


@pytest.fixture(scope="module")
def batches():
    """Three train batches (numpy) of the unbounded scene, random
    backgrounds, handed to both trainers."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
        ds = JaxUnbounded("train", n_train=3, width=16, height=16, num_rays=N_RAYS, seed=5,
                          color_bkgd_aug="random")
        test = JaxUnbounded("test", n_test=1, width=12, height=12)
    return [{k: np.asarray(v) for k, v in ds[0].items()} for _ in range(3)], test


def _jax_update_draws(k_occ, mode, levels, cells, n_eval, binaries):
    """The draws JAX's ``update_occ_grid`` makes from ``k_occ`` in ``mode``:
    the cell jitter, and the sampled update's uniform and occupied ids (its
    key sort, occupied cells first)."""
    _, k_uni, k_bits, k_eval = jax.random.split(k_occ, 4)
    draws = dict(cell_jitter=torch.tensor(np.asarray(
        jax.random.uniform(k_eval, (levels, n_eval, 3), jnp.float32))))
    if mode == "sampled":
        n = cells // 4
        uni = jax.random.randint(k_uni, (levels, n), 0, cells, dtype=jnp.int32)
        rbits = jax.random.bits(k_bits, (levels * cells,)).astype(jnp.uint32)
        keys = ((rbits >> 8) | jnp.where(jnp.asarray(binaries).reshape(-1), 0, 1 << 30))
        iota = jnp.broadcast_to(jnp.arange(cells, dtype=jnp.int32)[None], (levels, cells))
        _, ids = jax.lax.sort_key_val(keys.astype(jnp.int32).reshape(levels, cells), iota)
        draws["cell_ids"] = (torch.tensor(np.asarray(uni)), torch.tensor(np.asarray(ids[:, :n])))
    return draws


def _trainers(options):
    jtrainer = JaxTrainer(
        field=JaxField(aabb=AABB, unbounded=True, compute_dtype=jnp.float32, **SMALL),
        aabb=AABB, max_steps=100, grid_resolution=GRID, sample_budget=2**16,
        **UNBOUNDED, **JAX_ONLY, **options,
    )
    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, unbounded=True, compute_dtype=torch.float32, **SMALL),
        aabb=AABB, max_steps=100, grid_resolution=GRID, sample_budget=2**16, device="cpu",
        **UNBOUNDED, **options,
    )
    return jtrainer, trainer


def _run(batches, options, n_steps):
    """``n_steps`` steps of both trainers from the JAX trainer's initial
    state, JAX's draws fed to the port; yields (step, mode, JAX aux, JAX
    state, port aux, port state) after each."""
    jtrainer, trainer = _trainers(options)
    jstate = jtrainer.init_state()
    params = cp_field_params_from_numpy(jax.tree.map(np.asarray, jstate.params), device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    occ = occ_state_from_numpy(*(np.asarray(a) for a in (
        jstate.occ_state.aabbs, jstate.occ_state.occs, jstate.occ_state.binaries)), device="cpu")
    state = TrainState(params, trainer.init_optimizer(params), occ, 0)
    levels, cells = occ.levels, occ.cells_per_lvl
    for step in range(n_steps):
        _, k_occ, k_strat, _ = jax.random.split(jstate.key, 4)
        mode = update_mode(step, trainer.warmup_steps, trainer.dense_occ_update,
                           trainer.occ_refresh_stripes)
        draws = dict(near_jitter=torch.tensor(np.asarray(jax.random.uniform(k_strat, (N_RAYS,)))))
        if step % trainer.update_interval == 0:
            n_eval = cells_evaluated(mode, cells, trainer.occ_refresh_stripes)
            draws.update(_jax_update_draws(k_occ, mode, levels, cells, n_eval,
                                           np.asarray(jstate.occ_state.binaries)))
        batch = batches[step % len(batches)]
        jstate, ref = jtrainer.train_step(jstate, batch)  # donates the old state
        state, aux = trainer.train_step(state, {k: torch.tensor(v) for k, v in batch.items()},
                                        **draws)
        yield step, mode, ref, jstate, aux, state, trainer


def _assert_grids_agree(state, jstate, rtol):
    """Occupancies within ``rtol`` relative; binaries equal wherever JAX's
    occupancy is farther than that from the threshold."""
    occs, want = state.occ_state.occs.numpy(), np.asarray(jstate.occ_state.occs)
    np.testing.assert_allclose(occs, want, rtol=rtol, atol=0)
    thre = min(float(want[want >= 0].mean()), 1e-2)
    far = np.abs(want - thre) > rtol * np.abs(want) + 1e-12
    np.testing.assert_array_equal(state.occ_state.binaries.numpy().reshape(-1)[far],
                                  np.asarray(jstate.occ_state.binaries).reshape(-1)[far])


@pytest.mark.parametrize("options", [
    dict(dense_occ_update=False, warmup_steps=2, update_interval=2),
    dict(occ_refresh_stripes=4, warmup_steps=2, update_interval=2),
    dict(),
], ids=["sampled", "striped", "dense"])
def test_unbounded_steps_and_update_modes_match_jax(batches, options):
    """Three steps of the unbounded configuration (4 levels of an 8^3 grid,
    step 1e-3, cone 0.004, near 0.2, a contracted f32 CP field): the dense
    refresh at step 0, then at step 2 (sampled) the sampled update, whose
    ids hold duplicates, or (striped) one stripe of four; (dense) the
    refresh of every cell at step 0 only, then one view of the test split
    through both eval renderers (rounds of 128 candidates, early stopping)
    from the trained state.  After each step: the loss within 1e-4
    relative and the sample counts equal (every orbit ends inside the
    candidates of both: no ray truncated); the occupancies within 1e-4
    relative and the binaries equal away from the threshold (the
    parameters drift apart by Adam's steps on near-zero gradient entries);
    every leaf within 2e-3 of JAX's in relative Frobenius norm.  The view's
    colours within 2e-3."""
    for step, mode, ref, jstate, aux, state, trainer in _run(batches[0], options, 3):
        assert float(aux["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-4), step
        for key in ("n_rendering_samples", "n_total_samples", "overflow"):
            assert int(aux[key]) == int(ref[key]), (step, key)
        assert int(aux["n_rays_truncated"]) == int(ref["n_rays_truncated"]) == 0
        _assert_grids_agree(state, jstate, 1e-4)
        if step == 2 and options:
            assert mode == ("sampled" if "dense_occ_update" in options else "striped")
        want = cp_field_params_from_numpy(jax.tree.map(np.asarray, jstate.params), device="cpu")
        for name, p in state.params.items():
            got, w = p.detach().numpy(), want[name].numpy()
            assert np.linalg.norm(got - w) <= 2e-3 * np.linalg.norm(w), (step, name)
    assert int(aux["n_rendering_samples"]) > 1000 and state.step == 3
    if options:
        return
    jfield = JaxField(aabb=AABB, unbounded=True, compute_dtype=jnp.float32, **SMALL)
    view = {k: np.asarray(v) for k, v in batches[1][0].items()}

    def jax_field_fn(x, d):
        rgb, density = jfield(jstate.params, x, d)
        return rgb, density[..., 0]

    want = jax_render_rays_occgrid_test(
        jax_field_fn, jstate.occ_state, jnp.asarray(view["rays_o"]),
        jnp.asarray(view["rays_d"]), jnp.asarray(view["color_bkgd"]), near_plane=0.2,
        render_step_size=1e-3, cone_angle=0.004, early_stop_eps=1e-4, window=128,
        max_iters=32,
    )[0]
    colors, _, _, n_samples = trainer.render_view(
        state, {k: torch.tensor(v) for k, v in view.items()}
    )
    np.testing.assert_allclose(colors.numpy(), np.asarray(want), rtol=0, atol=2e-3)
    assert n_samples > 0 and np.isfinite(colors.numpy()).all()


def test_alpha_thre_changes_no_sample(batches):
    """``alpha_thre`` 1e-2 against 0: JAX's ``sampling_padded`` as its
    trainer calls it (no density callback, so the visibility filter that
    reads the threshold does not run) gives the same candidates, and one
    port trainer step gives the same samples and loss."""
    batch = batches[0][0]
    occ = JaxOccGridEstimator(AABB, GRID, 4).state
    occ = occ.__class__(aabbs=occ.aabbs, occs=occ.occs + 0.5, binaries=~occ.binaries)
    res = [jax_sampling_padded(occ, jnp.asarray(batch["rays_o"]), jnp.asarray(batch["rays_d"]),
                               near_plane=0.2, render_step_size=1e-3, alpha_thre=thre,
                               cone_angle=0.004, max_samples=1400)
           for thre in (0.0, 1e-2)]
    assert np.asarray(res[0].valid).any()
    for a, b in zip(*res):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    auxs = []
    for thre in (0.0, 1e-2):
        trainer = NGPOccTrainer(
            field=CPRadianceField(AABB, unbounded=True, compute_dtype=torch.float32, **SMALL),
            aabb=AABB, max_steps=100, grid_resolution=GRID, sample_budget=2**16,
            device="cpu", **{**UNBOUNDED, "alpha_thre": thre},
        )
        tbatch = {k: torch.tensor(v) for k, v in batch.items()}
        auxs.append(trainer.train_step(trainer.init_state(), tbatch,
                                       near_jitter=torch.full((N_RAYS,), 0.5))[1])
    for key in ("loss", "n_rendering_samples", "n_rays_ok"):
        assert float(auxs[0][key]) == float(auxs[1][key]), key
    assert int(auxs[0]["n_rendering_samples"]) > 0
