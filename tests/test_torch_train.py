"""Port vs JAX, the train slice: the learning-rate schedule, Adam against
optax, one NGPOccTrainer.train_step against the JAX trainer's fused step from
the same parameters, grid, batch and noise, and a convergence smoke."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerfacc_tpu.ops.cp_level as jax_cp_level
from nerfacc_tpu.data.procedural import ProceduralSceneLoader as JaxLoader
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
from nerfacc_tpu.trainers.ngp_occ import NGPOccTrainer as JaxTrainer
from nerfacc_tpu.trainers.ngp_occ import make_lr_schedule as jax_lr_schedule
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
from nerfacc_tpu_torch.estimators.occ_grid import sampling
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer, TrainState, make_lr_schedule
from nerfacc_tpu_torch.utils.jax_bridge import (
    cp_field_params_from_numpy,
    occ_state_from_numpy,
)
from nerfacc_tpu_torch.utils.rendering import compact_samples, render_rays_with_occgrid

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
SMALL = dict(resolutions=(16, 32, 64), ranks=(8, 8, 8))
GRID = 32
N_RAYS = 128


@pytest.mark.parametrize("max_steps", [1000, 150])
def test_lr_schedule_matches_optax(max_steps):
    """optax evaluates the warmup in f32 (1.7e-6 off at step 0), the port in
    f64: 1e-5 relative."""
    ref = jax_lr_schedule(max_steps, 1e-2, 100)
    out = make_lr_schedule(max_steps)
    for step in (0, 1, 50, 99, 100, max_steps // 2, max_steps * 3 // 4,
                 max_steps * 9 // 10, max_steps - 1):
        assert out(step) == pytest.approx(float(ref(step)), rel=1e-5), step
    assert out(max_steps - 1) == pytest.approx(1e-2 * 0.33**3)


def test_adam_matches_optax_chain():
    """Three updates of the port's Adam and of the JAX trainer's optax chain
    on the same gradient trees (through the bridge), within 1e-6 of each
    leaf's scale.  (optax forms the bias correction 1 - 0.999^t in f32,
    which puts ~1e-5 of relative noise on an update; the gradients here are
    all far above the decay term, so no sign can flip.)"""
    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, **SMALL), aabb=AABB, max_steps=100,
        grid_resolution=GRID,
    )
    jparams = JaxField(aabb=AABB, **SMALL).init(jax.random.PRNGKey(0))
    tx = optax.chain(
        optax.add_decayed_weights(1e-6),
        optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-15),
        optax.scale_by_learning_rate(jax_lr_schedule(100, 1e-2, 100)),
    )
    tx_state = tx.init(jparams)
    params = cp_field_params_from_numpy(jax.tree.map(np.asarray, jparams))
    for p in params.values():
        p.requires_grad_(True)
    opt = trainer.init_optimizer(params)
    rng = np.random.default_rng(0)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32) * 1e-3,
            jparams,
        )
        updates, tx_state = tx.update(grads, tx_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, g in cp_field_params_from_numpy(jax.tree.map(np.asarray, grads)).items():
            params[name].grad = g
        opt = trainer.apply_gradients(opt)
        ref = cp_field_params_from_numpy(jax.tree.map(np.asarray, jparams))
        for name, p in params.items():
            want = ref[name].numpy()
            np.testing.assert_allclose(
                p.detach().numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max()
            )
    assert opt.count == 3


@pytest.fixture(scope="module")
def batch():
    """One JAX train batch (numpy), handed to both trainers."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
        ds = JaxLoader("train", n_train=4, width=24, height=24, num_rays=N_RAYS)
    return {k: np.asarray(v) for k, v in ds[0].items()}


def _gradient_recorder():
    """An optax 'optimizer' whose state becomes the gradient tree and whose
    updates are zero: the JAX step then returns its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def _jax_step(batch, stratified, budget, bf16):
    """The JAX trainer's padded-traversal step; returns its aux, gradients,
    refreshed grid, its initial state as numpy, and the step's noise."""
    jfield = JaxField(
        aabb=AABB, compute_dtype=jnp.bfloat16 if bf16 else jnp.float32, **SMALL
    )
    if bf16:  # the port follows the Pallas CP-level kernels (interpreted)
        object.__setattr__(
            jfield, "encoder", dataclasses.replace(jfield.encoder, kernel="fused")
        )
    trainer = JaxTrainer(
        field=jfield, aabb=AABB, max_steps=100, grid_resolution=GRID,
        traversal="padded", windowed=False, max_samples_per_ray=1400,
        dynamic_budget=False, sample_budget=budget, stratified=stratified,
    )
    trainer.optimizer = _gradient_recorder()
    state = trainer.init_state()
    init = (
        jax.tree.map(np.asarray, state.params),
        tuple(np.asarray(a) for a in (state.occ_state.aabbs, state.occ_state.occs,
                                      state.occ_state.binaries)),
    )
    # the step's noise, as _step_body and update_occ_grid draw it
    _, k_occ, k_strat, _ = jax.random.split(state.key, 4)
    near = np.asarray(jax.random.uniform(k_strat, (N_RAYS,)))
    cells = np.asarray(jax.random.uniform(jax.random.split(k_occ, 4)[3], (1, GRID**3, 3)))
    new, aux = trainer.train_step(state, batch)  # donates ``state``
    grads = cp_field_params_from_numpy(jax.tree.map(np.asarray, new.opt_state))
    aux = {k: np.asarray(v) for k, v in aux.items()}
    occ = (np.asarray(new.occ_state.occs), np.asarray(new.occ_state.binaries))
    return aux, grads, occ, init, near, cells


def _f64_witness(trainer, params, occ_state, batch, near_jitter):
    """The port's step in float64: its loss and gradients on the samples its
    f32 step marched (same refreshed grid, rays, noise and budget cut), with
    the parameters, rays and sample bounds in float64 through the CPU
    twins.  Returns (loss, {name: gradient})."""
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    samples = compact_samples(
        sampling(
            occ_state, rays_o, rays_d, render_step_size=trainer.render_step_size,
            near_jitter=near_jitter if trainer.stratified else None,
        ),
        trainer.sample_budget,
    )
    samples = samples._replace(
        t_starts=samples.t_starts.double(), t_ends=samples.t_ends.double()
    )
    p64 = {k: v.detach().double().requires_grad_(True) for k, v in params.items()}

    def rgb_sigma_fn(positions, dirs):
        rgb, density = torch.func.functional_call(trainer.field, p64, (positions, dirs))
        return rgb, density[..., 0]

    colors = render_rays_with_occgrid(
        rgb_sigma_fn, rays_o.double(), rays_d.double(), samples,
        batch["color_bkgd"].double(),
    )[0]
    ray_ok = (torch.arange(N_RAYS) < samples.first_incomplete_ray)[:, None]
    diff = (colors - batch["rgb"].double()).abs() * ray_ok
    loss = torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5).sum() / (ray_ok.sum() * 3)
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in p64.items()}


@pytest.mark.parametrize(
    "stratified,budget,bf16",
    [(False, 2**18, False), (True, 2**18, False), (True, 12000, False),
     (True, 2**18, True)],
    ids=["f32", "f32-stratified", "f32-budget-cut", "bf16-stratified"],
)
def test_train_step_matches_jax(batch, monkeypatch, stratified, budget, bf16):
    """Tolerances.  Loss and mse: 1e-5 relative.  Counts: equal.  f32
    gradients: each leaf of the port within 1e-4 of its largest entry from
    the same step in float64 (:func:`_f64_witness`; the port reads 2.7e-6
    unstratified, 2.6e-5 and 6.3e-5 stratified).  Against JAX: within 1e-3
    of the largest entry and 3e-4 in relative Frobenius norm, the f32 noise
    floor of the JAX side, whose density gradients difference a global
    cumsum of the cotangents and whose table and base-MLP gradients sum
    them with cancellation (unstratified, its leaves lie up to 2.7e-4 of
    their max from the float64 step).  bf16: relative Frobenius 5e-3 per
    leaf against JAX (tests/test_cp_level.py's bound for the same bf16
    cotangent rounding).  The refreshed grid: equal except where the two
    occupancies straddle the threshold."""
    if bf16:
        interpreted = jax_cp_level.cp_level_encode
        monkeypatch.setattr(
            jax_cp_level, "cp_level_encode", lambda x, lines: interpreted(x, lines, True)
        )
    ref, ref_grads, (ref_occs, ref_bin), (jparams, jocc), near, cells = _jax_step(
        batch, stratified, budget, bf16
    )
    trainer = NGPOccTrainer(
        field=CPRadianceField(
            AABB, compute_dtype=torch.bfloat16 if bf16 else torch.float32, **SMALL
        ),
        aabb=AABB, max_steps=100, grid_resolution=GRID, sample_budget=budget,
        stratified=stratified,
    )
    params = cp_field_params_from_numpy(jparams)
    for p in params.values():
        p.requires_grad_(True)
    state = TrainState(params, trainer.init_optimizer(params), occ_state_from_numpy(*jocc), 0)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    new, aux = trainer.train_step(
        state, tbatch, near_jitter=torch.tensor(near), cell_jitter=torch.tensor(cells),
    )

    occs, binaries = new.occ_state.occs.numpy(), new.occ_state.binaries.numpy()
    np.testing.assert_allclose(occs, ref_occs, rtol=1e-2 if bf16 else 1e-5, atol=0)
    thre = min(float(occs[occs >= 0].mean()), trainer.occ_thre)
    differ = binaries.reshape(-1) != ref_bin.reshape(-1)
    near_thre = np.abs(ref_occs - thre) <= np.abs(occs - ref_occs) + 1e-6
    assert (near_thre | ~differ).all() and differ.mean() < 1e-3
    assert 0.05 < binaries.mean() < 0.95

    for key in ("loss", "mse"):
        assert float(aux[key]) == pytest.approx(float(ref[key]), rel=1e-5), key
    for key in ("n_rays_ok", "n_rendering_samples", "n_total_samples", "overflow"):
        assert int(aux[key]) == int(ref[key]), key
    assert int(aux["n_rays_truncated"]) == int(ref["n_rays_truncated"]) == 0
    if budget < 2**18:  # the cut masks the rays it left incomplete
        assert aux["overflow"] > 0 and int(aux["n_rays_ok"]) < N_RAYS
    for name, p in params.items():
        g, want = p.grad.numpy(), ref_grads[name].numpy()
        rel_fro = np.linalg.norm(g - want) / np.linalg.norm(want)
        assert rel_fro <= (5e-3 if bf16 else 3e-4), (name, rel_fro)
        if not bf16:
            np.testing.assert_allclose(g, want, rtol=0, atol=1e-3 * np.abs(want).max())
    assert new.step == 1 and new.opt_state.count == 1
    if bf16:  # the bf16 contract rounds to bf16 whatever the carrier dtype
        return

    loss64, grads64 = _f64_witness(
        trainer, cp_field_params_from_numpy(jparams), new.occ_state, tbatch,
        torch.tensor(near),
    )
    assert float(aux["loss"]) == pytest.approx(loss64, rel=1e-5)
    for name, p in params.items():
        g64 = grads64[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), g64, rtol=0, atol=1e-4 * np.abs(g64).max())


def test_train_steps_converge_on_the_port_alone():
    """30 steps of the port's trainer through its own entry points lower the
    loss (the smoke test of tests/test_trainers.py:37)."""
    ds = ProceduralSceneLoader("train", n_train=4, width=24, height=24, num_rays=128)
    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, **SMALL), aabb=AABB, max_steps=30,
        grid_resolution=GRID, sample_budget=2**15, update_interval=8,
    )
    state = trainer.init_state()
    batches = [ds[0] for _ in range(30)]
    state, aux = trainer.train_steps(
        state, {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    )
    losses = aux["loss"].numpy()
    assert aux["loss"].shape == (30,) and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean(), losses
    assert state.step == 30 and state.opt_state.count == 30
    assert (aux["n_rendering_samples"] <= 2**15).all()
    for p in state.params.values():
        assert torch.isfinite(p).all() and p.grad is not None
