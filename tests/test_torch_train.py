"""Port vs JAX, the train slice: the learning-rate schedule, Adam against
optax, one NGPOccTrainer.train_step against the JAX trainer's fused step from
the same parameters, grid, batch and noise (CP, hash-grid NGP and the
time-dependent TiNeuVox fields), and convergence smokes."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerfacc_tpu.ops
import nerfacc_tpu.ops.cp_level as jax_cp_level
from nerfacc_tpu.data.procedural import ProceduralDynamicSceneLoader as JaxDynamicLoader
from nerfacc_tpu.data.procedural import ProceduralSceneLoader as JaxLoader
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
from nerfacc_tpu.models.ngp import NGPRadianceField as JaxNGPField
from nerfacc_tpu.models.tineuvox import TiNeuVoxRadianceField as JaxTiNeuVox
from nerfacc_tpu.ops.hat_matmul import hat_interp_matmul as jax_hat
from nerfacc_tpu.trainers.ngp_occ import NGPOccTrainer as JaxTrainer
from nerfacc_tpu.trainers.ngp_occ import make_lr_schedule as jax_lr_schedule
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
from nerfacc_tpu_torch.estimators.occ_grid import sampling
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.models.ngp import NGPRadianceField
from nerfacc_tpu_torch.models.tineuvox import TiNeuVoxRadianceField
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer, TrainState, make_lr_schedule
from nerfacc_tpu_torch.utils.jax_bridge import (
    cp_field_params_from_numpy,
    ngp_field_params_from_numpy,
    occ_state_from_numpy,
    tineuvox_field_params_from_numpy,
)
from nerfacc_tpu_torch.utils.rendering import compact_samples, render_rays_with_occgrid
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
SMALL = dict(resolutions=(16, 32, 64), ranks=(8, 8, 8))
NGP_SMALL = dict(n_levels=4, log2_hashmap_size=12, max_resolution=64)
GRID = 32
N_RAYS = 128


@pytest.mark.parametrize("max_steps", [1000, 150, 400])
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
        grid_resolution=GRID, device="cpu",
    )
    jparams = JaxField(aabb=AABB, **SMALL).init(jax.random.PRNGKey(0))
    tx = optax.chain(
        optax.add_decayed_weights(1e-6),
        optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-15),
        optax.scale_by_learning_rate(jax_lr_schedule(100, 1e-2, 100)),
    )
    tx_state = tx.init(jparams)
    params = cp_field_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
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
        tgrads = cp_field_params_from_numpy(jax.tree.map(np.asarray, grads), device="cpu")
        for name, g in tgrads.items():
            params[name].grad = g
        opt = trainer.apply_gradients(opt)
        ref = cp_field_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
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


def _port_field(kind, dtype):
    """The port's field of ``kind`` ("cp" or "ngp") at the small size."""
    if kind == "cp":
        return CPRadianceField(AABB, compute_dtype=dtype, **SMALL)
    return NGPRadianceField(AABB, compute_dtype=dtype, **NGP_SMALL)


# the bridge from JAX parameter trees to each port field's state dict
FROM_NUMPY = {"cp": cp_field_params_from_numpy, "ngp": ngp_field_params_from_numpy}


def _jax_step(batch, stratified, budget, bf16, kind, max_samples=1400):
    """The JAX trainer's padded-traversal step, each ray's lattice
    ``max_samples`` candidates (1400 reach past every orbit); returns its
    aux, gradients, refreshed grid, its initial state as numpy, and the
    step's noise."""
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    if kind == "cp":
        jfield = JaxField(aabb=AABB, compute_dtype=dtype, **SMALL)
    else:
        # XLA's scatter-add table gradient: the same values as the default
        # sorted blocks (tests/test_torch_hash.py), whose buffers at this
        # padded sample count exceed a CPU's memory
        jfield = JaxNGPField(
            aabb=AABB, compute_dtype=dtype, table_grad="scatter", **NGP_SMALL
        )
    if bf16 and kind == "cp":  # the port follows the Pallas CP-level kernels
        object.__setattr__(
            jfield, "encoder", dataclasses.replace(jfield.encoder, kernel="fused")
        )
    trainer = JaxTrainer(
        field=jfield, aabb=AABB, max_steps=100, grid_resolution=GRID,
        traversal="padded", windowed=False, max_samples_per_ray=max_samples,
        dynamic_budget=False, sample_budget=budget, stratified=stratified,
    )
    trainer.optimizer = _gradient_recorder()
    state = trainer.init_state()
    if kind == "ngp":  # an O(1) table, so the untrained densities differ
        params = dict(state.params, encoder=state.params["encoder"] * 1e4)
        state = state._replace(params=params)
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
    grads = FROM_NUMPY[kind](jax.tree.map(np.asarray, new.opt_state), device="cpu")
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

    def rgb_sigma_fn(positions, dirs, _ray_indices):
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
    "kind,stratified,budget,bf16",
    [
        pytest.param("cp", False, 2**18, False, id="f32"),
        pytest.param("cp", True, 2**18, False, id="f32-stratified"),
        pytest.param("cp", True, 12000, False, id="f32-budget-cut"),
        pytest.param("cp", True, 2**18, True, id="bf16-stratified"),
        pytest.param("ngp", True, 2**18, False, id="ngp-f32-stratified"),
        pytest.param("ngp", True, 12000, False, id="ngp-f32-budget-cut"),
        pytest.param("ngp", True, 2**18, True, id="ngp-bf16-stratified"),
    ],
)
def test_train_step_matches_jax(batch, monkeypatch, kind, stratified, budget, bf16):
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
    occupancies straddle the threshold.  The hash-grid NGP field (4
    levels, T = 2^12, resolutions 16..64; its table scaled to O(1)) is held
    to the same bounds against JAX, and against the float64 step to 1e-4 or
    JAX's own distance from it, whichever is larger (see below)."""
    if bf16 and kind == "cp":
        interpreted = jax_cp_level.cp_level_encode
        monkeypatch.setattr(
            jax_cp_level, "cp_level_encode", lambda x, lines: interpreted(x, lines, True)
        )
    ref, ref_grads, (ref_occs, ref_bin), (jparams, jocc), near, cells = _jax_step(
        batch, stratified, budget, bf16, kind
    )
    trainer = NGPOccTrainer(
        field=_port_field(kind, torch.bfloat16 if bf16 else torch.float32),
        aabb=AABB, max_steps=100, grid_resolution=GRID, sample_budget=budget,
        stratified=stratified, device="cpu",
    )
    params = FROM_NUMPY[kind](jparams, device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    occ_state = occ_state_from_numpy(*jocc, device="cpu")
    state = TrainState(params, trainer.init_optimizer(params), occ_state, 0)
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
        trainer, FROM_NUMPY[kind](jparams, device="cpu"), new.occ_state, tbatch,
        torch.tensor(near),
    )
    assert float(aux["loss"]) == pytest.approx(loss64, rel=1e-5)
    for name, p in params.items():
        g64 = grads64[name].numpy()
        atol = 1e-4 * np.abs(g64).max()
        if kind == "ngp":
            # the hash features move with the f32 rounding of x * res (up to
            # 2^-18 of a cell at res 64), which the f64 step does not share:
            # the table and first-layer gradients of both f32 steps lie
            # ~2e-3 of their max from it, the port no farther than JAX
            atol = max(atol, 1.1 * np.abs(ref_grads[name].numpy() - g64).max())
        np.testing.assert_allclose(p.grad.numpy(), g64, rtol=0, atol=atol)


@pytest.mark.parametrize("traversal,windowed", [("padded", True), ("pooled", False)],
                         ids=["padded", "windowed-false"])
def test_padded_train_step_matches_jax(batch, traversal, windowed):
    """``traversal="padded"`` (or ``windowed=False``, which asks for it)
    cuts each ray at ``max_samples_per_ray`` orbit candidates, as the JAX
    trainer's padded step does: at 1000 candidates from the near plane
    some rays stop short of their orbit's end and are not terminated, and
    once more than a quarter of the rays terminate or saturate, the others
    leave the loss.  Against JAX's padded step (:func:`_jax_step`) from the
    same state, batch and noise: the counts equal (the truncated rays and
    the rays in the loss included), loss and mse within 1e-5 relative, and
    each gradient leaf within 3e-4 in relative Frobenius norm and 1e-3 of
    its largest entry, :func:`test_train_step_matches_jax`'s f32 bounds."""
    ref, ref_grads, _, (jparams, jocc), near, cells = _jax_step(
        batch, True, 2**18, False, "cp", max_samples=1000
    )
    trainer = NGPOccTrainer(
        field=_port_field("cp", torch.float32), aabb=AABB, max_steps=100,
        grid_resolution=GRID, traversal=traversal, windowed=windowed,
        max_samples_per_ray=1000, device="cpu",
    )
    params = cp_field_params_from_numpy(jparams, device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    state = TrainState(params, trainer.init_optimizer(params),
                       occ_state_from_numpy(*jocc, device="cpu"), 0)
    _, aux = trainer.train_step(
        state, {k: torch.tensor(v) for k, v in batch.items()},
        near_jitter=torch.tensor(near), cell_jitter=torch.tensor(cells),
    )
    for key in ("n_rays_ok", "n_rendering_samples", "n_total_samples", "overflow",
                "n_rays_truncated"):
        assert int(aux[key]) == int(ref[key]), key
    assert 0 < int(aux["n_rays_truncated"]) < N_RAYS
    assert int(aux["n_rays_ok"]) == N_RAYS - int(aux["n_rays_truncated"])
    for key in ("loss", "mse"):
        assert float(aux[key]) == pytest.approx(float(ref[key]), rel=1e-5), key
    for name, p in params.items():
        g, want = p.grad.numpy(), ref_grads[name].numpy()
        assert np.linalg.norm(g - want) <= 3e-4 * np.linalg.norm(want), name
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-3 * np.abs(want).max())


TNV_SMALL = dict(resolutions=(16, 32, 64), ranks=(8, 8, 8))
TNV_RAYS = 64
# the example's TiNeuVox settings beside the trainer's defaults
# (examples/train_mlp_tnerf.py:126-145: lr 1e-2, Adam eps 1e-15 and 100
# warmup steps are the defaults of both trainers)
TNV_TRAINER = dict(weight_decay=0.0, field_reg_weight=1e-4)


@pytest.fixture(scope="module")
def dynamic_batch():
    """One train batch of the JAX dynamic scene (numpy) and its frame
    times."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")
        ds = JaxDynamicLoader("train", n_train=5, width=24, height=24, num_rays=TNV_RAYS)
    return {k: np.asarray(v) for k, v in ds[0].items()}, np.asarray(ds.timestamps)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_tineuvox_train_step_matches_jax(dynamic_batch, monkeypatch, bf16):
    """A time-dependent step (per-ray times, one random frame per cell in the
    refresh, the TV regulariser) against the JAX trainer's padded-traversal
    step with the TiNeuVox field on its hat-matmul route, K3 interpreted,
    from the same parameters (the warp scaled up from its rigid init) and
    JAX's noise, the refresh's frame draw included.  Loss and mse 1e-5
    relative, counts equal; gradients nonzero on every leaf, and in the f32
    field within 1e-3 of each leaf's largest entry from JAX's; in the bf16
    field 2e-2 in relative Frobenius norm, for the reason given in
    tests/test_torch_tineuvox.py::test_gradients_match_jax.  The refreshed
    occupancies within 1e-2 relative (the warp's last-bit differences flip
    bf16 hat weights), the binaries equal where not within that of the
    threshold."""
    batch, timestamps = dynamic_batch
    monkeypatch.setattr(
        nerfacc_tpu.ops, "hat_interp_matmul", lambda x, line: jax_hat(x, line, True)
    )
    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    jfield = JaxTiNeuVox(aabb=AABB, compute_dtype=jdtype, **TNV_SMALL)
    object.__setattr__(
        jfield, "encoder", dataclasses.replace(jfield.encoder, use_pallas=True)
    )
    jtrainer = JaxTrainer(
        field=jfield, aabb=AABB, max_steps=100, grid_resolution=GRID,
        traversal="padded", windowed=False, max_samples_per_ray=1400,
        dynamic_budget=False, sample_budget=2**16, timestamps=timestamps,
        time_dependent=True, **TNV_TRAINER,
    )
    jtrainer.optimizer = _gradient_recorder()
    jstate = jtrainer.init_state()
    params = dict(jstate.params)
    params["deform"] = params["deform"][:-1] + [params["deform"][-1] * 3e3]
    jstate = jstate._replace(params=params)
    jparams = jax.tree.map(np.asarray, jstate.params)
    jocc = tuple(np.asarray(a) for a in (jstate.occ_state.aabbs, jstate.occ_state.occs,
                                         jstate.occ_state.binaries))
    _, k_occ, k_strat, k_time = jax.random.split(jstate.key, 4)
    near = np.asarray(jax.random.uniform(k_strat, (TNV_RAYS,)))
    cells = np.asarray(jax.random.uniform(jax.random.split(k_occ, 4)[3], (1, GRID**3, 3)))
    frames = np.asarray(jax.random.randint(k_time, (GRID**3,), 0, timestamps.shape[0]))
    new, ref = jtrainer.train_step(jstate, batch)  # donates ``jstate``
    ref_grads = tineuvox_field_params_from_numpy(
        jax.tree.map(np.asarray, new.opt_state), device="cpu"
    )
    ref_occs = np.asarray(new.occ_state.occs)

    field = TiNeuVoxRadianceField(
        AABB, compute_dtype=torch.bfloat16 if bf16 else torch.float32, device="cpu",
        **TNV_SMALL,
    )
    trainer = NGPOccTrainer(
        field=field, aabb=AABB, max_steps=100, grid_resolution=GRID,
        sample_budget=2**16, timestamps=timestamps, device="cpu", **TNV_TRAINER,
    )
    tparams = tineuvox_field_params_from_numpy(jparams, device="cpu")
    for p in tparams.values():
        p.requires_grad_(True)
    state = TrainState(
        tparams, trainer.init_optimizer(tparams), occ_state_from_numpy(*jocc, device="cpu"), 0
    )
    out, aux = trainer.train_step(
        state, {k: torch.tensor(v) for k, v in batch.items()},
        near_jitter=torch.tensor(near), cell_jitter=torch.tensor(cells),
        frame_idx=torch.tensor(frames),
    )

    occs = out.occ_state.occs.numpy()
    np.testing.assert_allclose(occs, ref_occs, rtol=1e-2, atol=0)
    thre = min(float(occs[occs >= 0].mean()), trainer.occ_thre)
    differ = out.occ_state.binaries.numpy().reshape(-1) != np.asarray(new.occ_state.binaries).reshape(-1)
    assert (~differ | (np.abs(ref_occs - thre) <= 1e-2 * thre)).all()
    for key in ("loss", "mse"):
        assert float(aux[key]) == pytest.approx(float(ref[key]), rel=1e-5), key
    for key in ("n_rays_ok", "n_rendering_samples", "n_total_samples", "overflow"):
        assert int(aux[key]) == int(ref[key]), key
    for name, p in tparams.items():
        got, want = p.grad.numpy(), ref_grads[name].numpy()
        assert np.abs(got).max() > 0 and np.abs(want).max() > 0, name
        if bf16:
            assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want), name
        else:
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-3 * np.abs(want).max(), err_msg=name
            )


def _converge(kind):
    ds = ProceduralSceneLoader(
        "train", n_train=4, width=24, height=24, num_rays=128, device="cpu"
    )
    trainer = NGPOccTrainer(
        field=_port_field(kind, torch.bfloat16), aabb=AABB, max_steps=30,
        grid_resolution=GRID, sample_budget=2**15, update_interval=8, device="cpu",
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


def test_train_steps_converge_on_the_port_alone():
    """30 steps of the port's trainer through its own entry points lower the
    loss (the smoke test of tests/test_trainers.py:37)."""
    _converge("cp")


def test_ngp_train_steps_converge_on_the_port_alone():
    """The same for the hash-grid NGP field from its own init (table
    U(-1e-4, 1e-4))."""
    _converge("ngp")


def test_tineuvox_train_steps_converge_on_the_port_alone():
    """30 time-dependent steps of the TiNeuVox field on the dynamic scene,
    from its own rigid init, with the example's optimiser: the loss falls
    and the deformation network moves."""
    from nerfacc_tpu_torch.data.procedural import ProceduralDynamicSceneLoader

    ds = ProceduralDynamicSceneLoader(
        "train", n_train=4, width=24, height=24, num_rays=128, device="cpu"
    )
    trainer = NGPOccTrainer(
        field=TiNeuVoxRadianceField(AABB, device="cpu", **TNV_SMALL), aabb=AABB,
        max_steps=30, grid_resolution=GRID, sample_budget=2**15, update_interval=8,
        timestamps=ds.timestamps, device="cpu", **TNV_TRAINER,
    )
    state = trainer.init_state()
    deform0 = {k: v.detach().clone() for k, v in state.params.items() if k.startswith("deform")}
    batches = [ds[0] for _ in range(30)]
    state, aux = trainer.train_steps(
        state, {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    )
    losses = aux["loss"].numpy()
    assert np.isfinite(losses).all() and losses[-5:].mean() < losses[:5].mean(), losses
    for k, v in deform0.items():
        assert not torch.equal(state.params[k], v), k


@pytest.mark.parametrize("options", [
    dict(grad_clip=1.0), dict(table_lr_mult=3.0), dict(distortion_loss_weight=1e-2),
    dict(grad_clip=1.0, table_lr_mult=3.0, distortion_loss_weight=1e-2),
], ids=["clip", "table-mult", "distortion", "all"])
def test_train_options_match_jax(batch, options):
    """``grad_clip`` (the global norm of Adam's update, clipped before the
    learning rate), ``table_lr_mult`` (the ``encoder`` tables' update scaled
    after the clip) and ``distortion_loss_weight``: one port step against the
    JAX trainer's padded-traversal step with its real optax chain, from the
    same parameters with JAX's noise.  The loss within 1e-5 relative; each
    leaf's update within 1e-3 of JAX's in relative Frobenius norm (Adam's
    first update is about the sign of each gradient entry, so a near-zero
    entry whose sign differs by rounding moves by up to twice the step).
    The clip at 1.0 binds: Adam's first update has a global norm of about
    sqrt(entries).  The chain's order is held exactly in
    :func:`test_chain_adam_matches_optax_chain`."""
    jtrainer = JaxTrainer(
        field=JaxField(aabb=AABB, compute_dtype=jnp.float32, **SMALL), aabb=AABB,
        max_steps=100, grid_resolution=GRID, traversal="padded", windowed=False,
        max_samples_per_ray=1400, dynamic_budget=False, sample_budget=2**18, **options,
    )
    jstate = jtrainer.init_state()
    jparams = jax.tree.map(np.asarray, jstate.params)
    jocc = tuple(np.asarray(a) for a in (jstate.occ_state.aabbs, jstate.occ_state.occs,
                                         jstate.occ_state.binaries))
    _, k_occ, k_strat, _ = jax.random.split(jstate.key, 4)
    near = np.asarray(jax.random.uniform(k_strat, (N_RAYS,)))
    cells = np.asarray(jax.random.uniform(jax.random.split(k_occ, 4)[3], (1, GRID**3, 3)))
    new, ref = jtrainer.train_step(jstate, batch)  # donates ``jstate``
    want = cp_field_params_from_numpy(jax.tree.map(np.asarray, new.params), device="cpu")

    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, compute_dtype=torch.float32, **SMALL), aabb=AABB,
        max_steps=100, grid_resolution=GRID, device="cpu", **options,
    )
    start = cp_field_params_from_numpy(jparams, device="cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
    state = TrainState(params, trainer.init_optimizer(params),
                       occ_state_from_numpy(*jocc, device="cpu"), 0)
    _, aux = trainer.train_step(
        state, {k: torch.tensor(v) for k, v in batch.items()},
        near_jitter=torch.tensor(near), cell_jitter=torch.tensor(cells),
    )
    assert float(aux["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-5)
    for name, p in params.items():
        got = (p.detach() - start[name]).numpy()
        ref_up = (want[name] - start[name]).numpy()
        assert np.linalg.norm(got - ref_up) <= 1e-3 * np.linalg.norm(ref_up), name


@pytest.mark.parametrize("clip", [0.0, 0.5, 1e3], ids=["no-clip", "binds", "loose"])
def test_chain_adam_matches_optax_chain(clip):
    """:class:`ChainAdam` against optax's chain in the JAX trainer's order
    (weight decay, ``scale_by_adam``, ``clip_by_global_norm``, the masked
    table scale, the learning rate) over three updates of random gradients:
    each update within 3e-5 of its largest entry (optax forms Adam's bias
    correction ``1 - 0.999^t`` in f32, ~1e-5 of relative noise on an
    update; read 1.02e-5).  The leaves start at 0, so that a parameter's
    change is its update to within an ulp of the parameter; where the clip
    binds, the updates' global norm before the table scale is lr x clip."""
    from nerfacc_tpu_torch.trainers.ngp_occ import ChainAdam

    rng = np.random.default_rng(0)
    shapes = {"encoder": (3, 8, 4), "mlp": (16, 5)}
    tx = optax.chain(
        optax.add_decayed_weights(1e-3),
        optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-15),
        *([optax.clip_by_global_norm(clip)] if clip else []),
        optax.masked(optax.scale(3.0), {"encoder": True, "mlp": False}),
        optax.scale_by_learning_rate(1e-2),
    )
    jp = {k: jnp.zeros(s) for k, s in shapes.items()}
    st = tx.init(jp)
    leaves = {k: torch.zeros(s, requires_grad=True) for k, s in shapes.items()}
    opt = ChainAdam(leaves.values(), lr=1e-2, weight_decay=1e-3, max_norm=clip, scale=3.0,
                    scaled=[True, False])
    for _ in range(3):
        grads = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
        before = {k: v.detach().clone() for k, v in leaves.items()}
        up, st = tx.update({k: jnp.asarray(g) for k, g in grads.items()}, st, jp)
        jp = optax.apply_updates(jp, up)
        for k, v in leaves.items():
            v.grad = torch.tensor(grads[k])
        opt.step()
        norm2 = 0.0
        for k, v in leaves.items():
            got = (v.detach() - before[k]).numpy()
            want = np.asarray(up[k])
            np.testing.assert_allclose(got, want, rtol=0, atol=3e-5 * np.abs(want).max())
            norm2 += float(((got / (3.0 if k == "encoder" else 1.0)) ** 2).sum())
        if clip == 0.5:
            assert np.sqrt(norm2) == pytest.approx(1e-2 * clip, rel=1e-5)


def test_table_lr_mult_warns_without_tables():
    """As the JAX trainer: a table multiplier on a field with no
    ``encoder`` entries warns that it does nothing."""
    class NoTables(CPRadianceField):
        def state_dict(self, *a, **k):
            return {f"w.{k}": v for k, v in super().state_dict(*a, **k).items()}

    trainer = NGPOccTrainer(field=NoTables(AABB, **SMALL), aabb=AABB, grid_resolution=GRID,
                            table_lr_mult=2.0, device="cpu")
    with pytest.warns(UserWarning, match="table_lr_mult"):
        trainer.init_state()


def test_checkpoint_resumes_the_update_clip(batch, tmp_path):
    """A state trained with ``grad_clip`` and ``table_lr_mult`` comes back
    from a checkpoint with its own optimizer (a :class:`ChainAdam` with
    the same settings and moments), so the next step is bit for bit the
    step of the state that was never saved."""
    from nerfacc_tpu_torch.trainers.ngp_occ import ChainAdam
    from nerfacc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, compute_dtype=torch.float32, **SMALL), aabb=AABB,
        max_steps=100, grid_resolution=GRID, grad_clip=1.0, table_lr_mult=3.0,
        device="cpu",
    )
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    near = torch.rand(N_RAYS, generator=torch.Generator().manual_seed(0))
    state, _ = trainer.train_step(trainer.init_state(), tbatch, near_jitter=near)
    path = tmp_path / "ckpt.pt"
    save_checkpoint(str(path), state)
    resumed = load_checkpoint(str(path), like=trainer.init_state(), device="cpu")
    opt = resumed.opt_state.optimizer
    assert isinstance(opt, ChainAdam)
    assert opt.defaults == state.opt_state.optimizer.defaults
    outs = [trainer.train_step(s, tbatch, near_jitter=near)[0] for s in (state, resumed)]
    for name in outs[0].params:
        torch.testing.assert_close(outs[1].params[name], outs[0].params[name], rtol=0, atol=0)
