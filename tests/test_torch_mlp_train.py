"""Port vs JAX, the trainer's learning-rate settings and one train step of
the dynamic example's T-NeRF and K-Planes fields: ``lr``, ``adam_eps`` and
``warmup_lr_steps`` against optax (warmup 0 included), and one
``NGPOccTrainer.train_step`` against the JAX trainer's padded-traversal
step from the same parameters, grid, batch and noise (the refresh's frame
draw included), at the example's settings."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import nerfacc_tpu.models.mlp as jax_mlp
from nerfacc_tpu.data.procedural import ProceduralDynamicSceneLoader as JaxDynamicLoader
from nerfacc_tpu.estimators.occ_grid import sampling_padded as jax_sampling_padded
from nerfacc_tpu.models.kplanes import KPlanesRadianceField as JaxKPlanes
from nerfacc_tpu.models.mlp import TNeRFRadianceField as JaxTNeRF
from nerfacc_tpu.trainers.ngp_occ import NGPOccTrainer as JaxTrainer
from nerfacc_tpu.trainers.ngp_occ import make_lr_schedule as jax_lr_schedule
from nerfacc_tpu.utils.rendering import compact_samples as jax_compact_samples
from nerfacc_tpu_torch.estimators.occ_grid import sampling
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.models.kplanes import KPlanesRadianceField
from nerfacc_tpu_torch.models.mlp import TNeRFRadianceField
from nerfacc_tpu_torch.trainers.ngp_occ import (
    NGPOccTrainer,
    TrainState,
    make_adam,
    make_lr_schedule,
)
from nerfacc_tpu_torch.utils import jax_bridge
from nerfacc_tpu_torch.utils.jax_bridge import field_params_from_numpy, occ_state_from_numpy
from nerfacc_tpu_torch.utils.rendering import compact_samples, render_rays_with_occgrid
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
GRID = 16
N_RAYS = 32


@pytest.mark.parametrize("max_steps,base_lr,warmup", [
    (1000, 5e-4, 0), (400, 1e-2, 100), (150, 3e-3, 37), (20, 5e-3, 0),
])
def test_lr_schedule_matches_optax(max_steps, base_lr, warmup):
    """``make_lr_schedule(max_steps, lr, warmup)`` against the JAX
    package's optax schedule at every step, warmup 0 (the constant
    schedule until the first decay) included; 1e-5 relative (optax's
    warmup runs in f32)."""
    ref = jax_lr_schedule(max_steps, base_lr, warmup)
    out = make_lr_schedule(max_steps, base_lr, warmup)
    for step in range(max_steps + 2):
        assert out(step) == pytest.approx(float(ref(step)), rel=1e-5), step
    if warmup == 0:
        assert out(0) == base_lr


def test_trainer_defaults_match_jax_and_leave_the_schedule_as_it_was():
    """The fields ``lr``, ``adam_eps`` and ``warmup_lr_steps`` take the
    JAX trainer's defaults, and with them the schedule and Adam are those
    the trainer had before it took the fields: lr 1e-2, warmup 100, eps
    1e-15."""
    jax_defaults = {f.name: f.default for f in dataclasses.fields(JaxTrainer)}
    trainer = NGPOccTrainer(field=CPRadianceField(AABB, resolutions=(8,), ranks=(4,)),
                            aabb=AABB, max_steps=300, device="cpu")
    for name in ("lr", "adam_eps", "warmup_lr_steps"):
        assert getattr(trainer, name) == jax_defaults[name], name
    assert (trainer.lr, trainer.adam_eps, trainer.warmup_lr_steps) == (1e-2, 1e-15, 100)
    for step in range(0, 301, 7):
        assert trainer.schedule(step) == make_lr_schedule(300)(step)
    opt = trainer.init_state().opt_state.optimizer
    assert type(opt) is torch.optim.Adam and opt.defaults["eps"] == 1e-15


@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["adam", "chain"])
def test_adam_eps_matches_optax(clip):
    """Three updates with eps 1e-8, lr 5e-4 and no warmup (the MLP
    examples' settings), plain Adam and the clipped chain, against optax's
    chain on the same gradients, within 1e-6 of each leaf's scale."""
    rng = np.random.default_rng(0)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((5, 3), (7,))]
    tx = optax.chain(
        optax.add_decayed_weights(0.0), optax.scale_by_adam(eps=1e-8),
        *([optax.clip_by_global_norm(clip)] if clip else []),
        optax.scale_by_learning_rate(jax_lr_schedule(100, 5e-4, 0)))
    jparams = [jnp.asarray(p) for p in leaves]
    tx_state = tx.init(jparams)
    params = [torch.tensor(p, requires_grad=True) for p in leaves]
    schedule = make_lr_schedule(100, 5e-4, 0)
    opt = make_adam(params, schedule, 0.0, grad_clip=clip, eps=1e-8)
    assert opt.optimizer.defaults["eps"] == 1e-8
    for _ in range(3):
        # small gradients, where eps 1e-8 against 1e-15 moves the update
        grads = [rng.standard_normal(p.shape).astype(np.float32) * 1e-8 for p in leaves]
        updates, tx_state = tx.update([jnp.asarray(g) for g in grads], tx_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, g in zip(params, grads):
            p.grad = torch.tensor(g)
        lr = schedule(opt.count)
        for group in opt.optimizer.param_groups:
            group["lr"] = lr
        opt.optimizer.step()
        opt = opt._replace(count=opt.count + 1)
    for p, want in zip(params, jparams):
        want = np.asarray(want)
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.fixture(scope="module")
def dynamic_batch():
    """One train batch of the JAX dynamic scene (numpy) and its frame
    times."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")
        ds = JaxDynamicLoader("train", n_train=4, width=16, height=16, num_rays=N_RAYS)
    return {k: np.asarray(v) for k, v in ds[0].items()}, np.asarray(ds.timestamps)


def _gradient_recorder():
    """An optax 'optimizer' whose state becomes the gradient tree and whose
    updates are zero: the JAX step then returns its gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


KPLANES_SMALL = dict(resolutions=(8, 16), ranks=(4, 4))
# field -> (JAX field, port field, the example's trainer settings:
# examples/train_mlp_tnerf.py:103-123)
CASES = {
    "tnerf": (lambda: JaxTNeRF(), lambda: TNeRFRadianceField(device="cpu"),
              dict(lr=5e-4, adam_eps=1e-8, warmup_lr_steps=0, field_reg_weight=0.0)),
    "kplanes": (lambda: JaxKPlanes(aabb=AABB, **KPLANES_SMALL),
                lambda: KPlanesRadianceField(AABB, device="cpu", **KPLANES_SMALL),
                dict(lr=1e-2, adam_eps=1e-15, warmup_lr_steps=100, field_reg_weight=1e-3)),
}


def _linear64(p, x, compute_dtype=None):
    return jnp.dot(x, p["w"]) + p["b"]


def _jax64_step(jtrainer, jparams, occ_state, batch, k_strat):
    """The JAX step in float64, the witness independent of the port: the
    samples that JAX's f32 step marched (its refreshed grid, rays, jitter
    and budget cut) through the JAX field on float64 parameters, whose
    ``_linear`` is swapped for the same product and bias in the operands'
    dtype (it asks its dots for an f32 result), and the volume-rendering
    sum and the trainer's loss written out in float64.  Returns (loss,
    {name: gradient}, the valid samples' ``(ray_indices, t_starts,
    t_ends)``)."""
    res = jax_sampling_padded(
        occ_state, jnp.asarray(batch["rays_o"]), jnp.asarray(batch["rays_d"]),
        near_plane=jtrainer.near_plane, far_plane=jtrainer.far_plane,
        render_step_size=jtrainer.render_step_size, alpha_thre=jtrainer.alpha_thre,
        early_stop_eps=jtrainer.early_stop_eps, stratified=jtrainer.stratified,
        cone_angle=jtrainer.cone_angle, key=k_strat, max_samples=jtrainer.max_samples_per_ray,
        n_windows=jtrainer.n_windows, window_size=jtrainer.window_size,
        max_coarse=max(jtrainer.max_samples_per_ray // jtrainer.window_size + 32, 64),
    )
    # every ray ended inside the grid, so the loss masks only the budget cut
    assert np.asarray(res.terminated).all()
    samples = jax_compact_samples(res, jtrainer.sample_budget)
    ri = np.asarray(samples.ray_indices)
    assert (np.diff(ri) >= 0).all()
    ok = (np.arange(N_RAYS) < int(samples.first_incomplete_ray))[:, None]
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(jax_mlp, "_linear", _linear64)
        f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)
        o, d, pixels, bkgd, times = (f64(batch[k]) for k in (
            "rays_o", "rays_d", "rgb", "color_bkgd", "timestamps"))
        ts, te = f64(samples.t_starts), f64(samples.t_ends)
        ids = np.minimum(ri, N_RAYS - 1)
        positions = o[ids] + (0.5 * (ts + te))[:, None] * d[ids]

        def loss_fn(p):
            rgb, sigma = jtrainer.field(p, positions, times[ids], condition=d[ids])
            sdt = jnp.where(jnp.asarray(samples.valid), sigma[:, 0] * (te - ts), 0.0)
            before = jnp.cumsum(sdt) - sdt  # optical depth before each sample
            first = jax.ops.segment_min(before, ri, N_RAYS + 1)
            w = jnp.exp(-(before - first[ri])) * -jnp.expm1(-sdt)
            opacity = jax.ops.segment_sum(w, ri, N_RAYS + 1)[:N_RAYS, None]
            colors = jax.ops.segment_sum(w[:, None] * rgb, ri, N_RAYS + 1)[:N_RAYS]
            diff = jnp.abs(colors + (1.0 - opacity) * bkgd - pixels) * ok
            return jnp.sum(jnp.where(diff < 1.0, 0.5 * diff**2, diff - 0.5)) / (ok.sum() * 3)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(f64, jparams))
        # the bridge's leaves kept in float64 (it makes f32 tensors)
        mp.setattr(jax_bridge, "_tensor", lambda a, device: torch.tensor(np.asarray(a)))
        grads = field_params_from_numpy(jax.tree.map(np.asarray, grads), device="cpu")
    valid = np.asarray(samples.valid)
    return (float(loss), {k: v.numpy() for k, v in grads.items()},
            tuple(np.asarray(a)[valid] for a in (ri, samples.t_starts, samples.t_ends)))


def _f64_step(trainer, jparams, occ_state, batch, near, jax_samples):
    """The port's step in float64 on JAX's samples: the port marches the
    rays through its refreshed grid with the same jitter and budget cut,
    and its samples must be JAX's rays with bounds within an ulp of JAX's
    (the f32 sums of the two marchers round apart); JAX's bounds then
    replace them.  Returns (loss, {name: gradient})."""
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    samples = compact_samples(
        sampling(occ_state, tb["rays_o"], tb["rays_d"], render_step_size=trainer.render_step_size,
                 near_jitter=torch.tensor(near)),
        trainer.sample_budget,
    )
    ray_indices, t_starts, t_ends = jax_samples
    np.testing.assert_array_equal(samples.ray_indices.numpy(), ray_indices)
    np.testing.assert_array_max_ulp(samples.t_starts.numpy(), t_starts, maxulp=1)
    np.testing.assert_array_max_ulp(samples.t_ends.numpy(), t_ends, maxulp=1)
    samples = samples._replace(t_starts=torch.tensor(t_starts).double(),
                               t_ends=torch.tensor(t_ends).double())
    p64 = {k: v.double().requires_grad_(True)
           for k, v in field_params_from_numpy(jparams, device="cpu").items()}
    field64 = copy.deepcopy(trainer.field).double()
    times = tb["timestamps"].double()

    def rgb_sigma_fn(positions, dirs, ray_indices):
        rgb, density = torch.func.functional_call(
            field64, p64, (positions, times[ray_indices.long()], dirs))
        return rgb, density[..., 0]

    colors = render_rays_with_occgrid(rgb_sigma_fn, tb["rays_o"].double(),
                                      tb["rays_d"].double(), samples,
                                      tb["color_bkgd"].double())[0]
    ok = (torch.arange(N_RAYS) < samples.first_incomplete_ray)[:, None]
    diff = (colors - tb["rgb"].double()).abs() * ok
    loss = torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5).sum() / (ok.sum() * 3)
    loss.backward()
    return float(loss.detach()), {k: v.grad.numpy() for k, v in p64.items()}


@pytest.mark.parametrize("kind", list(CASES))
def test_train_step_matches_jax(dynamic_batch, kind):
    """One time-dependent step (per-ray times, one frame a cell in the
    refresh, K-Planes' priors at TV 1e-3) against the JAX trainer's
    padded-traversal step: loss and mse within 1e-5 relative, the counts
    equal, the refreshed occupancies within 1e-4 of their largest (f32) or
    1e-2 relative (bf16) and the binaries equal except where the two
    straddle the threshold.

    Gradients: the bf16 K-Planes field's leaves within 5e-3 of JAX's in
    relative Frobenius norm.  T-NeRF's f32 step is ill-conditioned: JAX's
    own f32 leaves lie up to 5e-3 from the JAX step in float64 (a last-bit
    difference of a warped point is multiplied by up to 2^9 in the
    degree-10 encoding; tests/test_torch_mlp_fields.py holds the warp and
    the NeRF apart to 1e-4), so 1e-4 from JAX's f32 leaves cannot be asked
    of any f32 step.  The witness is the JAX step in float64
    (``_jax64_step``), and each port leaf is held within 1e-4 of it, or no
    farther from it than twice JAX's f32 step; the port's step in float64,
    on the same samples, within 1e-10 of it (loss 1e-12), so that an error
    shared by the port's f32 and float64 steps fails.  The density head is
    set to 30x its init (densities ~3e-2, alphas ~1e-4): at the init's
    alphas of ~5e-6, ``1 - exp(-x)`` in f32 carries ~1% of each weight in
    both trainers, and the colour leaves then read 2e-4 (port) and 2e-5
    (JAX) from the float64 step."""
    batch, timestamps = dynamic_batch
    jmake, make, settings = CASES[kind]
    jtrainer = JaxTrainer(
        field=jmake(), aabb=AABB, max_steps=100, grid_resolution=GRID,
        traversal="padded", windowed=False, max_samples_per_ray=1400, dynamic_budget=False,
        sample_budget=1 << 14, timestamps=timestamps, time_dependent=True,
        weight_decay=0.0, render_step_size=5e-3, **settings,
    )
    jtrainer.optimizer = _gradient_recorder()
    jstate = jtrainer.init_state()
    jparams = jax.tree.map(np.asarray, jstate.params)
    if kind == "tnerf":
        jparams["nerf"]["sigma"]["output"]["w"] = jparams["nerf"]["sigma"]["output"]["w"] * 30
        jstate = jstate._replace(params=jax.tree.map(jnp.asarray, jparams))
    jocc = tuple(np.asarray(a) for a in (jstate.occ_state.aabbs, jstate.occ_state.occs,
                                         jstate.occ_state.binaries))
    _, k_occ, k_strat, k_time = jax.random.split(jstate.key, 4)
    near = np.asarray(jax.random.uniform(k_strat, (N_RAYS,)))
    cells = np.asarray(jax.random.uniform(jax.random.split(k_occ, 4)[3], (1, GRID**3, 3)))
    frames = np.asarray(jax.random.randint(k_time, (GRID**3,), 0, timestamps.shape[0]))
    new, ref = jtrainer.train_step(jstate, batch)  # donates ``jstate``
    ref_grads = field_params_from_numpy(jax.tree.map(np.asarray, new.opt_state), device="cpu")
    ref_occs, ref_bin = np.asarray(new.occ_state.occs), np.asarray(new.occ_state.binaries)

    trainer = NGPOccTrainer(
        field=make(), aabb=AABB, max_steps=100, grid_resolution=GRID, sample_budget=1 << 14,
        timestamps=timestamps, weight_decay=0.0, render_step_size=5e-3, device="cpu",
        **settings,
    )
    params = field_params_from_numpy(jparams, device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    state = TrainState(params, trainer.init_optimizer(params),
                       occ_state_from_numpy(*jocc, device="cpu"), 0)
    out, aux = trainer.train_step(
        state, {k: torch.tensor(v) for k, v in batch.items()},
        near_jitter=torch.tensor(near), cell_jitter=torch.tensor(cells),
        frame_idx=torch.tensor(frames),
    )

    bf16 = kind == "kplanes"
    occs = out.occ_state.occs.numpy()
    if bf16:
        np.testing.assert_allclose(occs, ref_occs, rtol=1e-2, atol=0)
    else:
        np.testing.assert_allclose(occs, ref_occs, rtol=0, atol=1e-4 * ref_occs.max())
    thre = min(float(occs[occs >= 0].mean()), trainer.occ_thre)
    differ = out.occ_state.binaries.numpy().reshape(-1) != ref_bin.reshape(-1)
    near_thre = np.abs(ref_occs.reshape(-1) - thre) <= np.abs(occs - ref_occs).reshape(-1) + 1e-6
    assert (near_thre | ~differ).all()
    for key in ("loss", "mse"):
        assert float(aux[key]) == pytest.approx(float(ref[key]), rel=1e-5), key
    for key in ("n_rays_ok", "n_rendering_samples", "n_total_samples", "overflow"):
        assert int(aux[key]) == int(ref[key]), key
    assert int(aux["n_rendering_samples"]) > 0
    if bf16:
        for name, p in params.items():
            got, want = p.grad.numpy(), ref_grads[name].numpy()
            assert np.abs(want).max() > 0, name
            assert np.linalg.norm(got - want) <= 5e-3 * np.linalg.norm(want), (
                name, np.linalg.norm(got - want) / np.linalg.norm(want))
    else:
        loss64, grads64, jax_samples = _jax64_step(jtrainer, jparams, new.occ_state, batch,
                                                   k_strat)
        port_loss64, port_grads64 = _f64_step(
            trainer, jparams, out.occ_state, batch, near, jax_samples)
        assert port_loss64 == pytest.approx(loss64, rel=1e-12)
        assert float(aux["loss"]) == pytest.approx(loss64, rel=1e-5)
        for name, p in params.items():
            g64 = grads64[name]
            dist = lambda g: np.linalg.norm(g - g64) / np.linalg.norm(g64)
            assert dist(port_grads64[name]) <= 1e-10, (name, dist(port_grads64[name]))
            jax_dist = dist(ref_grads[name].numpy())
            assert dist(p.grad.numpy()) <= max(1e-4, 2 * jax_dist), (
                name, dist(p.grad.numpy()), jax_dist)
    assert out.opt_state.count == 1
    assert out.opt_state.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(jtrainer.schedule(0)), rel=1e-5)
