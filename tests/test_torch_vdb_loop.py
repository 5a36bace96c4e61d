"""Port vs JAX: a user's own training loop through ``VDBEstimator`` (the
shape of ``chip_smoke.py``'s phase 27, the README's quick start with the
sparse estimator), on the CPU at a small size: a narrow f32 CP field, a
16^3 grid over +-1.5, 64 rays.  Three steps: the estimator's update (the
dense warmup update at step 0), stratified sampling with a density
callback, ``rendering``, smooth L1 plus ``distortion`` at 1e-3, Adam.
Each step starts both packages from the same parameters (JAX's, after
its Adam steps, bridged into the port's field: Adam normalises every
gradient entry, so last-bit differences in entries near zero would become
step-sized parameter differences by the next step); JAX's draws (the
update's jitter, the near-plane jitter) are fed to the port.  The JAX side
runs its density callback, its visibility filter and its loss jitted, the
loss on sample buffers padded to one length (zero-width samples at the end,
which add exactly nothing), so that each compiles once."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import nerfacc_tpu
import nerfacc_tpu_torch
from nerfacc_tpu.data.procedural import ProceduralSceneLoader as JaxLoader
from nerfacc_tpu.estimators import sparse_grid as jsg
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.utils.jax_bridge import cp_field_params_from_numpy
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

ROI = [-1.5] * 3 + [1.5] * 3
SMALL = dict(resolutions=(16, 32, 64), ranks=(8, 8, 8))
RES = 16
N_RAYS = 64
STEP = 5e-3
# the quick start's bound (tests/test_torch_quickstart.py): the loss within
# 1e-5 relative; here every gradient leaf too, in relative Frobenius norm
REL = 1e-5
PAD = 1 << 15  # the JAX loss's sample buffer


@pytest.fixture
def jitted_visibility(monkeypatch):
    """The JAX estimator's visibility filter, jitted (eagerly its segmented
    associative scan compiles anew for each sample count, for seconds)."""
    static = ("n_rays", "early_stop_eps", "alpha_thre")
    for name in ("render_visibility_from_density", "render_visibility_from_alpha"):
        monkeypatch.setattr(jsg, name, jax.jit(getattr(jsg, name), static_argnames=static))


def _padded(rid, t0, t1):
    """The samples and zero-width ones on the last ray up to ``PAD``: their
    alpha, weight and distortion terms are exactly 0."""
    n = PAD - rid.shape[0]
    assert n >= 0
    return (jnp.concatenate([rid, jnp.full((n,), N_RAYS - 1, rid.dtype)]),
            jnp.concatenate([t0, jnp.full((n,), t1[-1])]),
            jnp.concatenate([t1, jnp.full((n,), t1[-1])]))


@pytest.fixture(scope="module")
def setup():
    jfield = JaxField(aabb=tuple(ROI), compute_dtype=jnp.float32, **SMALL)
    params = jfield.init(jax.random.PRNGKey(0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")
        ds = JaxLoader("train", n_train=4, width=24, height=24, num_rays=N_RAYS)
    batches = [{k: np.asarray(v) for k, v in ds[0].items()} for _ in range(3)]
    return jfield, params, batches, _jax_loss_fn(jfield), jax.jit(jfield.query_density)


def _jax_loss_fn(jfield):
    @jax.jit
    @jax.value_and_grad
    def loss_fn(p, batch, rid, t0, t1):
        o, d = batch["rays_o"], batch["rays_d"]

        def rgb_sigma_fn(a, b, r):
            rgb, density = jfield(p, o[r] + (0.5 * (a + b))[:, None] * d[r], d[r])
            return rgb, density[..., 0]

        colors, _, _, extras = nerfacc_tpu.rendering(
            t0, t1, rid, n_rays=N_RAYS, rgb_sigma_fn=rgb_sigma_fn,
            render_bkgd=batch["color_bkgd"])
        diff = jnp.abs(colors - batch["rgb"])
        l1 = jnp.mean(jnp.where(diff < 1.0, 0.5 * diff**2, diff - 0.5))
        return l1 + 1e-3 * jnp.mean(nerfacc_tpu.distortion(extras["weights"], t0, t1, rid,
                                                           N_RAYS))
    return loss_fn


@pytest.mark.parametrize("traversal", ["windowed", "padded"])
def test_vdb_loop_matches_jax(setup, traversal, jitted_visibility):
    """Three loop steps in both packages: equal ray ids every step, the
    loss and every gradient leaf within ``REL`` of JAX's, the grid after
    the warmup update equal to JAX's, and the loss falls."""
    jfield, params, batches, jax_loss, density = setup
    jest = nerfacc_tpu.VDBEstimator(roi_aabb=ROI, resolution=RES, seed=1)
    est = nerfacc_tpu_torch.VDBEstimator(roi_aabb=ROI, resolution=RES, seed=1, device="cpu")
    field = CPRadianceField(tuple(ROI), compute_dtype=torch.float32, **SMALL)
    tx = optax.adam(1e-2, eps=1e-15)
    jopt = tx.init(params)
    losses = []
    for step, batch in enumerate(batches):
        field.load_state_dict(cp_field_params_from_numpy(jax.tree.map(np.asarray, params),
                                                         device="cpu"))
        if step == 0:  # the warmup update's jitter, from the key it is about to split
            _, sub = jax.random.split(jest._key)
            jitter = torch.tensor(np.asarray(
                jax.random.uniform(jax.random.split(sub)[1], (RES**3, 3))))
        jest.update_every_n_steps(step, lambda x: density(params, x)[..., 0] * STEP)
        _, sub = jax.random.split(jest._key)  # the draw sampling is about to make
        near = torch.tensor(np.asarray(jax.random.uniform(sub, (N_RAYS,))))
        o, d = jnp.asarray(batch["rays_o"]), jnp.asarray(batch["rays_d"])

        def sigma_fn(t0, t1, rid, o=o, d=d):
            pos = o[rid] + (0.5 * (t0 + t1))[:, None] * d[rid]
            return density(params, pos)[..., 0]

        rid, t0, t1 = jest.sampling(o, d, sigma_fn=sigma_fn, render_step_size=STEP,
                                    stratified=True, traversal=traversal)
        loss, grads = jax_loss(params, {k: jnp.asarray(v) for k, v in batch.items()},
                               *_padded(rid, t0, t1))
        updates, jopt = tx.update(grads, jopt, params)
        params = optax.apply_updates(params, updates)

        tb = {k: torch.tensor(v) for k, v in batch.items()}
        est.update_every_n_steps(step, lambda x: field.query_density(x)[..., 0] * STEP,
                                 jitter=jitter if step == 0 else None)
        if step == 0:
            np.testing.assert_array_equal(est.grid_words.numpy(), np.asarray(jest.grid.words))
            assert 0 < float(est.binaries.float().mean()) < 1

        def port_sigma_fn(t0, t1, rid):
            pos = tb["rays_o"][rid] + (0.5 * (t0 + t1))[:, None] * tb["rays_d"][rid]
            return field.query_density(pos)[..., 0]

        ray_indices, t_starts, t_ends = est.sampling(
            tb["rays_o"], tb["rays_d"], sigma_fn=port_sigma_fn, render_step_size=STEP,
            stratified=True, traversal=traversal, near_jitter=near)

        def rgb_sigma_fn(a, b, r):
            pos = tb["rays_o"][r] + (0.5 * (a + b))[:, None] * tb["rays_d"][r]
            rgb, density = field(pos, tb["rays_d"][r])
            return rgb, density[..., 0]

        colors, _, _, extras = nerfacc_tpu_torch.rendering(
            t_starts, t_ends, ray_indices, n_rays=N_RAYS, rgb_sigma_fn=rgb_sigma_fn,
            render_bkgd=tb["color_bkgd"])
        port_loss = F.smooth_l1_loss(colors, tb["rgb"]) + 1e-3 * nerfacc_tpu_torch.distortion(
            extras["weights"], t_starts, t_ends, ray_indices, N_RAYS).mean()
        field.zero_grad()
        port_loss.backward()
        np.testing.assert_array_equal(ray_indices.numpy(), np.asarray(rid))
        assert ray_indices.shape[0] > 10 * N_RAYS
        assert float(port_loss.detach()) == pytest.approx(float(loss), rel=REL), step
        want = cp_field_params_from_numpy(jax.tree.map(np.asarray, grads), device="cpu")
        for name, p in field.named_parameters():
            err = float((p.grad - want[name]).norm() / want[name].norm())
            assert err <= REL, (step, name, err)
        losses.append(float(port_loss.detach()))
    assert losses[-1] < losses[0]
