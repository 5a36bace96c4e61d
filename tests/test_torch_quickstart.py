"""Port vs JAX: the README's quick start, written against each package with
only the imports and the device changed, on the CPU at a small size (a 32^3
grid, 64 rays, a narrow f32 CP field), then three steps of a user's own
training loop (the shape of ``chip_smoke.py``'s phase 19: the estimator's
update, stratified sampling, ``rendering``, a smooth-L1 loss plus
``distortion`` at weight 1e-3, Adam), the loss compared step by step."""
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
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.utils.jax_bridge import (
    cp_field_params_from_numpy,
    occ_grid_estimator_from_numpy,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

ROI = [-1.5] * 3 + [1.5] * 3
SMALL = dict(resolutions=(16, 32, 64), ranks=(8, 8, 8))
N_RAYS = 64
STEP = 5e-3


@pytest.fixture(scope="module")
def setup():
    """The JAX field and its parameters, an estimator whose grid one
    warmup update filled from the untrained field, and a batch of rays."""
    jfield = JaxField(aabb=tuple(ROI), compute_dtype=jnp.float32, **SMALL)
    params = jfield.init(jax.random.PRNGKey(0))
    jest = nerfacc_tpu.OccGridEstimator(roi_aabb=ROI, resolution=32, seed=1)
    jest.update_every_n_steps(
        0, lambda x: jfield.query_density(params, x)[..., 0] * STEP)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")
        ds = JaxLoader("train", n_train=4, width=24, height=24, num_rays=N_RAYS)
    batches = [{k: np.asarray(v) for k, v in ds[0].items()} for _ in range(3)]
    return jfield, params, jest, batches


def _port(jest, params):
    """The port's estimator and field carrying the JAX ones' state."""
    est = nerfacc_tpu_torch.OccGridEstimator(roi_aabb=ROI, resolution=32, seed=1,
                                             device="cpu")
    occ_grid_estimator_from_numpy(est, jax.tree.map(np.asarray, jest.state_dict()))
    field = CPRadianceField(tuple(ROI), compute_dtype=torch.float32, **SMALL)
    field.load_state_dict(cp_field_params_from_numpy(jax.tree.map(np.asarray, params),
                                                     device="cpu"))
    return est, field


@pytest.mark.parametrize("kw", [{}, dict(near_plane=2.0, render_step_size=STEP)],
                         ids=["readme", "near-2"])
def test_readme_quick_start_matches_jax(setup, kw):
    """The quick start's three calls as the README writes them, and with a
    near plane and step that put samples in this scene (at the defaults,
    near 0 and step 1e-3, the 1024-candidate cap ends every orbit before
    the box, in both packages): equal samples, and colours, opacities and
    depths within 1e-5, the sample bounds within two ulps (see below)."""
    jfield, params, jest, batches = setup
    rays_o, rays_d = batches[0]["rays_o"], batches[0]["rays_d"]

    def my_field(t_starts, t_ends, ray_indices):
        o, d = jnp.asarray(rays_o)[ray_indices], jnp.asarray(rays_d)[ray_indices]
        rgb, density = jfield(params, o + (0.5 * (t_starts + t_ends))[:, None] * d, d)
        return rgb, density[..., 0]

    estimator = jest
    ray_indices, t_starts, t_ends = estimator.sampling(
        jnp.asarray(rays_o), jnp.asarray(rays_d), **kw)
    want = nerfacc_tpu.rendering(
        t_starts, t_ends, ray_indices, n_rays=rays_o.shape[0],
        rgb_sigma_fn=my_field,
    )

    estimator, field = _port(jest, params)
    rays_o, rays_d = torch.tensor(rays_o), torch.tensor(rays_d)

    def my_field(t_starts, t_ends, ray_indices):  # noqa: F811 (the port's)
        o, d = rays_o[ray_indices], rays_d[ray_indices]
        rgb, density = field(o + (0.5 * (t_starts + t_ends))[:, None] * d, d)
        return rgb, density[..., 0]

    ray_indices2, t_starts2, t_ends2 = estimator.sampling(rays_o, rays_d, **kw)
    colors, opacities, depths, extras = nerfacc_tpu_torch.rendering(
        t_starts2, t_ends2, ray_indices2, n_rays=rays_o.shape[0],
        rgb_sigma_fn=my_field,
    )
    np.testing.assert_array_equal(ray_indices2.numpy(), np.asarray(ray_indices))
    # the bounds within an ulp: the JAX estimator marches eagerly, unfused,
    # where the port's march computes as jitted XLA does (fused
    # multiply-adds); the same candidates either way
    np.testing.assert_allclose(t_starts2.numpy(), np.asarray(t_starts), rtol=2.4e-7, atol=0)
    np.testing.assert_allclose(t_ends2.numpy(), np.asarray(t_ends), rtol=2.4e-7, atol=0)
    assert (ray_indices2.shape[0] > 20 * N_RAYS) == bool(kw)
    for g, w in zip((colors, opacities, depths), want[:3]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert set(extras) == set(want[3])


def test_user_loop_matches_jax_step_by_step(setup):
    """Three steps of the loop on both packages from the same field and
    grid, with JAX's near-plane jitter handed to the port: the loss within
    1e-5 relative at every step (Adam with eps 1e-15 and lr 1e-2 on both;
    the steps off the estimator's update interval leave both grids as
    bridged), and the loss falls."""
    jfield, params, jest0, batches = setup
    jest = nerfacc_tpu.OccGridEstimator(roi_aabb=ROI, resolution=32, seed=1)
    jest.load_state_dict(jest0.state_dict())
    est, field = _port(jest, params)
    tx = optax.adam(1e-2, eps=1e-15)
    jopt = tx.init(params)
    opt = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)

    @jax.jit
    @jax.value_and_grad
    def jax_loss(p, batch, rid, t0, t1):
        o, d = batch["rays_o"], batch["rays_d"]

        def rgb_sigma_fn(a, b, r):
            rgb, density = jfield(p, o[r] + (0.5 * (a + b))[:, None] * d[r], d[r])
            return rgb, density[..., 0]

        colors, _, _, extras = nerfacc_tpu.rendering(
            t0, t1, rid, n_rays=N_RAYS, rgb_sigma_fn=rgb_sigma_fn,
            render_bkgd=batch["color_bkgd"])
        diff = jnp.abs(colors - batch["rgb"])
        l1 = jnp.mean(jnp.where(diff < 1.0, 0.5 * diff**2, diff - 0.5))
        return l1 + 1e-3 * jnp.mean(nerfacc_tpu.distortion(extras["weights"], t0, t1, rid, N_RAYS))

    losses = []
    for step, batch in enumerate(batches, start=1):
        occ_fn = lambda x: jfield.query_density(params, x)[..., 0] * STEP  # noqa: E731
        jest.update_every_n_steps(step, occ_fn)
        _, sub = jax.random.split(jest._key)  # the draw sampling is about to make
        near = torch.tensor(np.asarray(jax.random.uniform(sub, (N_RAYS,))))
        o, d = jnp.asarray(batch["rays_o"]), jnp.asarray(batch["rays_d"])
        rid, t0, t1 = jest.sampling(o, d, render_step_size=STEP, stratified=True)
        loss, grads = jax_loss(params, {k: jnp.asarray(v) for k, v in batch.items()},
                               rid, t0, t1)
        updates, jopt = tx.update(grads, jopt, params)
        params = optax.apply_updates(params, updates)

        tb = {k: torch.tensor(v) for k, v in batch.items()}
        est.update_every_n_steps(step, lambda x: field.query_density(x)[..., 0] * STEP)
        ray_indices, t_starts, t_ends = est.sampling(
            tb["rays_o"], tb["rays_d"], render_step_size=STEP, stratified=True,
            near_jitter=near)

        def rgb_sigma_fn(a, b, r):
            pos = tb["rays_o"][r] + (0.5 * (a + b))[:, None] * tb["rays_d"][r]
            rgb, density = field(pos, tb["rays_d"][r])
            return rgb, density[..., 0]

        colors, _, _, extras = nerfacc_tpu_torch.rendering(
            t_starts, t_ends, ray_indices, n_rays=N_RAYS, rgb_sigma_fn=rgb_sigma_fn,
            render_bkgd=tb["color_bkgd"])
        port_loss = F.smooth_l1_loss(colors, tb["rgb"]) + 1e-3 * nerfacc_tpu_torch.distortion(
            extras["weights"], t_starts, t_ends, ray_indices, N_RAYS).mean()
        opt.zero_grad()
        port_loss.backward()
        opt.step()
        np.testing.assert_array_equal(ray_indices.numpy(), np.asarray(rid))
        assert float(port_loss.detach()) == pytest.approx(float(loss), rel=1e-5), step
        losses.append(float(port_loss.detach()))
    assert losses[-1] < losses[0]
