"""Port vs JAX, the proposal-network path: the s-to-t map, the interlevel
loss, CPDensityField, propnet_sampling, the batched rendering, the
proposal-gradient schedule, and NGPPropTrainer's train step (one step that
trains the proposal field, then one that does not) from the same
parameters, batch and jitter; a convergence smoke of the port alone."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.data.procedural import ProceduralSceneLoader as JaxLoader
from nerfacc_tpu.data_specs import RayIntervals as JaxIntervals
from nerfacc_tpu.estimators.prop_net import _pdf_loss as jax_pdf_loss
from nerfacc_tpu.estimators.prop_net import _transform_stot as jax_stot
from nerfacc_tpu.estimators.prop_net import get_proposal_requires_grad_fn as jax_rg_fn
from nerfacc_tpu.estimators.prop_net import propnet_sampling as jax_propnet_sampling
from nerfacc_tpu.models.cp_field import CPDensityField as JaxDensityField
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
from nerfacc_tpu.models.ngp import NGPDensityField as JaxNGPDensityField
from nerfacc_tpu.models.ngp import NGPRadianceField as JaxNGPField
from nerfacc_tpu.trainers import NGPPropTrainer as JaxPropTrainer
from nerfacc_tpu.volrend import rendering as jax_rendering
from nerfacc_tpu_torch.data.device_sampler import DeviceRaySampler
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
from nerfacc_tpu_torch.data_specs import RayIntervals
from nerfacc_tpu_torch.estimators.prop_net import (
    _pdf_loss,
    _transform_stot,
    get_proposal_requires_grad_fn,
    propnet_sampling,
)
from nerfacc_tpu_torch.models.cp_field import CPDensityField, CPRadianceField
from nerfacc_tpu_torch.models.ngp import NGPDensityField, NGPRadianceField
from nerfacc_tpu_torch.trainers.ngp_prop import NGPPropTrainer, PropTrainState
from nerfacc_tpu_torch.utils.jax_bridge import (
    cp_density_field_params_from_numpy,
    cp_density_field_params_to_numpy,
    prop_params_from_numpy,
)
from nerfacc_tpu_torch.volrend import rendering
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
FIELD = dict(resolutions=(8, 16), ranks=(4, 4))
PROP = dict(resolutions=(8, 16), ranks=(4, 4), hidden_dim=16)
N_RAYS = 32


@pytest.mark.parametrize("kind", ["uniform", "lindisp"])
def test_transform_stot_matches_jax_bitwise(kind):
    """Jitted JAX fuses ``s * s_max`` into the sum; the port too."""
    s = np.random.default_rng(0).uniform(size=(64, 33)).astype(np.float32)
    want = jax.jit(lambda x: jax_stot(kind, x, 2.0, 6.0))(jnp.asarray(s))
    got = _transform_stot(kind, torch.tensor(s), 2.0, 6.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pdf_loss_matches_jax():
    """tests/test_prop.py's case (16 rays, 33 query and 65 key edges): the
    loss within 1e-7 (the JAX package's one-hot selection and the port's
    gather give the same values, summed in another order) and its gradient
    for the key CDFs within 1e-6 relative."""
    rng = np.random.default_rng(3)
    q = np.sort(rng.uniform(0.0, 6.0, (16, 33)), -1).astype(np.float32)
    k = np.sort(rng.uniform(-1.0, 7.0, (16, 65)), -1).astype(np.float32)
    q[:, 5] = k[:, 20]  # query edges exactly on key edges
    cq = np.sort(rng.uniform(size=(16, 33)), -1).astype(np.float32)
    ck = np.sort(rng.uniform(size=(16, 65)), -1).astype(np.float32)

    def jloss(ckey):
        return jax_pdf_loss(JaxIntervals(vals=jnp.asarray(q)), jnp.asarray(cq),
                            JaxIntervals(vals=jnp.asarray(k)), ckey)

    want = jloss(jnp.asarray(ck))
    want_grad = jax.grad(lambda c: jnp.sum(jloss(c)))(jnp.asarray(ck))
    tck = torch.tensor(ck, requires_grad=True)
    got = _pdf_loss(RayIntervals(torch.tensor(q)), torch.tensor(cq), RayIntervals(torch.tensor(k)), tck)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tck.grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-6)


def _density_fields(seed, unbounded=False):
    jfield = JaxDensityField(aabb=AABB, unbounded=unbounded, compute_dtype=jnp.float32, **PROP)
    jparams = jfield.init(jax.random.PRNGKey(seed))
    field = CPDensityField(AABB, unbounded=unbounded, compute_dtype=torch.float32, **PROP)
    field.load_state_dict(
        cp_density_field_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    )
    return jfield, jparams, field


@pytest.mark.parametrize("unbounded", [False, True])
def test_cp_density_field_matches_jax(unbounded):
    """Density and the gradient of a density sum for every leaf, f32, from
    the same parameters through the bridge: within 1e-5 relative (the port
    sums the two taps per axis, JAX contracts the full hat row)."""
    jfield, jparams, field = _density_fields(0, unbounded)
    x = np.random.default_rng(1).uniform(-1.7, 1.7, (2000, 3)).astype(np.float32)
    if unbounded:
        x = x * 3.0
    want = jfield(jparams, jnp.asarray(x))
    want_grads = jax.grad(lambda p: jnp.sum(jnp.sin(jfield(p, jnp.asarray(x)))))(jparams)
    got = field(torch.tensor(x))
    torch.sin(got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    ref = cp_density_field_params_from_numpy(jax.tree.map(np.asarray, want_grads), device="cpu")
    for name, p in field.named_parameters():
        w = ref[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(), err_msg=name)
    assert (got.detach().numpy()[(np.abs(x) >= 1.5).any(-1)] == 0).all() != unbounded
    back = cp_density_field_params_to_numpy(field.state_dict())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([4 * np.cos(theta), 4 * np.sin(theta), rng.uniform(-1, 1, n)], -1)
    d = rng.uniform(-0.6, 0.6, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_propnet_sampling_matches_jax():
    """One f32 proposal level (32 samples) and 16 final samples, stratified
    with JAX's draws as the biases, through jitted JAX and the port: the
    level's edges bit for bit (the first resampling sees the same inputs),
    its CDF within 1e-6 and the final bounds within 1e-5 (the densities
    differ in the last bits, which move the CDF and so the samples)."""
    jfield, jparams, field = _density_fields(4)
    o, d = _rays(5, N_RAYS)
    key = jax.random.PRNGKey(9)

    def jfn(t0, t1):
        pos = o[:, None, :] + (0.5 * (t0 + t1))[..., None] * d[:, None, :]
        return jfield(jparams, pos.reshape(-1, 3)).reshape(t0.shape)

    def jrun(k):
        return jax_propnet_sampling([jfn], [32], 16, N_RAYS, 2.0, 6.0, "uniform", True, True, k)

    t0_ref, t1_ref, cache_ref = jax.jit(jrun)(key)
    biases = [jax.random.uniform(k, (N_RAYS, 1)) for k in jax.random.split(key, 2)]
    to, td = torch.tensor(o), torch.tensor(d)

    def fn(t0, t1):
        pos = to[:, None, :] + (0.5 * (t0 + t1))[..., None] * td[:, None, :]
        return field(pos.reshape(-1, 3)).reshape(t0.shape)

    t0, t1, cache = propnet_sampling(
        [fn], [32], 16, N_RAYS, 2.0, 6.0, "uniform", True, True,
        biases=[torch.tensor(np.asarray(b)) for b in biases], device="cpu",
    )
    np.testing.assert_array_equal(cache[0][0].numpy(), np.asarray(cache_ref[0][0]))
    np.testing.assert_allclose(cache[0][1].detach().numpy(), np.asarray(cache_ref[0][1]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(t0.numpy(), np.asarray(t0_ref), rtol=1e-5)
    np.testing.assert_allclose(t1.numpy(), np.asarray(t1_ref), rtol=1e-5)
    assert cache[0][1].requires_grad and cache[1][1] is None and len(cache) == 2
    assert t0.shape == (N_RAYS, 16) and torch.equal(t0[:, 1:], t1[:, :-1])


def test_batched_rendering_matches_jax():
    """The batched ``rendering`` (composite on the flat view) against JAX's
    batched layout: colours, opacities, depths and ``trans`` within 1e-5;
    the gradients for sigmas and rgbs within 1e-5 of their max."""
    rng = np.random.default_rng(6)
    t = np.sort(rng.uniform(2.0, 6.0, (N_RAYS, 17)), -1).astype(np.float32)
    sig = (10.0 ** rng.uniform(-1, 2, (N_RAYS, 16))).astype(np.float32)
    rgb = rng.uniform(size=(N_RAYS, 16, 3)).astype(np.float32)
    bkgd = np.array([1.0, 0.5, 0.0], np.float32)

    def jrender(s, c):
        out = jax_rendering(jnp.asarray(t[:, :-1]), jnp.asarray(t[:, 1:]),
                            rgb_sigma_fn=lambda *_: (c, s), render_bkgd=jnp.asarray(bkgd))
        return out[0], out[1], out[2], out[3]["trans"]

    want = jrender(jnp.asarray(sig), jnp.asarray(rgb))
    want_grads = jax.grad(lambda s, c: jnp.sum(jnp.sin(jrender(s, c)[0])), argnums=(0, 1))(
        jnp.asarray(sig), jnp.asarray(rgb))
    ts, tc = torch.tensor(sig, requires_grad=True), torch.tensor(rgb, requires_grad=True)
    got = rendering(torch.tensor(t[:, :-1]), torch.tensor(t[:, 1:]),
                    rgb_sigma_fn=lambda *_: (tc, ts), render_bkgd=torch.tensor(bkgd))
    torch.sin(got[0]).sum().backward()
    for g, w in zip(got[:3] + (got[3]["trans"],), want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    for g, w in zip((ts.grad, tc.grad), want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_proposal_requires_grad_schedule_matches_jax():
    ref, got = jax_rg_fn(), get_proposal_requires_grad_fn()
    assert [got(s) for s in range(2000)] == [ref(s) for s in range(2000)]


@pytest.fixture(scope="module")
def batch():
    """One JAX train batch (numpy), handed to both trainers."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
        ds = JaxLoader("train", n_train=4, width=24, height=24, num_rays=N_RAYS)
    return {k: np.asarray(v) for k, v in ds[0].items()}


TRAINER = dict(prop_samples=[16], num_samples=8, near_plane=2.0, far_plane=6.0, max_steps=100)


# the unbounded example's configuration, cut to size: two proposal levels
# and the final samples ([256, 96] -> 48 in the example), lindisp, the
# opaque last sample, near 0.2 and far 1e3 over the box +-1
CASCADE = dict(prop_samples=[16, 12], num_samples=8, near_plane=0.2, far_plane=1e3,
               sampling_type="lindisp", opaque_bkgd=True)
NGP_FIELD = dict(n_levels=4, log2_hashmap_size=10, max_resolution=64)
NGP_PROP = dict(n_levels=5, log2_hashmap_size=10, hidden_dim=16)


def _trainer_fields(kind, unbounded, levels):
    """(JAX field, JAX proposal fields, port field, port proposal fields),
    f32: the CP pair, or the hash-grid pair ("ngp", the example's --field
    ngp), over the unbounded example's box when ``unbounded``."""
    aabb = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0) if unbounded else AABB
    if kind == "cp":
        return (JaxField(aabb=aabb, unbounded=unbounded, compute_dtype=jnp.float32, **FIELD),
                [JaxDensityField(aabb=aabb, unbounded=unbounded, compute_dtype=jnp.float32, **PROP)
                 for _ in range(levels)],
                CPRadianceField(aabb, unbounded, compute_dtype=torch.float32, **FIELD),
                [CPDensityField(aabb, unbounded, compute_dtype=torch.float32, **PROP)
                 for _ in range(levels)])
    return (JaxNGPField(aabb=aabb, unbounded=unbounded, compute_dtype=jnp.float32, **NGP_FIELD),
            [JaxNGPDensityField(aabb=aabb, unbounded=unbounded, compute_dtype=jnp.float32,
                                **NGP_PROP) for _ in range(levels)],
            NGPRadianceField(aabb, unbounded, compute_dtype=torch.float32, **NGP_FIELD),
            [NGPDensityField(aabb, unbounded, compute_dtype=torch.float32, **NGP_PROP)
             for _ in range(levels)])


@pytest.mark.parametrize(
    "sampling_type,opaque_bkgd,fields",
    [("uniform", False, {}), ("lindisp", True, {}),
     ("uniform", False, dict(lr=5e-3, prop_loss_scaler=256.0, weight_decay=1e-4)),
     ("uniform", False, dict(stratified=False)),
     ("lindisp", True, dict(CASCADE, kind="cp")),
     ("lindisp", True, dict(CASCADE, kind="ngp"))],
    ids=["uniform", "lindisp-opaque", "lr-scaler-decay", "unstratified", "cascade-cp",
         "cascade-ngp"],
)
def test_prop_train_steps_match_jax(batch, sampling_type, opaque_bkgd, fields):
    """Two steps from the same parameters, batch and JAX's stratified draws:
    one with ``requires_grad`` (the interlevel loss trains the proposal
    fields), then one without (the proposal fields' gradients are zero,
    their Adam moments decay, and they move by their momentum).  f32
    fields.  The cascade cases run the unbounded example's configuration
    cut to size (two proposal levels, lindisp, the opaque last sample, near
    0.2, far 1e3, contracted fields over the box +-1) with the CP fields
    and with the hash-grid fields.

    Tolerances.  Loss, mse and prop loss: 1e-5 relative.  Every leaf of both
    groups after each Adam update: within 1e-6 absolute (1e-5 for the
    hash-grid cascade's second step, see below).  After one update
    Adam moves an entry by about lr * sign(gradient) (lr 1e-4 at step 0), so
    a leaf that took the wrong step, or none, would miss by ~1e-4; the two
    packages' gradients agree to ~1e-6 of their scale (compositing sums in
    another order), which moves the updates far less.  The trainer fields
    the port took from JAX (``lr``, ``prop_loss_scaler``, ``weight_decay``,
    ``stratified``) are set alike on both."""
    fields = dict(fields)
    kind = fields.pop("kind", "cp")
    cascade = "prop_samples" in fields
    settings = {**TRAINER, "sampling_type": sampling_type, "opaque_bkgd": opaque_bkgd, **fields}
    jfield, jprops, field, props = _trainer_fields(kind, cascade, len(settings["prop_samples"]))
    jtrainer = JaxPropTrainer(field=jfield, prop_fields=jprops, **settings)
    trainer = NGPPropTrainer(field=field, prop_fields=props, device="cpu", **settings)
    jstate = jtrainer.init_state()
    atol = 1e-6
    if kind == "ngp":
        # the hash tables scaled to O(1), as tests/test_torch_ngp_field.py
        # scales them: at their init (1e-4) the features are ~1e-4, and the
        # density MLP's gradient entries of the features that barely move
        # read ~1e-15, 1e-7 of the leaf's largest; there the last-bit
        # differences of the contracted coordinates flip their sign, and
        # Adam turns each flip into a step of 2 lr (measured: 5 of 1024
        # entries of field.mlp_base.1 off by 1.7e-4, the gradient itself
        # within 8e-7 relative Frobenius)
        # The hash grid's cascade is held at 1e-6 on the first step and at
        # 1e-5 on the step after: the last-bit differences of the proposal
        # densities (the MLPs sum in another order) move the next levels'
        # samples, which lindisp to far 1e3 stretches, and the table
        # gradient of that step reads ~2.4e-4 relative Frobenius from JAX's;
        # Adam's ratio then leaves entries up to 2.4e-6 apart (one entry of
        # field.mlp_head.1, with the box map in either rounding), still
        # ~1/40 of a step of lr (1e-4) taken wrongly.
        jstate = jstate._replace(params={
            "field": {**jstate.params["field"], "encoder": jstate.params["field"]["encoder"] * 1e4},
            "props": [{**p, "encoder": p["encoder"] * 1e4} for p in jstate.params["props"]],
        })
    params = prop_params_from_numpy(jax.tree.map(np.asarray, jstate.params), device="cpu")
    for leaf in trainer.leaves(params):
        leaf.requires_grad_(True)
    state = PropTrainState(params, trainer.init_optimizer(params), 0)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    for rg in (True, False):
        # the step's draws, as _train_step_impl and propnet_sampling split them
        k_strat = jax.random.split(jstate.key)[1]
        biases = [torch.tensor(np.asarray(jax.random.uniform(k, (N_RAYS, 1)))).reshape(-1)
                  for k in jax.random.split(k_strat, len(props) + 1)] if trainer.stratified else None
        jstate, ref = jtrainer.train_step(jstate, batch, requires_grad=rg)  # donates
        state, aux = trainer.train_step(state, tbatch, requires_grad=rg, biases=biases)
        for key in ("loss", "mse", "prop_loss"):
            assert float(aux[key]) == pytest.approx(float(ref[key]), rel=1e-5, abs=1e-12), (rg, key)
        assert (float(aux["prop_loss"]) > 0) == rg
        want = prop_params_from_numpy(jax.tree.map(np.asarray, jstate.params), device="cpu")
        groups = [("field", state.params["field"], want["field"])] + [
            (f"props.{i}", got, ref)
            for i, (got, ref) in enumerate(zip(state.params["props"], want["props"], strict=True))]
        for group, got_group, want_group in groups:
            assert set(got_group) == set(want_group)
            for name, p in got_group.items():
                np.testing.assert_allclose(
                    p.detach().numpy(), want_group[name].numpy(), rtol=0,
                    atol=atol if rg or kind == "cp" else 1e-5,
                    err_msg=f"rg={rg} {group}.{name}",
                )
    assert state.step == 2 and state.opt_state.count == 2


def test_prop_trainer_fields_match_jax_defaults():
    """The trainer fields that were module constants: JAX's names and
    defaults, and ``eval_psnr`` beside ``eval_metrics``."""
    jax_defaults = {f.name: f.default for f in dataclasses.fields(JaxPropTrainer)}
    port_defaults = {f.name: f.default for f in dataclasses.fields(NGPPropTrainer)}
    for name in ("stratified", "lr", "prop_loss_scaler", "weight_decay"):
        assert port_defaults[name] == jax_defaults[name], name
    assert callable(NGPPropTrainer.eval_psnr) and callable(JaxPropTrainer.eval_psnr)


def test_prop_trainer_converges_on_the_port_alone():
    """20 steps through ``train_steps_sampled`` with the device sampler and
    the proposal-gradient schedule, from the port's own init: the loss
    falls, both groups move, and the eval renders finite views."""
    ds = ProceduralSceneLoader("train", n_train=4, width=24, height=24, num_rays=64, device="cpu")
    trainer = NGPPropTrainer(
        field=CPRadianceField(AABB, **FIELD), prop_fields=[CPDensityField(AABB, **PROP)],
        device="cpu", **{**TRAINER, "max_steps": 20},
    )
    state = trainer.init_state()
    before = [p.detach().clone() for p in trainer.leaves(state.params)]
    rg_fn = get_proposal_requires_grad_fn()
    rgs = [rg_fn(s) for s in range(20)]
    state, aux = trainer.train_steps_sampled(state, DeviceRaySampler.from_loader(ds), rgs)
    losses = aux["loss"].numpy() - aux["prop_loss"].numpy()
    assert aux["loss"].shape == (20,) and np.isfinite(losses).all()
    assert losses[-5:].mean() < losses[:5].mean(), losses
    assert ((aux["prop_loss"].numpy() > 0) == np.array(rgs)).all()
    assert all(not torch.equal(a, b) for a, b in zip(before, trainer.leaves(state.params)))
    test = ProceduralSceneLoader("test", n_test=1, width=16, height=16, device="cpu")
    metrics = trainer.eval_metrics(state, test)
    assert metrics["views"][0]["finite"] and np.isfinite(metrics["psnr"])
    assert metrics["views"][0]["n_samples"] == 16 * 16 * (16 + 8)
