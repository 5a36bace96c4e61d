"""Port vs JAX: the TiNeuVox dynamic field (its sinusoidal encodings, the
forward, the occupancy query, the TV regulariser and every gradient, the
deformation network's included) against the JAX field on its hat-matmul
route, ``CPGridEncoder(use_pallas=True)``, with the Pallas kernels K3/K3b/K3c
in interpret mode."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerfacc_tpu.ops
from nerfacc_tpu.models.encoders import SinusoidalEncoder as JaxSinusoidal
from nerfacc_tpu.models.tineuvox import TiNeuVoxRadianceField as JaxTiNeuVox
from nerfacc_tpu.ops.hat_matmul import hat_interp_matmul as jax_hat
from nerfacc_tpu_torch.models.encoders import SinusoidalEncoder
from nerfacc_tpu_torch.models.tineuvox import TiNeuVoxRadianceField
from nerfacc_tpu_torch.utils.jax_bridge import (
    tineuvox_field_params_from_numpy,
    tineuvox_field_params_to_numpy,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
SMALL = dict(resolutions=(16, 32, 64), ranks=(8, 8, 16))
N = 1024


@pytest.fixture
def interpret_k3(monkeypatch):
    """The JAX encoder's hat route reaches K3 through ``nerfacc_tpu.ops``,
    which runs only interpreted on a CPU."""
    monkeypatch.setattr(
        nerfacc_tpu.ops, "hat_interp_matmul", lambda x, line: jax_hat(x, line, True)
    )


@pytest.mark.parametrize(
    "x_dim,min_deg,max_deg,identity",
    [(3, 0, 4, True), (1, 0, 4, True), (2, 1, 6, False), (3, 0, 0, True)],
)
def test_sinusoidal_encoder_matches_jax(x_dim, min_deg, max_deg, identity):
    """JAX's layout (identity first, degree-major, the cosines as shifted
    sines), within 1e-3 of JAX's values, which pins the layout (a misplaced
    column reads O(1)) without holding JAX's CPU sine to its last bits; and
    within 1e-6 of a float64 sine of the same f32 arguments."""
    x = np.random.default_rng(x_dim).uniform(-1.5, 1.5, (300, x_dim)).astype(np.float32)
    ref = np.asarray(JaxSinusoidal(x_dim, min_deg, max_deg, identity)(jnp.asarray(x)))
    enc = SinusoidalEncoder(x_dim, min_deg, max_deg, identity)
    out = enc(torch.tensor(x)).numpy()
    assert out.shape == ref.shape == (300, enc.latent_dim)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-3)
    if max_deg == min_deg:
        np.testing.assert_array_equal(out, x)
        return
    scales = (2.0 ** np.arange(min_deg, max_deg)).astype(np.float32)
    xb = (x[:, None, :] * scales[:, None]).reshape(300, -1)
    args = np.concatenate([xb, xb + np.float32(0.5 * np.pi)], axis=-1)
    want = np.sin(args.astype(np.float64))
    if identity:
        want = np.concatenate([x, want], axis=-1)
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("x_dim,min_deg,max_deg", [(3, 0, 4), (1, 0, 4), (2, 1, 6), (3, 0, 10)])
def test_sinusoidal_encoder_rounds_the_sine_once(x_dim, min_deg, max_deg):
    """Each sine is the f32 nearest to the sine of its f32 argument, bit for
    bit: the encoder takes it in f64 and rounds once, so no accuracy mode of
    the library's f32 vector sine (which once computed a chunk of it ~1.5e-4
    off, in one process after tests/test_torch_hat_matmul.py) reaches it."""
    x = np.random.default_rng(x_dim + 7).uniform(-1.5, 1.5, (4096, x_dim)).astype(np.float32)
    enc = SinusoidalEncoder(x_dim, min_deg, max_deg, True)
    out = enc(torch.tensor(x)).numpy()
    scales = (2.0 ** np.arange(min_deg, max_deg)).astype(np.float32)
    xb = (x[:, None, :] * scales[:, None]).reshape(4096, -1)
    args = np.concatenate([xb, xb + np.float32(0.5 * np.pi)], axis=-1)
    want = np.sin(args.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(out[:, x_dim:].view(np.int32), want.view(np.int32))


def _jax_field(dtype):
    jfield = JaxTiNeuVox(aabb=AABB, compute_dtype=dtype, **SMALL)
    object.__setattr__(
        jfield, "encoder", dataclasses.replace(jfield.encoder, use_pallas=True)
    )
    return jfield


def _params(jfield, warp=True):
    """JAX parameters; ``warp`` scales the deformation's output layer up from
    its rigid 1e-4 init, so the warp moves points by ~0.1."""
    params = jfield.init(jax.random.PRNGKey(3))
    if warp:
        params["deform"][-1] = params["deform"][-1] * 3e3
    return jax.tree.map(np.asarray, params)


def _port_field(dtype, params):
    field = TiNeuVoxRadianceField(AABB, compute_dtype=dtype, device="cpu", **SMALL)
    field.load_state_dict(tineuvox_field_params_from_numpy(params, device="cpu"))
    return field


def _samples(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.6, 1.6, (N, 3)).astype(np.float32)
    t = rng.uniform(0.0, 1.0, (N, 1)).astype(np.float32)
    d = rng.standard_normal((N, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return x, t, d


DTYPES = [
    pytest.param(jnp.float32, torch.float32, id="f32"),
    pytest.param(jnp.bfloat16, torch.bfloat16, id="bf16"),
]


@pytest.mark.parametrize("jdtype,dtype", DTYPES)
def test_field_matches_jax(interpret_k3, jdtype, dtype):
    """rgb and density on points inside and outside the box at random times.
    The two libraries' matmul sums and tanh and sin differ in the last bit,
    so the warped points do too, and a last-bit change of ``x (R-1)`` flips
    the bf16 rounding of about 2^-24 R / 2^-9 of the hat weights (0.2% at
    R = 64): 99% of the entries within 1e-5 of the largest output, and all
    within 2e-3 of it (one flipped weight moves a feature by 2^-9)."""
    jfield = _jax_field(jdtype)
    params = _params(jfield)
    x, t, d = _samples()
    rgb_ref, density_ref = map(
        np.asarray, jfield(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(d))
    )
    field = _port_field(dtype, params)
    with torch.no_grad():
        rgb, density = field(*map(torch.tensor, (x, t, d)))
    for out, ref in ((rgb.numpy(), rgb_ref), (density.numpy(), density_ref)):
        scale = np.abs(ref).max()
        err = np.abs(out - ref)
        assert err.max() <= 2e-3 * scale and (err > 1e-5 * scale).mean() <= 1e-2
    # the warped points left the box where JAX's did
    np.testing.assert_array_equal(density.numpy() == 0, density_ref == 0)
    assert 0 < (density_ref == 0).mean() < 1


def test_query_opacity_matches_jax_with_its_frames(interpret_k3):
    """``query_opacity`` with JAX's frame draw injected."""
    jfield = _jax_field(jnp.bfloat16)
    params = _params(jfield)
    x, _, _ = _samples(1)
    timestamps = np.linspace(0.0, 1.0, 7, dtype=np.float32)[:, None]
    key = jax.random.PRNGKey(5)
    ref = np.asarray(
        jfield.query_opacity(params, jnp.asarray(x), jnp.asarray(timestamps), 5e-3, key)
    )
    frames = np.asarray(jax.random.randint(key, (N,), 0, 7))
    field = _port_field(torch.bfloat16, params)
    with torch.no_grad():
        out = field.query_opacity(
            torch.tensor(x), torch.tensor(timestamps), 5e-3, torch.tensor(frames)
        ).numpy()
        drawn = field.query_opacity(
            torch.tensor(x), torch.tensor(timestamps), 5e-3,
            generator=torch.Generator().manual_seed(0),
        )
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert drawn.shape == (N, 1) and torch.isfinite(drawn).all()


def test_param_regularizer_matches_jax():
    jfield = _jax_field(jnp.bfloat16)
    params = _params(jfield)
    ref = float(jfield.param_regularizer(params))
    field = _port_field(torch.bfloat16, params)
    assert float(field.param_regularizer()) == pytest.approx(ref, rel=1e-6)
    state = {k: v * 2 for k, v in field.state_dict().items()}
    assert float(field.param_regularizer(state)) == pytest.approx(4 * ref, rel=1e-6)


@pytest.mark.parametrize("jdtype,dtype", DTYPES)
def test_gradients_match_jax(interpret_k3, jdtype, dtype):
    """Every parameter's gradient of a weighted sum of rgb and density,
    the deformation leaves included (their only path is the hat kernels'
    coordinate gradient): nonzero, and in the f32 field within 1e-3 of each
    leaf's largest entry from JAX's (readings up to 5.4e-4: the flipped
    hat weights of ``test_field_matches_jax``).  In the bf16 field each
    last-bit difference (warp, sines, the sigmoid's and tanh's derivatives)
    can flip a bf16 rounding of an MLP operand or cotangent, which moves
    others downstream: JAX's own gradients move by up to 2e-3 in relative
    Frobenius norm when the points move by one ulp, and the port reads up to
    7.8e-3 from them; so 2e-2 per leaf (in relative Frobenius norm), which
    the f32 field's gradients, whose bf16 roundings are lost, exceed on the
    encoder and deformation leaves (5e-2 to 1.1e-1)."""
    jfield = _jax_field(jdtype)
    params = _params(jfield)
    x, t, d = _samples(2)
    rng = np.random.default_rng(7)
    c_rgb = rng.standard_normal((N, 3)).astype(np.float32)
    c_den = rng.standard_normal((N, 1)).astype(np.float32)

    def loss(p):
        rgb, density = jfield(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(d))
        return jnp.sum(rgb * c_rgb) + jnp.sum(density * c_den)

    ref = tineuvox_field_params_from_numpy(
        jax.tree.map(np.asarray, jax.grad(loss)(jax.tree.map(jnp.asarray, params))),
        device="cpu",
    )
    field = _port_field(dtype, params)
    rgb, density = field(*map(torch.tensor, (x, t, d)))
    ((rgb * torch.tensor(c_rgb)).sum() + (density * torch.tensor(c_den)).sum()).backward()
    for name, p in field.named_parameters():
        got, want = p.grad.numpy(), ref[name].numpy()
        assert np.abs(want).max() > 0 and np.abs(got).max() > 0, name
        if dtype == torch.float32:
            np.testing.assert_allclose(
                got, want, rtol=0, atol=1e-3 * np.abs(want).max(), err_msg=name
            )
        else:
            assert np.linalg.norm(got - want) <= 2e-2 * np.linalg.norm(want), name


def test_bridge_round_trip():
    params = _params(_jax_field(jnp.bfloat16), warp=False)
    back = tineuvox_field_params_to_numpy(
        tineuvox_field_params_from_numpy(params, device="cpu")
    )
    flat, tree = jax.tree.flatten(params)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        np.testing.assert_array_equal(a, b)


def test_field_starts_rigid():
    """From its own init the warp is below 1e-3 of a cell, but the field
    still reads time through the base MLP."""
    field = TiNeuVoxRadianceField(AABB, device="cpu", **SMALL)
    field.init(torch.Generator().manual_seed(0))
    x, t, _ = map(torch.tensor, _samples(3))
    with torch.no_grad():
        assert float(field.warp(x, t).abs().max()) < 1e-3 * 3.0 / 64
        d0 = field.query_density(x, torch.zeros_like(t))
        d1 = field.query_density(x, torch.ones_like(t))
    assert not torch.equal(d0, d1)


def test_renders_a_view_that_meets_no_occupied_cell():
    """Rays that meet no occupied cell give the field an empty batch (a
    trained grid leaves whole 8192-ray chunks so): the view renders as its
    background, with no sample.  The grid of a fresh state is empty."""
    from nerfacc_tpu_torch.data.procedural import ProceduralDynamicSceneLoader
    from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer

    ds = ProceduralDynamicSceneLoader(split="test", n_test=1, width=8, height=8, device="cpu")
    trainer = NGPOccTrainer(
        field=TiNeuVoxRadianceField(AABB, device="cpu", **SMALL), aabb=AABB,
        timestamps=ds.timestamps, device="cpu",
    )
    data = ds[0]
    colors, opacities, depths, n_samples = trainer.render_rays(trainer.init_state(), data)
    assert n_samples == 0 and colors.shape == (64, 3)
    assert (opacities == 0).all() and torch.equal(colors, data["color_bkgd"].expand(64, 3))


@pytest.mark.parametrize(
    "resolutions,ranks", [((32, 128, 512), (16, 16, 32)), (SMALL["resolutions"], SMALL["ranks"])],
    ids=["tineuvox", "small"],
)
def test_hat_encoder_matches_the_per_axis_route(resolutions, ranks):
    """``CPGridEncoder(use_pallas=True)`` at seeded tables, one
    ``hat_cp_level`` a level, against the route it replaced, written out
    here: per axis ``hat_interp_matmul(x[:, axis], line[axis])`` on the
    clamped points, ``(a_0 * a_1) * a_2``, the levels concatenated.  Output,
    table gradients and the points' total gradient bitwise (autograd adds
    the levels' point gradients in the same order on both routes)."""
    from nerfacc_tpu_torch.models.cp_field import CPGridEncoder
    from nerfacc_tpu_torch.ops.hat_matmul import hat_interp_matmul

    rng = np.random.default_rng(11)
    enc = CPGridEncoder(resolutions, ranks, use_pallas=True)
    with torch.no_grad():
        for line in enc.lines:
            line.copy_(torch.tensor(1.0 + 0.1 * rng.standard_normal(line.shape), dtype=torch.float32))
    x0 = rng.uniform(-0.05, 1.05, (N, 3)).astype(np.float32)
    cot = torch.tensor(rng.standard_normal((N, enc.output_dim)).astype(np.float32))

    def per_axis(x):
        x = x.clamp(0.0, 1.0)
        feats = []
        for line in enc.lines:
            prod = hat_interp_matmul(x[:, 0], line[0])
            for axis in (1, 2):
                prod = prod * hat_interp_matmul(x[:, axis], line[axis])
            feats.append(prod)
        return torch.cat(feats, dim=-1)

    results = []
    for route in (per_axis, enc):
        enc.zero_grad()
        x = torch.tensor(x0, requires_grad=True)
        out = route(x)
        out.backward(cot)
        results.append([out.detach(), x.grad] + [line.grad.clone() for line in enc.lines])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert float(results[1][1].abs().max()) > 0


TRAJ_STEPS = 6
TRAJ_GRID = 16
TRAJ_RAYS = 48


@pytest.mark.parametrize("jdtype,dtype", DTYPES)
def test_trainer_trajectory_matches_jax(interpret_k3, jdtype, dtype):
    """Fault F3's check at a small width: the JAX TiNeuVox trainer and the
    port's, from the same parameters, take TRAJ_STEPS steps on the same
    batches with the same noise (each step's near-plane jitter and the
    refreshes' cell jitter and frame draw, drawn from the JAX trainer's key
    and handed to the port) at phase 12's optimiser settings.  After every
    step: the loss within 2e-5 relative of JAX's (read: at most 5.7e-6),
    and the deformation MLP's output ``raw`` on 4096 fixed points at
    training times, read through the same forward from each package's
    parameters, within 5e-3 of its largest entry in the f32 field (read:
    1.2e-3 by step 6) and 2e-2 in the bf16 field (read: 6.7e-3).  The gap
    grows step by step: Adam moves each weight by about the learning rate
    whatever its gradient's size, so last-bit differences in a near-zero
    gradient move ``raw`` by up to that.  The deformation must move (its
    output grows from the rigid init's ~1e-4)."""
    from nerfacc_tpu.data.procedural import ProceduralDynamicSceneLoader as JaxLoader
    from nerfacc_tpu.trainers.ngp_occ import NGPOccTrainer as JaxTrainer
    from nerfacc_tpu_torch.models.ngp import _mlp_apply
    from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer, TrainState
    from nerfacc_tpu_torch.utils.jax_bridge import occ_state_from_numpy

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")
        ds = JaxLoader("train", n_train=5, width=16, height=16, num_rays=TRAJ_RAYS)
    timestamps = np.asarray(ds.timestamps)
    batches = [{k: np.asarray(v) for k, v in ds[0].items()} for _ in range(TRAJ_STEPS)]
    settings = dict(weight_decay=0.0, field_reg_weight=1e-4, max_steps=1000,
                    grid_resolution=TRAJ_GRID, update_interval=4)
    jfield = JaxTiNeuVox(aabb=AABB, compute_dtype=jdtype, **SMALL)
    object.__setattr__(jfield, "encoder", dataclasses.replace(jfield.encoder, use_pallas=True))
    jtrainer = JaxTrainer(
        field=jfield, aabb=AABB, traversal="padded", windowed=False,
        max_samples_per_ray=1400, dynamic_budget=False, sample_budget=2**14,
        timestamps=timestamps, time_dependent=True, **settings,
    )
    jstate = jtrainer.init_state()
    jparams = jax.tree.map(np.asarray, jstate.params)
    jocc = tuple(np.asarray(a) for a in (jstate.occ_state.aabbs, jstate.occ_state.occs,
                                         jstate.occ_state.binaries))
    field = TiNeuVoxRadianceField(AABB, compute_dtype=dtype, device="cpu", **SMALL)
    trainer = NGPOccTrainer(field=field, aabb=AABB, sample_budget=2**14,
                            timestamps=timestamps, device="cpu", **settings)
    params = tineuvox_field_params_from_numpy(jparams, device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    state = TrainState(params, trainer.init_optimizer(params),
                       occ_state_from_numpy(*jocc, device="cpu"), 0)

    rng = np.random.default_rng(5)
    x = torch.tensor(rng.uniform(-1.5, 1.5, (4096, 3)).astype(np.float32))
    t = torch.tensor(timestamps[rng.integers(0, timestamps.shape[0], 4096)])
    reader = TiNeuVoxRadianceField(AABB, compute_dtype=dtype, device="cpu", **SMALL)

    @torch.no_grad()
    def raw(p):
        reader.load_state_dict({k: v.detach() for k, v in p.items()})
        h = torch.cat([reader.posi_encoder(x), reader.time_encoder(t)], dim=-1)
        return _mlp_apply(reader.deform, h, dtype)

    start = float(raw(params).abs().max())
    tol = 5e-3 if dtype == torch.float32 else 2e-2
    for i, batch in enumerate(batches):
        _, k_occ, k_strat, k_time = jax.random.split(jstate.key, 4)
        near = np.asarray(jax.random.uniform(k_strat, (TRAJ_RAYS,)))
        cells = np.asarray(jax.random.uniform(
            jax.random.split(k_occ, 4)[3], (1, TRAJ_GRID**3, 3)))
        frames = np.asarray(jax.random.randint(
            k_time, (TRAJ_GRID**3,), 0, timestamps.shape[0]))
        jstate, jaux = jtrainer.train_step(jstate, batch)
        state, aux = trainer.train_step(
            state, {k: torch.tensor(v) for k, v in batch.items()},
            near_jitter=torch.tensor(near), cell_jitter=torch.tensor(cells),
            frame_idx=torch.tensor(frames),
        )
        assert float(aux["loss"]) == pytest.approx(float(jaux["loss"]), rel=2e-5), i
        want = raw(tineuvox_field_params_from_numpy(
            jax.tree.map(np.asarray, jstate.params), device="cpu")).numpy()
        got = raw(state.params).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(),
                                   err_msg=f"step {i}")
    assert np.abs(want).max() > 10 * start
