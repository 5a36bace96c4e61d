"""Port vs JAX: the BARF trainer, step for step, at a tiny size.

Both trainers start from the same field parameters (through the bridge),
the same noisy poses (JAX's twists injected), the same all-occupied grid at
step 14, the same pixel batches and JAX's noise (the near-plane jitter and
the refresh's cell jitter), and run steps 14-17: the poses are frozen
before ``pose_start_step`` 16, the refresh at 16 runs with the
coarse-to-fine window of that step, and one camera looks down the box's
diagonal, whose orbit runs past the 1024 candidates a ray may emit (the
candidate lattice starts at the near plane, 0).
JAX's gradients are read off its Adam moments, ``g = (mu_t - 0.9
mu_{t-1}) / 0.1``.

Bounds (the field is f32): the loss and the pose gradient's norm within
1e-5 relative, each gradient leaf within 1e-4 in relative Frobenius norm
(the sine, the positions and the matmuls round apart at the last bit), the
sample counts equal, the pose deltas within 1e-6 of JAX's after Adam, each
field leaf's Adam step within 1e-3 of its size in relative Frobenius norm
(Adam's update ``m / (sqrt(v) + eps)`` turns a last-bit difference of a
gradient entry near 0 into a difference of order ``lr``), and a rendered
view within 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.data.procedural import ProceduralSceneLoader as JaxLoader
from nerfacc_tpu.estimators.occ_grid import sampling_padded as jax_sampling_padded
from nerfacc_tpu.models.mlp import VanillaNeRFRadianceField as JaxVanilla
from nerfacc_tpu.models.pose import perturb_poses as jax_perturb_poses
from nerfacc_tpu.trainers.barf import BARFTrainer as JaxBARF
from nerfacc_tpu_torch.estimators.occ_grid import sampling, visible_samples
from nerfacc_tpu_torch.models.mlp import VanillaNeRFRadianceField
from nerfacc_tpu_torch.trainers.barf import BARFTrainer, BARFTrainState
from nerfacc_tpu_torch.utils.jax_bridge import (
    barf_params_from_numpy,
    barf_params_to_numpy,
    occ_state_from_numpy,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
TINY = dict(net_depth=2, net_width=32, net_depth_condition=1, net_width_condition=16)
GRID = 16
N_RAYS = 24
SIZE = 8
START = 14  # the first step; the refresh comes at 16, the poses unfreeze at 16
TRAINER = dict(aabb=AABB, grid_resolution=GRID, max_steps=80, pose_start_step=16, seed=0)


def _diagonal_camera() -> np.ndarray:
    """A (3, 4) camera 3.2 from the origin on the (-1, -1, -1) diagonal,
    looking at the origin (OpenGL axes: -z forward)."""
    eye = -3.2 * np.ones(3) / np.sqrt(3.0)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    return np.stack([right, up, -fwd, eye], axis=1).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """The JAX loader's cameras plus the diagonal one, JAX's noisy poses,
    four pixel batches (each with the diagonal camera's centre pixel) and
    JAX's field parameters."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")
        ds = JaxLoader("train", n_train=4, width=SIZE, height=SIZE, num_rays=N_RAYS, seed=3)
        test = JaxLoader("test", n_test=1, width=SIZE, height=SIZE)
    c2w = np.concatenate([np.asarray(ds.camtoworlds, np.float32)[:, :3, :4],
                          _diagonal_camera()[None]])
    noisy, _ = jax_perturb_poses(jax.random.PRNGKey(5), c2w, 0.01, 0.01)
    noisy = np.array(noisy)
    noisy[-1] = c2w[-1]  # a tilt would cut the diagonal orbit short
    # the principal point on a pixel centre, so that pixel (3, 3) looks
    # down the optical axis
    K = np.array(ds.K, np.float32)
    K[0, 2] = K[1, 2] = 3.5
    batches = []
    for _ in range(4):
        b = {k: np.asarray(v) for k, v in ds.pixel_batch(0).items()}
        b["img_ids"][0], b["x"][0], b["y"][0] = len(c2w) - 1, 3, 3
        batches.append(b)
    params = JaxVanilla(**TINY).init(jax.random.PRNGKey(1))
    view = {k: np.asarray(v) for k, v in test[0].items()}
    return noisy, K, batches, params, view


def _grads(jtrainer, before, after):
    """JAX's gradients of the step from ``before`` to ``after``, off its Adam
    first moments."""
    def mus(state):
        inner = state.opt_state.inner_states
        return (inner["field"].inner_state[0].mu["field"],
                inner["pose"].inner_state[0].mu["pose_deltas"])

    (f0, p0), (f1, p1) = mus(before), mus(after)
    g = lambda a, b: (np.asarray(b, np.float64) - 0.9 * np.asarray(a, np.float64)) / 0.1
    return jax.tree.map(g, f0, f1), g(p0, p1)


def _rel_fro(a, b):
    return np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30)


def test_barf_steps_match_jax(setup):
    noisy, K, batches, params, view = setup
    jtrainer = JaxBARF(field=JaxVanilla(**TINY), camtoworlds_init=noisy, K=K, **TRAINER)
    jstate = jtrainer.init_state()
    occ = jstate.occ_state
    occ = type(occ)(aabbs=occ.aabbs, occs=occ.occs, binaries=jnp.ones_like(occ.binaries))
    jstate = jstate._replace(params={"field": params, "pose_deltas": jstate.params["pose_deltas"]},
                             occ_state=occ, step=jnp.asarray(START, jnp.int32))
    jstate = jstate._replace(opt_state=jtrainer.optimizer.init(jstate.params))
    trainer = BARFTrainer(field=VanillaNeRFRadianceField(**TINY, device="cpu"),
                          camtoworlds_init=noisy, K=K, device="cpu", **TRAINER)
    tparams = barf_params_from_numpy(
        {"field": jax.tree.map(np.asarray, params),
         "pose_deltas": np.zeros((len(noisy), 6), np.float32)}, "cpu")
    for leaf in (*tparams["field"].values(), tparams["pose_deltas"]):
        leaf.requires_grad_(True)
    state = BARFTrainState(tparams, trainer.init_optimizer(tparams),
                           occ_state_from_numpy(*map(np.asarray, (occ.aabbs, occ.occs,
                                                                  occ.binaries)), "cpu"),
                           START)
    jstep = jax.jit(jtrainer._step_body)
    capped = None
    for batch in batches:
        step = int(state.step)
        _, k_occ, k_strat = jax.random.split(jstate.key, 3)
        near = np.asarray(jax.random.uniform(k_strat, (N_RAYS,), jnp.float32))
        cells = np.asarray(jax.random.uniform(jax.random.split(k_occ, 4)[3], (1, GRID**3, 3)))
        before = jstate
        jstate, jaux = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tbatch = {k: torch.tensor(v) for k, v in batch.items()}
        if capped is None:
            rays_o, rays_d = trainer.rays_from_pixels(state.params["pose_deltas"],
                                                      tbatch["img_ids"], tbatch["x"],
                                                      tbatch["y"])
            capped = [int(sampling(state.occ_state, rays_o.detach(), rays_d.detach(),
                                   render_step_size=trainer.render_step_size,
                                   near_jitter=torch.tensor(near), max_samples=m).counts[0])
                      for m in (1024, None)]
        state, aux = trainer.train_step(state, tbatch, torch.tensor(near), torch.tensor(cells))
        assert float(aux["loss"]) == pytest.approx(float(jaux["loss"]), rel=1e-5), step
        assert float(aux["mse"]) == pytest.approx(float(jaux["mse"]), rel=1e-5), step
        assert aux["n_total_samples"] == int(jaux["n_total_samples"]), step
        assert float(aux["pose_grad_norm"]) == pytest.approx(
            float(jaux["pose_grad_norm"]), rel=1e-5), step
        gfield, gpose = _grads(jtrainer, before, jstate)
        got = barf_params_to_numpy({"field": {k: v.grad for k, v in state.params["field"].items()},
                                    "pose_deltas": state.params["pose_deltas"].grad})
        for a, b in zip(jax.tree.leaves(got["field"]), jax.tree.leaves(gfield)):
            assert _rel_fro(a, b) <= 1e-4, step
        if step < TRAINER["pose_start_step"]:
            assert not got["pose_deltas"].any() and not gpose.any()
        else:
            assert _rel_fro(got["pose_deltas"], gpose) <= 1e-4, step
        now = barf_params_to_numpy(state.params)
        np.testing.assert_allclose(now["pose_deltas"], np.asarray(jstate.params["pose_deltas"]),
                                   rtol=0, atol=1e-6)
        prev = jax.tree.leaves(before.params["field"])
        for a, b, p in zip(jax.tree.leaves(now["field"]),
                           jax.tree.leaves(jstate.params["field"]), prev):
            moved = np.asarray(b, np.float64) - np.asarray(p)
            assert _rel_fro(np.asarray(a, np.float64) - np.asarray(p), moved) <= 1e-3, step
    # the diagonal orbit is cut at the 1024th candidate from the near plane
    assert capped[0] < capped[1] and capped[0] > 800, capped
    assert int(state.step) == START + 4 and int(jstate.step) == START + 4
    assert np.abs(now["pose_deltas"]).max() > 0  # the poses moved after step 16
    ref = jtrainer.render_image(jstate, view)
    colors = trainer.render_image(state, {k: torch.tensor(v) for k, v in view.items()})
    np.testing.assert_allclose(colors.numpy(), ref, rtol=0, atol=1e-5)


def test_capped_diagonal_ray_matches_sampling_padded():
    """A ray down the box's diagonal through an all-occupied grid (about
    1039 candidates inside the box at step 5e-3) keeps those among the
    first 1024 of its lattice from the near plane, as JAX's padded lattice
    does, and the visibility filter keeps the same ones."""
    o = np.array([[-1.6, -1.6, -1.6], [-1.6, 0.1, 0.2]], np.float32)
    d = np.array([[1.0, 1.0, 1.0], [1.0, 0.05, -0.02]], np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    aabbs = np.array([AABB], np.float32)
    occs = np.zeros(GRID**3, np.float32)
    binaries = np.ones((1, GRID, GRID, GRID), bool)
    sigma = lambda x: 0.05 * (1.0 + np.sin(3.0 * x).sum(-1))
    from nerfacc_tpu.estimators.occ_grid import OccGridState as JaxState

    def jsigma(t0, t1, rid):
        x = jnp.asarray(o)[:, None] + (0.5 * (t0 + t1))[..., None] * jnp.asarray(d)[:, None]
        return 0.05 * (1.0 + jnp.sin(3.0 * x).sum(-1))

    ref = jax_sampling_padded(JaxState(jnp.asarray(aabbs), jnp.asarray(occs),
                                       jnp.asarray(binaries)),
                              jnp.asarray(o), jnp.asarray(d), sigma_fn=jsigma,
                              render_step_size=5e-3, max_samples=1024)
    valid = np.asarray(ref.valid)
    state = occ_state_from_numpy(aabbs, occs, binaries, "cpu")
    res = sampling(state, torch.tensor(o), torch.tensor(d), render_step_size=5e-3,
                   max_samples=1024)
    full = sampling(state, torch.tensor(o), torch.tensor(d), render_step_size=5e-3)
    assert res.counts[0] < full.counts[0] and res.counts[0] > 900
    assert res.counts[1] == full.counts[1]
    ids, t0, t1 = res.ray_indices.long(), res.t_starts, res.t_ends

    def tsigma(a, b, rid):
        x = torch.tensor(o)[rid] + (0.5 * (a + b))[:, None] * torch.tensor(d)[rid]
        return torch.tensor(sigma(x.numpy()))

    vis = visible_samples(state.occs, ids, t0, t1, 2, sigma_fn=tsigma)
    for r in range(2):
        keep = vis & (ids == r)
        np.testing.assert_array_equal(t0[keep].numpy(), np.asarray(ref.t_starts)[r][valid[r]])


def test_example_runs_two_calls_and_takes_the_jax_flags(capsys):
    """``train_barf``'s flags and defaults are the JAX script's (plus
    ``--device``); ``build`` and ``train_loop`` at a tiny size run two calls
    of two steps: a record a call with finite losses, the pose errors from
    the perturbed start, the log lines and the JSON summary."""
    import ast
    import pathlib

    from nerfacc_tpu_torch.examples import train_barf as ex

    src = (pathlib.Path(__file__).resolve().parent.parent / "examples" / "train_barf.py")
    jax_flags = {}
    for node in ast.walk(ast.parse(src.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"):
            name = node.args[0].value.lstrip("-")
            kw = {k.arg: k.value for k in node.keywords}
            jax_flags[name] = ast.literal_eval(kw["default"]) if "default" in kw else (
                False if isinstance(kw.get("action"), ast.Constant) else None)
    ap = ex.parser()
    for name, default in jax_flags.items():
        assert ap.get_default(name) == default, name
    assert ap.get_default("device") == "cuda"
    args = ap.parse_args(["--device", "cpu", "--max_steps", "4", "--steps_per_call", "2",
                          "--num_rays", "32", "--width", "12", "--height", "12",
                          "--log_every", "2", "--eval_images", "1"])
    trainer, train_ds, test_ds = ex.build(
        args, scene_kwargs=dict(n_train=3, n_test=1), field_kwargs=TINY,
        trainer_kwargs=dict(grid_resolution=8))
    assert trainer.pose_start_step == 1 and trainer.pe_c2f == (0.1, 0.5)
    run = ex.train_loop(trainer, train_ds, test_ds, args)
    assert [r["step"] for r in run.log] == [2, 4] and int(run.state.step) == 4
    assert all(np.isfinite(r["loss"]) and r["samples"] > 0 for r in run.log)
    assert run.pose_errors["initial"]["rot_deg"] > 0.5
    assert np.isfinite(run.metrics["psnr"]) and run.metrics["views"][0]["finite"]
    out = capsys.readouterr().out
    assert "initial pose error" in out and "train_psnr=" in out and "evaluation: psnr=" in out
    assert json.loads(out.strip().splitlines()[-1]) == run.summary
    assert set(run.summary) == {"name", "steps", "psnr", "ssim", "rot_deg", "trans",
                                "rot_deg_init", "trans_init", "train_wall_s"}


@pytest.mark.parametrize("aug", ["white", "random"])
def test_pixel_batches_match_jax(tmp_path, monkeypatch, aug):
    """``pixel_batch`` of the procedural and the Blender loaders: three
    consecutive batches from the same seed are JAX's, bitwise (the same
    numpy draws, then the same colours over the same background), but for
    the procedural colours, whose ground truth the two packages integrate
    apart by up to 1/255 (an 8-bit level)."""
    pytest.importorskip("imageio")
    from nerfacc_tpu.data.nerf_synthetic import SubjectLoader as JaxBlender
    from nerfacc_tpu_torch.data.nerf_synthetic import SubjectLoader as Blender
    from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
    from test_torch_datasets import H, W, _write_blender_fixture

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")
        kw = dict(split="train", n_train=3, width=SIZE, height=SIZE, num_rays=11, seed=4,
                  color_bkgd_aug=aug)
        pairs = [(JaxLoader(**kw), ProceduralSceneLoader(**kw, device="cpu"))]
    _write_blender_fixture(str(tmp_path))
    for cls in (JaxBlender, Blender):
        monkeypatch.setattr(cls, "WIDTH", W)
        monkeypatch.setattr(cls, "HEIGHT", H)
    kw = dict(subject_id="tiny", root_fp=str(tmp_path), split="train", num_rays=13, seed=2,
              color_bkgd_aug=aug)
    pairs.append((JaxBlender(**kw), Blender(**kw, device="cpu")))
    for (ref_ds, ds), rgb_tol in zip(pairs, (1.0 / 255 + 1e-6, 0.0)):
        for _ in range(3):
            ref, out = ref_ds.pixel_batch(0), ds.pixel_batch(0)
            assert set(out) == set(ref) == {"img_ids", "x", "y", "rgb", "color_bkgd"}
            for key in ("img_ids", "x", "y", "color_bkgd"):
                np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), key)
            np.testing.assert_allclose(out["rgb"].numpy(), ref["rgb"], rtol=0, atol=rgb_tol)
            assert out["img_ids"].dtype == torch.int32
