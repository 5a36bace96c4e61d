"""The port's occupancy example (``nerfacc_tpu_torch.examples.train_ngp_nerf_occ``)
at a tiny size on the CPU: its ray-batch controller against the JAX script's,
and a run interrupted by a checkpoint against the same run uninterrupted."""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as ex
from nerfacc_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_SCRIPT = ROOT / "examples" / "train_ngp_nerf_occ.py"
SCENE = dict(n_train=3, n_test=1, width=16, height=16)
FIELD = dict(resolutions=(8, 16), ranks=(4, 4), compute_dtype=torch.float32)


def _jax_script():
    """examples/train_ngp_nerf_occ.py as a module (it imports JAX only in
    its main) and its source."""
    spec = importlib.util.spec_from_file_location("jax_train_ngp_nerf_occ", JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module, JAX_SCRIPT.read_text()


def _run(tmp_path, argv, model_path=None, scene_kwargs=SCENE, grid_resolution=16):
    args = ex.parser().parse_args(
        ["--device", "cpu", "--steps_per_call", "8", "--ckpt_every", "8",
         "--target_sample_batch_size", "4096", "--init_batch_size", "64",
         "--log_every", "1000", *argv]
        + (["--model_path", str(model_path)] if model_path else [])
    )
    trainer, train_ds, test_ds = ex.build(
        args, scene_kwargs=scene_kwargs, field_kwargs=FIELD,
        trainer_kwargs=dict(grid_resolution=grid_resolution),
    )
    return trainer, ex.train_loop(trainer, train_ds, test_ds, args)


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    assert list(a.params) == list(b.params)
    adam_a, adam_b = a.opt_state.optimizer, b.opt_state.optimizer
    for name in a.params:
        pa, pb = a.params[name], b.params[name]
        assert torch.equal(pa, pb), name
        sa, sb = adam_a.state[pa], adam_b.state[pb]
        assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
        for key in sa:
            assert torch.equal(sa[key], sb[key]), (name, key)
    for key in ("aabbs", "occs", "binaries"):
        assert torch.equal(getattr(a.occ_state, key), getattr(b.occ_state, key)), key


def test_buckets_and_controller_match_the_jax_script():
    """``round_to_bucket``, the bucket list and the controller's update
    (scale by budget / demand, grow at most 2x, round down) against the JAX
    script's function and arithmetic, over a sweep of demands."""
    jax_script, src = _jax_script()
    assert "{1024 * 2**i for i in range(8)}" in src and "{1536 * 2**i for i in range(7)}" in src
    buckets = sorted({1024 * 2**i for i in range(8)} | {1536 * 2**i for i in range(7)})
    assert ex.BUCKETS == buckets and buckets[0] == 1024 and buckets[-1] == 131072
    # the script's update, line for line
    assert "num_rays * (args.target_sample_batch_size / float(n_total))" in src
    assert "want = min(want, num_rays * 2)" in src
    budget = 1 << 18
    for n in list(range(0, 140000, 97)) + [10**6, 10**7]:
        assert ex.round_to_bucket(n, buckets) == jax_script.round_to_bucket(n, buckets)
    for num_rays in buckets:
        for n_total in np.unique(np.geomspace(1, 5e7, 400).astype(int)):
            want = int(num_rays * (budget / float(n_total)))
            want = min(want, num_rays * 2)
            assert ex.next_num_rays(num_rays, int(n_total), budget) == (
                jax_script.round_to_bucket(want, buckets)
            )


class _Interrupted(Exception):
    pass


def test_interrupted_run_resumes_bitwise(tmp_path, monkeypatch):
    """A 16-step run stopped right after its checkpoint at step 8, then run
    again with the same arguments, which resumes from it: bitwise the 16
    uninterrupted steps in the parameters, Adam's moments and counts, the
    occupancy grid and the step (the batches are drawn on the device from
    generators keyed by the step).  The checkpoint loads back bitwise."""
    ckpt = tmp_path / "ckpt.pt"
    saved = []

    def save_then_stop(path, state):
        save_checkpoint(path, state)
        saved.append(state)
        raise _Interrupted

    with monkeypatch.context() as m:
        m.setattr(ex, "save_checkpoint", save_then_stop)
        with pytest.raises(_Interrupted):
            _run(tmp_path, ["--max_steps", "8"], ckpt)
    assert saved[0].step == 8
    _assert_states_equal(
        load_checkpoint(str(ckpt), like=saved[0], device="cpu"), saved[0]
    )
    _, resumed = _run(tmp_path, ["--max_steps", "8"], ckpt)
    _, whole = _run(tmp_path, ["--max_steps", "8"])
    assert whole.state.step == resumed.state.step == 16
    _assert_states_equal(resumed.state, whole.state)
    assert resumed.metrics["psnr"] == whole.metrics["psnr"]


def test_checkpoint_refuses_another_state(tmp_path):
    trainer, run = _run(tmp_path, ["--max_steps", "0"])
    path = tmp_path / "ckpt.pt"
    save_checkpoint(str(path), run.state)
    args = ex.parser().parse_args(["--device", "cpu"])
    other, _, _ = ex.build(
        args, scene_kwargs=SCENE, field_kwargs=dict(FIELD, ranks=(4, 8)),
        trainer_kwargs=dict(grid_resolution=16),
    )
    with pytest.raises(ValueError, match="the state's"):
        load_checkpoint(str(path), like=other.init_state(), device="cpu")


def test_controller_grows_the_batch_on_the_host_path(tmp_path):
    """The host loader's batches (``--device_sampler 0``) on the opaque
    scene: the controller moves the ray count to a bucket, every call is
    recorded, and the loop ends past ``--max_steps`` as the JAX loop does."""
    trainer, run = _run(
        tmp_path, ["--max_steps", "32", "--device_sampler", "0", "--scene",
                   "proceduralopaque", "--target_sample_batch_size", "1048576"],
    )
    assert run.state.step == 40
    assert [r["step"] for r in run.log] == list(range(8, 41, 8))
    rays = [r["num_rays"] for r in run.log]
    assert rays[:3] == [64, 64, 64] and rays[3] in ex.BUCKETS
    assert all(np.isfinite(r["loss"]) and r["samples"] > 0 for r in run.log)
    assert np.isfinite(run.metrics["psnr"]) and run.metrics["views"][0]["finite"]


def test_sampled_steps_refuse_a_time_dependent_field():
    args = ex.parser().parse_args(["--device", "cpu"])
    trainer, train_ds, _ = ex.build(
        args, scene_kwargs=SCENE, field_kwargs=FIELD,
        trainer_kwargs=dict(grid_resolution=16, timestamps=[[0.0], [1.0]]),
    )
    sampler = ex.DeviceRaySampler.from_loader(train_ds)
    with pytest.raises(ValueError, match="time-dependent"):
        trainer.train_steps_sampled(trainer.init_state(), sampler, 1)


def test_entry_point_defaults_to_the_card():
    args = ex.parser().parse_args([])
    assert args.device == "cuda" and args.field == "cp" and args.device_sampler == 1
    assert args.target_sample_batch_size == 1 << 18 and args.init_batch_size == 1024


def test_occupancy_example_refuses_the_unbounded_scene(tmp_path):
    """The name is kept from when ``--scene procedural360`` was refused; the
    scene now trains through the unbounded branch: a 4-level grid, step
    1e-3, cone 0.004, ``alpha_thre`` 1e-2, near 0.2, contracted fields over
    the box +-1, no weight decay, random train backgrounds and six test
    views.  Four steps at a tiny size (two calls of two): every call
    recorded with a finite loss and samples, no ray truncated, and a
    finite evaluation over the six views."""
    trainer, run = _run(
        tmp_path, ["--scene", "procedural360", "--max_steps", "2", "--steps_per_call", "2",
                   "--init_batch_size", "32"],
        scene_kwargs=dict(SCENE, n_test=6, width=12, height=12), grid_resolution=8,
    )
    assert (trainer.grid_nlvl, trainer.render_step_size, trainer.cone_angle) == (4, 1e-3, 0.004)
    assert (trainer.alpha_thre, trainer.near_plane, trainer.weight_decay) == (1e-2, 0.2, 0.0)
    assert trainer.field.unbounded and trainer.field.aabb.tolist() == ex.AABB_UNBOUNDED
    assert run.state.occ_state.levels == 4 and run.state.step == 4
    assert [r["step"] for r in run.log] == [2, 4]
    assert all(np.isfinite(r["loss"]) and r["samples"] > 0 and r["n_rays_truncated"] == 0
               for r in run.log)
    assert len(run.metrics["views"]) == 6 and np.isfinite(run.metrics["psnr"])
    assert all(v["finite"] for v in run.metrics["views"])


class _Captured(Exception):
    pass


def _jax_branch(monkeypatch, argv):
    """What the JAX script builds for ``argv``: its loaders' (name, keyword
    arguments), its field and its ``NGPOccTrainer``'s keyword arguments,
    caught at the trainer's construction (the loaders replaced by
    stand-ins, so that no ground truth is rendered)."""
    import nerfacc_tpu.data as jax_data
    import nerfacc_tpu.data.nerf_360_v2 as jax_360
    import nerfacc_tpu.trainers as jax_trainers
    import nerfacc_tpu.utils as jax_utils

    made = []

    def stand_in(name):
        def init(self, **kw):
            made.append((name, kw))
        return type(name, (), {"__init__": init})

    def capture(**kwargs):
        raise _Captured(kwargs)

    for name in ("ProceduralSceneLoader", "ProceduralUnboundedSceneLoader", "SubjectLoader"):
        monkeypatch.setattr(jax_data, name, stand_in(name))
    monkeypatch.setattr(jax_data, "PROCEDURAL_SCENES", {
        "procedural": jax_data.ProceduralSceneLoader,
        "proceduralopaque": stand_in("ProceduralOpaqueSceneLoader")})
    monkeypatch.setattr(jax_360, "SubjectLoader", stand_in("Loader360"))
    monkeypatch.setattr(jax_trainers, "NGPOccTrainer", capture)
    monkeypatch.setattr(jax_utils, "setup_compilation_cache", lambda: None)
    monkeypatch.setattr("sys.argv", ["train_ngp_nerf_occ.py", *argv])
    with pytest.raises(_Captured) as caught:
        _jax_script()[0].main()
    monkeypatch.undo()
    return made, caught.value.args[0]


TRAINER_KEYS = ("grid_nlvl", "render_step_size", "cone_angle", "alpha_thre", "near_plane",
                "weight_decay", "sample_budget", "seed", "max_steps", "dense_occ_update",
                "occ_refresh_stripes", "field_reg_weight", "max_samples_per_ray", "traversal",
                "window_budget", "fine_probes")
# each field kind's widths in the branch test (the hash grid's otherwise)
SMALL_FIELDS = {
    "cp": FIELD,
    "tensorf": dict(resolutions=(8, 16), ranks=(4, 4), plane_resolutions=(8,),
                    plane_ranks=(4,), compute_dtype=torch.float32),
    "voxel": dict(resolutions=(8,), channels=(2,), compute_dtype=torch.float32),
}


@pytest.mark.parametrize("argv", [
    ["--scene", "procedural360", "--field", "ngp"],
    ["--scene", "garden", "--sampled_occ_update"],
    ["--scene", "proceduralopaque", "--occ_stripes", "4", "--seed", "7"],
    ["--scene", "lego", "--data_root", "ROOT", "--train_split", "trainval"],
    ["--scene", "ficus", "--data_root", "ROOT", "--sampled_occ_update"],
    ["--scene", "garden", "--data_root", "ROOT", "--field", "ngp"],
    ["--scene", "procedural", "--field", "tensorf"],
    ["--scene", "proceduralopaque", "--field", "voxel", "--field_reg_weight", "1e-4"],
    ["--scene", "procedural", "--field", "cp", "--plane_res", "8", "--plane_rank", "4",
     "--field_reg_weight", "1e-3"],
    ["--scene", "procedural", "--traversal", "padded", "--window_budget", "4096",
     "--fine_probes", "4"],
], ids=["procedural360", "garden-procedural", "opaque-stripes", "lego-data", "ficus-data",
        "garden-data", "tensorf", "voxel", "cp-planes", "padded"])
def test_branches_match_the_jax_script(monkeypatch, tmp_path, argv):
    """``build`` for each of the JAX script's branches: the trainer's
    marching, occupancy-update and optimiser settings and box, the field's
    class, box and contraction, and each loader's class and arguments (the
    Blender loader of ``--train_split``, the 360 loader at ``factor=4``
    with random train backgrounds, the procedural scenes); the data
    branches on fixtures written into ``tmp_path``."""
    from test_torch_datasets import _write_blender_fixture, _write_colmap_fixture

    from nerfacc_tpu_torch.data.nerf_360_v2 import SubjectLoader as Loader360
    from nerfacc_tpu_torch.data.nerf_synthetic import SubjectLoader as Blender

    argv = [str(tmp_path) if a == "ROOT" else a for a in argv]
    made, want = _jax_branch(monkeypatch, argv)
    scene = argv[argv.index("--scene") + 1]
    if "--data_root" in argv:
        _write_colmap_fixture(str(tmp_path), subject=scene)
        _write_blender_fixture(str(tmp_path), subject=scene)
        monkeypatch.setattr(Blender, "WIDTH", 8)
        monkeypatch.setattr(Blender, "HEIGHT", 8)
    args = ex.parser().parse_args([*argv, "--device", "cpu"])
    field_kwargs = SMALL_FIELDS.get(args.field, dict(
        n_levels=2, log2_hashmap_size=8, max_resolution=32, compute_dtype=torch.float32))
    trainer, train_ds, test_ds = ex.build(
        args, scene_kwargs=dict(n_train=2, width=8, height=8), field_kwargs=field_kwargs,
        trainer_kwargs=dict(grid_resolution=8))
    from nerfacc_tpu.trainers.ngp_occ import NGPOccTrainer as JaxTrainer

    want = {**{f.name: f.default for f in dataclasses.fields(JaxTrainer)}, **want}
    for key in TRAINER_KEYS:
        assert getattr(trainer, key) == want[key], key
    np.testing.assert_array_equal(trainer.aabb, want["aabb"])
    jfield = want["field"]
    assert type(trainer.field).__name__ == type(jfield).__name__
    assert trainer.field.unbounded == jfield.unbounded
    if args.field == "cp":  # the plane flags reach the field
        enc = trainer.field.encoder
        assert enc.plane_resolutions == tuple(jfield.plane_resolutions)
        assert enc.plane_ranks == tuple(jfield.plane_ranks)
        assert enc.plane_mode == jfield.plane_mode
    names = {"ProceduralSceneLoader": "ProceduralSceneLoader",
             "ProceduralUnboundedSceneLoader": "ProceduralUnboundedSceneLoader",
             "ProceduralOpaqueSceneLoader": "ProceduralOpaqueSceneLoader",
             "SubjectLoader": Blender.__name__, "Loader360": Loader360.__name__}
    for (name, kw), ds in zip(made, (train_ds, test_ds)):
        assert type(ds).__name__ == names[name]
        if name == "Loader360":
            assert type(ds) is Loader360
        assert ds.num_rays == kw.get("num_rays") and ds.split == kw.get("split", "train")
        assert ds.color_bkgd_aug == kw.get("color_bkgd_aug", "white")
        if "n_test" in kw:
            assert len(ds) == kw["n_test"]
        if name == "Loader360":
            assert kw["factor"] == 4 and ds.WIDTH == 2


@pytest.mark.parametrize("argv", [
    ["--field", "cp", "--plane_res", "8", "--plane_rank", "4", "--field_reg_weight", "1e-3"],
    ["--field", "voxel", "--field_reg_weight", "1e-3"],
], ids=["cp-planes", "voxel"])
def test_field_flags_train(tmp_path, argv):
    """Two calls of two steps at a tiny size with tri-plane levels or the
    voxel field and the regulariser on: every call recorded with a finite
    loss, and a finite evaluation."""
    args = ex.parser().parse_args(
        ["--device", "cpu", "--max_steps", "2", "--steps_per_call", "2",
         "--target_sample_batch_size", "4096", "--init_batch_size", "32", *argv])
    trainer, train_ds, test_ds = ex.build(
        args, scene_kwargs=dict(SCENE, width=12, height=12),
        field_kwargs={k: v for k, v in SMALL_FIELDS[args.field].items() if "plane" not in k},
        trainer_kwargs=dict(grid_resolution=8))
    assert trainer.field_reg_weight == 1e-3
    run = ex.train_loop(trainer, train_ds, test_ds, args)
    assert [r["step"] for r in run.log] == [2, 4]
    assert all(np.isfinite(r["loss"]) for r in run.log)
    assert all(v["finite"] for v in run.metrics["views"])
