"""The port's MLP examples (``nerfacc_tpu_torch.examples.train_mlp_tnerf``
and ``train_mlp_nerf``) against the JAX scripts: their flags and defaults,
the trainer each builds for each field, the ray-batch controller on a
scripted sequence of sample counts, and a few CPU steps at a tiny size
(the dynamic example's summary line; the vanilla example's checkpoint
resume)."""
import argparse
import dataclasses
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch.data.procedural import (
    ProceduralDynamicSceneLoader,
    ProceduralLocalDynamicSceneLoader,
    ProceduralSceneLoader,
)
from nerfacc_tpu_torch.examples import train_mlp_nerf as exv
from nerfacc_tpu_torch.examples import train_mlp_tnerf as ex
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SCRIPTS = {"tnerf": ROOT / "examples" / "train_mlp_tnerf.py",
           "nerf": ROOT / "examples" / "train_mlp_nerf.py",
           "occ": ROOT / "examples" / "train_ngp_nerf_occ.py"}
PORTS = {"tnerf": ex, "nerf": exv}
SCENE = dict(n_train=3, n_test=1, width=16, height=16)


class _Captured(Exception):
    pass


def _jax_script(name):
    """The JAX script as a module (it imports JAX only in its main)."""
    spec = importlib.util.spec_from_file_location(f"jax_{SCRIPTS[name].stem}", SCRIPTS[name])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_parser(monkeypatch, name):
    """The JAX script's parser, caught where its main parses."""
    def grab(self, *args, **kwargs):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Captured) as caught:
        _jax_script(name).main()
    monkeypatch.undo()
    return {a.dest: a for a in caught.value.args[0]._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["tnerf", "nerf"])
def test_flags_and_defaults_match_the_jax_script(monkeypatch, name):
    """Every flag of the JAX script with its default, type and choices;
    ``--device`` added, defaulting to the card."""
    jax_actions = _jax_parser(monkeypatch, name)
    port = {a.dest: a for a in PORTS[name].parser()._actions if a.dest != "help"}
    assert set(port) - {"device"} == set(jax_actions)
    for key, j in jax_actions.items():
        p = port[key]
        assert (p.default, p.type or str, p.choices) == (j.default, j.type or str, j.choices), key
    assert port["device"].default == "cuda"


def _jax_trainer_kwargs(monkeypatch, name, argv):
    """The keyword arguments the JAX script gives ``NGPOccTrainer`` for
    ``argv``, caught at the trainer's construction, and its loaders'
    classes and keyword arguments (stand-ins, so that no ground truth is
    rendered)."""
    import nerfacc_tpu.data as jax_data
    import nerfacc_tpu.trainers as jax_trainers
    import nerfacc_tpu.utils as jax_utils

    made = []

    def stand_in(real):
        def init(self, **kw):
            made.append((real.__name__, kw))
            self.timestamps = np.zeros((3, 1), np.float32)
        return type(real.__name__, (), {"__init__": init})

    def capture(**kwargs):
        raise _Captured(kwargs)

    scenes = {k: stand_in(v) for k, v in jax_data.PROCEDURAL_SCENES.items()}
    monkeypatch.setattr(jax_data, "PROCEDURAL_SCENES", scenes)
    for cls in ("ProceduralSceneLoader", "ProceduralDynamicSceneLoader"):
        monkeypatch.setattr(jax_data, cls, stand_in(getattr(jax_data, cls)))
    monkeypatch.setattr(jax_trainers, "NGPOccTrainer", capture)
    monkeypatch.setattr(jax_utils, "setup_compilation_cache", lambda: None)
    monkeypatch.setattr("sys.argv", [SCRIPTS[name].name, *argv])
    with pytest.raises(_Captured) as caught:
        _jax_script(name).main()
    monkeypatch.undo()
    return caught.value.args[0], made


TRAINER_KEYS = ("max_steps", "render_step_size", "lr", "weight_decay", "adam_eps",
                "warmup_lr_steps", "sample_budget", "field_reg_weight", "seed")
SMALL_FIELDS = {"kplanes": dict(resolutions=(8, 16), ranks=(4, 4)),
                "tineuvox": dict(resolutions=(8, 16, 32), ranks=(4, 4, 4))}


@pytest.mark.parametrize("name,argv", [
    ("tnerf", []),
    ("tnerf", ["--field", "kplanes", "--scene", "procedurallocaldyn", "--amp_prior", "0.5"]),
    ("tnerf", ["--field", "kplanes", "--plane_activation", "tanh", "--seed", "7"]),
    ("tnerf", ["--field", "tineuvox", "--lr", "5e-3", "--field_reg_weight", "3e-4"]),
    ("nerf", ["--max_steps", "600"]),
], ids=["tnerf", "kplanes-localdyn", "kplanes-tanh", "tineuvox-lr", "nerf"])
def test_build_matches_the_jax_script(monkeypatch, name, argv):
    """``build``: the per-field trainer settings (lr, Adam epsilon, warmup,
    prior weight, no weight decay, step 5e-3, the budget), the field's
    class and options, the box, the frame times and the loaders' classes
    and arguments; ``--scene`` picks the procedural loader as the JAX
    script does."""
    from nerfacc_tpu.trainers.ngp_occ import NGPOccTrainer as JaxTrainer

    want, made = _jax_trainer_kwargs(monkeypatch, name, argv)
    want = {**{f.name: f.default for f in dataclasses.fields(JaxTrainer)}, **want}
    args = PORTS[name].parser().parse_args([*argv, "--device", "cpu"])
    field = getattr(args, "field", "nerf")
    field_kwargs = SMALL_FIELDS.get(field, dict(net_depth=2, net_width=16, skip_layer=1)
                                    if name == "nerf" else {})
    trainer, train_ds, test_ds = PORTS[name].build(args, scene_kwargs=SCENE,
                                                   field_kwargs=field_kwargs)
    for key in TRAINER_KEYS:
        assert getattr(trainer, key) == pytest.approx(want[key]), key
    np.testing.assert_array_equal(trainer.aabb, want["aabb"])
    assert type(trainer.field).__name__ == type(want["field"]).__name__
    for option in ("plane_activation", "amp_prior"):
        if hasattr(want["field"], option):
            assert getattr(trainer.field.encoder, option) == getattr(want["field"], option)
    assert (trainer.timestamps is None) == (not want.get("time_dependent", False))
    if name == "tnerf":
        torch.testing.assert_close(trainer.timestamps, train_ds.timestamps)
    for (cls, kw), ds in zip(made, (train_ds, test_ds)):
        assert type(ds).__name__ == cls
        assert ds.num_rays == kw.get("num_rays") and ds.split == kw.get("split")
    scene = {"procedurallocaldyn": ProceduralLocalDynamicSceneLoader}.get(
        args.scene, ProceduralDynamicSceneLoader if name == "tnerf" else ProceduralSceneLoader)
    assert type(train_ds) is scene


@pytest.mark.parametrize("scene", ["proceduraltextured", "proceduralthin", "proceduralmixed"])
def test_occupancy_example_builds_the_named_scene(monkeypatch, scene):
    """F4: ``train_ngp_nerf_occ --scene <scene>`` builds the loader class
    the JAX script builds for that name, where it fell back to the
    translucent scene while ``PROCEDURAL_SCENES`` held two names."""
    from nerfacc_tpu_torch.data.procedural import PROCEDURAL_SCENES
    from nerfacc_tpu_torch.examples import train_ngp_nerf_occ as occ

    _, made = _jax_trainer_kwargs(monkeypatch, "occ", ["--scene", scene])
    args = occ.parser().parse_args(["--scene", scene, "--device", "cpu"])
    trainer, train_ds, test_ds = occ.build(
        args, scene_kwargs=SCENE, field_kwargs=dict(resolutions=(8,), ranks=(4,)),
        trainer_kwargs=dict(grid_resolution=8))
    assert [cls for cls, _ in made] == [type(train_ds).__name__, type(test_ds).__name__]
    assert type(train_ds) is PROCEDURAL_SCENES[scene] is not ProceduralSceneLoader


def test_controller_matches_the_jax_scripts():
    """Both JAX scripts' rule (scale by budget / the last step's demand,
    round down to the 1k-64k buckets, no growth cap), line for line in
    their sources, against the port's on a scripted sequence of demands
    and over a sweep."""
    for name in ("tnerf", "nerf"):
        src = SCRIPTS[name].read_text()
        assert "{1024 * 2**i for i in range(7)} | {1536 * 2**i for i in range(6)}" in src
        assert "num_rays * (args.target_sample_batch_size / float(n_total))" in src
        assert "round_to_bucket(num_rays, buckets)" in src and "num_rays * 2" not in src
    occ = importlib.util.spec_from_file_location("jax_occ", ROOT / "examples" / "train_ngp_nerf_occ.py")
    jax_occ = importlib.util.module_from_spec(occ)
    occ.loader.exec_module(jax_occ)
    buckets = sorted({1024 * 2**i for i in range(7)} | {1536 * 2**i for i in range(6)})
    assert ex.BUCKETS == buckets and buckets[-1] == 65536
    budget = 1 << 16

    def jax_rule(num_rays, n_total):
        return jax_occ.round_to_bucket(int(num_rays * (budget / float(n_total))), buckets)

    # a run's demands: the untrained grid (far over), clearing, then settling
    script = [9_000_000, 4_500_000, 600_000, 90_000, 40_000, 12_000, 70_000, 64_000, 2_000]
    mine = theirs = 1024
    for n_total in script:
        mine, theirs = ex.next_num_rays(mine, n_total, budget), jax_rule(theirs, n_total)
        assert mine == theirs
    assert ex.next_num_rays(1024, 1000, budget) == 65536  # 64x growth: no cap
    for num_rays in buckets:
        for n_total in np.unique(np.geomspace(1, 1e8, 300).astype(int)):
            assert ex.next_num_rays(num_rays, int(n_total), budget) == jax_rule(num_rays, n_total)


@pytest.mark.parametrize("field", ["tnerf", "kplanes"])
def test_a_few_steps_print_the_summary_line(capsys, field):
    """Two calls of 4 steps on the CPU: finite losses, the controller's ray
    counts, the log lines, the evaluation line and the JAX script's JSON
    summary line with its keys."""
    args = ex.parser().parse_args([
        "--device", "cpu", "--field", field, "--max_steps", "4", "--steps_per_call", "4",
        "--init_batch_size", "64", "--target_sample_batch_size", "1024", "--log_every", "4",
    ])
    trainer, train_ds, test_ds = ex.build(
        args, scene_kwargs=SCENE, field_kwargs=SMALL_FIELDS.get(field, {}),
        trainer_kwargs=dict(grid_resolution=16))
    run = ex.train_loop(trainer, train_ds, test_ds, args)
    out = capsys.readouterr().out.strip().splitlines()
    summary = json.loads(out[-1])
    assert summary == run.summary
    assert set(summary) == {"name", "field", "scene", "steps", "psnr", "ssim", "train_wall_s",
                            "samples_per_sec"}
    assert summary["name"] == f"{field}@lego" and summary["steps"] == 4
    assert out[-2].startswith("evaluation: psnr_avg=") and "train_wall=" in out[-2]
    assert any(line.startswith("elapsed_time=") for line in out)
    assert run.state.step == 8 and [r["num_rays"] for r in run.log][0] == 64
    assert all(np.isfinite(r["loss"]) and 0.0 <= r["masked"] <= 1.0 for r in run.log)
    assert np.isfinite(run.metrics["psnr"])


def test_vanilla_example_resumes_from_its_checkpoint(tmp_path, capsys):
    """``--model_path``: a run to step 4 saves its checkpoint at its log,
    and a second ``train_loop`` with ``--max_steps 8`` resumes at step 4
    and ends at 12, the step carried over; ``evaluation: psnr_avg=``."""
    path = tmp_path / "vanilla.ckpt"

    def run(max_steps):
        args = exv.parser().parse_args([
            "--device", "cpu", "--max_steps", str(max_steps), "--steps_per_call", "4",
            "--init_batch_size", "64", "--target_sample_batch_size", "1024", "--log_every", "4",
            "--model_path", str(path),
        ])
        trainer, train_ds, test_ds = exv.build(
            args, scene_kwargs=SCENE, field_kwargs=dict(net_depth=2, net_width=16, skip_layer=1),
            trainer_kwargs=dict(grid_resolution=16))
        return exv.train_loop(trainer, train_ds, test_ds, args)

    first = run(0)
    assert first.state.step == 4 and path.exists()
    second = run(8)
    out = capsys.readouterr().out
    assert "resumed from" in out and "at step 4" in out
    assert [r["step"] for r in second.log] == [8, 12] and second.state.step == 12
    assert out.strip().splitlines()[-1].startswith("evaluation: psnr_avg=")
    assert np.isfinite(second.metrics["psnr"])


def test_entry_points_default_to_the_card():
    for module in (ex, exv):
        args = module.parser().parse_args([])
        assert args.device == "cuda" and args.target_sample_batch_size == 1 << 16
        assert args.init_batch_size == 1024
