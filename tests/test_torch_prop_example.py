"""The port's proposal example (``nerfacc_tpu_torch.examples.train_ngp_nerf_prop``)
against the JAX script (examples/train_ngp_nerf_prop.py): its flags and
defaults, the configuration each scene branch gives the trainer, and a few
steps on the CPU at a tiny size that print the script's log and evaluation
lines."""
import argparse
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch.data.procedural import (
    ProceduralSceneLoader,
    ProceduralUnboundedSceneLoader,
)
from nerfacc_tpu_torch.examples import train_ngp_nerf_prop as ex
from nerfacc_tpu_torch.models.cp_field import CPDensityField, CPRadianceField
from nerfacc_tpu_torch.models.ngp import NGPDensityField, NGPRadianceField
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_SCRIPT = ROOT / "examples" / "train_ngp_nerf_prop.py"
SCENE = dict(n_train=2, n_test=1, width=12, height=12)
SMALL = {
    "cp": (dict(resolutions=(8, 16), ranks=(4, 4)), dict(resolutions=(8, 16), ranks=(4, 4),
                                                         hidden_dim=16)),
    "ngp": (dict(n_levels=4, log2_hashmap_size=10, max_resolution=64),
            dict(n_levels=5, log2_hashmap_size=10, hidden_dim=16)),
}
# what the port leaves out of the JAX script's flags, and what it adds
LEFT_OUT, ADDED = {"encoder_remat"}, {"device"}


class _Captured(Exception):
    pass


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_train_ngp_nerf_prop", JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_parser(monkeypatch):
    """The JAX script's parser, caught where its main parses (its main
    imports JAX only after that)."""
    def grab(self, *args, **kwargs):
        raise _Captured(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Captured) as caught:
        _jax_script().main()
    return caught.value.args[0]


def _actions(ap):
    return {a.dest: a for a in ap._actions if a.dest != "help"}


def test_flags_and_defaults_match_the_jax_script(monkeypatch):
    """Every flag of the JAX script but the two the module docstring names,
    with the same default, type and choices; ``--device`` added, defaulting
    to the card."""
    jax_actions = _actions(_jax_parser(monkeypatch))
    monkeypatch.undo()
    port = _actions(ex.parser())
    assert set(jax_actions) - LEFT_OUT == set(port) - ADDED
    for name in LEFT_OUT:
        assert f"--{name}" in ex.__doc__
    for name in set(port) - ADDED:
        j, p = jax_actions[name], port[name]
        # a flag with no type takes its string, as type=str does
        assert (p.default, p.type or str, p.choices) == (j.default, j.type or str, j.choices), name
    assert port["device"].default == "cuda"


def _jax_trainer_kwargs(monkeypatch, scene, field):
    """The keyword arguments the JAX script gives ``NGPPropTrainer`` for
    ``--scene scene --field field``, caught at the trainer's construction
    (its loaders replaced by stand-ins with the real planes, so that no
    ground truth is rendered)."""
    import nerfacc_tpu.data as jax_data
    import nerfacc_tpu.trainers as jax_trainers

    def stand_in(real):
        return type(real.__name__, (), {"NEAR": real.NEAR, "FAR": real.FAR,
                                        "__init__": lambda self, **kw: None})

    def capture(**kwargs):
        raise _Captured(kwargs)

    for name in ("ProceduralSceneLoader", "ProceduralUnboundedSceneLoader"):
        monkeypatch.setattr(jax_data, name, stand_in(getattr(jax_data, name)))
    monkeypatch.setattr(jax_trainers, "NGPPropTrainer", capture)
    monkeypatch.setattr("sys.argv", ["train_ngp_nerf_prop.py", "--scene", scene,
                                     "--field", field])
    with pytest.raises(_Captured) as caught:
        _jax_script().main()
    monkeypatch.undo()
    return caught.value.args[0]


KEYS = ("prop_samples", "num_samples", "near_plane", "far_plane", "sampling_type",
        "opaque_bkgd")


@pytest.mark.parametrize("scene,field", [("lego", "cp"), ("garden", "ngp"),
                                         ("procedural360", "cp"), ("procedural360", "ngp")])
def test_scene_branches_match_the_jax_script(monkeypatch, scene, field):
    """``build``'s trainer for each branch: the JAX script's proposal and
    final sample counts, planes (the unbounded loader's own for
    procedural360), sampling and background; the fields' classes, box and
    contraction; the loaders (six test views on the 360 scene)."""
    want = _jax_trainer_kwargs(monkeypatch, scene, field)
    args = ex.parser().parse_args(["--scene", scene, "--field", field, "--device", "cpu"])
    field_kw, prop_kw = SMALL[field]
    scene_kwargs = {k: v for k, v in SCENE.items() if k != "n_test"}  # the branch's own
    trainer, train_ds, test_ds = ex.build(args, scene_kwargs=scene_kwargs, field_kwargs=field_kw,
                                          prop_kwargs=prop_kw)
    for key in KEYS:
        got = getattr(trainer, key)
        assert (list(got) if key == "prop_samples" else got) == want[key], key
    assert (trainer.max_steps, trainer.seed) == (want["max_steps"], want["seed"])
    jfield, jprops = want["field"], want["prop_fields"]
    assert len(trainer.prop_fields) == len(jprops)
    classes = {"cp": (CPRadianceField, CPDensityField), "ngp": (NGPRadianceField, NGPDensityField)}
    assert type(trainer.field) is classes[field][0]
    for prop, jprop in zip(trainer.prop_fields, jprops):
        assert type(prop) is classes[field][1] and type(jprop).__name__ == type(prop).__name__
        assert prop.unbounded == jprop.unbounded
        np.testing.assert_array_equal(prop.aabb.numpy(), jprop.aabb)
    assert trainer.field.unbounded == jfield.unbounded
    loader = ProceduralUnboundedSceneLoader if scene == "procedural360" else ProceduralSceneLoader
    assert type(train_ds) is loader and type(test_ds) is loader
    assert train_ds.num_rays == 4096 and train_ds.training
    assert len(test_ds) == (6 if scene == "procedural360" else 4)


def test_data_root_raises_and_names_the_roadmap_item(monkeypatch, tmp_path):
    """The name is kept from when ``--data_root`` raised; it now takes the
    JAX script's data branch: the Blender loader of ``--train_split`` under
    the root, ``--batch_size`` rays a train batch, with the scene name's
    configuration (the JAX script's trainer arguments), on a fixture
    written into ``tmp_path``; a root without the scene raises and names
    the file it misses."""
    pytest.importorskip("imageio.v2")
    from test_torch_datasets import _write_blender_fixture

    from nerfacc_tpu_torch.data.nerf_synthetic import SubjectLoader

    want = _jax_trainer_kwargs(monkeypatch, "lego", "cp")
    _write_blender_fixture(str(tmp_path), subject="lego")
    monkeypatch.setattr(SubjectLoader, "WIDTH", 8)
    monkeypatch.setattr(SubjectLoader, "HEIGHT", 8)
    args = ex.parser().parse_args(["--data_root", str(tmp_path), "--train_split", "trainval",
                                   "--device", "cpu"])
    field_kw, prop_kw = SMALL["cp"]
    trainer, train_ds, test_ds = ex.build(args, field_kwargs=field_kw, prop_kwargs=prop_kw)
    assert type(train_ds) is SubjectLoader and type(test_ds) is SubjectLoader
    assert (train_ds.split, train_ds.num_rays, len(train_ds)) == ("trainval", 4096, 4)
    assert test_ds.split == "test" and not test_ds.training
    for key in KEYS:
        got = getattr(trainer, key)
        assert (list(got) if key == "prop_samples" else got) == want[key], key
    args = ex.parser().parse_args(["--data_root", str(tmp_path / "none"), "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="transforms_train.json"):
        ex.build(args)


LOG = re.compile(
    r"^elapsed_time=\d+\.\d{2}s \| step=(\d+) \| loss=\d+\.\d{5} \| psnr=-?\d+\.\d{2} \| "
    r"prop_loss=\d+\.\d{5} \| samples/s=\S+$"
)
EVAL = re.compile(r"^evaluation: psnr_avg=\d+\.\d{2} ssim_avg=-?\d\.\d{4}$")


@pytest.mark.parametrize("scene,field,device_sampler", [
    ("procedural360", "cp", "1"), ("lego", "ngp", "0")])
def test_a_few_steps_print_the_log_and_evaluation_lines(capsys, scene, field, device_sampler):
    """Six steps, two a call, logged every two, on the CPU at a tiny size
    (the 360 cascade cut to [8, 6] -> 4 samples, the bounded one to [8] ->
    4): one log line a call in the JAX script's format, the proposal loss
    positive on the steps that train the proposal fields (the schedule's),
    finite losses, and the evaluation line."""
    args = ex.parser().parse_args([
        "--scene", scene, "--field", field, "--max_steps", "5", "--steps_per_call", "2",
        "--log_every", "2", "--batch_size", "32", "--device_sampler", device_sampler,
        "--device", "cpu",
    ])
    field_kw, prop_kw = SMALL[field]
    samples = dict(prop_samples=[8, 6], num_samples=4) if scene == "procedural360" else dict(
        prop_samples=[8], num_samples=4)
    trainer, train_ds, test_ds = ex.build(args, scene_kwargs=SCENE, field_kwargs=field_kw,
                                          prop_kwargs=prop_kw, trainer_kwargs=samples)
    run = ex.train_loop(trainer, train_ds, test_ds, args)
    lines = capsys.readouterr().out.strip().splitlines()
    steps = [int(LOG.match(line).group(1)) for line in lines[:-1]]
    assert steps == [2, 4, 6] and EVAL.match(lines[-1]), lines
    assert run.state.step == 6 and len(run.log["loss"]) == 6
    assert np.isfinite(run.log["loss"]).all()
    assert ((run.log["prop_loss"] > 0) == run.log["requires_grad"]).all()
    assert run.log["requires_grad"].any()
    assert run.metrics["views"][0]["finite"] and len(run.metrics["views"]) == 1
    assert run.metrics["views"][0]["n_samples"] == 12 * 12 * (sum(samples["prop_samples"]) + 4)
    assert torch.isfinite(torch.tensor(run.metrics["psnr"]))
