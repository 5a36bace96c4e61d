"""The port imports without JAX, without CUDA, and builds nothing; its
entry points put their state on the card unless asked for another device."""
import dataclasses
import importlib
import inspect
import pathlib
import re
import subprocess
import sys

import pytest
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import nerfacc_tpu_torch\n"
        "import nerfacc_tpu_torch.utils.profiler\n"
        "from nerfacc_tpu_torch.cuda import _build\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'nerfacc_tpu' not in sys.modules, 'nerfacc_tpu imported'\n"
        "assert _build._lib is None and _build.build_seconds is None\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize(
    "path",
    sorted((ROOT / "nerfacc_tpu_torch").rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_eval.py"],
    ids=lambda p: p.name,
)
def test_no_source_imports_jax(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|nerfacc_tpu)\b", src, re.M)


def _default_device(fn):
    if fn.__name__ == "parser":  # an example script's flags
        return fn().get_default("device")
    if dataclasses.is_dataclass(fn):
        return {f.name: f.default for f in dataclasses.fields(fn)}["device"]
    return inspect.signature(fn).parameters["device"].default


@pytest.mark.parametrize(
    "name",
    [
        "trainers.ngp_occ.NGPOccTrainer",
        "data.procedural.ProceduralSceneLoader",
        "data.procedural.ProceduralDynamicSceneLoader",
        "data.procedural.ProceduralOpaqueSceneLoader",
        "data.procedural.ProceduralUnboundedSceneLoader",
        "utils.checkpoint.load_checkpoint",
        "estimators.occ_grid.init_occ_grid",
        "models.tineuvox.TiNeuVoxRadianceField",
        "utils.jax_bridge.cp_field_params_from_numpy",
        "utils.jax_bridge.ngp_field_params_from_numpy",
        "utils.jax_bridge.tineuvox_field_params_from_numpy",
        "utils.jax_bridge.occ_state_from_numpy",
        "utils.jax_bridge.cp_density_field_params_from_numpy",
        "utils.jax_bridge.prop_params_from_numpy",
        "utils.jax_bridge.ngp_density_field_params_from_numpy",
        "utils.jax_bridge.field_params_from_numpy",
        "trainers.ngp_prop.NGPPropTrainer",
        "data.device_sampler.DeviceRaySampler",
        "estimators.prop_net.propnet_sampling",
        "estimators.occ_grid.OccGridEstimator",
        "estimators.prop_net.PropNetEstimator.sampling",
        "data.nerf_synthetic.SubjectLoader",
        "data.nerf_360_v2.SubjectLoader",
        "models.mlp.VanillaNeRFRadianceField",
        "models.mlp.TNeRFRadianceField",
        "models.mlp.NDRTNeRFRadianceField",
        "models.kplanes.KPlanesRadianceField",
        "utils.jax_bridge.vanilla_field_params_from_numpy",
        "utils.jax_bridge.tnerf_field_params_from_numpy",
        "utils.jax_bridge.ndrt_field_params_from_numpy",
        "utils.jax_bridge.kplanes_field_params_from_numpy",
        "utils.jax_bridge.voxel_field_params_from_numpy",
        "utils.jax_bridge.barf_params_from_numpy",
        "trainers.barf.BARFTrainer",
        "examples.train_barf.parser",
        "examples.train_ngp_nerf_occ.parser",
        "estimators.sparse_grid.SparseGridEstimator",
        "estimators.sparse_grid.sparse_grid_from_dense",
        "estimators.sparse_grid.sparse_grid_from_ijk",
        "parallel.dryrun.entry",
        "utils.jax_bridge.occ_train_state_from_numpy",
    ],
)
def test_entry_points_default_to_the_card(name):
    """Read from the signature or the dataclass field: nothing is built on
    a card here, and nothing falls back to the CPU."""
    package, module, *attrs = name.split(".")
    fn = importlib.import_module(f"nerfacc_tpu_torch.{package}.{module}")
    for attr in attrs:
        fn = getattr(fn, attr)
    assert _default_device(fn) == "cuda"
