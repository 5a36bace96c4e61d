"""Move field parameters and occupancy grids between the two packages.

The JAX package keeps parameters as a pytree of arrays; this package keeps
them in a field's ``state_dict`` (:class:`~nerfacc_tpu_torch.models.cp_field.
CPRadianceField`, :class:`~nerfacc_tpu_torch.models.cp_field.CPDensityField`,
:class:`~nerfacc_tpu_torch.models.ngp.NGPRadianceField`,
:class:`~nerfacc_tpu_torch.models.ngp.NGPDensityField`,
:class:`~nerfacc_tpu_torch.models.tineuvox.TiNeuVoxRadianceField`, the MLP
fields of :mod:`~nerfacc_tpu_torch.models.mlp` and
:class:`~nerfacc_tpu_torch.models.kplanes.KPlanesRadianceField`,
:class:`~nerfacc_tpu_torch.models.voxel_field.VoxelRadianceField`, the CP
field's tri-plane levels and TensoRF), the proposal trainer keeps
``{"field": ..., "props": [...]}`` of them, and the BARF trainer
``{"field": ..., "pose_deltas": ...}``.  An
:class:`~nerfacc_tpu_torch.estimators.occ_grid.OccGridEstimator` keeps the
JAX estimator's ``state_dict()`` keys as buffers, and so does a
:class:`~nerfacc_tpu_torch.estimators.sparse_grid.SparseGridEstimator`.
The bridge speaks numpy on the JAX side, so it needs no JAX import: convert
a JAX tree with ``jax.tree.map(np.asarray, params)`` first.  Tensors land on
the card unless ``device`` says otherwise.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from ..estimators.occ_grid import OccGridEstimator, OccGridState
from ..estimators.sparse_grid import SparseGrid, SparseGridEstimator

_MLPS = ("mlp_base", "mlp_head")


_CP_TABLES = ("lines", "planes", "plane_lines")


def cp_field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """``{"encoder": {"lines": [(3, R, rank)...], "planes": [(3, R, R,
    rank)...], "plane_lines": [(3, R, rank)...]}, "mlp_base": [W...],
    "mlp_head": [W...]}`` (``planes`` and ``plane_lines`` where the field
    has them) -> a CPRadianceField or TensoRFRadianceField state dict (f32
    tensors)."""
    params = {
        f"encoder.{name}.{i}": _tensor(table, device)
        for name in _CP_TABLES
        for i, table in enumerate(tree["encoder"].get(name, ()))
    }
    return {**params, **_mlps_from_numpy(tree, device)}


def cp_field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`cp_field_params_from_numpy`."""
    encoder = {name: _listed(params, f"encoder.{name}.") for name in _CP_TABLES}
    encoder = {k: v for k, v in encoder.items() if v or k == "lines"}
    return {"encoder": encoder, **_mlps_to_numpy(params)}


def voxel_field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """``{"encoder": {"grids": [(R, R, R, C)...]}, "mlp_base": [W...],
    "mlp_head": [W...]}`` -> a VoxelRadianceField state dict (f32
    tensors)."""
    params = {f"encoder.grids.{i}": _tensor(grid, device)
              for i, grid in enumerate(tree["encoder"]["grids"])}
    return {**params, **_mlps_from_numpy(tree, device)}


def voxel_field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`voxel_field_params_from_numpy`."""
    return {"encoder": {"grids": _listed(params, "encoder.grids.")},
            **_mlps_to_numpy(params)}


def barf_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict:
    """The JAX BARF trainer's ``{"field": vanilla field, "pose_deltas": (n,
    6)}`` -> the port's ``BARFTrainState.params``."""
    return {"field": field_params_from_numpy(tree["field"], device),
            "pose_deltas": _tensor(tree["pose_deltas"], device)}


def barf_params_to_numpy(params: Dict) -> Dict:
    """The inverse of :func:`barf_params_from_numpy`."""
    return {"field": field_params_to_numpy(params["field"]),
            "pose_deltas": params["pose_deltas"].detach().cpu().numpy()}


def ngp_field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """``{"encoder": (L, T, F), "mlp_base": [W...], "mlp_head": [W...]}``
    -> an NGPRadianceField state dict (f32 tensors)."""
    return {"encoder.table": _tensor(tree["encoder"], device),
            **_mlps_from_numpy(tree, device)}


def ngp_field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`ngp_field_params_from_numpy`."""
    return {"encoder": params["encoder.table"].detach().cpu().numpy(),
            **_mlps_to_numpy(params)}


def tineuvox_field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """``{"deform": [W...], "encoder": {"lines": [(3, R, rank)...]},
    "mlp_base": [W...], "mlp_head": [W...]}`` -> a TiNeuVoxRadianceField
    state dict (f32 tensors)."""
    deform = {f"deform.{i}": _tensor(w, device) for i, w in enumerate(tree["deform"])}
    return {**deform, **cp_field_params_from_numpy(tree, device)}


def tineuvox_field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`tineuvox_field_params_from_numpy`."""
    return {"deform": _listed(params, "deform."), **cp_field_params_to_numpy(params)}


def cp_density_field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """``{"encoder": {"lines": [(3, R, rank)...]}, "mlp_base": [W...]}`` ->
    a CPDensityField state dict (f32 tensors)."""
    params = {
        f"encoder.lines.{i}": _tensor(line, device)
        for i, line in enumerate(tree["encoder"]["lines"])
    }
    return {**params, **{f"mlp_base.{i}": _tensor(w, device)
                         for i, w in enumerate(tree["mlp_base"])}}


def cp_density_field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`cp_density_field_params_from_numpy`."""
    return {"encoder": {"lines": _listed(params, "encoder.lines.")},
            "mlp_base": _listed(params, "mlp_base.")}


def ngp_density_field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """``{"encoder": (L, T, F), "mlp_base": [W...]}`` -> an NGPDensityField
    state dict (f32 tensors)."""
    return {"encoder.table": _tensor(tree["encoder"], device),
            **{f"mlp_base.{i}": _tensor(w, device) for i, w in enumerate(tree["mlp_base"])}}


def ngp_density_field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`ngp_density_field_params_from_numpy`."""
    return {"encoder": params["encoder.table"].detach().cpu().numpy(),
            "mlp_base": _listed(params, "mlp_base.")}


def _mlp_from_numpy(tree: Dict, prefix: str, device) -> Dict[str, torch.Tensor]:
    """An MLP's ``{"hidden": [{"w", "b"}...], "output": {"w", "b"}}`` (no
    ``"output"`` without an output layer) -> its state dict entries under
    ``prefix``."""
    layers = [(f"hidden.{i}", layer) for i, layer in enumerate(tree["hidden"])]
    if "output" in tree:
        layers.append(("output", tree["output"]))
    return {f"{prefix}{name}.{k}": _tensor(layer[k], device)
            for name, layer in layers for k in ("w", "b")}


def _mlp_to_numpy(params: Dict[str, torch.Tensor], prefix: str) -> Dict:
    """The inverse of :func:`_mlp_from_numpy`."""
    n = sum(1 for k in params if k.startswith(f"{prefix}hidden.") and k.endswith(".w"))
    layer = lambda name: {k: params[f"{prefix}{name}.{k}"].detach().cpu().numpy()
                          for k in ("w", "b")}
    tree = {"hidden": [layer(f"hidden.{i}") for i in range(n)]}
    if f"{prefix}output.w" in params:
        tree["output"] = layer("output")
    return tree


_NERF_MLPS = ("base", "sigma", "bottleneck", "rgb")


def vanilla_field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda", prefix: str = ""
) -> Dict[str, torch.Tensor]:
    """``{"base", "sigma", "bottleneck", "rgb"}``, each an MLP's
    ``{"hidden": [{"w", "b"}...], "output"}`` -> a VanillaNeRFRadianceField
    state dict (f32 tensors), its keys under ``prefix``."""
    return {k: v for name in _NERF_MLPS
            for k, v in _mlp_from_numpy(tree[name], f"{prefix}mlp.{name}.", device).items()}


def vanilla_field_params_to_numpy(params: Dict[str, torch.Tensor], prefix: str = "") -> Dict:
    """The inverse of :func:`vanilla_field_params_from_numpy`."""
    return {name: _mlp_to_numpy(params, f"{prefix}mlp.{name}.") for name in _NERF_MLPS}


def tnerf_field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """``{"warp": MLP, "nerf": vanilla}`` -> a TNeRFRadianceField state
    dict (f32 tensors)."""
    return {**_mlp_from_numpy(tree["warp"], "warp_mlp.", device),
            **vanilla_field_params_from_numpy(tree["nerf"], device, "nerf.")}


def tnerf_field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`tnerf_field_params_from_numpy`."""
    return {"warp": _mlp_to_numpy(params, "warp_mlp."),
            "nerf": vanilla_field_params_to_numpy(params, "nerf.")}


def ndrt_field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """``{"warp1": [MLP] * 3, "warp2": [MLP] * 3, "time1": [{"w", "b"}] * 3,
    "time2": [...] * 3, "nerf": vanilla}`` -> an NDRTNeRFRadianceField state
    dict (f32 tensors)."""
    params = vanilla_field_params_from_numpy(tree["nerf"], device, "nerf.")
    for name in ("warp1", "warp2"):
        for i, mlp in enumerate(tree[name]):
            params.update(_mlp_from_numpy(mlp, f"{name}.{i}.", device))
    for name in ("time1", "time2"):
        for i, layer in enumerate(tree[name]):
            params.update({f"{name}.{i}.{k}": _tensor(layer[k], device) for k in ("w", "b")})
    return params


def ndrt_field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`ndrt_field_params_from_numpy`."""
    tree = {name: [_mlp_to_numpy(params, f"{name}.{i}.") for i in range(3)]
            for name in ("warp1", "warp2")}
    for name in ("time1", "time2"):
        tree[name] = [{k: params[f"{name}.{i}.{k}"].detach().cpu().numpy() for k in ("w", "b")}
                      for i in range(3)]
    return {**tree, "nerf": vanilla_field_params_to_numpy(params, "nerf.")}


def kplanes_field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """``{"encoder": {"planes": [(6, R, R, rank)...]}, "mlp_base": [W...],
    "mlp_head": [W...]}`` -> a KPlanesRadianceField state dict (f32
    tensors)."""
    params = {f"encoder.planes.{i}": _tensor(plane, device)
              for i, plane in enumerate(tree["encoder"]["planes"])}
    return {**params, **_mlps_from_numpy(tree, device)}


def kplanes_field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`kplanes_field_params_from_numpy`."""
    return {"encoder": {"planes": _listed(params, "encoder.planes.")},
            **_mlps_to_numpy(params)}


def field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """A field's JAX tree -> its state dict, the kind read off the tree: the
    MLP fields by their top-level keys (vanilla ``"base"``, T-NeRF
    ``"warp"``, NDRT ``"warp1"``), TiNeuVox by ``"deform"``, K-Planes by
    ``"planes"`` without ``"lines"`` under ``"encoder"``, the voxel field by
    ``"grids"`` there; otherwise CP levels (lines, and planes where the
    field has them) are a dict under ``"encoder"``, a hash grid its table,
    and a radiance field has an ``"mlp_head"``."""
    for key, fn in (("base", vanilla_field_params_from_numpy),
                    ("warp", tnerf_field_params_from_numpy),
                    ("warp1", ndrt_field_params_from_numpy),
                    ("deform", tineuvox_field_params_from_numpy)):
        if key in tree:
            return fn(tree, device)
    encoder = tree["encoder"]
    if isinstance(encoder, dict) and "planes" in encoder and "lines" not in encoder:
        return kplanes_field_params_from_numpy(tree, device)
    if isinstance(encoder, dict) and "grids" in encoder:
        return voxel_field_params_from_numpy(tree, device)
    cp = isinstance(encoder, dict)
    if "mlp_head" in tree:
        fn = cp_field_params_from_numpy if cp else ngp_field_params_from_numpy
    else:
        fn = cp_density_field_params_from_numpy if cp else ngp_density_field_params_from_numpy
    return fn(tree, device)


def field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`field_params_from_numpy`, the kind read off
    the state dict's keys."""
    for key, fn in (("mlp.base.hidden.0.w", vanilla_field_params_to_numpy),
                    ("warp_mlp.hidden.0.w", tnerf_field_params_to_numpy),
                    ("warp1.0.hidden.0.w", ndrt_field_params_to_numpy),
                    ("deform.0", tineuvox_field_params_to_numpy),
                    ("encoder.grids.0", voxel_field_params_to_numpy)):
        if key in params:
            return fn(params)
    if "encoder.planes.0" in params and "encoder.lines.0" not in params:
        return kplanes_field_params_to_numpy(params)
    cp = "encoder.table" not in params
    if "mlp_head.0" in params:
        return (cp_field_params_to_numpy if cp else ngp_field_params_to_numpy)(params)
    return (cp_density_field_params_to_numpy if cp else ngp_density_field_params_to_numpy)(params)


def prop_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict:
    """The JAX proposal trainer's ``{"field": ..., "props": [...]}`` tree (a
    CP or hash-grid radiance field and one CP or hash-grid density field a
    proposal level) -> the port's ``PropTrainState.params``."""
    return {
        "field": field_params_from_numpy(tree["field"], device),
        "props": [field_params_from_numpy(p, device) for p in tree["props"]],
    }


def prop_params_to_numpy(params: Dict) -> Dict:
    """The inverse of :func:`prop_params_from_numpy`."""
    return {
        "field": field_params_to_numpy(params["field"]),
        "props": [field_params_to_numpy(p) for p in params["props"]],
    }


def occ_state_from_numpy(
    aabbs: np.ndarray,
    occs: np.ndarray,
    binaries: np.ndarray,
    device: Union[str, torch.device] = "cuda",
) -> OccGridState:
    """JAX ``OccGridState`` arrays -> this package's ``OccGridState``."""
    return OccGridState(
        aabbs=_tensor(aabbs, device),
        occs=_tensor(occs, device),
        binaries=torch.tensor(np.asarray(binaries, bool), device=device),
    )


def occ_state_to_numpy(state: OccGridState):
    """The inverse of :func:`occ_state_from_numpy`: (aabbs, occs, binaries)."""
    return tuple(
        t.detach().cpu().numpy() for t in (state.aabbs, state.occs, state.binaries)
    )


def occ_grid_estimator_from_numpy(estimator: OccGridEstimator, state_dict: Dict) -> None:
    """Load the JAX ``OccGridEstimator.state_dict()`` (``aabbs``, ``occs``,
    ``binaries`` as numpy) into ``estimator``'s buffers, on their device."""
    dev = estimator.occs.device
    estimator.load_state_dict({
        "aabbs": _tensor(state_dict["aabbs"], dev),
        "occs": _tensor(state_dict["occs"], dev),
        "binaries": torch.tensor(np.asarray(state_dict["binaries"], bool), device=dev),
    })


def occ_grid_estimator_to_numpy(estimator: OccGridEstimator) -> Dict[str, np.ndarray]:
    """The inverse of :func:`occ_grid_estimator_from_numpy`."""
    return {k: v.detach().cpu().numpy() for k, v in estimator.state_dict().items()}


def sparse_grid_estimator_from_numpy(estimator: SparseGridEstimator, state_dict: Dict) -> None:
    """Load the JAX ``SparseGridEstimator.state_dict()`` or
    ``N3TreeEstimator.state_dict()`` (``grid_words``, ``grid_aabb``,
    ``grid_resolution``, ``occs`` as numpy) into ``estimator``, on its
    device, whatever resolution it had."""
    dev = estimator.occs.device
    estimator.grid = SparseGrid(
        words=torch.tensor(np.asarray(state_dict["grid_words"], np.int32), device=dev),
        aabb=_tensor(state_dict["grid_aabb"], dev),
        resolution=tuple(int(r) for r in np.asarray(state_dict["grid_resolution"])),
    )
    estimator.occs = _tensor(state_dict["occs"], dev)


def prop_fields_from_numpy(prop_fields, trees) -> None:
    """Load the JAX proposal fields' parameter trees (numpy, one a field, as
    in the JAX trainer's ``params["props"]``) into the port's
    ``CPDensityField`` or ``NGPDensityField`` modules, in place: the modules
    whose parameters a
    :class:`~nerfacc_tpu_torch.estimators.prop_net.PropNetEstimator`'s
    optimizer steps."""
    for field, tree in zip(prop_fields, trees, strict=True):
        dev = next(field.parameters()).device
        with torch.no_grad():
            for name, value in field_params_from_numpy(tree, dev).items():
                field.get_parameter(name).copy_(value)


def _mlps_from_numpy(tree: Dict, device) -> Dict[str, torch.Tensor]:
    return {
        f"{name}.{i}": _tensor(w, device)
        for name in _MLPS
        for i, w in enumerate(tree[name])
    }


def _mlps_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    return {name: _listed(params, f"{name}.") for name in _MLPS}


def _listed(params: Dict[str, torch.Tensor], prefix: str):
    n = sum(1 for k in params if k.startswith(prefix))
    return [params[f"{prefix}{i}"].detach().cpu().numpy() for i in range(n)]


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device)
