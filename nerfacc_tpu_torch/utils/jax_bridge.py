"""Move field parameters and occupancy grids between the two packages.

The JAX package keeps parameters as a pytree of arrays; this package keeps
them in a field's ``state_dict`` (:class:`~nerfacc_tpu_torch.models.cp_field.
CPRadianceField`, :class:`~nerfacc_tpu_torch.models.cp_field.CPDensityField`,
:class:`~nerfacc_tpu_torch.models.ngp.NGPRadianceField`,
:class:`~nerfacc_tpu_torch.models.ngp.NGPDensityField`,
:class:`~nerfacc_tpu_torch.models.tineuvox.TiNeuVoxRadianceField`), and the
proposal trainer keeps ``{"field": ..., "props": [...]}`` of them.  An
:class:`~nerfacc_tpu_torch.estimators.occ_grid.OccGridEstimator` keeps the
JAX estimator's ``state_dict()`` keys as buffers.
The bridge speaks numpy on the JAX side, so it needs no JAX import: convert
a JAX tree with ``jax.tree.map(np.asarray, params)`` first.  Tensors land on
the card unless ``device`` says otherwise.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from ..estimators.occ_grid import OccGridEstimator, OccGridState

_MLPS = ("mlp_base", "mlp_head")


def cp_field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """``{"encoder": {"lines": [(3, R, rank)...]}, "mlp_base": [W...],
    "mlp_head": [W...]}`` -> a CPRadianceField state dict (f32 tensors)."""
    params = {
        f"encoder.lines.{i}": _tensor(line, device)
        for i, line in enumerate(tree["encoder"]["lines"])
    }
    return {**params, **_mlps_from_numpy(tree, device)}


def cp_field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`cp_field_params_from_numpy`."""
    return {"encoder": {"lines": _listed(params, "encoder.lines.")},
            **_mlps_to_numpy(params)}


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


def field_params_from_numpy(
    tree: Dict, device: Union[str, torch.device] = "cuda"
) -> Dict[str, torch.Tensor]:
    """A CP or hash-grid radiance or density field's JAX tree -> its state
    dict, the kind read off the tree: CP line levels are a dict under
    ``"encoder"``, a hash grid its table; a radiance field has an
    ``"mlp_head"``."""
    cp = isinstance(tree["encoder"], dict)
    if "mlp_head" in tree:
        fn = cp_field_params_from_numpy if cp else ngp_field_params_from_numpy
    else:
        fn = cp_density_field_params_from_numpy if cp else ngp_density_field_params_from_numpy
    return fn(tree, device)


def field_params_to_numpy(params: Dict[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`field_params_from_numpy`, the kind read off
    the state dict's keys."""
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
