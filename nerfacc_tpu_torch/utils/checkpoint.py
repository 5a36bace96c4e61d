"""Checkpoint and resume of an occupancy-grid training state.

PyTorch counterpart of nerfacc_tpu/utils/checkpoint.py, which pickles the
JAX ``TrainState`` pytree and restores it into a template's structure.  Here
the :class:`~nerfacc_tpu_torch.trainers.ngp_occ.TrainState` is flattened into
named plain tensors (parameters, Adam's moments and step counts, the
update count, the occupancy grid's ``occs``, ``binaries`` and ``aabbs``, and
the step) and written with ``torch.save``; loading reads them back with
``weights_only=True`` and refuses a checkpoint whose names or shapes differ
from the template's, the port's form of JAX's treedef guard.  A data- or
tensor-parallel state (``parallel``) saves from rank 0, a tensor-parallel
one gathered into the whole layout (W1's rows in shard-major order, as JAX
writes it); ``load_checkpoint`` of the whole state, then
``parallel.tp.shard_state``, restores a rank's part.
"""
from __future__ import annotations

import os
from typing import Dict, Union

import torch

from ..trainers.ngp_occ import OptState, TrainState

_MOMENTS = ("step", "exp_avg", "exp_avg_sq")


def _flatten(state: TrainState) -> Dict[str, torch.Tensor]:
    flat = {f"params/{k}": v.detach() for k, v in state.params.items()}
    adam = state.opt_state.optimizer
    for name, p in state.params.items():
        for key, value in adam.state.get(p, {}).items():
            flat[f"adam/{name}/{key}"] = value
    flat["adam/count"] = torch.tensor(state.opt_state.count)
    for key in ("occs", "binaries", "aabbs"):
        flat[f"occ/{key}"] = getattr(state.occ_state, key)
    flat["step"] = torch.tensor(int(state.step))
    return flat


def save_checkpoint(path: str, state: TrainState, trainer=None, mesh=None) -> None:
    """Write ``state`` to ``path`` (through a temporary file, so an
    interrupted save leaves the previous checkpoint whole).  With a
    ``mesh`` (and the ``trainer`` whose state it is) every rank calls it:
    a model-sharded state is gathered first, rank 0 writes, and every rank
    returns once the file is whole."""
    if mesh is not None:
        from ..parallel.mesh import barrier
        from ..parallel.tp import gather_state

        if mesh.n_model > 1:
            state = gather_state(state, trainer, mesh)
        if mesh.rank == 0:
            save_checkpoint(path, state)
        barrier(mesh)
        return
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(_flatten(state), tmp)
    os.replace(tmp, path)


def load_checkpoint(
    path: str, like: TrainState, device: Union[str, torch.device] = "cuda"
) -> TrainState:
    """The state saved at ``path``, on ``device``, in the structure of
    ``like`` (a fresh ``trainer.init_state()``): new parameter leaves and a
    new Adam with ``like``'s settings, holding the saved moments (Adam's
    step counts stay where ``like``'s are, on the CPU).

    Raises:
        ValueError: the saved names or shapes differ from ``like``'s.
    """
    flat = torch.load(path, map_location=device, weights_only=True)
    want = _flatten(like)
    params = list(like.params)
    # Adam holds moments only for the leaves it has updated
    fixed = {k for k in want if not k.startswith("adam/")} | {"adam/count"}
    moments = {f"adam/{n}/{m}" for n in params for m in _MOMENTS}
    if not fixed <= set(flat) or not set(flat) - fixed <= moments:
        raise ValueError(
            f"checkpoint {path}: entries {sorted(set(flat) ^ fixed)} differ "
            "from the state's"
        )
    for key in fixed - {"adam/count"}:
        if flat[key].shape != want[key].shape or flat[key].dtype != want[key].dtype:
            raise ValueError(
                f"checkpoint {path}: {key} is {flat[key].dtype} "
                f"{tuple(flat[key].shape)}, the state's {want[key].dtype} "
                f"{tuple(want[key].shape)}"
            )
    new = {k: flat[f"params/{k}"].clone().requires_grad_(True) for k in params}
    like_adam = like.opt_state.optimizer
    adam = type(like_adam)(list(new.values()), **like_adam.defaults)
    for name, p in new.items():
        saved = {m: flat.get(f"adam/{name}/{m}") for m in _MOMENTS}
        if all(v is None for v in saved.values()):
            continue
        if any(v is None or v.shape != shape for v, shape in (
            (saved["step"], torch.Size([])), (saved["exp_avg"], p.shape),
            (saved["exp_avg_sq"], p.shape),
        )):
            raise ValueError(f"checkpoint {path}: Adam moments of {name} do not fit it")
        saved["step"] = saved["step"].cpu()
        adam.state[p] = saved
    occ = like.occ_state.__class__(
        **{k: flat[f"occ/{k}"] for k in ("aabbs", "occs", "binaries")}
    )
    return TrainState(
        new, OptState(adam, int(flat["adam/count"])), occ, int(flat["step"])
    )
