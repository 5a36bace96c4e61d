"""Tensor parallelism of the CP field over a 2-D (data, model) mesh.

PyTorch counterpart of nerfacc_tpu/parallel/tp.py, with its semantics:

* each line level's table ``(3, R, rank)`` is cut along its rank dimension,
  one slice a model rank, and every rank encodes its slice (kernels G1/G4
  on the card run on the local ``(3, R, rank / n_model)`` tables);
* the first base-MLP weight is cut by rows to match the local features,
  its rows first permuted into shard-major order
  (:func:`tp_w1_permutation`); the partial products are summed over the
  model group, with an identity backward
  (:class:`~nerfacc_tpu_torch.models.cp_field.TPAllReduce`), and every
  later layer runs replicated;
* Adam's moments follow their parameters; everything else (the other
  weights, the occupancy grid, the step) is replicated;
* the data axis is ``parallel.mesh``'s data parallelism: the model ranks of
  one data index share one block of rays.

The model axis is innermost: rank = d * n_model + m.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, init_group, shard_batch

_MOMENTS = ("exp_avg", "exp_avg_sq")


def make_mesh_2d(
    n_data: int,
    n_model: int,
    rank: int,
    init_method: str,
    backend: Optional[str] = None,
    device: Union[None, str, torch.device] = None,
) -> Mesh:
    """A ``(n_data, n_model)`` mesh of ``n_data * n_model`` processes, the
    model axis innermost (rank = d * n_model + m).  Every rank creates every
    data and model group, in the same order, as ``torch.distributed``
    requires.  ``init_method``, ``backend`` and ``device`` as for
    :func:`~nerfacc_tpu_torch.parallel.mesh.make_mesh`."""
    world = n_data * n_model
    device, backend = init_group(world, rank, init_method, backend, device)
    d, m = divmod(rank, n_model)
    data_groups = [dist.new_group([e * n_model + k for e in range(n_data)])
                   for k in range(n_model)]
    model_groups = [dist.new_group([e * n_model + k for k in range(n_model)])
                    for e in range(n_data)]
    return Mesh(dist.group.WORLD, rank, world, device, backend, data_groups[m], d, n_data,
                model_groups[d], m, n_model)


def tp_w1_permutation(ranks: Sequence[int], n_model: int) -> np.ndarray:
    """Row permutation of the first base-MLP weight into shard-major order.

    The whole feature vector is ``[lvl0 ranks | lvl1 ranks | ...]``; model
    rank ``m`` holds ``[lvl0 slice_m | lvl1 slice_m | ...]``, which is not a
    contiguous piece of it.  ``perm[i]`` is the original row that feeds
    permuted row ``i``, so that rank ``m`` takes the m-th contiguous block.
    """
    offs = np.cumsum([0] + list(ranks))
    chunks = []
    for m in range(n_model):
        for level, r in enumerate(ranks):
            if r % n_model:
                raise ValueError(f"level rank {r} must divide over {n_model} model shards")
            lo = offs[level] + m * (r // n_model)
            chunks.append(np.arange(lo, lo + r // n_model))
    return np.concatenate(chunks)


def permute_w1(params: Dict[str, torch.Tensor], perm: np.ndarray) -> Dict[str, torch.Tensor]:
    """``params`` (a CP field's state dict) with the first base-MLP
    weight's rows in shard-major order; the other entries as they are."""
    params = dict(params)
    w1 = params["mlp_base.0"]
    params["mlp_base.0"] = w1[torch.as_tensor(perm, device=w1.device)]
    return params


def _is_sharded(name: str) -> Optional[int]:
    """The dimension along which parameter ``name`` is cut, or None."""
    if name.startswith("encoder.lines."):
        return 2
    if name == "mlp_base.0":
        return 0
    return None


def _slice(name: str, value: torch.Tensor, n_model: int, m: int) -> torch.Tensor:
    """Model rank ``m``'s slice of parameter ``name`` (or of a tensor shaped
    like it); unsharded tensors whole."""
    dim = _is_sharded(name)
    if dim is None or n_model == 1:
        return value
    block = value.shape[dim] // n_model
    return value.narrow(dim, m * block, block)


def shard_params(params: Dict[str, torch.Tensor], n_model: int, m: int) -> Dict[str, torch.Tensor]:
    """Model rank ``m``'s slices of a whole CP field's state dict (W1
    already in shard-major order): every line table along its rank
    dimension, W1 along its rows; the rest whole."""
    return {name: _slice(name, value, n_model, m) for name, value in params.items()}


def make_tp_field(field, mesh: Mesh):
    """The same CP field (``CPRadianceField`` or ``CPDensityField``) sharded
    over ``mesh``'s model group: its line tables and first weight hold this
    rank's slices, and its ``init`` draws the whole field's parameters and
    keeps them, W1 permuted."""
    return type(field)(**field.config, tp_group=mesh.model_group)


def _map_state(state, trainer, fn: Callable[[str, torch.Tensor], torch.Tensor]):
    """``state`` (an ``NGPOccTrainer`` ``TrainState``) with every parameter
    and its Adam moments mapped by ``fn(name, tensor)``, under a new
    optimizer of the trainer's kind that holds the mapped moments."""
    old_opt = state.opt_state.optimizer
    params = {k: fn(k, v.detach()).clone().requires_grad_(True)
              for k, v in state.params.items()}
    opt_state = trainer.init_optimizer(params)
    opt = opt_state.optimizer
    for name, p in params.items():
        saved = old_opt.state.get(state.params[name], {})
        if saved:
            opt.state[p] = {"step": saved["step"].clone(),
                            **{k: fn(name, saved[k]).clone() for k in _MOMENTS}}
    device = next(iter(params.values())).device
    occ = dataclasses.replace(state.occ_state, **{
        f.name: getattr(state.occ_state, f.name).to(device).clone()
        for f in dataclasses.fields(state.occ_state)
    })
    return state._replace(params=params,
                          opt_state=type(state.opt_state)(opt, state.opt_state.count),
                          occ_state=occ)


def copy_state(state, trainer):
    """An independent copy of ``state``: parameters, Adam's moments and the
    occupancy grid cloned (a step updates its parameters in place)."""
    return _map_state(state, trainer, lambda _name, value: value)


def shard_state(state, trainer, mesh: Mesh):
    """This rank's state from a whole one (W1 in shard-major order, as
    :func:`permute_w1` leaves it, or as a TP checkpoint holds it): the
    rank's slices of the line tables, of W1 and of their Adam moments, the
    rest replicated, on the rank's device (JAX's ``make_state_specs``
    placement)."""

    return _map_state(state, trainer, lambda name, value: _slice(
        name, value.to(mesh.device), mesh.n_model, mesh.model_rank))


def gather_state(state, trainer, mesh: Mesh):
    """The whole state from the ranks' slices: every sharded parameter and
    Adam moment gathered over the model group, in the shard-major (permuted)
    layout of W1, as JAX's ``save_checkpoint`` writes a TP state.  Gloo
    gathers through the host.  Every rank of the model group calls it and
    gets the whole state."""
    if mesh.n_model == 1:
        return copy_state(state, trainer)
    return _map_state(state, trainer, functools.partial(gather_tensor, mesh=mesh))


def gather_tensor(name: str, value: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole tensor of parameter ``name`` (or of a tensor shaped like
    it: a moment, a gradient) from the model group's slices; unsharded
    tensors as they are.  Gloo gathers through the host."""
    dim = _is_sharded(name)
    if dim is None or mesh.n_model == 1:
        return value
    via = value.cpu() if mesh.backend == "gloo" else value.contiguous()
    parts = [torch.empty_like(via) for _ in range(mesh.n_model)]
    dist.all_gather(parts, via, group=mesh.model_group)
    return torch.cat(parts, dim=dim).to(value.device)


def make_tp_train_step(trainer, mesh: Mesh):
    """The DP+TP step of an ``NGPOccTrainer`` whose field came from
    :func:`make_tp_field`.  Returns ``(step, shard_state, shard_batch)``:
    ``step(state, local_batch, **kw)`` runs ``trainer.train_step`` with the
    data group (the model group's sum runs inside the field, in training
    and in every rank's occupancy update); ``shard_state(whole_state)`` and
    ``shard_batch(global_batch)`` give this rank's pieces."""

    def step(state, local_batch, **kw):
        return trainer.train_step(state, local_batch, group=mesh.data_group, **kw)

    return (step, functools.partial(shard_state, trainer=trainer, mesh=mesh),
            functools.partial(shard_batch, mesh=mesh))
