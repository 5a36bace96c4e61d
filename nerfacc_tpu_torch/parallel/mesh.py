"""Data parallelism over a ``torch.distributed`` process group.

PyTorch counterpart of nerfacc_tpu/parallel/mesh.py.  The semantics are the
JAX layer's: the rays of every batch are cut into contiguous blocks, one a
rank (:func:`shard_batch`); parameters, Adam's moments and the occupancy
grid are replicated; each rank runs the single-device train step on its
block, with the collectives at the JAX step body's points (the trainers'
``group`` argument): the loss is normalised by the global count of
completed rays and the gradients are summed over the group, so a step
equals the single-device step on the global batch up to the order of the
sums.  Sampling, packing and the field stay local to a rank.

The process group is built from what the caller gives, an
``init_method`` (``tcp://127.0.0.1:<port>``), the world size and the rank:
nothing on a machine announces a cluster.  NCCL is the default on the card
and needs one card a rank; ranks that share a card (or the CPU) take gloo,
whose ``all_reduce`` and ``broadcast`` accept CUDA tensors.
"""
from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.distributed as dist


@dataclasses.dataclass
class Mesh:
    """One rank's view of a (data, model) mesh of processes.

    Attributes:
        group: the group of every rank.
        rank / world_size: this rank in it, and its size.
        device: where this rank's tensors live.
        backend: "nccl" or "gloo".
        data_group / data_rank / n_data: the ranks that hold the same
            model shard (the data axis), this rank's place there, its size.
        model_group / model_rank / n_model: the ranks that share one block
            of rays (the model axis, innermost: rank = d * n_model + m);
            ``model_group`` is None on a data-parallel mesh.
    """

    group: Any
    rank: int
    world_size: int
    device: torch.device
    backend: str
    data_group: Any
    data_rank: int
    n_data: int
    model_group: Any = None
    model_rank: int = 0
    n_model: int = 1
    axis_name: str = "data"


def _device_and_backend(world_size: int, rank: int, backend: Optional[str],
                        device: Union[None, str, torch.device]):
    if device is None:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' (and backend='gloo')")
        device = torch.device("cuda", rank % n_cards)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA devices, not {device}: use backend='gloo'")
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"NCCL refuses two ranks on one card: {world_size} ranks over "
                f"{torch.cuda.device_count()} card(s); use backend='gloo' for ranks "
                "that share a card"
            )
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    return device, backend


def init_group(world_size: int, rank: int, init_method: str, backend: Optional[str],
               device, timeout: float = 300.0):
    """Join the default process group (or check the one this process is
    already in) and return ``(device, backend)``."""
    device, backend = _device_and_backend(world_size, rank, backend, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        if dist.get_world_size() != world_size or dist.get_rank() != rank:
            raise ValueError(
                f"this process is rank {dist.get_rank()} of {dist.get_world_size()}, "
                f"not {rank} of {world_size}"
            )
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, not {backend}")
    else:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=timeout),
        )
    return device, backend


def make_mesh(
    world_size: int,
    rank: int,
    init_method: str,
    backend: Optional[str] = None,
    device: Union[None, str, torch.device] = None,
    axis_name: str = "data",
) -> Mesh:
    """A 1-D data-parallel mesh over ``world_size`` processes; this process
    is ``rank``.

    Args:
        init_method: ``tcp://127.0.0.1:<port>``, the same in every rank.
        backend: "nccl" (the default on the card) or "gloo" (the default on
            the CPU, and the one for ranks that share a card).
        device: this rank's device; by default ``cuda:(rank % cards)``.

    Raises:
        ValueError: NCCL on the CPU, or NCCL with more ranks than cards
            (two ranks on one card); nothing falls back to gloo.
    """
    device, backend = init_group(world_size, rank, init_method, backend, device)
    group = dist.group.WORLD
    return Mesh(group, rank, world_size, device, backend, group, rank, world_size,
                axis_name=axis_name)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (a one-element all-reduce, on either backend)."""
    dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.group)


def take_block(batch: Dict, index: int, count: int, device=None) -> Dict:
    """Block ``index`` of ``count`` equal contiguous blocks of a global
    ``batch``'s rays, as ``P(axis)`` places it in JAX: every leaf with a ray
    axis is cut along its first axis; ``color_bkgd`` stays whole."""
    out = {}
    for key, value in batch.items():
        value = torch.as_tensor(value, device=device)
        if value.ndim >= 1 and key != "color_bkgd":
            n = value.shape[0]
            if n % count:
                raise ValueError(f"{key}: {n} rays do not split over {count} ranks")
            value = value[index * (n // count) : (index + 1) * (n // count)]
        out[key] = value
    return out


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's contiguous block of rays of a global ``batch``, on its
    device: ``mesh.n_data`` blocks, the ranks of one model group taking the
    same one."""
    return take_block(batch, mesh.data_rank, mesh.n_data, mesh.device)


def make_dp_train_step(trainer, mesh: Mesh) -> Callable:
    """The data-parallel step of an ``NGPOccTrainer``: ``step(state,
    local_batch, **kw)`` runs ``trainer.train_step`` on this rank's block
    (:func:`shard_batch`) with the mesh's data group, so the loss is
    normalised by the global completed-ray count, the gradients, loss, mse
    and aux counts are summed over the group and every rank applies the same
    update; the occupancy update draws from the step's stream 0 on every
    rank, so the grid stays replicated bit for bit.  ``kw`` passes the
    step's noise through (``near_jitter`` is then this rank's block).

    The trainer's ``sample_budget`` applies to each rank: the global budget
    is ``n_data * sample_budget``, as in JAX.
    """

    def step(state, local_batch, **kw):
        return trainer.train_step(state, local_batch, group=mesh.data_group, **kw)

    return step


def make_dp_prop_step(trainer, mesh: Mesh) -> Callable:
    """The data-parallel step of an ``NGPPropTrainer``: ``step(state,
    local_batch, requires_grad, **kw)`` runs its ``train_step`` on this
    rank's block with the mesh's data group: gradients, loss, mse and
    ``prop_loss`` are averaged over the group (every loss term is a mean
    over equal blocks of rays, so the mean of the blocks' gradients is the
    global batch's)."""

    def step(state, local_batch, requires_grad: bool = False, **kw):
        return trainer.train_step(state, local_batch, requires_grad,
                                  group=mesh.data_group, **kw)

    return step
