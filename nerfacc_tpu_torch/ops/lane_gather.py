"""Per-lane gather: kernel G12 and its PyTorch version.

``out[i, l] = src[idx[i, l], l]`` over 128 lanes: the function of the TPU
kernel nerfacc_tpu/ops/lane_gather.py::lane_gather (K6), and of the gather
probe scripts/pallas_gather_probe2.py (P2), where each lane carries its own
table column and index stream.  The shape contract is K6's (128 lanes, ``n``
a multiple of ``T``, which Mosaic's same-shape gather imposed) and raises
the same errors; the indices follow JAX's gather: one in [-T, 0) counts from
the end, one outside [-T, T) reads NaN.  The dtype of ``src`` (f32 or bf16)
is kept.  On the card the table's rows go through shared memory where at
least half of them fit a block's share (:func:`lane_gather_route`), else
through L2, one thread an element.
"""
from __future__ import annotations

import torch

from .. import cuda


def _check_shapes(src: torch.Tensor, idx: torch.Tensor) -> None:
    """K6's two errors, worded as the JAX function words them."""
    t, lanes = src.shape
    n = idx.shape[0]
    if lanes != 128:
        raise ValueError(f"src must have 128 lanes, got {lanes}")
    if n % t != 0:
        raise ValueError(f"idx rows ({n}) must be a multiple of T ({t})")


def take_rows(idx: torch.Tensor, T: int):
    """JAX's gather index rule: (row clamped into [0, T), in range)."""
    row = torch.where(idx < 0, idx + T, idx)
    inside = (row >= 0) & (row < T)
    return row.clamp(0, T - 1).long(), inside


def lane_gather_plain(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """PyTorch version of kernel G12, on any device, bitwise equal to it.

    Args:
        src: (T, 128) f32 or bf16 table columns.
        idx: (n, 128) int32 row ids; ``n`` a multiple of ``T``.

    Returns:
        (n, 128) ``src[idx[i, l], l]`` in ``src``'s dtype.
    """
    _check_shapes(src, idx)
    row, inside = take_rows(idx, src.shape[0])
    lanes = torch.arange(128, device=src.device)
    picked = src[row, lanes[None, :]]
    return torch.where(inside, picked, torch.full((), float("nan"), dtype=src.dtype))


# The shared-memory route keeps, in each block, the first rows of its group
# of columns of the table: up to this many bytes of the 227 KB a block may
# use.  Each launch passes it to the kernel, so it is kept here alone.
SHARED_TABLE_BYTES = 224 * 1024


def lane_gather_route(T: int, dtype: torch.dtype) -> int:
    """The route G12 takes for a (T, 128) table of ``dtype``: the bytes of
    each table row a block keeps in shared memory, or 0.

    32 (8 f32 or 16 bf16 columns a block) while enough of the table's rows
    fit in ``SHARED_TABLE_BYTES``: half of them for f32, three quarters for
    bf16; then, for bf16, 16 (8 columns, whose int32 indices still fill
    whole 32-byte sectors) while half fit; past that 0: one thread an
    element, the table read through L2, the faster there
    (``csrc/gather.cu``)."""
    if dtype == torch.bfloat16:
        if 3 * T * 32 <= 4 * SHARED_TABLE_BYTES:
            return 32
        return 16 if T * 16 <= 2 * SHARED_TABLE_BYTES else 0
    return 32 if T * 32 <= 2 * SHARED_TABLE_BYTES else 0


def lane_gather(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel G12 for CUDA tensors, :func:`lane_gather_plain` for CPU
    tensors; same contract, bitwise equal."""
    if not cuda.on_card(src, idx):
        return lane_gather_plain(src, idx)
    _check_shapes(src, idx)
    if src.dtype not in (torch.float32, torch.bfloat16) or idx.dtype != torch.int32:
        raise TypeError("lane_gather: want an f32 or bf16 src and int32 idx")
    if idx.ndim != 2 or idx.shape[1] != 128:
        raise ValueError(f"lane_gather: idx {tuple(idx.shape)}: want (n, 128)")
    T = src.shape[0]
    route = lane_gather_route(T, src.dtype)
    src, idx = src.contiguous(), idx.contiguous()
    if route and idx.data_ptr() % 16:  # the shared-memory route reads idx 16 bytes at a time
        idx = idx.clone()
    out = torch.empty(idx.shape, dtype=src.dtype, device=src.device)
    err = cuda.load().lane_gather(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0], T,
        src.element_size(), route, SHARED_TABLE_BYTES, cuda.stream_ptr(src),
    )
    cuda.check(err, "lane_gather")
    cuda.LAUNCHES["lane_gather"] += 1
    return out
