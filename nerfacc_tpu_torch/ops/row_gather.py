"""Row gather: kernel G13 and its PyTorch version.

``out[i, :] = tab[idx[i], :]``: the function that the four kernels of the
TPU gather probe scripts/pallas_gather_probe.py (P1) each formulate
(``jnp.take`` over a VMEM table, gridded, per lane, and a scalar loop), with
``jnp.take``'s index rule: one in [-T, 0) counts from the end, one outside
[-T, T) reads NaN.  On the card one thread copies one 16-byte chunk of a
row (one element where the row length or alignment forbids a chunk).
"""
from __future__ import annotations

import torch

from .. import cuda
from .lane_gather import take_rows


def row_gather_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """PyTorch version of kernel G13, on any device, bitwise equal to it.

    Args:
        tab: (T, F) f32 table.
        idx: (n,) int32 row ids.

    Returns:
        (n, F) f32 rows.
    """
    row, inside = take_rows(idx, tab.shape[0])
    return torch.where(inside[:, None], tab[row], float("nan"))


def _vector_width(t: torch.Tensor, F: int) -> int:
    """Floats per thread: the widest of 4, 2, 1 that divides the row and
    keeps every chunk aligned."""
    for vec in (4, 2):
        if F % vec == 0 and t.data_ptr() % (4 * vec) == 0:
            return vec
    return 1


def row_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel G13 for CUDA tensors, :func:`row_gather_plain` for CPU
    tensors; same contract, bitwise equal."""
    if not cuda.on_card(tab, idx):
        return row_gather_plain(tab, idx)
    if tab.dtype != torch.float32 or tab.ndim != 2:
        raise TypeError(f"row_gather: tab {tab.dtype} {tuple(tab.shape)}: want f32 (T, F)")
    if idx.dtype != torch.int32 or idx.ndim != 1:
        raise TypeError(f"row_gather: idx {idx.dtype} {tuple(idx.shape)}: want int32 (n,)")
    tab, idx = tab.contiguous(), idx.contiguous()
    T, F = tab.shape
    out = torch.empty((idx.shape[0], F), dtype=torch.float32, device=tab.device)
    vec = min(_vector_width(tab, F), _vector_width(out, F))
    err = cuda.load().row_gather(
        cuda.ptr(tab), cuda.ptr(idx), cuda.ptr(out), idx.shape[0], T, F, vec,
        cuda.stream_ptr(tab),
    )
    cuda.check(err, "row_gather")
    cuda.LAUNCHES["row_gather"] += 1
    return out
