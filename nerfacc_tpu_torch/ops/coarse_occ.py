"""Coarse-occupancy lookup: kernel G11 and its PyTorch version.

``out[n] = f32(bf16(summary[row[n], lane[n]]))``, and 0 where ``row[n]`` or
``lane[n]`` lies outside the table: the function of the TPU kernel
nerfacc_tpu/ops/coarse_occ.py::coarse_occ_lookup (K5), which reads the
summary through a bf16 one-hot row matmul (so a value is rounded to bf16,
and an index that matches no one-hot column reads 0).  On the card it is one
indexed load per output.  No user path of either package calls it: the
windowed traversal it was written for looks its windows up through XLA, and
the port marches exactly instead (``grid.py``).
"""
from __future__ import annotations

import torch

from .. import cuda


def coarse_occ_lookup_plain(
    row: torch.Tensor, lane: torch.Tensor, summary: torch.Tensor
) -> torch.Tensor:
    """PyTorch version of kernel G11, on any device, bitwise equal to it.

    Args:
        row, lane: (N,) int32 indices.
        summary: (rows, lanes) f32 table.

    Returns:
        (N,) f32 values, bf16-rounded, 0 outside the table.
    """
    rows, lanes = summary.shape
    inside = (row >= 0) & (row < rows) & (lane >= 0) & (lane < lanes)
    r = row.long().clamp(0, rows - 1)
    c = lane.long().clamp(0, lanes - 1)
    picked = summary[r, c].to(torch.bfloat16).to(torch.float32)
    return torch.where(inside, picked, 0.0)


def coarse_occ_lookup(
    row: torch.Tensor, lane: torch.Tensor, summary: torch.Tensor
) -> torch.Tensor:
    """Kernel G11 for CUDA tensors, :func:`coarse_occ_lookup_plain` for CPU
    tensors; same contract, bitwise equal."""
    if not cuda.on_card(row, lane, summary):
        return coarse_occ_lookup_plain(row, lane, summary)
    if row.dtype != torch.int32 or lane.dtype != torch.int32 or row.shape != lane.shape:
        raise TypeError("coarse_occ_lookup: row and lane must be int32 (N,) alike")
    if summary.dtype != torch.float32 or summary.ndim != 2 or row.ndim != 1:
        raise ValueError("coarse_occ_lookup: want (N,) indices and an f32 (rows, lanes) table")
    # the copies stay named until the launch; any alignment is taken
    row, lane, summary = row.contiguous(), lane.contiguous(), summary.contiguous()
    out = torch.empty_like(row, dtype=torch.float32)
    err = cuda.load().coarse_occ_lookup(
        row.data_ptr(), lane.data_ptr(), summary.data_ptr(), out.data_ptr(),
        out.shape[0], *summary.shape, cuda.stream_ptr(row),
    )
    cuda.check(err, "coarse_occ_lookup")
    cuda.LAUNCHES["coarse_occ"] += 1
    return out
