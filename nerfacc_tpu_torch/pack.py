"""Packing utilities: per-sample ray ids to per-ray chunks.

PyTorch counterpart of nerfacc_tpu/pack.py.
"""
from __future__ import annotations

from typing import Optional

import torch


def pack_info(ray_indices: torch.Tensor, n_rays: Optional[int] = None) -> torch.Tensor:
    """Per-sample ray ids -> packed info ``[chunk_start, chunk_cnt]``.

    ``ray_indices`` must be sorted ascending (a ray's samples contiguous).

    Args:
        ray_indices: (all_samples,) integer ray id per sample.
        n_rays: number of rays; ``max(ray_indices) + 1`` if None, which
            waits on the device.  Given, nothing waits.

    Returns:
        (n_rays, 2) int32 ``[chunk_start, chunk_cnt]``.
    """
    if ray_indices.ndim != 1:
        raise ValueError("ray_indices must be a 1-D tensor")
    if n_rays is None:
        n_rays = int(ray_indices.max()) + 1 if ray_indices.numel() else 0
    cnts = torch.bincount(ray_indices.long(), minlength=n_rays)[:n_rays]
    starts = torch.cumsum(cnts, 0) - cnts
    return torch.stack([starts, cnts], dim=-1).to(torch.int32)
