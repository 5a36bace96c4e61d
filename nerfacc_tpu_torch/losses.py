"""Regularisation losses.

PyTorch counterpart of nerfacc_tpu/losses.py.
"""
from __future__ import annotations

from typing import Optional

import torch

from .scan import exclusive_sum
from .volrend import accumulate_along_rays


def distortion(
    weights: torch.Tensor,
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    ray_indices: torch.Tensor,
    n_rays: int,
    masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mip-NeRF 360's distortion regulariser, per ray.

    Args:
        weights: (n,) flattened rendering weights.
        t_starts / t_ends: (n,) sample bounds.
        ray_indices: (n,) ray ids; the exclusive sums run over runs of equal
            consecutive ids (:func:`~nerfacc_tpu_torch.scan.exclusive_sum`).
        n_rays: number of rays.
        masks: optional (n,) bool; samples where False weigh 0.

    Returns:
        (n_rays, 1) loss per ray.
    """
    if not weights.shape == t_starts.shape == t_ends.shape == ray_indices.shape:
        raise ValueError("weights, t_starts, t_ends and ray_indices must share a shape")
    if masks is not None:
        weights = torch.where(masks, weights, 0.0)
    t_mids = 0.5 * (t_starts + t_ends)
    t_deltas = t_ends - t_starts
    loss_uni = (1 / 3) * (t_deltas * weights**2)
    loss_bi_0 = weights * t_mids * exclusive_sum(weights, indices=ray_indices)
    loss_bi_1 = weights * exclusive_sum(weights * t_mids, indices=ray_indices)
    loss = loss_uni + 2 * (loss_bi_0 - loss_bi_1)
    return accumulate_along_rays(loss, None, ray_indices, n_rays)
