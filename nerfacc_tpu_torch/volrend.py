"""Volume-rendering weights, on the sorted flat layout and the batched one.

PyTorch counterpart of two layouts of nerfacc_tpu/volrend.py:
- the ``indices_sorted=True`` flat path: samples are a flat buffer whose ray
  ids are nondecreasing, with per-ray ``seg_starts`` / ``seg_ends``; slots
  with id ``n_rays`` are fill and carry no weight;
- the batched ``(n_rays, n_samples)`` layout of the proposal path (no
  ``ray_indices``), whose :func:`rendering` composites through kernels
  G3/G5 on the flat view of the rows.
The unsorted flat layout and the alpha-based functions are not ported yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


def render_transmittance_from_density(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    ray_indices: Optional[torch.Tensor] = None,
    n_rays: Optional[int] = None,
    seg_starts: Optional[torch.Tensor] = None,
    seg_ends: Optional[torch.Tensor] = None,
    prefix_trans: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transmittance ``T_i = exp(-sum_{j<i, same ray} sigma_j delta_j)`` and
    alphas ``1 - exp(-sigma_i delta_i)``, differentiable in everything.

    Without ``ray_indices`` the inputs are batched ``(n_rays, n_samples)``
    rows and the sum runs along the last axis; with them, they are the
    sorted flat buffer described in the module docstring.  The per-sample
    optical depth is capped at 40: alpha is then 1 to f32 and every later
    transmittance 0, and no sum can grow without bound.  ``prefix_trans`` is
    a per-sample factor (transmittance carried in from earlier marching
    rounds); ``masks`` zeroes the samples where False.
    """
    sigmas_dt = sigmas * (t_ends - t_starts)
    if masks is not None:
        sigmas_dt = torch.where(masks, sigmas_dt, 0.0)
    sigmas_dt = sigmas_dt.clamp(max=40.0)
    alphas = 1.0 - torch.exp(-sigmas_dt)
    if ray_indices is None:
        excl = torch.cat([torch.zeros_like(sigmas_dt[..., :1]),
                          torch.cumsum(sigmas_dt[..., :-1], dim=-1)], dim=-1)
    else:
        from .ops.sorted_segments import exclusive_sum_sorted

        excl = exclusive_sum_sorted(sigmas_dt, ray_indices, n_rays, seg_starts, seg_ends)
    if masks is not None:
        excl = torch.where(masks, excl, 0.0)
    trans = torch.exp(-excl)
    if prefix_trans is not None:
        trans = trans * prefix_trans
    return trans, alphas


def render_weight_from_density(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    ray_indices: torch.Tensor,
    n_rays: int,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    prefix_trans: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rendering weights ``w_i = T_i * alpha_i``; returns (w, T, alpha)."""
    trans, alphas = render_transmittance_from_density(
        t_starts, t_ends, sigmas, ray_indices, n_rays, seg_starts, seg_ends,
        prefix_trans, masks,
    )
    return trans * alphas, trans, alphas


def rendering(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    rgb_sigma_fn: Callable,
    render_bkgd: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """Render batched rays through a radiance field, differentiably in what
    ``rgb_sigma_fn`` computes (not in the sample bounds).

    Args:
        t_starts, t_ends: (n_rays, S) sample bounds.
        rgb_sigma_fn: ``(t_starts, t_ends) -> (rgbs (n_rays, S, 3),
            sigmas (n_rays, S))``.
        render_bkgd: (3,) background colour, blended in by 1 - opacity.

    Returns:
        colors (n_rays, 3), opacities (n_rays, 1), depths (n_rays, 1)
        (expected depth) and extras ``{"trans"}``, the (n_rays, S)
        transmittance that the proposal loss reads.  The composite runs on
        the flat view of the rows, one segment per ray (kernels G3/G5 on the
        card).
    """
    from .ops.sorted_segments import composite_sorted

    rgbs, sigmas = rgb_sigma_fn(t_starts, t_ends)
    n_rays, S = t_starts.shape
    trans, _ = render_transmittance_from_density(t_starts, t_ends, sigmas)
    dev = t_starts.device
    ray_indices = torch.arange(n_rays, dtype=torch.int32, device=dev).repeat_interleave(S)
    seg_starts = torch.arange(n_rays, dtype=torch.int32, device=dev) * S
    colors, opacities, depths, _ = composite_sorted(
        t_starts.reshape(-1), t_ends.reshape(-1), sigmas.reshape(-1),
        rgbs.reshape(-1, 3), ray_indices, n_rays, seg_starts, seg_starts + (S - 1),
    )
    depths = depths / opacities.clamp_min(torch.finfo(colors.dtype).eps)
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities)
    return colors, opacities, depths, {"trans": trans}
