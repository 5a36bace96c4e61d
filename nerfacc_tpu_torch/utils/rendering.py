"""Occupancy-grid rendering: packed samples, per-chunk render, whole images.

PyTorch counterpart of nerfacc_tpu/utils/rendering.py.  The JAX package
compacts a padded candidate lattice into a fixed sample budget; here the
march (kernel G2) counts, scans and fills an exact-size buffer, which
:func:`compact_samples` cuts at an optional budget with the JAX package's
truncation contract.  Per chunk of rays the flow is: march, pack, field,
composite (kernel G3, differentiable through kernel G5), background blend.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..grid import MarchResult, march
from ..ops.sorted_segments import composite_sorted


class CompactSamples(NamedTuple):
    """Flat sample buffer, sorted by ray.

    Attributes:
        ray_indices: (n,) int32 nondecreasing ray ids.  The exact packing
            leaves no fill slots; consumers still treat an id ``n_rays`` as
            fill, as in the JAX package's budgeted buffers.
        t_starts / t_ends: (n,) f32 sample bounds.
        num_valid: samples kept, ``min(total, budget)``.
        overflow: samples dropped past the budget.
        first_incomplete_ray: the first ray whose samples were cut by the
            budget (rays from it on render wrong and must not train);
            ``n_rays`` when nothing was dropped.
        seg_starts / seg_ends: (n_rays,) int32 first and last slot of each
            ray (ends inclusive; ends < starts for empty rays).
    """

    ray_indices: torch.Tensor
    t_starts: torch.Tensor
    t_ends: torch.Tensor
    num_valid: int
    overflow: int
    first_incomplete_ray: int
    seg_starts: torch.Tensor
    seg_ends: torch.Tensor


def compact_samples(samples: MarchResult, budget: Optional[int] = None) -> CompactSamples:
    """Segment bounds of a march's packed samples, from its per-ray counts,
    keeping the first ``min(total, budget)`` samples (all with no budget).

    The march packs in (ray, orbit) order, so the cut drops a suffix of
    rays: ``first_incomplete_ray`` is the ray of the last kept sample when
    anything was dropped (the JAX package's ``compact_samples`` contract),
    and ``seg_starts = min(ends - counts, budget)``, ``seg_ends =
    min(ends, budget) - 1``.
    """
    n_rays = samples.counts.shape[0]
    total = samples.ray_indices.shape[0]
    keep = total if budget is None else min(total, budget)
    ends = torch.cumsum(samples.counts, 0, dtype=torch.int64)
    first_incomplete = n_rays
    if keep < total:
        first_incomplete = int(samples.ray_indices[keep - 1]) if keep else n_rays
    return CompactSamples(
        ray_indices=samples.ray_indices[:keep],
        t_starts=samples.t_starts[:keep],
        t_ends=samples.t_ends[:keep],
        num_valid=keep,
        overflow=total - keep,
        first_incomplete_ray=first_incomplete,
        seg_starts=(ends - samples.counts).clamp(max=keep).to(torch.int32),
        seg_ends=(ends.clamp(max=keep) - 1).to(torch.int32),
    )


def render_rays_with_occgrid(
    rgb_sigma_fn: Callable,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    samples: CompactSamples,
    render_bkgd: torch.Tensor,
):
    """Composite a packed sample buffer, differentiably in whatever
    ``rgb_sigma_fn`` computes from its parameters.

    Args:
        rgb_sigma_fn: ``(positions (N, 3), dirs (N, 3)) ->
            (rgbs (N, 3), sigmas (N,))``, evaluated on the packed samples.
        rays_o / rays_d: (n_rays, 3).
        render_bkgd: (3,) background colour, blended in by 1 - opacity.

    Returns:
        colors (n_rays, 3), opacities (n_rays, 1), depths (n_rays, 1)
        (expected depth: the weighted mean of sample midpoints), and extras
        ``{"weights": (n,) per-sample weights (no gradient),
        "n_rendering_samples": int}``.
    """
    n_rays = rays_o.shape[0]
    ids = samples.ray_indices.long()
    t_mid = 0.5 * (samples.t_starts + samples.t_ends)
    d = rays_d[ids]
    positions = rays_o[ids] + t_mid[:, None] * d
    rgbs, sigmas = rgb_sigma_fn(positions, d)
    colors, opacities, depths, weights = composite_sorted(
        samples.t_starts, samples.t_ends, sigmas, rgbs, samples.ray_indices,
        n_rays, samples.seg_starts, samples.seg_ends, return_weights=True,
    )
    depths = depths / opacities.clamp_min(torch.finfo(colors.dtype).eps)
    extras = {"weights": weights, "n_rendering_samples": samples.num_valid}
    return colors + render_bkgd * (1.0 - opacities), opacities, depths, extras


def render_image_with_occgrid(
    field_fn: Callable,
    occ_state,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    render_bkgd: torch.Tensor,
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    render_step_size: float = 5e-3,
    cone_angle: float = 0.0,
    chunk: int = 8192,
):
    """Chunked full-image rendering.

    Args:
        field_fn: ``(positions, dirs) -> (rgbs (N, 3), sigmas (N,))``.
        occ_state: an :class:`~nerfacc_tpu_torch.estimators.occ_grid.OccGridState`.
        rays_o / rays_d: (n_pixels, 3) rays.
        render_bkgd: (3,) background colour.

    Returns:
        colors (n, 3), opacities (n, 1), depths (n, 1), and the total number
        of samples rendered.
    """
    n = rays_o.shape[0]
    outs, n_samples = [], 0
    for s in range(0, n, chunk):
        o = rays_o[s : s + chunk]
        d = rays_d[s : s + chunk]
        n_chunk = o.shape[0]
        samples = compact_samples(
            march(
                o, d, occ_state.binaries, occ_state.aabbs,
                near_planes=torch.full((n_chunk,), near_plane, device=o.device),
                far_planes=torch.full((n_chunk,), far_plane, device=o.device),
                step_size=render_step_size, cone_angle=cone_angle,
            )
        )
        n_samples += samples.num_valid
        outs.append(
            render_rays_with_occgrid(field_fn, o, d, samples, render_bkgd)[:3]
        )
    colors, opacities, depths = (torch.cat(parts) for parts in zip(*outs))
    return colors, opacities, depths, n_samples
