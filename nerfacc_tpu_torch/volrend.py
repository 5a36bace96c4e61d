"""Differentiable volume rendering, on the batched and the flattened layouts.

PyTorch counterpart of nerfacc_tpu/volrend.py.  Every function takes one of
three layouts: batched ``(n_rays, n_samples)`` rows (no ``ray_indices`` or
``packed_info``); a flattened buffer with ``packed_info``; a flattened
buffer with ``ray_indices``, whose segments are runs of equal consecutive
ids (:mod:`~nerfacc_tpu_torch.scan`).  The sorted flat layout of the
occupancy path (``indices_sorted=True`` with per-ray ``seg_starts`` /
``seg_ends``; slots with id ``n_rays`` are fill and carry no weight) scans
through :func:`~nerfacc_tpu_torch.ops.sorted_segments.exclusive_sum_sorted`.

``masks`` (the shape of the samples) makes the samples where it is False
behave as absent: alpha 0, weight 0, and no step in the transmittance.

:func:`rendering` composites densities through kernels G3/G5 on the card
(the batched rows as one segment each, the flattened buffer run by run);
the alpha route composites in PyTorch ops, since G3 takes densities.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .scan import exclusive_prod, exclusive_sum


def _apply_mask(x: torch.Tensor, masks: Optional[torch.Tensor], fill: float) -> torch.Tensor:
    return x if masks is None else torch.where(masks, x, fill)


def render_transmittance_from_alpha(
    alphas: torch.Tensor,
    packed_info: Optional[torch.Tensor] = None,
    ray_indices: Optional[torch.Tensor] = None,
    n_rays: Optional[int] = None,
    prefix_trans: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Transmittance ``T_i = prod_{j<i, same segment} (1 - alpha_j)``.

    Example::

        >>> alphas = torch.tensor([0.4, 0.8, 0.1, 0.8, 0.1, 0.0, 0.9])
        >>> ray_indices = torch.tensor([0, 0, 0, 1, 1, 2, 2])
        >>> render_transmittance_from_alpha(alphas, ray_indices=ray_indices)
        tensor([1.0000, 0.6000, 0.1200, 1.0000, 0.2000, 1.0000, 1.0000])
    """
    alphas = _apply_mask(alphas, masks, 0.0)
    trans = exclusive_prod(1.0 - alphas, packed_info=packed_info, indices=ray_indices)
    if prefix_trans is not None:
        trans = trans * prefix_trans
    return trans


def render_transmittance_from_density(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    packed_info: Optional[torch.Tensor] = None,
    ray_indices: Optional[torch.Tensor] = None,
    n_rays: Optional[int] = None,
    prefix_trans: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
    indices_sorted: bool = False,
    seg_starts: Optional[torch.Tensor] = None,
    seg_ends: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transmittance ``T_i = exp(-sum_{j<i, same segment} sigma_j delta_j)``
    and alphas ``1 - exp(-sigma_i delta_i)``, differentiable in everything.

    The per-sample optical depth is capped at 40: alpha is then 1 to f32 and
    every later transmittance 0, and no sum can grow without bound.
    ``indices_sorted`` (with ``ray_indices``, ``n_rays``, ``seg_starts`` and
    ``seg_ends``) takes the sorted flat layout's scan.

    Example::

        >>> t_starts = torch.tensor([0., 1., 2., 3., 4., 5., 6.])
        >>> t_ends = torch.tensor([1., 2., 3., 4., 5., 6., 7.])
        >>> sigmas = torch.tensor([0.4, 0.8, 0.1, 0.8, 0.1, 0.0, 0.9])
        >>> ray_indices = torch.tensor([0, 0, 0, 1, 1, 2, 2])
        >>> trans, alphas = render_transmittance_from_density(
        ...     t_starts, t_ends, sigmas, ray_indices=ray_indices)
        trans:  [1.00, 0.67, 0.30, 1.00, 0.45, 1.00, 1.00]
        alphas: [0.33, 0.55, 0.095, 0.55, 0.095, 0.00, 0.59]
    """
    sigmas_dt = _apply_mask(sigmas * (t_ends - t_starts), masks, 0.0)
    sigmas_dt = sigmas_dt.clamp(max=40.0)
    alphas = 1.0 - torch.exp(-sigmas_dt)
    if indices_sorted and ray_indices is not None and n_rays is not None:
        from .ops.sorted_segments import exclusive_sum_sorted

        excl = exclusive_sum_sorted(sigmas_dt, ray_indices, n_rays, seg_starts, seg_ends)
        excl = _apply_mask(excl, masks, 0.0)
    else:
        excl = exclusive_sum(sigmas_dt, packed_info=packed_info, indices=ray_indices)
    trans = torch.exp(-excl)
    if prefix_trans is not None:
        trans = trans * prefix_trans
    return trans, alphas


def render_weight_from_alpha(
    alphas: torch.Tensor,
    packed_info: Optional[torch.Tensor] = None,
    ray_indices: Optional[torch.Tensor] = None,
    n_rays: Optional[int] = None,
    prefix_trans: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rendering weights ``w_i = T_i * alpha_i`` from alphas: (w, T)."""
    alphas = _apply_mask(alphas, masks, 0.0)
    trans = render_transmittance_from_alpha(
        alphas, packed_info, ray_indices, n_rays, prefix_trans
    )
    return trans * alphas, trans


def render_weight_from_density(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    packed_info: Optional[torch.Tensor] = None,
    ray_indices: Optional[torch.Tensor] = None,
    n_rays: Optional[int] = None,
    prefix_trans: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
    indices_sorted: bool = False,
    seg_starts: Optional[torch.Tensor] = None,
    seg_ends: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rendering weights ``w_i = T_i * alpha_i`` from densities: (w, T,
    alpha).  Arguments as :func:`render_transmittance_from_density`."""
    trans, alphas = render_transmittance_from_density(
        t_starts, t_ends, sigmas, packed_info, ray_indices, n_rays, prefix_trans,
        masks, indices_sorted, seg_starts, seg_ends,
    )
    return trans * alphas, trans, alphas


def _visibility(trans, alphas, early_stop_eps, alpha_thre, masks):
    vis = trans >= early_stop_eps
    alpha_thre = torch.as_tensor(alpha_thre, dtype=alphas.dtype, device=alphas.device)
    vis = torch.where(alpha_thre > 0, vis & (alphas >= alpha_thre), vis)
    return vis if masks is None else vis & masks


@torch.no_grad()
def render_visibility_from_alpha(
    alphas: torch.Tensor,
    packed_info: Optional[torch.Tensor] = None,
    ray_indices: Optional[torch.Tensor] = None,
    n_rays: Optional[int] = None,
    early_stop_eps: float = 1e-4,
    alpha_thre=0.0,
    prefix_trans: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Visibility: ``T >= early_stop_eps`` and, where ``alpha_thre > 0``
    (a float or a 0-d tensor), ``alpha >= alpha_thre``.  Not
    differentiable."""
    alphas = _apply_mask(alphas, masks, 0.0)
    trans = render_transmittance_from_alpha(alphas, packed_info, ray_indices, n_rays, prefix_trans)
    return _visibility(trans, alphas, early_stop_eps, alpha_thre, masks)


@torch.no_grad()
def render_visibility_from_density(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    packed_info: Optional[torch.Tensor] = None,
    ray_indices: Optional[torch.Tensor] = None,
    n_rays: Optional[int] = None,
    early_stop_eps: float = 1e-4,
    alpha_thre=0.0,
    prefix_trans: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Visibility computed from densities, as
    :func:`render_visibility_from_alpha`.  Not differentiable."""
    trans, alphas = render_transmittance_from_density(
        t_starts, t_ends, sigmas, packed_info, ray_indices, n_rays, prefix_trans, masks
    )
    return _visibility(trans, alphas, early_stop_eps, alpha_thre, masks)


def accumulate_along_rays(
    weights: torch.Tensor,
    values: Optional[torch.Tensor] = None,
    ray_indices: Optional[torch.Tensor] = None,
    n_rays: Optional[int] = None,
    masks: Optional[torch.Tensor] = None,
    indices_sorted: bool = False,
) -> torch.Tensor:
    """``sum_i w_i * v_i`` along each ray (``v = 1`` without ``values``).

    The flattened layout adds each sample into its ray with ``index_add``
    (ids outside ``[0, n_rays)`` are dropped, as fill); the batched layout
    sums over the sample axis.

    Returns:
        (n_rays, D) sums (D = 1 without ``values``).
    """
    weights = _apply_mask(weights, masks, 0.0)
    if values is None:
        src = weights[..., None]
    else:
        if values.shape[:-1] != weights.shape:
            raise ValueError("values must be the samples' shape plus one axis")
        src = weights[..., None] * values
    if ray_indices is None:
        return src.sum(dim=-2)
    if n_rays is None:
        raise ValueError("n_rays must be provided")
    if weights.ndim != 1:
        raise ValueError("weights must be flattened")
    from .ops.sorted_segments import segment_sum_sorted

    return segment_sum_sorted(src, ray_indices, n_rays)


def accumulate_along_rays_(
    weights: torch.Tensor,
    values: Optional[torch.Tensor] = None,
    ray_indices: Optional[torch.Tensor] = None,
    outputs: Optional[torch.Tensor] = None,
    masks: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Add the sums of :func:`accumulate_along_rays` into ``outputs`` (n_rays,
    D) in place, and return it (the reference's in-place form; the JAX
    package returns a new array)."""
    delta = accumulate_along_rays(weights, values, ray_indices, outputs.shape[0], masks)
    return outputs.add_(delta.expand_as(outputs) if values is None else delta)


def _composite_runs(t_starts, t_ends, sigmas, rgbs, ray_indices, n_rays):
    """Per-ray colour, opacity and depth sums of a flattened buffer, each run
    of equal consecutive ids composited as one segment through
    :func:`~nerfacc_tpu_torch.ops.sorted_segments.composite_sorted` (G3/G5
    on the card), the runs then added into their rays.  Sorted ids give one
    run a ray.  Runs whose id lies outside ``[0, n_rays)`` are dropped."""
    from .ops.sorted_segments import composite_sorted, segment_sum_sorted
    from .scan import _flags_from_indices

    flags = _flags_from_indices(ray_indices)
    run_ids = (torch.cumsum(flags, 0) - 1).to(torch.int32)
    run_starts = torch.nonzero(flags)[:, 0]  # waits on the device: sizes the runs
    run_ends = torch.cat([run_starts[1:], run_starts.new_full((1,), t_starts.shape[0])])
    run_ends = run_ends[: run_starts.shape[0]] - 1
    sums = composite_sorted(
        t_starts, t_ends, sigmas, rgbs, run_ids, run_starts.shape[0],
        run_starts.to(torch.int32), run_ends.to(torch.int32),
    )[:3]
    sums = segment_sum_sorted(torch.cat(sums, -1), ray_indices[run_starts], n_rays)
    return sums[:, :3], sums[:, 3:4], sums[:, 4:5]


def _composite_rows(t_starts, t_ends, sigmas, rgbs):
    """:func:`_composite_runs` for batched rows: each row one segment, with
    nothing to wait on."""
    from .ops.sorted_segments import composite_sorted

    n_rays, S = t_starts.shape
    rows = torch.arange(n_rays, dtype=torch.int32, device=t_starts.device)
    colors, opacities, depths, _ = composite_sorted(
        t_starts.reshape(-1), t_ends.reshape(-1), sigmas.reshape(-1),
        rgbs.reshape(-1, 3), rows.repeat_interleave(S), n_rays, rows * S, rows * S + (S - 1),
    )
    return colors, opacities, depths


def rendering(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    ray_indices: Optional[torch.Tensor] = None,
    n_rays: Optional[int] = None,
    rgb_sigma_fn: Optional[Callable] = None,
    rgb_alpha_fn: Optional[Callable] = None,
    render_bkgd: Optional[torch.Tensor] = None,
    expected_depths: bool = True,
    masks: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict]:
    """Render rays through a radiance field given by a callback,
    differentiably in what the callback computes (not in the sample bounds).

    Args:
        t_starts, t_ends: (n_rays, S) batched or (n,) flattened bounds.
        ray_indices: (n,) ray ids of a flattened buffer (None: batched).
        n_rays: the number of rays of a flattened buffer.
        rgb_sigma_fn: ``(t_starts, t_ends, ray_indices) -> (rgbs (..., 3),
            sigmas (...))``; ``ray_indices`` is None in the batched layout.
        rgb_alpha_fn: the same returning ``(rgbs, alphas)``, used when
            ``rgb_sigma_fn`` is None.
        render_bkgd: (3,) background colour, blended in by 1 - opacity.
        expected_depths: divide the depth sum by the opacity.
        masks: samples to treat as absent where False.

    Returns:
        colors (n_rays, 3), opacities (n_rays, 1), depths (n_rays, 1), and
        extras ``{weights, alphas, trans, sigmas, rgbs}`` (no ``sigmas`` on
        the alpha route), differentiable.  On the density route the colours,
        opacities and depths come from kernel G3 (gradients from G5) on the
        card and its plain version on the CPU; the extras from PyTorch ops.
    """
    if ray_indices is not None and not (t_starts.shape == t_ends.shape == ray_indices.shape):
        raise ValueError("t_starts, t_ends and ray_indices must have the same shape")
    if rgb_sigma_fn is None and rgb_alpha_fn is None:
        raise ValueError(
            "At least one of `rgb_sigma_fn` and `rgb_alpha_fn` should be specified."
        )
    if rgb_sigma_fn is not None:
        rgbs, sigmas = rgb_sigma_fn(t_starts, t_ends, ray_indices)
        if rgbs.shape[-1] != 3 or sigmas.shape != t_starts.shape:
            raise ValueError(f"rgbs {tuple(rgbs.shape)} / sigmas {tuple(sigmas.shape)}: "
                             f"want (..., 3) and {tuple(t_starts.shape)}")
        weights, trans, alphas = render_weight_from_density(
            t_starts, t_ends, sigmas, ray_indices=ray_indices, n_rays=n_rays, masks=masks
        )
        extras = {"weights": weights, "alphas": alphas, "trans": trans,
                  "sigmas": sigmas, "rgbs": rgbs}
        live = _apply_mask(sigmas, masks, 0.0)
        if ray_indices is None:
            colors, opacities, depths = _composite_rows(t_starts, t_ends, live, rgbs)
        else:
            colors, opacities, depths = _composite_runs(
                t_starts, t_ends, live, rgbs, ray_indices, n_rays
            )
    else:
        rgbs, alphas = rgb_alpha_fn(t_starts, t_ends, ray_indices)
        if rgbs.shape[-1] != 3 or alphas.shape != t_starts.shape:
            raise ValueError(f"rgbs {tuple(rgbs.shape)} / alphas {tuple(alphas.shape)}: "
                             f"want (..., 3) and {tuple(t_starts.shape)}")
        weights, trans = render_weight_from_alpha(
            alphas, ray_indices=ray_indices, n_rays=n_rays, masks=masks
        )
        extras = {"weights": weights, "trans": trans, "rgbs": rgbs, "alphas": alphas}
        colors = accumulate_along_rays(weights, rgbs, ray_indices, n_rays)
        opacities = accumulate_along_rays(weights, None, ray_indices, n_rays)
        depths = accumulate_along_rays(
            weights, (t_starts + t_ends)[..., None] / 2.0, ray_indices, n_rays
        )
    if expected_depths:
        depths = depths / opacities.clamp_min(torch.finfo(rgbs.dtype).eps)
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities)
    return colors, opacities, depths, extras
