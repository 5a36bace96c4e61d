"""Occupancy-grid rendering: packed samples, per-chunk render, whole images.

PyTorch counterpart of nerfacc_tpu/utils/rendering.py.  The JAX package
compacts a padded candidate lattice into a fixed sample budget; here the
march (kernel G2) counts, scans and fills an exact-size buffer, which
:func:`compact_samples` cuts at an optional budget with the JAX package's
truncation contract.  Per chunk of rays the flow is: march, pack, field,
composite (kernel G3, differentiable through kernel G5), background blend.
The eval renderer :func:`render_rays_occgrid_test` marches a window of orbit
candidates a round and stops each ray once its opacity saturates.  The JAX
package's pooled renderers are here too: :func:`compact_samples_from_windows`
flattens a window pool (``grid.traverse_grids_pooled``), and
:func:`render_rays_occgrid_pooled` (rounds of the pool from each ray's
resume plane) and :func:`make_cursor_eval_chunk` (rounds over one window
list a chunk) composite each ray's exact samples in rounds, behind the
opacity of the rounds before, until it saturates.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..grid import (
    MarchResult,
    TraversalResult,
    WindowSamples,
    _occupied_windows,
    _orbit_t,
    _window_bounds,
    march,
    traverse_grids_pooled,
)
from ..estimators.occ_grid import sampling
from ..ops.sorted_segments import composite_sorted


class CompactSamples(NamedTuple):
    """Flat sample buffer, sorted by ray.

    Attributes:
        ray_indices: (n,) int32 nondecreasing ray ids.  The exact packing
            leaves no fill slots; consumers still treat an id ``n_rays`` as
            fill, as in the JAX package's budgeted buffers.
        t_starts / t_ends: (n,) f32 sample bounds.
        valid: (n,) bool, the slots that hold a sample: all true, since the
            exact packing has no fill slots (the JAX package's fixed-size
            buffer marks its filled prefix).
        num_valid: samples kept, ``min(total, budget)``.
        overflow: samples dropped past the budget.
        first_incomplete_ray: the first ray whose samples were cut by the
            budget (rays from it on render wrong and must not train);
            ``n_rays`` when nothing was dropped.
        seg_starts / seg_ends: (n_rays,) int32 first and last slot of each
            ray (ends inclusive; ends < starts for empty rays).
        rays_o / rays_d: (n, 3) each sample's ray, where the buffer came from
            a window pool (:func:`compact_samples_from_windows`); else None.
        extras: (n, C) per-window channels carried to each sample, or None.
    """

    ray_indices: torch.Tensor
    t_starts: torch.Tensor
    t_ends: torch.Tensor
    valid: torch.Tensor
    num_valid: int
    overflow: int
    first_incomplete_ray: int
    seg_starts: torch.Tensor
    seg_ends: torch.Tensor
    rays_o: Optional[torch.Tensor] = None
    rays_d: Optional[torch.Tensor] = None
    extras: Optional[torch.Tensor] = None


def compact_samples(res, budget: Optional[int] = None) -> CompactSamples:
    """Segment bounds of a march's packed samples, from its per-ray counts,
    keeping the first ``min(total, budget)`` samples (all with no budget).

    ``res`` is a :class:`~nerfacc_tpu_torch.grid.MarchResult`, or a padded
    :class:`~nerfacc_tpu_torch.grid.TraversalResult` (``sampling_padded``'s,
    as the JAX package takes), whose valid candidates are packed in (ray,
    orbit) order first.  The march packs in (ray, orbit) order, so the cut
    drops a suffix of rays: ``first_incomplete_ray`` is the ray of the last
    kept sample when anything was dropped (the JAX package's
    ``compact_samples`` contract), and ``seg_starts = min(ends - counts,
    budget)``, ``seg_ends = min(ends, budget) - 1``.
    """
    if isinstance(res, TraversalResult):
        ray_ids, _ = res.valid.nonzero(as_tuple=True)
        res = MarchResult(
            ray_ids.to(torch.int32), res.t_starts[res.valid], res.t_ends[res.valid],
            res.valid.sum(dim=-1, dtype=torch.int32), res.termination_planes, res.terminated,
        )
    n_rays = res.counts.shape[0]
    total = res.ray_indices.shape[0]
    keep = total if budget is None else min(total, budget)
    ends = torch.cumsum(res.counts, 0, dtype=torch.int64)
    first_incomplete = n_rays
    if keep < total:
        first_incomplete = int(res.ray_indices[keep - 1]) if keep else n_rays
    return CompactSamples(
        ray_indices=res.ray_indices[:keep],
        t_starts=res.t_starts[:keep],
        t_ends=res.t_ends[:keep],
        valid=torch.ones(keep, dtype=torch.bool, device=res.t_starts.device),
        num_valid=keep,
        overflow=total - keep,
        first_incomplete_ray=first_incomplete,
        seg_starts=(ends - res.counts).clamp(max=keep).to(torch.int32),
        seg_ends=(ends.clamp(max=keep) - 1).to(torch.int32),
    )


def render_rays_with_occgrid(
    rgb_sigma_fn: Callable,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    samples: CompactSamples,
    render_bkgd: Optional[torch.Tensor] = None,
    expected_depths: bool = True,
    prefix_trans: Optional[torch.Tensor] = None,
    prefix_trans_samples: Optional[torch.Tensor] = None,
):
    """Composite a packed sample buffer, differentiably in whatever
    ``rgb_sigma_fn`` computes from its parameters.

    Args:
        rgb_sigma_fn: ``(positions (N, 3), dirs (N, 3), ray_indices (N,))
            -> (rgbs (N, 3), sigmas (N,))``, evaluated on the packed samples
            (``ray_indices``, int64, lets a time- or appearance-conditioned
            field look up per-ray inputs).
        rays_o / rays_d: (n_rays, 3).
        render_bkgd: (3,) background colour, blended in by 1 - opacity
            (None: no blend).
        expected_depths: divide the depth sums by the opacities (the
            weighted mean of the sample midpoints); False keeps the sums.
        prefix_trans: (n_rays, 1) transmittance carried in from earlier
            rounds of the same rays: every sample's weight is scaled by its
            ray's, and the outputs are this round's shares (the JAX
            package's resumable ``prefix_trans``).  It goes into kernel G3
            (and G5) as :func:`render_rays_occgrid_test` hands it, and
            carries no gradient.
        prefix_trans_samples: the same, one value a sample (n,), as JAX's
            pooled renderers carry it; each ray's samples hold its one
            value.  Preferred over ``prefix_trans``.

    Returns:
        colors (n_rays, 3), opacities (n_rays, 1), depths (n_rays, 1), and
        extras ``{"weights": (n,) per-sample weights (no gradient; the JAX
        package's carry one), "sigmas", "rgbs": the field's outputs,
        "n_rendering_samples": int}``.
    """
    n_rays = rays_o.shape[0]
    ids = samples.ray_indices.long()
    t_mid = 0.5 * (samples.t_starts + samples.t_ends)
    d = rays_d[ids]
    positions = rays_o[ids] + t_mid[:, None] * d
    rgbs, sigmas = rgb_sigma_fn(positions, d, ids)
    pt = None
    if prefix_trans_samples is not None:
        pt = torch.ones(n_rays, dtype=t_mid.dtype, device=t_mid.device)
        pt[ids] = prefix_trans_samples.to(t_mid.dtype)
    elif prefix_trans is not None:
        pt = prefix_trans.reshape(n_rays).contiguous()
    colors, opacities, depths, weights = composite_sorted(
        samples.t_starts, samples.t_ends, sigmas, rgbs, samples.ray_indices,
        n_rays, samples.seg_starts, samples.seg_ends, prefix_trans=pt,
        return_weights=True,
    )
    if expected_depths:
        depths = depths / opacities.clamp_min(torch.finfo(colors.dtype).eps)
    if render_bkgd is not None:
        colors = colors + render_bkgd * (1.0 - opacities)
    extras = {"weights": weights, "sigmas": sigmas, "rgbs": rgbs,
              "n_rendering_samples": samples.num_valid}
    return colors, opacities, depths, extras


def render_image_with_occgrid(
    field_fn: Callable,
    occ_state,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    render_bkgd: Optional[torch.Tensor] = None,
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    render_step_size: float = 5e-3,
    cone_angle: float = 0.0,
    alpha_thre: float = 0.0,
    early_stop_eps: float = 1e-4,
    max_samples: Optional[int] = 1024,
    chunk: int = 8192,
    sample_budget: Optional[int] = 2**18,
):
    """Chunked full-image rendering, the JAX package's: per chunk of
    ``chunk`` rays, the occupied samples among each ray's first
    ``max_samples`` orbit candidates from the near plane (the padded
    lattice of ``sampling_padded``; here kernel G2 with that candidate
    window, packed exactly), cut at ``sample_budget`` samples
    (:func:`compact_samples`: the rays from the first one cut on render
    wrong, as in JAX), then the field and kernel G3.  ``max_samples`` and
    ``sample_budget`` None march every orbit whole and keep every sample
    (the exact renderer).  ``alpha_thre`` and ``early_stop_eps`` are taken
    as JAX takes them, and change no sample: its ``sampling_padded`` filters
    by them only given a density or alpha callback, which this renderer
    does not pass.

    Args:
        field_fn: ``(positions, dirs) -> (rgbs (N, 3), sigmas (N,))``.
        occ_state: an :class:`~nerfacc_tpu_torch.estimators.occ_grid.OccGridState`.
        rays_o / rays_d: (n_pixels, 3) rays.
        render_bkgd: (3,) background colour (None: none blended in).

    Returns:
        colors (n, 3), opacities (n, 1), depths (n, 1), and the total number
        of samples rendered.
    """
    n = rays_o.shape[0]
    outs, n_samples = [], 0
    for s in range(0, n, chunk):
        o = rays_o[s : s + chunk]
        d = rays_d[s : s + chunk]
        samples = compact_samples(
            sampling(
                occ_state, o, d, near_plane=near_plane, far_plane=far_plane,
                render_step_size=render_step_size, cone_angle=cone_angle,
                max_samples=max_samples,
            ),
            sample_budget,
        )
        n_samples += samples.num_valid
        outs.append(
            render_rays_with_occgrid(
                lambda p, dirs, _ids: field_fn(p, dirs), o, d, samples, render_bkgd
            )[:3]
        )
    colors, opacities, depths = (torch.cat(parts) for parts in zip(*outs))
    return colors, opacities, depths, n_samples


def render_rays_occgrid_test(
    field_fn: Callable,
    occ_state,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    render_bkgd: Optional[torch.Tensor] = None,
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    render_step_size: float = 5e-3,
    cone_angle: float = 0.0,
    early_stop_eps: float = 1e-4,
    window: int = 64,
    max_iters: int = 64,
    expected_depths: bool = True,
    return_stats: bool = False,
):
    """Alive-ray inference renderer: each round marches the alive rays'
    next ``window`` orbit candidates, composites them behind the opacity the
    earlier rounds gathered, and retires the rays that terminated or whose
    opacity passed ``1 - early_stop_eps``; the survivors resume from their
    termination planes.

    The JAX package's ``render_rays_occgrid_test``, round for round: the
    march (kernel G2) with ``max_samples=window`` and ``rays_mask=alive``
    from the previous round's termination planes, the field on the round's
    packed samples, and kernel G3 with ``prefix_trans = 1 - opacity``.  It
    stops after ``max_iters`` rounds or when no ray is alive.  The host
    waits once a round, on the march's sample count: a round that emits a
    sample had a live ray, so only a round that emits none reads whether any
    ray is alive, and a round that finds none is not counted.

    Args:
        field_fn: ``(positions, dirs) -> (rgbs (N, 3), sigmas (N,))``.
        occ_state: an :class:`~nerfacc_tpu_torch.estimators.occ_grid.OccGridState`.
        rays_o / rays_d: (n_rays, 3).
        render_bkgd: optional (3,) background, blended in by 1 - opacity.

    Returns:
        colors (n_rays, 3), opacities (n_rays, 1), depths (n_rays, 1), as
        the JAX package's; with ``return_stats`` also ``{"n_samples":
        samples rendered over the rounds, "n_rounds": rounds run, "counts":
        (n_rays,) int32 samples of each ray}``.
    """
    n_rays = rays_o.shape[0]
    like = dict(dtype=rays_o.dtype, device=rays_o.device)
    near = torch.full((n_rays,), near_plane, **like)
    far = torch.full((n_rays,), far_plane, **like)
    alive = torch.ones(n_rays, dtype=torch.bool, device=rays_o.device)
    color = torch.zeros((n_rays, 3), **like)
    opacity = torch.zeros((n_rays, 1), **like)
    depth = torch.zeros((n_rays, 1), **like)
    counts = torch.zeros(n_rays, dtype=torch.int32, device=rays_o.device)
    n_samples = n_rounds = 0
    while n_rounds < max_iters:
        res = march(
            rays_o, rays_d, occ_state.binaries, occ_state.aabbs,
            near_planes=near, far_planes=far, step_size=render_step_size,
            cone_angle=cone_angle, rays_mask=alive, max_samples=window,
        )
        samples = compact_samples(res)
        if not samples.num_valid and not bool(alive.any()):
            break
        if samples.num_valid:
            ids = samples.ray_indices.long()
            t_mid = 0.5 * (samples.t_starts + samples.t_ends)
            d = rays_d[ids]
            rgbs, sigmas = field_fn(rays_o[ids] + t_mid[:, None] * d, d)
            c, o, dep, _ = composite_sorted(
                samples.t_starts, samples.t_ends, sigmas, rgbs,
                samples.ray_indices, n_rays, samples.seg_starts, samples.seg_ends,
                prefix_trans=(1.0 - opacity[:, 0]).contiguous(),
            )
            color, opacity, depth = color + c, opacity + o, depth + dep
        alive = alive & ~res.terminated & (opacity[:, 0] <= 1.0 - early_stop_eps)
        near = res.termination_planes
        counts += res.counts
        n_samples += samples.num_valid
        n_rounds += 1
    if expected_depths:
        depth = depth / opacity.clamp_min(torch.finfo(depth.dtype).eps)
    if render_bkgd is not None:
        color = color + render_bkgd * (1.0 - opacity)
    if not return_stats:
        return color, opacity, depth
    stats = {"n_samples": n_samples, "n_rounds": n_rounds, "counts": counts}
    return color, opacity, depth, stats


def compact_samples_from_windows(
    ws: WindowSamples,
    budget: int,
    n_rays: int,
    extras: Optional[torch.Tensor] = None,
    step_size: Optional[float] = None,
    cone_angle: float = 0.0,
    compaction: str = "onehot",
) -> CompactSamples:
    """The samples of a window pool, flattened in (ray, orbit) order and
    cut at ``budget``, with :func:`compact_samples`'s contract; each sample
    carries its window's ray (``rays_o`` / ``rays_d``) and the window's row
    of ``extras`` ((window_budget,) or (window_budget, C); None: none).

    ``n_rays`` is JAX's argument (the pool's counts give it).  The JAX
    package recomputes the bounds from the orbit with ``step_size`` and
    sorts by ``compaction``; the pool already holds the exact bounds, so
    both are taken and ignored.  Waits on the device once, for the count."""
    f = ws.valid.shape[1]
    idx = ws.valid.reshape(-1).nonzero()[:, 0]  # (window, lane) order
    w = idx // f
    flat = compact_samples(MarchResult(
        ws.ray_ids[w], ws.t_starts.reshape(-1)[idx], ws.t_ends.reshape(-1)[idx], ws.counts,
        ws.termination_planes, ws.terminated), budget)
    w = w[: flat.num_valid]
    if extras is not None:
        extras = (extras[:, None] if extras.dim() == 1 else extras)[w]
    return flat._replace(rays_o=ws.rays_o[w], rays_d=ws.rays_d[w], extras=extras)


def _composite_round(field_fn, ray_ids, t_starts, t_ends, o, d, n_rays, opacity):
    """One round's (colour, opacity, depth) sums: the field on the round's
    samples (ray ids nondecreasing, each sample's ray ``o`` / ``d``) and
    kernel G3 behind the transmittance ``1 - opacity`` the earlier rounds
    left, clamped to [0, 1] as in the JAX package."""
    n = ray_ids.shape[0]
    if n == 0:
        return opacity.new_zeros((n_rays, 3)), opacity.new_zeros((n_rays, 1)), \
            opacity.new_zeros((n_rays, 1))
    counts = torch.bincount(ray_ids.long(), minlength=n_rays)
    ends = torch.cumsum(counts, 0)
    t_mid = 0.5 * (t_starts + t_ends)
    rgbs, sigmas = field_fn(o + t_mid[:, None] * d, d)
    c, op, dep, _ = composite_sorted(
        t_starts, t_ends, sigmas, rgbs, ray_ids.to(torch.int32), n_rays,
        (ends - counts).to(torch.int32), (ends - 1).to(torch.int32),
        prefix_trans=(1.0 - opacity[:, 0]).clamp(0.0, 1.0).contiguous(),
    )
    return c, op, dep


def make_pooled_eval_round(
    field_fn: Callable,
    occ_state,
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    render_step_size: float = 5e-3,
    cone_angle: float = 0.0,
    early_stop_eps: float = 1e-4,
    budget: int = 1 << 18,
    window_budget: Optional[int] = None,
    window_size: int = 8,
    max_coarse: int = 160,
):
    """One round of the pooled inference renderer (the JAX package's
    ``make_pooled_eval_round``): the window pool of the alive rays from
    their resume planes (``grid.traverse_grids_pooled``, kernel G2 on the
    card, ``window_budget`` windows, default ``max(budget // 4, 1024)``),
    its first ``budget`` samples, the field on them and kernel G3 behind
    each ray's earlier opacity.  A ray whose samples all fitted resumes at
    its termination plane, one cut by the budget after its last kept
    sample, an untouched one where it was; a ray dies once it terminated
    whole or its opacity passed ``1 - early_stop_eps``.

    Returns ``round_fn(rays_o, rays_d, near, alive, color, opacity, depth)
    -> (near, alive, color, opacity, depth)``, the sums accumulated; the
    host waits on it for the round's sample count.
    """
    wb = window_budget if window_budget is not None else max(budget // 4, 1024)

    def round_fn(rays_o, rays_d, near, alive, color, opacity, depth):
        n_rays = rays_o.shape[0]
        ws = traverse_grids_pooled(
            rays_o, rays_d, occ_state.binaries, occ_state.aabbs, near_planes=near,
            far_planes=torch.full_like(near, far_plane), step_size=render_step_size,
            cone_angle=cone_angle, window_budget=wb, window_size=window_size,
            max_coarse=max_coarse, rays_mask=alive,
        )
        samples = compact_samples_from_windows(ws, budget, n_rays)
        c, op, dep = _composite_round(
            field_fn, samples.ray_indices, samples.t_starts, samples.t_ends, samples.rays_o,
            samples.rays_d, n_rays, opacity)
        color, opacity, depth = color + c, opacity + op, depth + dep
        counts = ws.counts.long()
        kept = (samples.num_valid - samples.seg_starts.long()).clamp(min=0).minimum(counts)
        fully = kept == counts
        if samples.num_valid:
            last = (samples.seg_starts.long() + kept - 1).clamp(0, samples.num_valid - 1)
            t_last = samples.t_ends[last]
        else:
            t_last = near
        resume = torch.where(fully, ws.termination_planes, torch.where(kept > 0, t_last, near))
        alive = alive & (opacity[:, 0] <= 1.0 - early_stop_eps) & ~(fully & ws.terminated)
        return torch.where(alive, resume, near), alive, color, opacity, depth

    return round_fn


def render_rays_occgrid_pooled(
    field_fn: Callable,
    occ_state,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    render_bkgd: Optional[torch.Tensor] = None,
    max_rounds: int = 16,
    expected_depths: bool = True,
    jit_round: bool = False,
    **round_kwargs,
):
    """The pooled inference renderer (the JAX package's
    ``render_rays_occgrid_pooled``): rounds of :func:`make_pooled_eval_round`
    (``round_kwargs`` are its arguments) until no ray is alive or
    ``max_rounds`` ran.  Each ray composites its exact samples, those of
    :func:`render_rays_with_occgrid`, in order, and stops between rounds
    once its opacity passed ``1 - early_stop_eps``: with
    ``early_stop_eps=0`` and every sample in one round the image is the
    exact renderer's.  ``jit_round`` (JAX's compile switch) is taken and
    ignored.  Returns colors (n_rays, 3), opacities (n_rays, 1), depths
    (n_rays, 1)."""
    n_rays = rays_o.shape[0]
    like = dict(dtype=rays_o.dtype, device=rays_o.device)
    round_fn = make_pooled_eval_round(field_fn, occ_state, **round_kwargs)
    near = torch.full((n_rays,), round_kwargs.get("near_plane", 0.0), **like)
    alive = torch.ones(n_rays, dtype=torch.bool, device=rays_o.device)
    color = torch.zeros((n_rays, 3), **like)
    opacity = torch.zeros((n_rays, 1), **like)
    depth = torch.zeros((n_rays, 1), **like)
    for _ in range(max_rounds):
        near, alive, color, opacity, depth = round_fn(
            rays_o, rays_d, near, alive, color, opacity, depth)
        if not bool(alive.any()):
            break
    if expected_depths:
        depth = depth / opacity.clamp_min(torch.finfo(depth.dtype).eps)
    if render_bkgd is not None:
        color = color + render_bkgd * (1.0 - opacity)
    return color, opacity, depth


def make_cursor_eval_chunk(
    field_fn: Callable,
    occ_state,
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    render_step_size: float = 5e-3,
    cone_angle: float = 0.0,
    early_stop_eps: float = 1e-4,
    sample_budget: int = 1 << 17,
    window_size: int = 8,
    max_coarse: int = 160,
    fine_probes: int = 0,
    window_budget: Optional[int] = None,
    max_windows: int = 1 << 17,
    max_rounds: int = 64,
    max_recoarse: int = 4,
):
    """The cursor-based inference renderer (the JAX package's
    ``make_cursor_eval_chunk``): per chunk, each ray's windows that hold a
    sample are listed once (``grid.traverse_grids_pooled``'s windows,
    kernel G2 on the card; at most ``max_windows``), and each round takes
    the alive rays' next windows, at most ``window_budget`` (default
    ``max(3 * sample_budget // (2 * window_size), 1024)``) and whole windows
    up to ``sample_budget`` samples, composites them behind each ray's
    earlier opacity (kernel G3) and moves each ray's cursor past its
    windows taken.  A ray stops once its opacity passed ``1 -
    early_stop_eps`` or its windows ran out; one whose segments outran the
    list or the sweep of ``max_coarse`` windows lists again from where it
    stopped, at most ``max_recoarse`` lists in all, ``max_rounds`` rounds a
    list.  ``fine_probes`` (JAX's approximate occupancy probes) is taken and
    ignored.

    Returns ``chunk_fn(rays_o, rays_d) -> (color, opacity, depth)``, the
    unnormalised sums with no background, as JAX's.
    """
    f = window_size
    wb = window_budget if window_budget is not None else max((3 * sample_budget) // (2 * f), 1024)
    binaries, aabbs = occ_state.binaries, occ_state.aabbs

    def chunk_fn(rays_o, rays_d):
        n_rays = rays_o.shape[0]
        like = dict(dtype=rays_o.dtype, device=rays_o.device)
        near = torch.full((n_rays,), near_plane, **like)
        far = torch.full((n_rays,), far_plane, **like)
        active = torch.ones(n_rays, dtype=torch.bool, device=rays_o.device)
        color = torch.zeros((n_rays, 3), **like)
        opacity = torch.zeros((n_rays, 1), **like)
        depth = torch.zeros((n_rays, 1), **like)
        for _ in range(max_recoarse):
            if not bool(active.any()):
                break
            wins = _occupied_windows(rays_o, rays_d, binaries, aabbs, near, far,
                                     render_step_size, cone_angle, f, max_coarse, active)
            total = wins.ray.shape[0]
            first = torch.cumsum(wins.counts_w, 0) - wins.counts_w
            counts_w = (max_windows - first).clamp(min=0).minimum(wins.counts_w)
            list_cut = counts_w < wins.counts_w
            n_list = min(total, max_windows)
            k_after = (wins.j0 + max_coarse) * f
            if total:
                k_after = torch.where(
                    list_cut, wins.wk[(first + counts_w).clamp(max=total - 1)], k_after)
            resume = _orbit_t(near, k_after[:, None], render_step_size, cone_angle,
                              fused=True)[:, 0]
            resume = torch.where(wins.has_seg, resume, near)
            recoarse = wins.has_seg & (list_cut | wins.sweep_exhausted) & active
            ray_l = wins.ray[:n_list]
            rank = torch.arange(n_list, device=rays_o.device) - first[ray_l]
            cursor = torch.zeros(n_rays, dtype=torch.long, device=rays_o.device)
            alive = active & (counts_w > 0)
            for _ in range(max_rounds):
                if not bool(alive.any()):
                    break
                rem = torch.where(alive, counts_w - cursor, 0).clamp(min=0)
                kept = (wb - (torch.cumsum(rem, 0) - rem)).clamp(min=0).minimum(rem)
                take = alive[ray_l] & (rank >= cursor[ray_l]) & (rank < (cursor + kept)[ray_l])
                sel = take.nonzero()[:, 0]
                # whole windows while the round's samples fit the budget
                fits = torch.cumsum(wins.valid[sel].sum(dim=-1), 0) <= sample_budget
                sel = sel[: int(fits.sum())]
                ray = wins.ray[sel]
                t0, t1 = _window_bounds(near[ray], wins.wk[sel], f, render_step_size,
                                        cone_angle)
                v = wins.valid[sel]
                ids = ray[:, None].expand_as(v)[v]
                c, op, dep = _composite_round(field_fn, ids, t0[v], t1[v], rays_o[ids],
                                              rays_d[ids], n_rays, opacity)
                color, opacity, depth = color + c, opacity + op, depth + dep
                cursor = cursor + torch.bincount(ray, minlength=n_rays)
                alive = alive & (opacity[:, 0] <= 1.0 - early_stop_eps) & (cursor < counts_w)
            unsat = opacity[:, 0] <= 1.0 - early_stop_eps
            active = active & unsat & recoarse & (cursor >= counts_w)
            near = torch.where(active, resume, near)
        return color, opacity, depth

    return chunk_fn
