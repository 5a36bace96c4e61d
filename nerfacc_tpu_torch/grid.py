"""Ray-AABB intersection and occupancy-grid marching: kernel G2 and its twin.

PyTorch counterpart of nerfacc_tpu/grid.py.  With ``step_size > 0`` a ray's
marching variable follows the deterministic orbit
``t_{k+1} = t_k + clamp(t_k * cone_angle, step_size, 1e10)`` from its near
plane, and occupancy only decides which orbit candidates are emitted:
candidate ``k`` is a sample iff its midpoint lies inside a valid grid segment
and inside an occupied voxel of that segment's level.

:func:`march` emits exactly those samples, packed in (ray, orbit) order with
no budget: on the card through kernel G2 (count, scan, fill), on the CPU
through :func:`march_plain`, which evaluates the padded candidate lattice of
:func:`traverse_grids_padded` and packs its valid entries.  G2 starts each
ray's walk at :func:`march_start`'s candidate, past the orbit's empty prefix.
With ``max_samples`` only the first ``max_samples`` orbit candidates from
each ray's near plane may emit: one round of the eval renderer, which
resumes the rays that did not terminate from their termination planes.

The reference's padded API: :func:`traverse_grids` returns the lattice of
:func:`traverse_grids_padded` as ``RayIntervals`` / ``RaySamples`` (its
samples from kernel G2 on the card), and with ``step_size <= 0``
:func:`traverse_grids_voxel`'s one interval per voxel crossing, in PyTorch
ops (an XLA path in the JAX package too).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import cuda
from .data_specs import RayIntervals, RaySamples
from .utils.fp import fma_f32

# G2's bound on a walk (csrc/march.cu kMaxSteps): orbit indices stay exact in f32
_MAX_STEPS = 1 << 24


def ray_aabb_intersect(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabbs: torch.Tensor,
    near_plane: float = -math.inf,
    far_plane: float = math.inf,
    miss_value: float = math.inf,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Slab-method ray-AABB intersection.

    Args:
        rays_o, rays_d: (n_rays, 3) origins and normalized directions.
        aabbs: (m, 6) boxes {xmin, ymin, zmin, xmax, ymax, zmax}.
        near_plane / far_plane: the hit distances are clamped to this range
            (before the miss fill, as in the JAX package).
        miss_value: the distances of a missed pair.

    Returns:
        t_mins (n_rays, m), t_maxs (n_rays, m) (``miss_value`` where
        missed), and hits (n_rays, m) bool.
    """
    inv_dir = 1.0 / rays_d  # inf where a component is 0
    t1 = (aabbs[None, :, :3] - rays_o[:, None, :]) * inv_dir[:, None, :]
    t2 = (aabbs[None, :, 3:] - rays_o[:, None, :]) * inv_dir[:, None, :]
    t_mins = torch.minimum(t1, t2).amax(dim=-1)
    t_maxs = torch.maximum(t1, t2).amin(dim=-1)
    hits = (t_maxs > t_mins) & (t_maxs > 0)
    t_mins = t_mins.clamp(near_plane, far_plane)
    t_maxs = t_maxs.clamp(near_plane, far_plane)
    return (
        torch.where(hits, t_mins, miss_value), torch.where(hits, t_maxs, miss_value), hits
    )


def _enlarge_aabb(aabb: torch.Tensor, factor: float) -> torch.Tensor:
    """Scale an AABB about its center."""
    center = (aabb[:3] + aabb[3:]) / 2
    extent = (aabb[3:] - aabb[:3]) / 2
    return torch.cat([center - extent * factor, center + extent * factor])


def _orbit_t(
    near_planes: torch.Tensor,
    k: torch.Tensor,
    step_size: float,
    cone_angle: float,
    fused: bool = False,
) -> torch.Tensor:
    """Closed form of the marching orbit: linear steps of ``step_size`` while
    ``t < step_size / cone_angle``, geometric growth by ``1 + cone_angle``
    after.  Returns ``t_k`` for (n_rays,) near planes and (1, K) or (n_rays,
    1) indices.  ``fused``: the linear part as one fused multiply-add, the
    form in which XLA computes the windowed traversal's termination plane
    (it fuses the gather of one orbit value into its closed form)."""
    near = near_planes[:, None]
    k = k.to(near.dtype)
    step = torch.tensor(step_size, dtype=near.dtype, device=near.device)
    linear = fma_f32(k, step, near) if fused else near + k * step_size
    if cone_angle <= 0.0:
        return linear
    tau = step_size / cone_angle
    # a tensor divisor: with a Python number PyTorch's CUDA division
    # multiplies by its f32 reciprocal, which can round n_lin to another
    # integer than the true quotient of kernel G2 and of JAX does
    n_lin = torch.ceil((tau - near) / step).clamp_min(0.0)
    t_lin_end = near + n_lin * step_size
    geom = t_lin_end * torch.pow(1.0 + cone_angle, (k - n_lin).clamp_min(0.0))
    return torch.where(k <= n_lin, linear, geom)


def _grid_segments(
    t_sorted: torch.Tensor,
    t_indices: torch.Tensor,
    hits: torch.Tensor,
    near_planes: torch.Tensor,
    far_planes: torch.Tensor,
):
    """Resolve the sorted entry/exit events into disjoint grid segments.

    Between consecutive sorted events lies one segment; it belongs to the
    level of the entering event, or, after a leaving event, to the level of
    the next event if that one also leaves a hit grid.

    Returns:
        seg_lo, seg_hi (n_rays, 2m-1), seg_level int64, seg_valid bool.
    """
    m = t_sorted.shape[1] // 2
    ev_level = t_indices % m
    ev_entering = t_indices < m
    ev_hit = torch.take_along_dim(hits, ev_level, dim=-1)
    entering_this, entering_next = ev_entering[:, :-1], ev_entering[:, 1:]
    hit_this, hit_next = ev_hit[:, :-1], ev_hit[:, 1:]
    seg_valid = torch.where(
        entering_this, hit_this, hit_this & ~entering_next & hit_next
    )
    seg_level = torch.where(entering_this, ev_level[:, :-1], ev_level[:, 1:])
    seg_lo = torch.maximum(t_sorted[:, :-1], near_planes[:, None])
    seg_hi = torch.minimum(t_sorted[:, 1:], far_planes[:, None])
    return seg_lo, seg_hi, seg_level, seg_valid & (seg_lo < seg_hi)


def _segments(rays_o, rays_d, aabbs, near_planes, far_planes):
    """The slab test, the stable event sort and :func:`_grid_segments`."""
    t_mins, t_maxs, hits = ray_aabb_intersect(rays_o, rays_d, aabbs)
    t_sorted, t_indices = torch.sort(
        torch.cat([t_mins, t_maxs], dim=-1), dim=-1, stable=True
    )
    return _grid_segments(t_sorted, t_indices, hits, near_planes, far_planes)


def _occupancy_lookup(
    pos: torch.Tensor,
    level: torch.Tensor,
    binaries: torch.Tensor,
    aabbs: torch.Tensor,
) -> torch.Tensor:
    """Binary occupancy of ``pos`` in the voxel of its grid ``level``."""
    m = binaries.shape[0]
    rx, ry, rz = binaries.shape[1:]
    res = torch.tensor([rx, ry, rz], dtype=pos.dtype, device=pos.device)
    lo = aabbs[0, :3].expand_as(pos)
    hi = aabbs[0, 3:].expand_as(pos)
    for lvl in range(1, m):
        sel = (level == lvl)[..., None]
        lo = torch.where(sel, aabbs[lvl, :3], lo)
        hi = torch.where(sel, aabbs[lvl, 3:], hi)
    u = (pos - lo) / (hi - lo)
    f = torch.minimum(torch.floor(u * res).clamp_min(0.0), res - 1)
    idx = f.long()
    flat = ((level * rx + idx[..., 0]) * ry + idx[..., 1]) * rz + idx[..., 2]
    return binaries.reshape(-1)[flat]


class TraversalResult(NamedTuple):
    """Padded traversal: (n_rays, K) candidates on the marching orbit.

    Attributes:
        t_starts / t_ends: (n_rays, K) candidate interval bounds.
        valid: (n_rays, K) bool; candidate ``k`` is a sample.
        termination_planes: (n_rays,) ``t_edges[k_stop]``, ``k_stop`` the
            first candidate whose midpoint clears the farthest segment, or
            ``K`` when none does (the resume point of iterative rendering);
            the near plane for masked rays and rays with no segment.
        terminated: (n_rays,) bool, ``k_stop < K``; True for a ray with no
            segment.
    """

    t_starts: torch.Tensor
    t_ends: torch.Tensor
    valid: torch.Tensor
    termination_planes: torch.Tensor
    terminated: torch.Tensor

    @property
    def t_mids(self) -> torch.Tensor:
        return 0.5 * (self.t_starts + self.t_ends)

    @property
    def t_edges(self) -> torch.Tensor:
        """The shared edges (n_rays, K + 1) of contiguous intervals."""
        return torch.cat([self.t_starts, self.t_ends[:, -1:]], dim=-1)


class MarchResult(NamedTuple):
    """Exact-size packed samples of a march, in (ray, orbit) order.

    Attributes:
        ray_indices: (n_samples,) int32 ray id of each sample (nondecreasing).
        t_starts / t_ends: (n_samples,) f32 sample bounds.
        counts: (n_rays,) int32 samples per ray.
        termination_planes: (n_rays,) f32, as in :class:`TraversalResult`.
        terminated: (n_rays,) bool, as in :class:`TraversalResult` (all
            True for a march over the whole orbit).
    """

    ray_indices: torch.Tensor
    t_starts: torch.Tensor
    t_ends: torch.Tensor
    counts: torch.Tensor
    termination_planes: torch.Tensor
    terminated: torch.Tensor


def _lattice_size(
    near: torch.Tensor,
    seg_hi: torch.Tensor,
    seg_valid: torch.Tensor,
    step_size: float,
    cone_angle: float,
) -> int:
    """Orbit candidates that cover every ray up to its farthest segment, plus
    a margin, so that each ray also sees its first candidate past the end."""
    have = seg_valid.any(dim=-1)
    if not bool(have.any()):
        return 1
    near = near[have].double()
    t_hi = torch.where(seg_valid, seg_hi, -math.inf).amax(dim=-1)[have].double()
    k = torch.ceil((t_hi - near) / step_size)
    if cone_angle > 0.0:
        n_lin = torch.ceil((step_size / cone_angle - near) / step_size).clamp_min(0)
        t_lin_end = near + n_lin * step_size
        k_geom = n_lin + torch.ceil(
            torch.log(t_hi / t_lin_end) / math.log1p(cone_angle)
        )
        k = torch.where(t_hi <= t_lin_end, k, k_geom)
    return int(k.max()) + 2


def traverse_grids_padded(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    binaries: torch.Tensor,
    aabbs: torch.Tensor,
    near_planes: Optional[torch.Tensor] = None,
    far_planes: Optional[torch.Tensor] = None,
    step_size: float = 1e-3,
    cone_angle: float = 0.0,
    rays_mask: Optional[torch.Tensor] = None,
    max_samples: Optional[int] = None,
    valid_samples_limit: Optional[int] = None,
    through_march: bool = False,
) -> TraversalResult:
    """Evaluate every orbit candidate of every ray at once (padded layout).

    Same semantics as nerfacc_tpu's ``traverse_grids_padded``: with
    ``max_samples`` its lattice of that many candidates, else one long
    enough to cover every ray's orbit up to its farthest segment, so no ray
    is cut.

    Args:
        rays_o, rays_d: (n_rays, 3).
        binaries: (m, rx, ry, rz) bool occupancy.
        aabbs: (m, 6) level boxes.
        near_planes / far_planes: (n_rays,), defaults 0 / +inf.
        step_size: marching step (> 0).
        cone_angle: step growth; 0 is uniform stepping.
        rays_mask: optional (n_rays,) bool; rays where False emit nothing.
        max_samples: candidates per ray (>= 1), or None for the whole orbit.
        valid_samples_limit: at most this many samples a ray (the
            reference's ``traverse_steps_limit``); a ray cut by it ends
            right after its last sample, not terminated.
        through_march: on the card, the samples come from kernel G2 (the
            same set as the PyTorch occupancy test's), placed on the
            lattice.
    """
    if step_size <= 0.0:
        raise ValueError("step_size must be > 0")
    if max_samples is not None and max_samples < 1:
        raise ValueError(f"max_samples must be >= 1, got {max_samples}")
    n_rays = rays_o.shape[0]
    dev, dtype = rays_o.device, rays_o.dtype
    if near_planes is None:
        near_planes = torch.zeros(n_rays, dtype=dtype, device=dev)
    if far_planes is None:
        far_planes = torch.full((n_rays,), math.inf, dtype=dtype, device=dev)

    seg_lo, seg_hi, seg_level, seg_valid = _segments(
        rays_o, rays_d, aabbs, near_planes, far_planes
    )
    n_candidates = (
        _lattice_size(near_planes, seg_hi, seg_valid, step_size, cone_angle)
        if max_samples is None else int(max_samples)
    )
    k = torch.arange(n_candidates + 1, dtype=dtype, device=dev)[None, :]
    t_edges = _orbit_t(near_planes, k, step_size, cone_angle)
    t_mids = 0.5 * (t_edges[:, :-1] + t_edges[:, 1:])  # (n, K)

    inside_any = torch.zeros(t_mids.shape, dtype=torch.bool, device=dev)
    level = torch.zeros(t_mids.shape, dtype=torch.long, device=dev)
    for j in range(seg_lo.shape[-1]):
        inside_j = (
            seg_valid[:, j : j + 1]
            & (t_mids >= seg_lo[:, j : j + 1])
            & (t_mids < seg_hi[:, j : j + 1])
        )
        inside_any = inside_any | inside_j
        level = torch.where(inside_j, seg_level[:, j : j + 1], level)

    if through_march and cuda.on_card(rays_o):
        valid = _on_lattice(
            march(rays_o, rays_d, binaries, aabbs, near_planes, far_planes, step_size,
                  cone_angle, rays_mask, n_candidates),
            t_edges[:, :-1],
        )
    else:
        # the midpoint's position as one fused multiply-add (kernel G2 and
        # XLA fuse it): the f32 product is exact in f64, so this differs
        # from an FMA only where the f64 sum lands exactly on an f32
        # rounding tie
        pos = (
            rays_o[:, None, :].double()
            + t_mids[..., None].double() * rays_d[:, None, :].double()
        ).float()
        valid = inside_any & _occupancy_lookup(pos, level, binaries, aabbs)
        if rays_mask is not None:
            valid = valid & rays_mask[:, None]
    if valid_samples_limit is not None:
        n_upto = torch.cumsum(valid.to(torch.int32), dim=-1)
        valid = valid & (n_upto - valid.to(torch.int32) < valid_samples_limit)

    # termination plane: the first orbit edge whose midpoint clears the
    # farthest valid segment, or the lattice's end (the whole-orbit lattice
    # reaches past it for every ray)
    t_hi_last = torch.where(seg_valid, seg_hi, -math.inf).amax(dim=-1)
    beyond = t_mids >= t_hi_last[:, None]
    k_stop = torch.where(
        beyond.any(dim=-1), beyond.to(torch.uint8).argmax(dim=-1), n_candidates
    )
    if valid_samples_limit is not None:
        # the candidate right after the limit-th sample
        reached = n_upto >= valid_samples_limit
        k_limit = reached.to(torch.uint8).argmax(dim=-1) + 1
        k_stop = torch.where(reached.any(dim=-1), torch.minimum(k_stop, k_limit), k_stop)
    terminated = k_stop < n_candidates
    if max_samples is None:
        termination_planes = torch.take_along_dim(t_edges, k_stop[:, None], dim=-1)[:, 0]
    else:
        termination_planes = _orbit_t(
            near_planes, k_stop[:, None], step_size, cone_angle, fused=True
        )[:, 0]
    has_segment = seg_valid.any(dim=-1)
    terminated = terminated | ~has_segment
    stopped = has_segment if rays_mask is None else has_segment & rays_mask
    termination_planes = torch.where(stopped, termination_planes, near_planes)
    return TraversalResult(
        t_edges[:, :-1], t_edges[:, 1:], valid, termination_planes, terminated
    )


def _on_lattice(res: "MarchResult", lattice: torch.Tensor) -> torch.Tensor:
    """(n_rays, K) bool: the packed samples of a march over the ``K``
    candidates of ``lattice`` (their (n_rays, K) starts), each placed at the
    lattice value nearest its start (G2's cone orbit rounds its power apart
    from PyTorch's by an ulp, far below a step)."""
    n_rays, K = lattice.shape
    counts = res.counts.long()
    valid = torch.zeros((n_rays, K), dtype=torch.bool, device=lattice.device)
    if res.t_starts.numel() == 0:
        return valid
    starts = torch.cumsum(counts, 0) - counts
    j = torch.arange(int(counts.max()), device=lattice.device)
    ok = j[None, :] < counts[:, None]
    idx = (starts[:, None] + j[None, :]).clamp(max=res.t_starts.numel() - 1)
    t = torch.where(ok, res.t_starts[idx], math.inf)
    k = torch.searchsorted(lattice.contiguous(), t.contiguous()).clamp(max=K - 1)
    prev = (k - 1).clamp_min(0)
    nearer_prev = (t - lattice.gather(1, prev)).abs() < (lattice.gather(1, k) - t).abs()
    k = torch.where(nearer_prev, prev, k)
    rows = torch.arange(n_rays, device=lattice.device)[:, None].expand_as(k)
    valid[rows[ok], k[ok]] = True
    return valid


def march_start(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabbs: torch.Tensor,
    near_planes: torch.Tensor,
    far_planes: torch.Tensor,
    step_size: float,
    cone_angle: float = 0.0,
) -> torch.Tensor:
    """Kernel G2's first candidate per ray (``csrc/march.cu::first_candidate``),
    the same rounded operations written out once more: (n_rays,) int64.

    Every candidate before it has its midpoint below ``lo_first``, the start
    of the ray's first valid segment, so it lies in no valid segment and does
    not end the walk.  In the orbit's linear part (``k + 1 <= n_lin``, or any
    ``k`` without a cone) ``t_k = near + fl(k * step)`` is nondecreasing in
    ``k`` and so is the midpoint, so checking candidate ``k - 1`` checks all
    before it.  The estimate ``floor((lo_first - near) / step) - 1`` is capped
    at ``n_lin``, checked by evaluating candidate ``k - 1``, and stepped back
    while the check fails.  0 where ``lo_first`` is within two steps of the
    near plane or NaN, and for rays with no valid segment (G2 does not walk
    those).
    """
    seg_lo, _, _, seg_valid = _segments(rays_o, rays_d, aabbs, near_planes, far_planes)
    lo_first = torch.where(seg_valid, seg_lo, math.inf).amin(dim=-1)
    near = near_planes
    e = (lo_first - near) / step_size
    cap = torch.full_like(near, float(_MAX_STEPS))
    if cone_angle > 0.0:
        n_lin = torch.ceil((step_size / cone_angle - near) / step_size).clamp_min(0.0)
        cap = torch.minimum(n_lin, cap)
    walked = (e >= 2.0) & seg_valid.any(dim=-1)
    k = torch.where(walked, torch.minimum(torch.floor(e) - 1.0, cap), 0.0).long()

    def midpoint(kf):
        return 0.5 * ((near + kf * step_size) + (near + (kf + 1.0) * step_size))

    while True:
        back = (k > 0) & (midpoint(k.to(near.dtype) - 1.0) >= lo_first)
        if not bool(back.any()):
            return k
        k = k - back.long()


def march_plain(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    binaries: torch.Tensor,
    aabbs: torch.Tensor,
    near_planes: Optional[torch.Tensor] = None,
    far_planes: Optional[torch.Tensor] = None,
    step_size: float = 1e-3,
    cone_angle: float = 0.0,
    rays_mask: Optional[torch.Tensor] = None,
    max_samples: Optional[int] = None,
) -> MarchResult:
    """PyTorch twin of kernel G2, on any device: the padded traversal (of
    the whole orbit, or of ``max_samples`` candidates), packed in (ray,
    orbit) order."""
    res = traverse_grids_padded(
        rays_o, rays_d, binaries, aabbs, near_planes, far_planes,
        step_size=step_size, cone_angle=cone_angle, rays_mask=rays_mask,
        max_samples=max_samples,
    )
    counts = res.valid.sum(dim=1, dtype=torch.int32)
    ray, k = res.valid.nonzero(as_tuple=True)  # row-major: (ray, orbit) order
    return MarchResult(
        ray.to(torch.int32), res.t_starts[ray, k], res.t_ends[ray, k], counts,
        res.termination_planes, res.terminated,
    )


def march(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    binaries: torch.Tensor,
    aabbs: torch.Tensor,
    near_planes: Optional[torch.Tensor] = None,
    far_planes: Optional[torch.Tensor] = None,
    step_size: float = 1e-3,
    cone_angle: float = 0.0,
    rays_mask: Optional[torch.Tensor] = None,
    max_samples: Optional[int] = None,
) -> MarchResult:
    """Occupancy-grid march with exact packing: kernel G2 on the card, the
    twin :func:`march_plain` on the CPU.  Arguments as for
    :func:`traverse_grids_padded`; at most 8 grid levels."""
    n_rays = rays_o.shape[0]
    dev = rays_o.device
    if near_planes is None:
        near_planes = torch.zeros(n_rays, dtype=torch.float32, device=dev)
    if far_planes is None:
        far_planes = torch.full((n_rays,), math.inf, dtype=torch.float32, device=dev)
    tensors = [rays_o, rays_d, binaries, aabbs, near_planes, far_planes]
    if rays_mask is not None:
        tensors.append(rays_mask)
    if not cuda.on_card(*tensors):
        return march_plain(
            rays_o, rays_d, binaries, aabbs, near_planes, far_planes,
            step_size, cone_angle, rays_mask, max_samples,
        )
    if step_size <= 0.0:
        raise ValueError("step_size must be > 0")
    if max_samples is not None and not 1 <= max_samples <= _MAX_STEPS:
        raise ValueError(f"max_samples must be in [1, 2^24], got {max_samples}")
    for name, t in (("rays_o", rays_o), ("rays_d", rays_d), ("aabbs", aabbs),
                    ("near_planes", near_planes), ("far_planes", far_planes)):
        if t.dtype != torch.float32:
            raise TypeError(f"march: {name} must be f32, got {t.dtype}")
    m = binaries.shape[0]
    if binaries.ndim != 4 or not 1 <= m <= 8 or aabbs.shape != (m, 6):
        raise ValueError(
            f"march: binaries {tuple(binaries.shape)} / aabbs "
            f"{tuple(aabbs.shape)}: want (m, rx, ry, rz) and (m, 6), m <= 8"
        )
    if binaries.dtype != torch.bool:
        raise TypeError(f"march: binaries must be bool, got {binaries.dtype}")
    grid = binaries.view(torch.uint8)  # the kernel reads bytes
    mask = None if rays_mask is None else rays_mask.to(torch.uint8)
    rx, ry, rz = binaries.shape[1:]
    orbit = (
        step_size, cone_angle,
        step_size / cone_angle if cone_angle > 0.0 else 0.0, 1.0 + cone_angle,
    )
    common = (
        cuda.ptr(rays_o), cuda.ptr(rays_d), cuda.ptr(near_planes),
        cuda.ptr(far_planes), cuda.ptr(mask), cuda.ptr(grid), cuda.ptr(aabbs),
        n_rays, m, rx, ry, rz, *orbit, -1 if max_samples is None else int(max_samples),
    )
    lib = cuda.load()
    stream = cuda.stream_ptr(rays_o)
    counts = torch.empty(n_rays, dtype=torch.int32, device=dev)
    term = torch.empty(n_rays, dtype=torch.float32, device=dev)
    terminated = torch.empty(n_rays, dtype=torch.bool, device=dev)
    cuda.check(
        lib.march_count(
            *common, cuda.ptr(counts), cuda.ptr(term), cuda.ptr(terminated), stream
        ),
        "march_count",
    )
    ends = torch.cumsum(counts, 0, dtype=torch.int64)
    total = int(ends[-1]) if n_rays else 0  # host sync: sizes the buffer
    offsets = ends - counts
    ray_ids = torch.empty(total, dtype=torch.int32, device=dev)
    t_starts = torch.empty(total, dtype=torch.float32, device=dev)
    t_ends = torch.empty(total, dtype=torch.float32, device=dev)
    cuda.check(
        lib.march_fill(
            *common, cuda.ptr(offsets), cuda.ptr(ray_ids), cuda.ptr(t_starts),
            cuda.ptr(t_ends), stream,
        ),
        "march_fill",
    )
    cuda.LAUNCHES["march"] += 1
    return MarchResult(ray_ids, t_starts, t_ends, counts, term, terminated)


def traverse_grids_voxel(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    binaries: torch.Tensor,
    aabbs: torch.Tensor,
    near_planes: Optional[torch.Tensor] = None,
    far_planes: Optional[torch.Tensor] = None,
    max_edges: int = 1024,
    rays_mask: Optional[torch.Tensor] = None,
) -> TraversalResult:
    """One interval per voxel crossing: the reference's ``step_size <= 0``
    mode, as nerfacc_tpu's ``traverse_grids_voxel`` computes it.

    A ray's voxel-boundary crossings are, per grid level and axis, an
    arithmetic progression (spacing ``voxel / |d|``) from the first plane
    past the ray's entry; with the grid segments' ends they are sorted per
    ray, and the interval between consecutive edges is emitted iff its
    midpoint lies in an occupied voxel of its segment's level.

    Returns a :class:`TraversalResult` of ``(n_rays, max_edges - 1)``
    intervals (``t_starts[k]`` = edge ``k``, ``t_ends[k]`` = edge ``k + 1``).
    Truncation is reported, not silent: where a ray needs more crossings
    than ``max_edges`` keeps, or than a progression's ``k_per`` terms, the
    intervals past the trusted horizon are dropped, ``terminated`` is False
    and ``termination_planes`` is the horizon, from which a call with
    ``near_planes = termination_planes`` resumes.
    """
    n_rays = rays_o.shape[0]
    dev, dtype = rays_o.device, rays_o.dtype
    m = binaries.shape[0]
    if near_planes is None:
        near_planes = torch.zeros(n_rays, dtype=dtype, device=dev)
    if far_planes is None:
        far_planes = torch.full((n_rays,), math.inf, dtype=dtype, device=dev)
    seg_lo, seg_hi, seg_level, seg_valid = _segments(
        rays_o, rays_d, aabbs, near_planes, far_planes
    )
    n_segments = seg_lo.shape[-1]
    has_seg = seg_valid.any(dim=-1)
    t_enter = torch.where(
        has_seg, torch.where(seg_valid, seg_lo, math.inf).amin(dim=-1), 0.0
    )
    t_exit = torch.where(
        has_seg, torch.where(seg_valid, seg_hi, -math.inf).amax(dim=-1), 0.0
    )

    # per (level, axis): the plane crossings from the first plane past t_enter
    res = torch.tensor(binaries.shape[1:], dtype=dtype, device=dev)
    k_per = max((max_edges - 2 * n_segments) // (3 * m), 1)
    ks = torch.arange(k_per, dtype=dtype, device=dev)[None, :]
    seqs, seq_cov = [], []  # progressions, and each one's trusted horizon
    for lvl in range(m):
        lo, hi = aabbs[lvl, :3], aabbs[lvl, 3:]
        vox = (hi - lo) / res
        for a in range(3):
            d_a, o_a = rays_d[:, a], rays_o[:, a]
            inv = 1.0 / torch.where(d_a.abs() < 1e-12, 1e-12, d_a)
            delta = (vox[a] * inv).abs()
            i_enter = (fma_f32(t_enter, d_a, o_a) - lo[a]) / vox[a]
            next_plane = torch.where(d_a >= 0, torch.ceil(i_enter), torch.floor(i_enter))
            t_first = (fma_f32(next_plane, vox[a], lo[a]) - o_a) * inv
            t_first = torch.where(t_first <= t_enter, t_first + delta, t_first)
            seqs.append(fma_f32(ks, delta[:, None], t_first[:, None]))
            # the first crossing not generated still before t_exit: the
            # progression was cut, and nothing past its last term is trusted
            last = fma_f32(torch.full_like(delta, k_per - 1.0), delta, t_first)
            seq_cov.append(torch.where(last + delta <= t_exit, last, math.inf))
    seqs.append(torch.where(seg_valid, seg_lo, math.inf))
    seqs.append(torch.where(seg_valid, seg_hi, math.inf))
    edges = torch.cat(seqs, dim=-1)
    edges = torch.where(
        (edges >= t_enter[:, None]) & (edges <= t_exit[:, None]), edges, math.inf
    )
    n_in_range = torch.isfinite(edges).sum(dim=-1)
    edges = torch.sort(edges, dim=-1).values
    E = min(max_edges, edges.shape[-1])
    cut = n_in_range > E
    edges = edges[:, :E]
    t_cov = torch.minimum(
        torch.stack(seq_cov, dim=-1).amin(dim=-1),
        torch.where(cut, edges[:, E - 1], math.inf),
    )

    t0, t1 = edges[:, :-1], edges[:, 1:]
    t_mids = 0.5 * (t0 + t1)
    finite = torch.isfinite(t_mids) & (t1 - t0 > 1e-9)
    inside_any = torch.zeros(t_mids.shape, dtype=torch.bool, device=dev)
    level = torch.zeros(t_mids.shape, dtype=torch.long, device=dev)
    for j in range(n_segments):
        inside_j = (
            seg_valid[:, j : j + 1]
            & (t_mids >= seg_lo[:, j : j + 1])
            & (t_mids < seg_hi[:, j : j + 1])
        )
        inside_any = inside_any | inside_j
        level = torch.where(inside_j, seg_level[:, j : j + 1], level)
    safe_mids = torch.where(finite, t_mids, 0.0)
    pos = fma_f32(safe_mids[..., None], rays_d[:, None, :], rays_o[:, None, :])
    valid = finite & inside_any & _occupancy_lookup(pos, level, binaries, aabbs)
    # an interval reaching past the horizon may straddle missing crossings
    valid = valid & (t1 <= t_cov[:, None])
    if rays_mask is not None:
        valid = valid & rays_mask[:, None]

    truncated = t_cov < t_exit
    if rays_mask is not None:
        truncated = truncated & rays_mask  # a masked ray has nothing to resume
    termination_planes = torch.where(
        truncated, t_cov, torch.where(has_seg, t_exit, near_planes)
    )
    return TraversalResult(
        torch.where(torch.isfinite(t0), t0, 0.0), torch.where(torch.isfinite(t1), t1, 0.0),
        valid, termination_planes, ~truncated,
    )


def traverse_grids(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    binaries: torch.Tensor,
    aabbs: torch.Tensor,
    near_planes: Optional[torch.Tensor] = None,
    far_planes: Optional[torch.Tensor] = None,
    step_size: float = 1e-3,
    cone_angle: float = 0.0,
    traverse_steps_limit: Optional[int] = None,
    over_allocate: bool = False,
    rays_mask: Optional[torch.Tensor] = None,
    max_samples: int = 1024,
) -> Tuple[RayIntervals, RaySamples, torch.Tensor]:
    """The reference's ``traverse_grids`` in the padded layout, as
    nerfacc_tpu's: ``max_samples`` orbit candidates a ray
    (:func:`traverse_grids_padded`, its samples from kernel G2 on the card),
    or with ``step_size <= 0`` one interval a voxel crossing
    (:func:`traverse_grids_voxel`, ``max_samples + 1`` edges).

    Returns ``RayIntervals`` (``vals`` (n_rays, K + 1) edges; ``is_left`` /
    ``is_right`` mark the edges that open / close a sample's interval, the
    reference's shared-edge encoding), ``RaySamples`` (``vals`` the (n_rays,
    K) midpoints, ``ray_indices``, ``is_valid``) and the termination planes,
    from which a call resumes the rays cut by ``max_samples`` or by
    ``traverse_steps_limit`` (at most that many samples a ray, in both
    modes).  ``over_allocate`` is the reference's buffer sizing, which a
    fixed lattice has no use for; it is taken and ignored.
    """
    limit = traverse_steps_limit
    if step_size <= 0.0:
        res = traverse_grids_voxel(
            rays_o, rays_d, binaries, aabbs, near_planes, far_planes,
            max_edges=max_samples + 1, rays_mask=rays_mask,
        )
        if limit is not None:
            n_upto = torch.cumsum(res.valid.to(torch.int32), dim=-1)
            res = res._replace(valid=res.valid & (n_upto - res.valid.to(torch.int32) < limit))
    else:
        res = traverse_grids_padded(
            rays_o, rays_d, binaries, aabbs, near_planes, far_planes,
            step_size=step_size, cone_angle=cone_angle, rays_mask=rays_mask,
            max_samples=max_samples, valid_samples_limit=limit, through_march=True,
        )
    n_rays, K = res.valid.shape
    pad = torch.zeros((n_rays, 1), dtype=torch.bool, device=res.valid.device)
    intervals = RayIntervals(
        vals=res.t_edges, is_left=torch.cat([res.valid, pad], dim=-1),
        is_right=torch.cat([pad, res.valid], dim=-1),
    )
    ray_ids = torch.arange(n_rays, dtype=torch.int32, device=res.valid.device)
    samples = RaySamples(
        vals=res.t_mids, ray_indices=ray_ids[:, None].expand(n_rays, K),
        is_valid=res.valid,
    )
    return intervals, samples, res.termination_planes


def _orbit_index(
    near: torch.Tensor, t: torch.Tensor, step_size: float, cone_angle: float
) -> torch.Tensor:
    """The smallest orbit index whose midpoint is at least ``t``, in the JAX
    package's closed form (its ``_orbit_index``): (n_rays,) int64."""
    if cone_angle <= 0.0:
        return torch.ceil((t - near) / step_size - 0.5).clamp_min(0.0).long()
    n_lin = torch.ceil((step_size / cone_angle - near) / step_size).clamp_min(0.0)
    t_lin_end = near + n_lin * step_size
    k_lin = torch.ceil((t - near) / step_size - 0.5)
    ratio = (t / (1.0 + 0.5 * cone_angle) / t_lin_end.clamp_min(1e-10)).clamp_min(1e-10)
    k_geo = n_lin + torch.ceil(torch.log(ratio) / math.log(1.0 + cone_angle))
    k = torch.where(t <= t_lin_end * (1.0 + 0.5 * cone_angle), k_lin, k_geo)
    return k.clamp_min(0.0).long()


def pool_binaries(binaries: torch.Tensor, pool: int, dilation: int = 1) -> torch.Tensor:
    """Conservative coarse occupancy, as the JAX package builds the
    ``coarse_binaries`` of its windowed and pooled traversals: (m, rx, ry,
    rz) bool max-pooled by ``pool`` along each axis, then dilated by
    ``dilation`` cells (a coarse cell is set if any set cell lies within
    reach)."""
    m, rx, ry, rz = binaries.shape
    if rx % pool or ry % pool or rz % pool:
        raise ValueError(f"pool {pool} must divide the resolution {(rx, ry, rz)}")
    x = binaries.reshape(m, rx // pool, pool, ry // pool, pool, rz // pool, pool)
    x = x.any(dim=6).any(dim=4).any(dim=2)
    if dilation > 0:
        w = 2 * dilation + 1
        x = torch.nn.functional.max_pool3d(
            x[:, None].to(torch.float32), w, stride=1, padding=dilation
        )[:, 0] > 0.0
    return x


class WindowSamples(NamedTuple):
    """The flat window pool of :func:`traverse_grids_pooled`: the windows of
    ``window_size`` consecutive orbit candidates that hold a sample, of all
    rays in (ray, window) order, ``window_budget`` slots in all.

    Attributes:
        t_starts / t_ends: (window_budget, window_size) candidate bounds.
        valid: same shape; the candidate is a sample.
        ray_ids: (window_budget,) int32 ray of each window (``n_rays`` on
            the empty slots after the last window; nondecreasing).
        counts: (n_rays,) int32 samples of each ray within the pool.
        termination_planes / terminated: (n_rays,), the resume contract of
            :class:`TraversalResult`.
        window_overflow: windows dropped past ``window_budget`` (0-d).
        rays_o / rays_d: (window_budget, 3) the ray of each window.
        near / wk: (window_budget,) the window's ray near plane and the
            int32 orbit index of its first candidate.
    """

    t_starts: torch.Tensor
    t_ends: torch.Tensor
    valid: torch.Tensor
    ray_ids: torch.Tensor
    counts: torch.Tensor
    termination_planes: torch.Tensor
    terminated: torch.Tensor
    window_overflow: torch.Tensor
    rays_o: torch.Tensor
    rays_d: torch.Tensor
    near: Optional[torch.Tensor] = None
    wk: Optional[torch.Tensor] = None


class _Windows(NamedTuple):
    """The windows that hold a sample, of every ray's coarse sweep, in
    (ray, window) order: ``ray`` (W,), ``wk`` (W,) the window's first orbit
    index, ``valid`` (W, f); per ray ``counts_w`` (windows), ``j0`` (the
    sweep's first window), ``t_hi_last`` (the far end of the farthest
    segment), ``has_seg`` and ``sweep_exhausted`` (segments reach past the
    sweep's ``max_coarse`` windows)."""

    ray: torch.Tensor
    wk: torch.Tensor
    valid: torch.Tensor
    counts_w: torch.Tensor
    j0: torch.Tensor
    t_hi_last: torch.Tensor
    has_seg: torch.Tensor
    sweep_exhausted: torch.Tensor


def _occupied_windows(
    rays_o, rays_d, binaries, aabbs, near_planes, far_planes, step_size, cone_angle,
    window_size, max_coarse, rays_mask,
) -> _Windows:
    """Every ray's samples on its whole orbit (kernel G2 on the card), cut
    into windows of ``window_size`` candidates aligned at multiples of it.
    A ray's sweep covers ``max_coarse`` windows from the one holding its
    first segment's entry, as the JAX package's coarse phase does; the
    windows with no sample are left out, which that phase, testing a
    conservative pooled grid, may keep."""
    f = window_size
    seg_lo, seg_hi, _, seg_valid = _segments(rays_o, rays_d, aabbs, near_planes, far_planes)
    t_entry = torch.where(seg_valid, seg_lo, math.inf).amin(dim=-1)
    finite = torch.isfinite(t_entry)
    k_entry = _orbit_index(near_planes, torch.where(finite, t_entry, near_planes), step_size,
                           cone_angle)
    j0 = torch.where(finite, k_entry // f, 0)
    res = traverse_grids_padded(
        rays_o, rays_d, binaries, aabbs, near_planes, far_planes, step_size=step_size,
        cone_angle=cone_angle, rays_mask=rays_mask, through_march=True,
    )
    n_rays, K = res.valid.shape
    n_win = -(-K // f)
    valid = torch.nn.functional.pad(res.valid, (0, n_win * f - K)).view(n_rays, n_win, f)
    w = torch.arange(n_win, device=valid.device)
    occupied = valid.any(dim=-1) & (w[None, :] < (j0 + max_coarse)[:, None])
    ray, win = occupied.nonzero(as_tuple=True)  # row-major: (ray, window) order
    t_hi_last = torch.where(seg_valid, seg_hi, -math.inf).amax(dim=-1)
    sweep_end = _orbit_t(near_planes, ((j0 + max_coarse) * f)[:, None], step_size,
                         cone_angle)[:, 0]
    return _Windows(
        ray, win * f, valid[ray, win], occupied.sum(dim=-1), j0, t_hi_last,
        seg_valid.any(dim=-1), t_hi_last > sweep_end,
    )


def _window_bounds(near: torch.Tensor, wk: torch.Tensor, f: int, step_size: float,
                   cone_angle: float):
    """(W, f) starts and ends of the candidates of windows starting at
    orbit indices ``wk`` on rays with near planes ``near``: the orbit values
    of :func:`traverse_grids_padded` and kernel G2 (``near + fl(k *
    step)``; XLA fuses the two into one rounding, an ulp apart at most)."""
    k = wk[:, None] + torch.arange(f, device=wk.device)[None, :]
    return _orbit_t(near, k, step_size, cone_angle), _orbit_t(near, k + 1, step_size, cone_angle)


def _stop_planes(wins: _Windows, k_cut, cut, near_planes, rays_mask, step_size, cone_angle,
                 max_coarse, f):
    """The JAX traversals' termination: a ray cut at orbit index ``k_cut``
    (where ``cut``) resumes there; a ray whose segments outran the sweep
    resumes at its end; the others stop at the first candidate past their
    farthest segment, terminated.  The plane is the orbit value in one
    fused multiply-add, as XLA and kernel G2 compute it."""
    k_natural = _orbit_index(near_planes, wins.t_hi_last, step_size, cone_angle)
    k_stop = torch.where(
        cut, k_cut, torch.where(wins.sweep_exhausted, (wins.j0 + max_coarse) * f, k_natural)
    )
    planes = _orbit_t(near_planes, k_stop[:, None], step_size, cone_angle, fused=True)[:, 0]
    planes = torch.where(wins.has_seg, planes, near_planes)
    terminated = torch.where(wins.has_seg, ~(cut | wins.sweep_exhausted), True)
    if rays_mask is not None:
        planes = torch.where(rays_mask, planes, near_planes)
        terminated = torch.where(rays_mask, terminated, True)
    return planes, terminated


def _default_planes(rays_o, near_planes, far_planes):
    n_rays = rays_o.shape[0]
    like = dict(dtype=rays_o.dtype, device=rays_o.device)
    if near_planes is None:
        near_planes = torch.zeros(n_rays, **like)
    if far_planes is None:
        far_planes = torch.full((n_rays,), math.inf, **like)
    return near_planes, far_planes


def traverse_grids_windowed(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    binaries: torch.Tensor,
    aabbs: torch.Tensor,
    near_planes: Optional[torch.Tensor] = None,
    far_planes: Optional[torch.Tensor] = None,
    step_size: float = 1e-3,
    cone_angle: float = 0.0,
    n_windows: int = 40,
    window_size: int = 8,
    max_coarse: int = 192,
    pool: int = 4,
    dilation: int = 1,
    rays_mask: Optional[torch.Tensor] = None,
    coarse_binaries=None,
) -> TraversalResult:
    """Each ray's first ``n_windows`` windows of ``window_size`` orbit
    candidates that hold a sample: a :class:`TraversalResult` of
    ``(n_rays, n_windows * window_size)`` candidates, as the JAX package's
    ``traverse_grids_windowed`` returns.

    The samples come from the march of the whole orbit (kernel G2 on the
    card), so they are :func:`traverse_grids_padded`'s; the sweep covers
    ``max_coarse`` windows from the one holding the ray's first segment
    entry, as in JAX.  A ray with more windows than ``n_windows`` is not
    terminated and resumes at its next window; a ray whose segments outrun
    the sweep resumes at its end.  JAX picks its windows by a conservative
    test of a pooled grid, which may also keep windows with no sample; the
    port keeps only windows with a sample, so where JAX's ray runs out of
    windows the port's may not, and reaches farther.  Unused window slots
    hold the candidates of the ray's first window, none valid.
    ``pool``, ``dilation`` and ``coarse_binaries`` choose JAX's pooled grid:
    they are taken and ignored.
    """
    near_planes, far_planes = _default_planes(rays_o, near_planes, far_planes)
    f, W = window_size, n_windows
    wins = _occupied_windows(rays_o, rays_d, binaries, aabbs, near_planes, far_planes,
                             step_size, cone_angle, f, max_coarse, rays_mask)
    n_rays = rays_o.shape[0]
    first = torch.cumsum(wins.counts_w, 0) - wins.counts_w  # each ray's first window
    slot = torch.arange(W, device=rays_o.device)[None, :]
    used = slot < wins.counts_w[:, None]
    idx = (first[:, None] + slot).clamp(max=max(wins.ray.numel() - 1, 0))
    if wins.ray.numel():
        wk = torch.where(used, wins.wk[idx], (wins.j0 * f)[:, None])
        valid = used[..., None] & wins.valid[idx]
    else:
        wk = (wins.j0 * f)[:, None].expand(n_rays, W)
        valid = torch.zeros((n_rays, W, f), dtype=torch.bool, device=rays_o.device)
    k = (wk[..., None] + torch.arange(f, device=wk.device)).reshape(n_rays, W * f)
    t0 = _orbit_t(near_planes, k, step_size, cone_angle)
    t1 = _orbit_t(near_planes, k + 1, step_size, cone_angle)
    cut = wins.counts_w > W
    k_next = wins.wk[(first + W).clamp(max=max(wins.ray.numel() - 1, 0))] if wins.ray.numel() \
        else wins.j0
    planes, terminated = _stop_planes(wins, k_next, cut, near_planes, rays_mask, step_size,
                                      cone_angle, max_coarse, f)
    return TraversalResult(t0, t1, valid.reshape(n_rays, W * f), planes, terminated)


def traverse_grids_pooled(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    binaries: torch.Tensor,
    aabbs: torch.Tensor,
    near_planes: Optional[torch.Tensor] = None,
    far_planes: Optional[torch.Tensor] = None,
    step_size: float = 1e-3,
    cone_angle: float = 0.0,
    window_budget: int = 1 << 16,
    window_size: int = 8,
    max_coarse: int = 160,
    pool: int = 4,
    dilation: int = 1,
    rays_mask: Optional[torch.Tensor] = None,
    fine_probes: int = 0,
    coarse_binaries=None,
    compaction: str = "onehot",
) -> WindowSamples:
    """The windows of ``window_size`` orbit candidates that hold a sample,
    of all rays, in one flat pool of ``window_budget`` windows in (ray,
    window) order: the JAX package's ``traverse_grids_pooled``, whose pool
    feeds :func:`~nerfacc_tpu_torch.utils.rendering.compact_samples_from_windows`.

    The samples come from the march of the whole orbit (kernel G2 on the
    card): :func:`traverse_grids_padded`'s within each ray's sweep of
    ``max_coarse`` windows, as in JAX.  When the windows outnumber the
    budget, the pool keeps a prefix of them, so it cuts a suffix of rays:
    each cut ray is not terminated and resumes at its first dropped window,
    and ``window_overflow`` counts the dropped windows.  JAX's pool also
    holds the windows with no sample that its conservative pooled grid
    passes, so it fills sooner; below that the two pools hold the same
    samples.  Empty slots have ray id ``n_rays``, zero bounds and rays.
    ``pool``, ``dilation``, ``coarse_binaries`` (JAX's pooled grid),
    ``fine_probes`` (its approximate occupancy probes) and ``compaction``
    (its sort or cumsum inversion) choose TPU mechanisms: they are taken and
    ignored, and every sample is exact.
    """
    near_planes, far_planes = _default_planes(rays_o, near_planes, far_planes)
    f, Wb = window_size, window_budget
    n_rays = rays_o.shape[0]
    dev = rays_o.device
    wins = _occupied_windows(rays_o, rays_d, binaries, aabbs, near_planes, far_planes,
                             step_size, cone_angle, f, max_coarse, rays_mask)
    total = wins.ray.numel()
    keep = min(total, Wb)
    ray, wk, valid = wins.ray[:keep], wins.wk[:keep], wins.valid[:keep]
    near = near_planes[ray]
    t0, t1 = _window_bounds(near, wk, f, step_size, cone_angle)
    counts = torch.zeros(n_rays, dtype=torch.int32, device=dev).index_add_(
        0, ray, valid.sum(dim=-1, dtype=torch.int32))
    # windows kept per ray, and each cut ray's first dropped window
    ends = torch.cumsum(wins.counts_w, 0)
    kept_w = (Wb - (ends - wins.counts_w)).clamp(min=0)
    cut = kept_w < wins.counts_w
    first_dropped = (ends - wins.counts_w + kept_w).clamp(max=max(total - 1, 0))
    k_cut = wins.wk[first_dropped] if total else wins.j0
    planes, terminated = _stop_planes(wins, k_cut, cut, near_planes, rays_mask, step_size,
                                      cone_angle, max_coarse, f)

    def fill(x, value=0):
        pad = (0, 0) * (x.dim() - 1) + (0, Wb - keep)
        return torch.nn.functional.pad(x, pad, value=value)

    return WindowSamples(
        fill(t0), fill(t1), fill(valid, False), fill(ray.to(torch.int32), n_rays), counts,
        planes, terminated, torch.tensor(total - keep, device=dev),
        fill(rays_o[ray]), fill(rays_d[ray]), fill(near), fill(wk.to(torch.int32)),
    )
