"""PDF ops: per-ray searchsorted and inverse-transform importance sampling
(kernel G14).

PyTorch counterpart of nerfacc_tpu/pdf.py.  On the batched layout,
``(n_rays, n_edges)`` rows with an int sample count (the proposal
estimator's), importance sampling runs kernel G14.  A per-ray count array
(``_importance_sampling_varying`` in JAX, the reference's tensor overload),
on the batched or the flattened ``packed_info`` layout, gives padded
``(n_rays, max_n)`` outputs with ``is_valid`` / ``is_left`` / ``is_right``
masks, in PyTorch ops (as XLA ops in JAX); so does :func:`searchsorted` on
the flattened layouts, a fixed-trip binary search per query.  Stratified
jitter is one uniform draw per ray, from the caller's ``torch.Generator`` or
given as ``bias``.
"""
from __future__ import annotations

import math
import numbers
from typing import Optional, Sequence, Tuple, Union

import torch

from . import cuda
from .data_specs import RayIntervals, RaySamples
from .utils.fp import fma_f32


def _upper_bound(
    data: torch.Tensor, base: torch.Tensor, last: torch.Tensor, values: torch.Tensor
) -> torch.Tensor:
    """Per query, the first index ``p`` in ``[base, last)`` with
    ``data[p] > value`` (``last`` if none): a binary search of
    ``ceil(log2(len(data)))`` trips for every query in lockstep, as in the
    JAX package."""
    lo = base.expand(values.shape).long()
    hi = last.expand(values.shape).long()
    n = data.shape[0]
    for _ in range(max(1, math.ceil(math.log2(max(2, n))))):
        active = lo < hi
        mid = lo + (hi - lo) // 2
        greater = data[mid.clamp(0, n - 1)] > values
        lo = torch.where(active & ~greater, mid + 1, lo)
        hi = torch.where(active & greater, mid, hi)
    return lo


def _clip(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``hi`` wins where ``hi < lo`` (an empty ray)."""
    return torch.minimum(torch.maximum(x, lo), hi)


def _query_ray_ids(spec: Union[RayIntervals, RaySamples]) -> torch.Tensor:
    """Each flattened entry's ray: ``ray_indices``, or the chunk of
    ``packed_info`` whose start is the last at or before the entry."""
    if spec.ray_indices is not None:
        return spec.ray_indices.long()
    starts = spec.packed_info[:, 0].contiguous()
    idx = torch.arange(spec.vals.shape[0], dtype=starts.dtype, device=starts.device)
    return torch.searchsorted(starts, idx, right=True).long() - 1


def searchsorted(
    sorted_sequence: Union[RayIntervals, RaySamples],
    values: Union[RayIntervals, RaySamples],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray searchsorted with "right" bounds: ``(ids_left, ids_right)``
    with ``key[ids_left] <= query < key[ids_right]``, clamped into each
    ray's own span.

    Batched queries (with batched keys): per-row ids, from a count of each
    key row's first ``n_edges - 1`` entries that are ``<= query``.
    Flattened queries (``packed_info`` or ``ray_indices``): global offsets
    into the keys, flattened too or batched (then flattened row-major),
    from the binary search of :func:`_upper_bound` over each ray's keys.
    """
    k_vals, q_vals = sorted_sequence.vals, values.vals
    if q_vals.ndim > 1:
        if k_vals.ndim < 2:
            raise ValueError("searchsorted: batched queries need batched keys")
        last = k_vals.shape[-1] - 1
        cnt = (k_vals[:, None, :-1] <= q_vals[:, :, None]).sum(-1)
        return (cnt - 1).clamp(0, last), cnt.clamp(0, last)
    ray_ids = _query_ray_ids(values)
    if k_vals.ndim > 1:
        k_edges = k_vals.shape[-1]
        base = ray_ids * k_edges
        last = base + k_edges - 1
        k_vals = k_vals.reshape(-1)
    else:
        starts = sorted_sequence.packed_info[:, 0].long()
        base = starts[ray_ids]
        last = base + sorted_sequence.packed_info[:, 1].long()[ray_ids] - 1
    p = _upper_bound(k_vals, base, last, q_vals)
    return _clip(p - 1, base, last), _clip(p, base, last)


def importance_sampling_plain(
    vals: torch.Tensor, cdfs: torch.Tensor, bias: torch.Tensor, n: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch version of kernel G14, on any device, bitwise equal to it and
    to the jitted JAX function on the CPU (XLA's forms: the step a product
    with 1/n, the position a fused multiply-add).

    Args:
        vals: (n_rays, E) f32 interval edges.
        cdfs: (n_rays, E) f32 CDF values at the edges.
        bias: (n_rays,) f32 position of each ray's samples within their CDF
            strata (0.5, or one uniform draw when stratified).
        n: samples per ray.

    Returns:
        samples (n_rays, n) and edges (n_rays, n + 1).
    """
    E = vals.shape[-1]
    u = cdf_positions(cdfs, bias, n)
    cdfs_e, vals_e = cdfs[:, None, :-1], vals[:, None, :-1]
    le = cdfs_e <= u[:, :, None]
    cnt = le.sum(-1)
    u_lower = torch.where(le, cdfs_e, -math.inf).amax(-1)
    t_lower = torch.where(le, vals_e, -math.inf).amax(-1)
    u_lower = torch.where(cnt == 0, cdfs[:, :1], u_lower)
    t_lower = torch.where(cnt == 0, vals[:, :1], t_lower)
    u_upper = torch.where(le, math.inf, cdfs_e).amin(-1)
    t_upper = torch.where(le, math.inf, vals_e).amin(-1)
    u_upper = torch.where(cnt >= E - 1, cdfs[:, -1:], u_upper)
    t_upper = torch.where(cnt >= E - 1, vals[:, -1:], t_upper)
    return samples_and_edges(vals, u, u_lower, t_lower, u_upper, t_upper)


def cdf_positions(cdfs: torch.Tensor, bias: torch.Tensor, n: int) -> torch.Tensor:
    """Each ray's ``n`` CDF positions ``u`` (n_rays, n) in XLA's forms: the
    step a product with 1/n, the position a fused multiply-add."""
    u_floor = cdfs[:, :1]
    # XLA divides by the constant n as a product with its f32 reciprocal
    u_step = (cdfs[:, -1:] - u_floor) * (torch.ones((), dtype=cdfs.dtype) / n)
    sid = torch.arange(n, dtype=cdfs.dtype, device=cdfs.device)[None, :]
    return fma_f32(sid + bias[:, None], u_step, u_floor)


def _lerp(u, u_lower, t_lower, u_upper, t_upper):
    """Samples lerped at CDF positions ``u`` between the chosen CDF and
    edge bounds; the midpoint of the edges where the CDF is flat."""
    denom = u_upper - u_lower
    flat = denom < torch.tensor(1e-10, dtype=torch.float32)
    mid = 0.5 * (t_lower + t_upper)
    lerped = (u - u_lower) * (t_upper - t_lower) / torch.where(flat, 1.0, denom) + t_lower
    return torch.where(flat, mid, lerped)


def samples_and_edges(vals, u, u_lower, t_lower, u_upper, t_upper):
    """The samples (n_rays, n) lerped at positions ``u`` between the chosen
    CDF and edge bounds, and their edges (n_rays, n + 1)."""
    n = u.shape[1]
    samples = _lerp(u, u_lower, t_lower, u_upper, t_upper)
    t_min, t_max = vals[:, :1], vals[:, -1:]
    if n == 1:
        return samples, torch.cat([t_min, t_max], dim=-1)
    first = torch.maximum(samples[:, :1] - 0.5 * (samples[:, 1:2] - samples[:, :1]), t_min)
    inner = 0.5 * (samples[:, 1:] + samples[:, :-1])
    last = torch.minimum(samples[:, -1:] + 0.5 * (samples[:, -1:] - samples[:, -2:-1]), t_max)
    return samples, torch.cat([first, inner, last], dim=-1)


# The kernel stages each of a block's rows (edges and CDF values, 2 E
# floats) in shared memory, one row a block at the most: E within 48 KB.
_MAX_EDGES = 48 * 1024 // 8


def _importance_sampling(vals, cdfs, bias, n):
    """Kernel G14 for CUDA tensors, the plain version for CPU tensors."""
    if not cuda.on_card(vals, cdfs, bias):
        return importance_sampling_plain(vals, cdfs, bias, n)
    for name, t in (("vals", vals), ("cdfs", cdfs), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"importance_sampling: {name} must be f32, got {t.dtype}")
    n_rays, E = vals.shape
    if cdfs.shape != vals.shape or bias.shape != (n_rays,) or E < 2 or n < 1:
        raise ValueError(
            f"importance_sampling: vals {tuple(vals.shape)}, cdfs {tuple(cdfs.shape)}, "
            f"bias {tuple(bias.shape)}, n {n}: want (n_rays, E >= 2) twice, (n_rays,), n >= 1"
        )
    if E > _MAX_EDGES:
        raise ValueError(f"importance_sampling: {E} edges exceed the kernel's {_MAX_EDGES}")
    vals, cdfs, bias = vals.contiguous(), cdfs.contiguous(), bias.contiguous()
    samples = torch.empty((n_rays, n), dtype=torch.float32, device=vals.device)
    edges = torch.empty((n_rays, n + 1), dtype=torch.float32, device=vals.device)
    err = cuda.load().importance_sampling(
        cuda.ptr(vals), cuda.ptr(cdfs), cuda.ptr(bias), cuda.ptr(samples),
        cuda.ptr(edges), n_rays, E, n, cuda.stream_ptr(vals),
    )
    cuda.check(err, "importance_sampling")
    cuda.LAUNCHES["importance_sampling"] += 1
    return samples, edges


def importance_sampling(
    intervals: RayIntervals,
    cdfs: torch.Tensor,
    n_intervals_per_ray: Union[int, torch.Tensor, Sequence[int]],
    stratified: bool = False,
    generator: Optional[torch.Generator] = None,
    bias: Optional[torch.Tensor] = None,
    max_intervals_per_ray: Optional[int] = None,
) -> Tuple[RayIntervals, RaySamples]:
    """Inverse-transform sampling of per-ray CDFs.  No gradient: callers
    pass detached edges and CDFs.

    With an int ``n_intervals_per_ray`` on the batched layout: kernel G14
    for CUDA tensors, :func:`importance_sampling_plain` for CPU tensors.
    With one count a ray (a tensor or sequence), on the batched or the
    flattened ``packed_info`` layout: :func:`_importance_sampling_varying`,
    padded to ``max_intervals_per_ray`` (default: the largest count).

    Args:
        intervals: edges ``vals`` (n_rays, E), or flattened with
            ``packed_info``.
        cdfs: the CDF at the edges, the shape of ``vals``.
        n_intervals_per_ray: samples per ray, one int or one a ray.
        stratified: jitter each ray's CDF positions by one uniform draw,
            ``bias`` (n_rays,) when given, else from ``generator``.
        max_intervals_per_ray: the padded width of a per-ray count.

    Returns:
        intervals (n_rays, n + 1) and samples (n_rays, n); with per-ray
        counts n is the padded width and the masks mark each ray's own.
    """
    vals = intervals.vals
    varying = not isinstance(n_intervals_per_ray, numbers.Integral)
    if varying:
        n_per_ray = torch.as_tensor(n_intervals_per_ray, device=cdfs.device).long()
        n_rays = n_per_ray.shape[0]
    elif vals.ndim != 2:
        raise ValueError("importance_sampling: pass one count a ray for flattened inputs")
    else:
        n_rays = vals.shape[0]
    if not stratified:
        bias = torch.full((n_rays,), 0.5, dtype=cdfs.dtype, device=cdfs.device)
    elif bias is None:
        bias = torch.rand(n_rays, generator=generator, device=cdfs.device)
    bias = bias.reshape(n_rays)
    if varying:
        return _importance_sampling_varying(intervals, cdfs, n_per_ray, bias,
                                            max_intervals_per_ray)
    samples, edges = _importance_sampling(vals, cdfs, bias, int(n_intervals_per_ray))
    return RayIntervals(vals=edges), RaySamples(vals=samples)


def _importance_sampling_varying(
    intervals: RayIntervals,
    cdfs: torch.Tensor,
    n_per_ray: torch.Tensor,
    bias: torch.Tensor,
    max_n: Optional[int],
) -> Tuple[RayIntervals, RaySamples]:
    """Per-ray sample counts, in PyTorch ops as the JAX package's XLA ops:
    sample ``sid`` of ray ``r`` is valid iff ``sid < n_per_ray[r]``, and
    each ray's samples and edges are those of its own ``n = n_per_ray[r]``
    problem, padded to ``max_n``: the CDF positions spaced by
    ``(u_ceil - u_floor) / n`` (a quotient, then a fused multiply-add, as
    jitted XLA computes them), the upper bound by :func:`_upper_bound` over
    each ray's CDF, the lerp as in the int path, the edges at sample
    midpoints clamped to the ray's span with the closing edge at ``n``."""
    n_rays = n_per_ray.shape[0]
    if max_n is None:
        max_n = int(n_per_ray.max())
    vals = intervals.vals
    dev, dtype = cdfs.device, cdfs.dtype
    if vals.ndim == 2:
        n_edges = vals.shape[-1]
        base = torch.arange(n_rays, device=dev) * n_edges
        last = base + n_edges - 1
    else:
        base = intervals.packed_info[:, 0].long()
        last = base + intervals.packed_info[:, 1].long().clamp(min=1) - 1
    flat_vals, flat_cdfs = vals.reshape(-1), cdfs.reshape(-1)

    u_floor, u_ceil = flat_cdfs[base], flat_cdfs[last]
    u_step = (u_ceil - u_floor) / n_per_ray.clamp(min=1).to(dtype)
    sid = torch.arange(max_n, dtype=dtype, device=dev)[None, :]
    u = fma_f32(sid + bias[:, None], u_step[:, None], u_floor[:, None])  # (n_rays, max_n)

    flat_u = u.reshape(-1)
    base_b = base.repeat_interleave(max_n)
    last_b = last.repeat_interleave(max_n)
    p = _upper_bound(flat_cdfs, base_b, last_b, flat_u)
    p0, p1 = _clip(p - 1, base_b, last_b), _clip(p, base_b, last_b)
    t = _lerp(flat_u, flat_cdfs[p0], flat_vals[p0], flat_cdfs[p1], flat_vals[p1])
    t = t.reshape(n_rays, max_n)
    sample_valid = torch.arange(max_n, device=dev)[None, :] < n_per_ray[:, None]

    t_min, t_max = flat_vals[base][:, None], flat_vals[last][:, None]
    epos = torch.arange(max_n + 1, device=dev)[None, :]
    if max_n > 1:
        inner = 0.5 * (t[:, 1:] + t[:, :-1])
        first = torch.maximum(t[:, :1] - 0.5 * (t[:, 1:2] - t[:, :1]), t_min)
        lastv = torch.minimum(t[:, -1:] + 0.5 * (t[:, -1:] - t[:, -2:-1]), t_max)
        edges = torch.cat([first, inner, lastv], dim=-1)
        # the closing edge of a ray with n < max_n sits past its sample
        # n - 1 by the full-count rule (the generic inner value there would
        # read its first padded sample); samples are nondecreasing, so the
        # two it needs are masked maxima
        sid_i = torch.arange(max_n, device=dev)[None, :]
        t_last = torch.where(sid_i < n_per_ray[:, None], t, -math.inf).amax(-1)
        t_prev = torch.where(sid_i < n_per_ray[:, None] - 1, t, -math.inf).amax(-1)
        closing = torch.minimum(t_last + 0.5 * (t_last - t_prev), t_max[:, 0])
        closing = torch.where(n_per_ray >= 2, closing, t_max[:, 0])
        edges = torch.where(epos == n_per_ray[:, None], closing[:, None], edges)
        # a one-sample ray's edges are [t_min, t_max], the int path's n = 1
        edges = torch.where((epos == 0) & (n_per_ray[:, None] <= 1), t_min, edges)
    else:
        edges = torch.cat([t_min, t_max], dim=-1)
    edge_valid = epos <= n_per_ray[:, None]
    return (
        RayIntervals(vals=edges, is_left=edge_valid & (epos < n_per_ray[:, None]),
                     is_right=edge_valid & (epos > 0)),
        RaySamples(vals=t, is_valid=sample_valid),
    )
