"""PDF ops on the batched layout: per-ray searchsorted and inverse-transform
importance sampling (kernel G14).

PyTorch counterpart of nerfacc_tpu/pdf.py for ``(n_rays, n_edges)`` rows
and an int sample count, the layout the proposal estimator uses.  The
flattened ``packed_info`` layout and per-ray sample counts
(``_importance_sampling_varying``) are not ported yet.  Stratified jitter is
one uniform draw per ray, from the caller's ``torch.Generator`` or given as
``bias``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from . import cuda
from .data_specs import RayIntervals, RaySamples
from .utils.fp import fma_f32


def searchsorted(
    sorted_sequence: RayIntervals, values: RayIntervals
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row searchsorted with "right" bounds: ``(ids_left, ids_right)``
    with ``key[ids_left] <= query < key[ids_right]``, clamped into the row.

    The upper bound runs over each key row's first ``n_edges - 1`` entries
    as a count of entries ``<= query``, as in the JAX package.
    """
    k_vals, q_vals = sorted_sequence.vals, values.vals
    last = k_vals.shape[-1] - 1
    cnt = (k_vals[:, None, :-1] <= q_vals[:, :, None]).sum(-1)
    return (cnt - 1).clamp(0, last), cnt.clamp(0, last)


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


def samples_and_edges(vals, u, u_lower, t_lower, u_upper, t_upper):
    """The samples (n_rays, n) lerped at positions ``u`` between the chosen
    CDF and edge bounds, and their edges (n_rays, n + 1)."""
    n = u.shape[1]
    denom = u_upper - u_lower
    flat = denom < torch.tensor(1e-10, dtype=torch.float32)
    mid = 0.5 * (t_lower + t_upper)
    lerped = (u - u_lower) * (t_upper - t_lower) / torch.where(flat, 1.0, denom) + t_lower
    samples = torch.where(flat, mid, lerped)

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
    n_intervals_per_ray: int,
    stratified: bool = False,
    generator: Optional[torch.Generator] = None,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[RayIntervals, RaySamples]:
    """Inverse-transform sampling of per-ray CDFs: kernel G14 for CUDA
    tensors, :func:`importance_sampling_plain` for CPU tensors.  No
    gradient: callers pass detached edges and CDFs.

    Args:
        intervals: edges ``vals`` (n_rays, E).
        cdfs: (n_rays, E) CDF at the edges.
        n_intervals_per_ray: samples per ray.
        stratified: jitter each ray's CDF positions by one uniform draw,
            ``bias`` (n_rays,) when given, else from ``generator``.

    Returns:
        intervals (n_rays, n + 1) and samples (n_rays, n).
    """
    vals = intervals.vals
    n_rays = vals.shape[0]
    if not stratified:
        bias = torch.full((n_rays,), 0.5, dtype=cdfs.dtype, device=cdfs.device)
    elif bias is None:
        bias = torch.rand(n_rays, generator=generator, device=cdfs.device)
    samples, edges = _importance_sampling(vals, cdfs, bias.reshape(n_rays), n_intervals_per_ray)
    return RayIntervals(vals=edges), RaySamples(vals=samples)
