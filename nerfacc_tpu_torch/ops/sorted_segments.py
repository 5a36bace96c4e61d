"""Segmented reductions over sorted ray ids, and kernels G3 and G5
(compositing, forward and backward).

The render path's samples form a flat buffer whose ray ids are
nondecreasing, with per-ray first and last slots ``seg_starts`` /
``seg_ends`` (ends < starts for an empty ray).  Slots with id ``n_rays`` are
fill: they belong to no ray and are never written.

Every sum here runs within one segment, never as one global cumsum
differenced at the segment starts: that form carries an error relative to
the whole buffer's running total, which on hard surfaces put transmittance
above 1 in the JAX package before its block-decomposed fix.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import cuda
from ..volrend import render_weight_from_density
from .ordered_sums import index_add_rows


def segment_starts(ids: torch.Tensor, n_rays: int) -> torch.Tensor:
    """(n_rays,) int32 index of the first element of each segment of the
    nondecreasing ``ids``: for an empty segment, where its first element
    would be (fill ids ``n_rays`` sort after every segment)."""
    queries = torch.arange(n_rays, dtype=ids.dtype, device=ids.device)
    return torch.searchsorted(ids.contiguous(), queries).to(torch.int32)


def segment_ends(ids: torch.Tensor, n_rays: int) -> torch.Tensor:
    """(n_rays,) int32 index of the last element of each segment of the
    nondecreasing ``ids``: ends are nondecreasing, and an empty segment
    ends one before its start (-1 before the first element)."""
    queries = torch.arange(n_rays, dtype=ids.dtype, device=ids.device)
    return torch.searchsorted(ids.contiguous(), queries, right=True).to(torch.int32) - 1


def exclusive_sum_sorted(
    vals: torch.Tensor,
    ids: torch.Tensor,
    n_rays: int,
    seg_starts: Optional[torch.Tensor] = None,
    seg_ends: Optional[torch.Tensor] = None,
    nonnegative: bool = False,
    reverse: bool = False,
) -> torch.Tensor:
    """``out[i] = sum_{j < i, ids[j] == ids[i]} vals[j]`` (``j > i`` with
    ``reverse``); 0 on fill slots.

    Each segment is laid out as one row of an (n_rays, longest segment)
    table and scanned along the row, so the sums are segment-local.
    ``seg_starts`` / ``seg_ends`` (n_rays,) are each segment's first and
    last slot (None: found from ``ids``).  ``nonnegative`` is the JAX
    package's promise that ``vals >= 0``, which switches it to a
    segment-local evaluation; this one is segment-local for every input,
    so the flag changes nothing.
    """
    if seg_starts is None:
        seg_starts = segment_starts(ids, n_rays)
    if seg_ends is None:
        seg_ends = segment_ends(ids, n_rays)
    n = vals.shape[0]
    out = torch.zeros_like(vals)
    valid = ids < n_rays
    if n_rays == 0 or not bool(valid.any()):
        return out
    rid = ids[valid].long()
    slot = torch.arange(n, device=vals.device)[valid]
    if reverse:
        col = seg_ends.long()[rid] - slot
    else:
        col = slot - seg_starts.long()[rid]
    width = int((seg_ends - seg_starts).max()) + 1
    table = vals.new_zeros((n_rays, width + 1))
    table[rid, col + 1] = vals[valid]  # shifted one column: an exclusive scan
    out[valid] = table.cumsum(dim=1)[rid, col]
    return out


def segment_sum_sorted(
    src: torch.Tensor,
    ids: torch.Tensor,
    n_rays: int,
    seg_starts: Optional[torch.Tensor] = None,
    seg_ends: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment sums ``out[r] = sum_{ids[i] == r} src[i]``; ``src`` is
    (n,) or (n, C); fill slots are dropped.  ``seg_starts`` / ``seg_ends``
    are taken for the JAX package's signature, where they spare a search;
    the sum here reads the ids alone, and adds each segment's terms in their
    order (:func:`~nerfacc_tpu_torch.ops.ordered_sums.index_add_rows`)."""
    valid = ids < n_rays
    out = src.new_zeros((n_rays,) + tuple(src.shape[1:]))
    return index_add_rows(out, ids[valid].long(), src[valid])


def composite_sorted_plain(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    rgbs: torch.Tensor,
    ray_indices: torch.Tensor,
    n_rays: int,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    prefix_trans: Optional[torch.Tensor] = None,
    return_weights: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """PyTorch twin of kernel G3, on any device.

    Args:
        t_starts, t_ends, sigmas: (n,) f32 per-sample bounds and densities.
        rgbs: (n, 3) f32 per-sample colours.
        ray_indices: (n,) int32 nondecreasing ray ids (fill: ``n_rays``).
        seg_starts / seg_ends: (n_rays,) int32 first / last slot per ray.
        prefix_trans: optional (n_rays,) transmittance carried in per ray.
        return_weights: also return the (n,) per-sample weights (0 on fill).

    Returns:
        Unnormalised per-ray sums: colours (n_rays, 3), opacities
        (n_rays, 1), depths (n_rays, 1) = sum of w * t_mid; and the weights
        or None.
    """
    valid = ray_indices < n_rays
    pt = None
    if prefix_trans is not None:
        pt = prefix_trans[ray_indices.clamp(max=n_rays - 1).long()]
    weights, _, _ = render_weight_from_density(
        t_starts, t_ends, sigmas, ray_indices=ray_indices, n_rays=n_rays,
        prefix_trans=pt, masks=valid, indices_sorted=True, seg_starts=seg_starts,
        seg_ends=seg_ends,
    )
    t_mid = 0.5 * (t_starts + t_ends)
    packed = torch.cat([rgbs, torch.ones_like(t_mid[:, None]), t_mid[:, None]], -1)
    accum = segment_sum_sorted(weights[:, None] * packed, ray_indices, n_rays)
    return (
        accum[:, :3], accum[:, 3:4], accum[:, 4:5],
        weights if return_weights else None,
    )


def composite_sorted_backward_plain(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    rgbs: torch.Tensor,
    ray_indices: torch.Tensor,
    n_rays: int,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    g_colors: torch.Tensor,
    g_opacities: torch.Tensor,
    g_depths: torch.Tensor,
    prefix_trans: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PyTorch twin of kernel G5, on any device: the closed-form gradient of
    :func:`composite_sorted_plain`'s three sums for the densities and colours.

    With ``v_i = gc . rgb_i + go + gd * t_mid_i`` for the cotangents of the
    ray's colour (n_rays, 3), opacity (n_rays, 1) and depth (n_rays, 1) sums:
    ``drgb_i = w_i gc`` and ``dsigma_i = delta_i [sigma_i delta_i < 40]
    (T_i exp(-sd_i) v_i - sum_{j > i, same ray} w_j v_j)``, the suffix sum
    taken within the segment.  Fill slots get 0.

    Returns:
        (dsigmas (n,), drgbs (n, 3)).
    """
    valid = ray_indices < n_rays
    rid = ray_indices.clamp(max=max(n_rays - 1, 0)).long()
    delta = t_ends - t_starts
    sigmas_dt = torch.where(valid, sigmas * delta, 0.0)
    live = valid & (sigmas_dt < 40.0)
    sd = sigmas_dt.clamp(max=40.0)
    excl = exclusive_sum_sorted(sd, ray_indices, n_rays, seg_starts, seg_ends)
    trans = torch.exp(-excl)
    if prefix_trans is not None:
        trans = trans * prefix_trans[rid]
    w = trans * (1.0 - torch.exp(-sd))
    gc = g_colors[rid]
    t_mid = 0.5 * (t_starts + t_ends)
    v = (gc * rgbs).sum(-1) + g_opacities[rid, 0] + g_depths[rid, 0] * t_mid
    suffix = exclusive_sum_sorted(
        torch.where(valid, w * v, 0.0), ray_indices, n_rays, seg_starts,
        seg_ends, reverse=True,
    )
    d_sigmas = torch.where(live, delta * (trans * torch.exp(-sd) * v - suffix), 0.0)
    d_rgbs = torch.where(valid[:, None], w[:, None] * gc, 0.0)
    return d_sigmas, d_rgbs


def _check_composite_args(t_starts, t_ends, sigmas, rgbs, n_rays, seg_starts, seg_ends):
    n = t_starts.shape[0]
    for name, t in (("t_starts", t_starts), ("t_ends", t_ends),
                    ("sigmas", sigmas), ("rgbs", rgbs)):
        if t.dtype != torch.float32:
            raise TypeError(f"composite: {name} must be f32, got {t.dtype}")
    if seg_starts.dtype != torch.int32 or seg_ends.dtype != torch.int32:
        raise TypeError("composite: seg_starts / seg_ends must be int32")
    if rgbs.shape != (n, 3) or sigmas.shape != (n,) or t_ends.shape != (n,):
        raise ValueError("composite: want (n,) t and sigmas and (n, 3) rgbs")
    if seg_starts.shape != (n_rays,) or seg_ends.shape != (n_rays,):
        raise ValueError("composite: want (n_rays,) seg_starts / seg_ends")


def _composite_forward(t_starts, t_ends, sigmas, rgbs, ray_indices, n_rays,
                       seg_starts, seg_ends, prefix_trans, return_weights):
    """Kernel G3 for CUDA tensors, the twin for CPU tensors."""
    tensors = [t_starts, t_ends, sigmas, rgbs, ray_indices, seg_starts, seg_ends]
    if prefix_trans is not None:
        tensors.append(prefix_trans)
    if not cuda.on_card(*tensors):
        return composite_sorted_plain(
            t_starts, t_ends, sigmas, rgbs, ray_indices, n_rays, seg_starts,
            seg_ends, prefix_trans, return_weights,
        )
    _check_composite_args(t_starts, t_ends, sigmas, rgbs, n_rays, seg_starts, seg_ends)
    sigmas, rgbs = sigmas.contiguous(), rgbs.contiguous()
    n, dev = t_starts.shape[0], t_starts.device
    colors = torch.empty((n_rays, 3), dtype=torch.float32, device=dev)
    opacities = torch.empty((n_rays, 1), dtype=torch.float32, device=dev)
    depths = torch.empty((n_rays, 1), dtype=torch.float32, device=dev)
    weights = (
        torch.zeros(n, dtype=torch.float32, device=dev) if return_weights else None
    )
    err = cuda.load().composite_fwd(
        cuda.ptr(t_starts), cuda.ptr(t_ends), cuda.ptr(sigmas), cuda.ptr(rgbs),
        cuda.ptr(seg_starts), cuda.ptr(seg_ends), cuda.ptr(prefix_trans),
        n_rays, cuda.ptr(colors), cuda.ptr(opacities), cuda.ptr(depths),
        cuda.ptr(weights), cuda.stream_ptr(t_starts),
    )
    cuda.check(err, "composite_fwd")
    cuda.LAUNCHES["composite_fwd"] += 1
    return colors, opacities, depths, weights


def composite_sorted_backward(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    rgbs: torch.Tensor,
    ray_indices: torch.Tensor,
    n_rays: int,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    g_colors: torch.Tensor,
    g_opacities: torch.Tensor,
    g_depths: torch.Tensor,
    prefix_trans: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients for the densities and colours: kernel G5 for CUDA tensors,
    the twin :func:`composite_sorted_backward_plain` for CPU tensors.  Same
    contract as the twin."""
    tensors = [t_starts, t_ends, sigmas, rgbs, ray_indices, seg_starts, seg_ends,
               g_colors, g_opacities, g_depths]
    if prefix_trans is not None:
        tensors.append(prefix_trans)
    if not cuda.on_card(*tensors):
        return composite_sorted_backward_plain(
            t_starts, t_ends, sigmas, rgbs, ray_indices, n_rays, seg_starts,
            seg_ends, g_colors, g_opacities, g_depths, prefix_trans,
        )
    _check_composite_args(t_starts, t_ends, sigmas, rgbs, n_rays, seg_starts, seg_ends)
    for name, g, shape in (("g_colors", g_colors, (n_rays, 3)),
                           ("g_opacities", g_opacities, (n_rays, 1)),
                           ("g_depths", g_depths, (n_rays, 1))):
        if g.dtype != torch.float32 or g.shape != shape:
            raise ValueError(f"composite: {name} {g.dtype} {tuple(g.shape)}: want f32 {shape}")
    n, like = t_starts.shape[0], dict(dtype=torch.float32, device=t_starts.device)
    d_sigmas = torch.zeros(n, **like)
    d_rgbs = torch.zeros((n, 3), **like)
    scratch = torch.empty(n, **like)
    # contiguous copies held in names until the launch: a copy made inside
    # the call's arguments is freed once its pointer is taken, and the next
    # copy may reuse its memory before the kernel reads it
    sigmas, rgbs = sigmas.contiguous(), rgbs.contiguous()
    g_colors, g_opacities, g_depths = (
        g.contiguous() for g in (g_colors, g_opacities, g_depths))
    err = cuda.load().composite_bwd(
        cuda.ptr(t_starts), cuda.ptr(t_ends), cuda.ptr(sigmas), cuda.ptr(rgbs),
        cuda.ptr(seg_starts), cuda.ptr(seg_ends), cuda.ptr(prefix_trans), n_rays,
        cuda.ptr(g_colors), cuda.ptr(g_opacities), cuda.ptr(g_depths),
        cuda.ptr(d_sigmas), cuda.ptr(d_rgbs), cuda.ptr(scratch),
        cuda.stream_ptr(t_starts),
    )
    cuda.check(err, "composite_bwd")
    cuda.LAUNCHES["composite_bwd"] += 1
    return d_sigmas, d_rgbs


class _Composite(torch.autograd.Function):
    """Differentiable in ``sigmas`` and ``rgbs`` only (the sample bounds
    carry no gradient, as in the JAX package); the weights carry none."""

    @staticmethod
    def forward(ctx, t_starts, t_ends, sigmas, rgbs, ray_indices, n_rays,
                seg_starts, seg_ends, prefix_trans, return_weights):
        ctx.save_for_backward(
            t_starts, t_ends, sigmas, rgbs, ray_indices, seg_starts, seg_ends,
            prefix_trans,
        )
        ctx.n_rays = n_rays
        out = _composite_forward(
            t_starts, t_ends, sigmas, rgbs, ray_indices, n_rays, seg_starts,
            seg_ends, prefix_trans, return_weights,
        )
        if out[3] is not None:
            ctx.mark_non_differentiable(out[3])
        return out

    @staticmethod
    def backward(ctx, g_colors, g_opacities, g_depths, _g_weights):
        saved = ctx.saved_tensors
        n_rays, like = ctx.n_rays, dict(dtype=torch.float32, device=saved[0].device)
        cots = [
            torch.zeros((n_rays, c), **like) if g is None else g
            for g, c in ((g_colors, 3), (g_opacities, 1), (g_depths, 1))
        ]
        d_sigmas, d_rgbs = composite_sorted_backward(
            *saved[:5], n_rays, *saved[5:7], *cots, saved[7]
        )
        return (None, None, d_sigmas, d_rgbs) + (None,) * 6


def composite_sorted(
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    sigmas: torch.Tensor,
    rgbs: torch.Tensor,
    ray_indices: torch.Tensor,
    n_rays: int,
    seg_starts: torch.Tensor,
    seg_ends: torch.Tensor,
    prefix_trans: Optional[torch.Tensor] = None,
    return_weights: bool = False,
):
    """Per-ray compositing, differentiable in ``sigmas`` and ``rgbs``:
    kernels G3/G5 for CUDA tensors, the twins :func:`composite_sorted_plain`
    / :func:`composite_sorted_backward_plain` for CPU tensors.  Same
    contract as :func:`composite_sorted_plain`; no gradient reaches
    ``t_starts``, ``t_ends`` or the weights, and ``prefix_trans`` must not
    require one."""
    if prefix_trans is not None and prefix_trans.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("composite: no gradient for prefix_trans")
    return _Composite.apply(
        t_starts, t_ends, sigmas, rgbs, ray_indices, n_rays, seg_starts,
        seg_ends, prefix_trans, return_weights,
    )
