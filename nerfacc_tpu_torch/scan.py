"""Segmented inclusive and exclusive sums and products.

PyTorch counterpart of nerfacc_tpu/scan.py, on its three layouts:

* batched ``(..., n)``: ``cumsum`` / ``cumprod`` along the last axis;
* flattened ``(all_samples,)`` with ``packed_info`` (n_rays, 2)
  ``[chunk_start, chunk_cnt]``: chunks contiguous and in order, rows with a
  zero count allowed;
* flattened ``(all_samples,)`` with ``indices`` (all_samples,): a segment
  is a *run* of equal consecutive ids, not every sample of one id.

A flattened scan lays each segment out as one row of an (n_segments,
longest segment) table and scans along the rows, so every sum and product is
segment-local: never one global cumsum differenced at the segment starts,
whose rounding error grows with the whole buffer's running total.  Autograd
gives the gradients, the exclusive product's exact where an input is 0.
The table's shape waits on the device once (the segment count and the
longest segment).
"""
from __future__ import annotations

from typing import Optional

import torch


def _flags_from_packed_info(packed_info: torch.Tensor, n: int) -> torch.Tensor:
    """Segment-start flags: the start of every non-empty chunk."""
    starts, cnts = packed_info[:, 0].long(), packed_info[:, 1]
    flags = torch.zeros(n + 1, dtype=torch.bool, device=packed_info.device)
    flags[torch.where(cnts > 0, starts, n).clamp(0, n)] = True
    return flags[:n]


def _flags_from_indices(indices: torch.Tensor) -> torch.Tensor:
    """Segment-start flags: wherever the id differs from the one before."""
    flags = torch.ones_like(indices, dtype=torch.bool)
    flags[1:] = indices[1:] != indices[:-1]
    return flags


def _flags(n: int, packed_info, indices, device) -> torch.Tensor:
    if indices is not None and packed_info is not None:
        raise ValueError("Only one of `indices` and `packed_info` can be specified.")
    if indices is not None:
        if indices.shape != (n,):
            raise ValueError("indices must be 1-D with the shape of inputs")
        return _flags_from_indices(indices)
    if packed_info.ndim != 2 or packed_info.shape[-1] != 2:
        raise ValueError("packed_info must be 2-D with shape (B, 2)")
    return _flags_from_packed_info(packed_info, n)


def _segment_layout(flags: torch.Tensor):
    """Each element's segment and column in the row table of its segment.

    The elements before the first flag form a segment of their own, as in
    a scan that starts accumulating at element 0.

    Returns:
        seg (n,) int64, col (n,) int64, the segment count and the longest
        segment's length.
    """
    flags = flags.clone()
    flags[:1] = True
    seg = torch.cumsum(flags, 0) - 1
    pos = torch.arange(flags.shape[0], device=flags.device)
    starts = torch.zeros(flags.shape[0], dtype=torch.long, device=flags.device)
    starts = starts.index_put((seg[flags],), pos[flags])
    col = pos - starts[seg]
    n_seg, width = (int(v) for v in torch.stack([seg[-1] + 1, col.max() + 1]).tolist())
    return seg, col, n_seg, width


def _flat_scan(vals, seg, col, n_seg, width, op: str, exclusive: bool) -> torch.Tensor:
    """Scan along each segment's row of the table (shifted one column for an
    exclusive scan)."""
    identity = 0.0 if op == "sum" else 1.0
    shift = 1 if exclusive else 0
    table = vals.new_full((n_seg, width + shift), identity)
    table = table.index_put((seg, col + shift), vals)
    table = table.cumsum(1) if op == "sum" else table.cumprod(1)
    return table[seg, col]


def _dispatch(inputs, packed_info, indices, op: str, exclusive: bool) -> torch.Tensor:
    if indices is None and packed_info is None:
        if exclusive:
            pad = torch.full_like(inputs[..., :1], 0.0 if op == "sum" else 1.0)
            inputs = torch.cat([pad, inputs[..., :-1]], dim=-1)
        return inputs.cumsum(-1) if op == "sum" else inputs.cumprod(-1)
    if inputs.ndim != 1:
        raise ValueError("inputs must be flattened")
    n = inputs.shape[0]
    if n == 0:
        return inputs.clone()
    layout = _segment_layout(_flags(n, packed_info, indices, inputs.device))
    return _flat_scan(inputs, *layout, op, exclusive)


def _normalize_by_segment_total(out, inputs, packed_info, indices, eps: float = 1e-12):
    """Divide each element by its segment's total (the inclusive sum at the
    segment's last element; the row sum in the batched layout)."""
    if indices is None and packed_info is None:
        total = inputs.sum(-1, keepdim=True)
    elif inputs.shape[0] == 0:
        return out
    else:
        seg, col, n_seg, width = _segment_layout(
            _flags(inputs.shape[0], packed_info, indices, inputs.device)
        )
        incl = _flat_scan(inputs, seg, col, n_seg, width, "sum", False)
        lengths = torch.bincount(seg, minlength=n_seg)
        last = torch.arange(seg.shape[0], device=seg.device) - col + lengths[seg] - 1
        total = incl[last]
    return out / torch.where(total.abs() > eps, total, torch.ones_like(total))


def inclusive_sum(
    inputs: torch.Tensor,
    packed_info: Optional[torch.Tensor] = None,
    indices: Optional[torch.Tensor] = None,
    normalize: bool = False,
) -> torch.Tensor:
    """Inclusive sum, batched along the last axis or per flattened segment
    (``packed_info`` or ``indices``); ``normalize`` divides every element by
    its segment's total.

    Example::

        >>> inputs = torch.tensor([1., 2., 3., 4., 5., 6., 7., 8., 9.])
        >>> packed_info = torch.tensor([[0, 2], [2, 3], [5, 4]])
        >>> inclusive_sum(inputs, packed_info)
        tensor([ 1.,  3.,  3.,  7., 12.,  6., 13., 21., 30.])
    """
    out = _dispatch(inputs, packed_info, indices, "sum", exclusive=False)
    if normalize:
        out = _normalize_by_segment_total(out, inputs, packed_info, indices)
    return out


def exclusive_sum(
    inputs: torch.Tensor,
    packed_info: Optional[torch.Tensor] = None,
    indices: Optional[torch.Tensor] = None,
    normalize: bool = False,
) -> torch.Tensor:
    """Exclusive sum, layouts as :func:`inclusive_sum`.

    Example::

        >>> exclusive_sum(inputs, packed_info)
        tensor([ 0.,  1.,  0.,  3.,  7.,  0.,  6., 13., 21.])
    """
    out = _dispatch(inputs, packed_info, indices, "sum", exclusive=True)
    if normalize:
        out = _normalize_by_segment_total(out, inputs, packed_info, indices)
    return out


def inclusive_prod(
    inputs: torch.Tensor,
    packed_info: Optional[torch.Tensor] = None,
    indices: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Inclusive product, layouts as :func:`inclusive_sum`.

    Example::

        >>> inclusive_prod(inputs, packed_info)
        tensor([1., 2., 3., 12., 60., 6., 42., 336., 3024.])
    """
    return _dispatch(inputs, packed_info, indices, "prod", exclusive=False)


def exclusive_prod(
    inputs: torch.Tensor,
    packed_info: Optional[torch.Tensor] = None,
    indices: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Exclusive product, layouts as :func:`inclusive_sum`.

    Example::

        >>> exclusive_prod(inputs, packed_info)
        tensor([1., 1., 1., 3., 12., 1., 6., 42., 336.])
    """
    return _dispatch(inputs, packed_info, indices, "prod", exclusive=True)
