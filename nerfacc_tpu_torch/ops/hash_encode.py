"""Multiresolution hash encode (Instant-NGP): kernels G6 (forward) and G7
(table gradient) and their PyTorch twins.

For points ``x`` (N, 3) and an (L, T, F) table, level ``l`` at resolution
``res_l`` gives

    pos = x * res_l ;  i0 = floor(pos) ;  frac = pos - i0
    h_c = ((i0x+dx)*1 ^ (i0y+dy)*2654435761 ^ (i0z+dz)*805459861  mod 2^32) & (T-1)
    w_c = ((dx ? fx : 1-fx) * (dy ? fy : 1-fy)) * (dz ? fz : 1-fz)
    out[n, l*F + f] = sum_{c=0..7} w_c * table[l, h_c, f]

with the eight corners ``c = 4 dx + 2 dy + dz`` (dx-major) summed in that
order: the function of the JAX package's ``HashGridEncoder`` (tcnn's primes,
uint32 wraparound for corners below 0) and of its Pallas kernel
(nerfacc_tpu/ops/hash_vmem.py), without the kernel's lane-folded layout and
its cap on T.  ``x`` is not clamped: a point outside [0, 1]^3 hashes the
cells it lies in, as in JAX.

The backward gives the table gradient only,

    g_table[l, h_c, f] += w_c * cot[n, l*F + f]

the contract of JAX's kernel path (``_vmem_encode_bwd``): positions get no
gradient.  :func:`hash_encode` raises if ``x`` requires one, rather than
returning none for it.

Numerics, as XLA's CPU backend computes the JAX encoder: ``frac`` is
``pos - floor(pos)`` with ``pos`` rounded, not one fused multiply-add (a
fused form differs in the last bit on ~40% of coordinates), while the
corner sum is fused, ``acc = fma(w_c, row_c, acc)`` for c = 0..7 (a
rounded product differs on ~44% of outputs).  So the twin's corner ids,
weights and features equal JAX's bit for bit, and G6 uses explicitly
rounded intrinsics (``__fmul_rn``, ``__fsub_rn``, ``__fmaf_rn``) to equal
the twin bit for bit.  The table gradient sums the rounded products
``w_c * cot`` (JAX's scatter-add does the same).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from .. import cuda
from . import ordered_sums
from ..utils.fp import fma_f32

# tcnn's spatial hash primes (public constants)
PRIMES = (1, 2654435761, 805459861)
# corner offsets (dx, dy, dz), dx-major: c = 4 dx + 2 dy + dz
_CORNERS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))


def hash_corners_plain(
    x: torch.Tensor, resolutions: Sequence[int], table_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner hash ids and trilinear weights of every level.

    Args:
        x: (N, 3) positions, [0, 1]^3 inside the grid.
        resolutions: per-level grid resolutions (length L).
        table_size: rows per level, a power of two.

    Returns:
        idx: (N, L, 8) int64 ids in [0, table_size), corners dx-major.
        w: (N, L, 8) weights in ``x``'s dtype.
    """
    res = torch.tensor(resolutions, dtype=x.dtype, device=x.device)
    pos = x[:, None, :] * res[None, :, None]  # (N, L, 3)
    i0 = torch.floor(pos)
    frac = pos - i0
    # int64 products and XORs agree with uint32 ones in their low 32 bits
    i0 = i0.long()
    mask = table_size - 1
    idx, w = [], []
    for dx, dy, dz in _CORNERS:
        h = (
            (i0[..., 0] + dx) * PRIMES[0]
            ^ (i0[..., 1] + dy) * PRIMES[1]
            ^ (i0[..., 2] + dz) * PRIMES[2]
        ) & mask
        wx = frac[..., 0] if dx else 1.0 - frac[..., 0]
        wy = frac[..., 1] if dy else 1.0 - frac[..., 1]
        wz = frac[..., 2] if dz else 1.0 - frac[..., 2]
        idx.append(h)
        w.append((wx * wy) * wz)
    return torch.stack(idx, dim=-1), torch.stack(w, dim=-1)


def _flat_rows(idx: torch.Tensor, table_size: int) -> torch.Tensor:
    """(N, L, 8) per-level ids -> row ids of the (L*T, F) flat table."""
    levels = idx.shape[1]
    offset = torch.arange(levels, device=idx.device) * table_size
    return idx + offset[None, :, None]


def hash_encode_plain(
    x: torch.Tensor, table: torch.Tensor, resolutions: Sequence[int]
) -> torch.Tensor:
    """PyTorch twin of kernel G6, on any device.

    Args:
        x: (N, 3) positions.
        table: (L, T, F) parameters.
        resolutions: per-level resolutions (length L).

    Returns:
        (N, L*F) features in the table's dtype, corners summed in the order
        c = 0..7, in f32 by fused multiply-adds each rounded once
        (:func:`fma_f32`).
    """
    L, T, F = table.shape
    idx, w = hash_corners_plain(x, resolutions, T)
    rows = table.reshape(L * T, F)[_flat_rows(idx, T)]  # (N, L, 8, F)
    acc = torch.zeros((x.shape[0], L, F), dtype=table.dtype, device=x.device)
    f32 = table.dtype == torch.float32
    for c in range(8):
        w_c, row_c = w[:, :, c, None], rows[:, :, c, :]
        acc = fma_f32(w_c, row_c, acc) if f32 else w_c * row_c + acc
    return acc.reshape(x.shape[0], L * F)


def hash_encode_backward_plain(
    x: torch.Tensor, cot: torch.Tensor, table_shape, resolutions: Sequence[int]
) -> torch.Tensor:
    """PyTorch twin of kernel G7, on any device: the table gradient of
    :func:`hash_encode_plain` for the cotangent ``cot`` (N, L*F).  Returns an
    (L, T, F) tensor in ``cot``'s dtype.  An f32 gradient is summed in fixed
    point (:func:`scale_exponent`), so that it does not depend on the order
    of the samples and the kernel's equals it bit for bit; another dtype is
    summed row by row in sample order
    (:func:`~nerfacc_tpu_torch.ops.ordered_sums.index_add_rows`)."""
    L, T, F = table_shape
    idx, w = hash_corners_plain(x, resolutions, T)
    rows = _flat_rows(idx, T).reshape(-1)
    if cot.dtype != torch.float32:
        upd = (w[..., None] * cot.reshape(-1, L, 1, F)).reshape(-1, F)  # (N L 8, F)
        g = torch.zeros((L * T, F), dtype=cot.dtype, device=cot.device)
        return ordered_sums.index_add_rows(g, rows, upd).reshape(L, T, F)
    k = scale_exponent(cot)
    upd = w[..., None] * ordered_sums.scale(cot, k).reshape(-1, L, 1, F)
    q, special = ordered_sums.quantize(upd.reshape(-1, F))
    acc = torch.zeros((L * T, F), dtype=torch.int64, device=cot.device).index_add_(0, rows, q)
    special = torch.zeros((L * T, F), dtype=torch.float64, device=cot.device).index_add_(
        0, rows, special)
    return ordered_sums.from_fixed(acc, special, k).reshape(L, T, F)


def scale_exponent(cot: torch.Tensor) -> torch.Tensor:
    """G7's fixed-point scale: the int64 ``k``, each term summed as
    ``round(w_c * (cot * 2^k))``.  A term ``w_c * cot`` with ``w_c <= 1`` lies below
    the exponent bound of the largest finite ``|cot|``, and an entry takes
    at most eight terms a sample (every corner on one row)."""
    e = ordered_sums.exponent_bound(ordered_sums.finite_abs_max(cot))
    return ordered_sums.scale_exponent(e, 8 * cot.shape[0])


# per-level resolutions as f32 device tensors, made once per device: a copy
# from host memory at every call would wait for the stream
_RES: Dict[Tuple[Tuple[int, ...], torch.device], torch.Tensor] = {}


def _resolutions(resolutions: Sequence[int], device: torch.device) -> torch.Tensor:
    key = (tuple(int(r) for r in resolutions), device)
    if key not in _RES:
        _RES[key] = torch.tensor(key[0], dtype=torch.float32, device=device)
    return _RES[key]


def _check(x, table_shape, resolutions, dtype, cot=None):
    if x.dtype != torch.float32 or dtype != torch.float32:
        raise TypeError("hash_encode: x and table must be f32 on the card")
    L, T, F = table_shape
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"hash_encode: x {tuple(x.shape)}: want (N, 3)")
    if F != 2 or T & (T - 1) or len(resolutions) != L:
        raise ValueError(
            f"hash_encode: table (L, T, F) = {tuple(table_shape)} with "
            f"{len(resolutions)} resolutions: want F = 2, T a power of two, "
            "one resolution per level"
        )
    if cot is not None and (cot.dtype != torch.float32 or cot.shape != (x.shape[0], L * F)):
        raise ValueError(
            f"hash_encode: cotangent {cot.dtype} {tuple(cot.shape)}: want f32 (N, L*F)"
        )


def hash_encode_forward(
    x: torch.Tensor, table: torch.Tensor, resolutions: Sequence[int]
) -> torch.Tensor:
    """Kernel G6 for CUDA tensors, the twin :func:`hash_encode_plain` for
    CPU tensors; same contract, bitwise equal."""
    if not cuda.on_card(x, table):
        return hash_encode_plain(x, table, resolutions)
    _check(x, table.shape, resolutions, table.dtype)
    x, table = x.contiguous(), table.contiguous()
    L, T, F = table.shape
    out = torch.empty((x.shape[0], L * F), dtype=torch.float32, device=x.device)
    err = cuda.load().hash_fwd(
        cuda.ptr(x), cuda.ptr(table), cuda.ptr(_resolutions(resolutions, x.device)),
        cuda.ptr(out), x.shape[0], L, T.bit_length() - 1, cuda.stream_ptr(x),
    )
    cuda.check(err, "hash_fwd")
    cuda.LAUNCHES["hash_fwd"] += 1
    return out


def hash_encode_backward(
    x: torch.Tensor, cot: torch.Tensor, table_shape, resolutions: Sequence[int]
) -> torch.Tensor:
    """The table gradient: kernel G7 for CUDA tensors, the twin
    :func:`hash_encode_backward_plain` for CPU tensors.  Same contract, and
    bitwise equal to the twin: both sum in fixed point."""
    if not cuda.on_card(x, cot):
        return hash_encode_backward_plain(x, cot, table_shape, resolutions)
    _check(x, table_shape, resolutions, cot.dtype, cot)
    x, cot = x.contiguous(), cot.contiguous()
    L, T, F = table_shape
    entries = L * T * F
    # the int64 twin of the table, a flag byte an entry, and the largest |cot|
    work = torch.zeros(entries + (entries + 7) // 8 + 1, dtype=torch.int64, device=x.device)
    g = torch.empty((L, T, F), dtype=torch.float32, device=x.device)
    err = cuda.load().hash_bwd(
        cuda.ptr(x), cuda.ptr(cot), cuda.ptr(_resolutions(resolutions, x.device)),
        cuda.ptr(g), cuda.ptr(work), x.shape[0], L, T.bit_length() - 1, cuda.stream_ptr(x),
    )
    cuda.check(err, "hash_bwd")
    cuda.LAUNCHES["hash_bwd"] += 1
    return g


class _HashEncode(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, resolutions):
        ctx.save_for_backward(x)
        ctx.table_shape = tuple(table.shape)
        ctx.resolutions = resolutions
        return hash_encode_forward(x, table, resolutions)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        (x,) = ctx.saved_tensors
        g_table = hash_encode_backward(x, g.contiguous(), ctx.table_shape, ctx.resolutions)
        return None, g_table, None


def hash_encode(
    x: torch.Tensor, table: torch.Tensor, resolutions: Sequence[int]
) -> torch.Tensor:
    """The hash encode, differentiable in ``table``: kernels G6/G7 for CUDA
    tensors, the twins for CPU tensors.  Any other device, or a mix, raises.

    Args:
        x: (N, 3) positions; must not require a gradient.
        table: (L, T, F) parameters (F = 2 and f32 on the card).
        resolutions: per-level resolutions (length L).

    Returns:
        (N, L*F) features.
    """
    if x.requires_grad:
        raise ValueError(
            "hash_encode gives no position gradient; detach x (sample "
            "positions carry none in the trainers)"
        )
    return _HashEncode.apply(x, table, tuple(int(r) for r in resolutions))
