"""Hat-interpolation matmul of one line table: kernels G8 (forward), G9
(table gradient) and G10 (coordinate gradient) and their PyTorch versions.

For coordinates ``x`` (N,) and a line table (R, rank),

    out[n, :] = sum_i W[n, i] * line[i, :],   W[n, i] = max(0, 1 - |x_n (R-1) - i|)

with the contract of the TPU kernels (nerfacc_tpu/ops/hat_matmul.py): the
weights and the table are rounded to bf16 and the sums are f32 (the table
gradient's long sums are taken in f64 and rounded once).  The backward
gives both gradients:

    dline = bf16(W)^T @ bf16(g)
    dx[n] = (R - 1) * sum_i dW[n, i] * (bf16(g) @ bf16(line)^T)[n, i]

with ``dW[n, i] = -sign(pos - i)`` where ``|pos - i| < 1`` and 0 elsewhere.
So ``dx`` is exactly 0 wherever ``x (R-1)`` is an integer, x = 0 and x = 1
included, where autograd of the hat would give a one-sided slope: the plain
versions write this rule out and do not differentiate the forward.  A hat row
has two nonzeros, so every version here reads two table rows per sample.

This is the one op of the port whose coordinates receive a gradient: the
TiNeuVox field's deformation network learns only through ``dx``.

:func:`hat_cp_level` takes one CP level of such a field at once: for points
``x`` (N, 3) and tables ``lines`` (3, R, rank) it gives
``(a_0 * a_1) * a_2`` with ``a_i = hat_interp_matmul(x[:, i], lines[i])``,
the JAX encoder's order, from one launch of G8 (the kernel's three-axis
instance), and its gradients through G9 and G10 per axis.
"""
from __future__ import annotations

import torch

from .. import cuda
from .cp_level import _round_bf16, _taps


def hat_taps(x: torch.Tensor, R: int):
    """Rows (i0, i1), bf16 weights (w0, w1) and slopes (dw0, dw1) of each
    coordinate's two taps; i1 is clamped into the table with weight and
    slope 0 where it is row R."""
    i0, i1, w0, w1 = _taps(x, R, bf16=True)
    pos = x * (R - 1)

    def slope(i, inside):
        delta = pos - i
        return torch.where(inside & (delta.abs() < 1.0), -torch.sign(delta), 0.0)

    dw0 = slope(i0.to(x.dtype), torch.ones_like(x, dtype=torch.bool))
    dw1 = slope((i0 + 1).to(x.dtype), i0 + 1 < R)
    return i0, i1, w0, w1, dw0, dw1


def hat_interp_matmul_plain(x: torch.Tensor, line: torch.Tensor) -> torch.Tensor:
    """PyTorch version of kernel G8, on any device, bitwise equal to it.

    Args:
        x: (N,) f32 coordinates; the hat is evaluated outside [0, 1] too.
        line: (R, rank) f32 table.

    Returns:
        (N, rank) f32 ``bf16(W) @ bf16(line)``: two exact products and one
        rounded f32 addition per entry.
    """
    i0, i1, w0, w1, _, _ = hat_taps(x, line.shape[0])
    table = _round_bf16(line)
    return w0[:, None] * table[i0] + w1[:, None] * table[i1]


def hat_level_plain(x: torch.Tensor, lines: torch.Tensor, keep_axes: bool = True):
    """PyTorch version of G8's three-axis instance, on any device: the
    per-axis :func:`hat_interp_matmul_plain` composed in JAX's order.

    Args:
        x: (N, 3) f32 coordinates.
        lines: (3, R, rank) f32 tables of one CP level.
        keep_axes: also return the three axes' interpolants.

    Returns:
        ``prod`` (N, rank) ``(a_0 * a_1) * a_2``, and ``axes`` (3, N, rank)
        holding a_0, a_1 and a_2, or None where ``keep_axes`` is False.
    """
    a = [hat_interp_matmul_plain(x[:, i], lines[i]) for i in range(3)]
    prod = (a[0] * a[1]) * a[2]
    return prod, torch.stack(a) if keep_axes else None


def hat_bwd_line_plain(x: torch.Tensor, g: torch.Tensor, R: int) -> torch.Tensor:
    """PyTorch version of kernel G9, on any device: the (R, rank) table
    gradient ``bf16(W)^T @ bf16(g)`` for the cotangent ``g`` (N, rank), by
    ``index_add_``.  The products are exact in f32; they are summed in f64
    and rounded to f32 once, so the result does not depend on the order of
    the sums."""
    i0, i1, w0, w1, _, _ = hat_taps(x, R)
    gb = _round_bf16(g)
    dline = torch.zeros((R, g.shape[1]), dtype=torch.float64, device=g.device)
    dline.index_add_(0, i0, (w0[:, None] * gb).double())
    dline.index_add_(0, i1, (w1[:, None] * gb).double())
    return dline.to(g.dtype)


def hat_bwd_x_plain(x: torch.Tensor, g: torch.Tensor, line: torch.Tensor) -> torch.Tensor:
    """PyTorch version of kernel G10, on any device: the (N,) coordinate
    gradient ``(R - 1) (dW0 S0 + dW1 S1)`` with ``S_j = bf16(g) . bf16(line[i_j])``
    (f32 sums over the rank), exactly 0 at grid points."""
    R = line.shape[0]
    i0, i1, _, _, dw0, dw1 = hat_taps(x, R)
    gb, table = _round_bf16(g), _round_bf16(line)
    s0 = (gb * table[i0]).sum(dim=1)
    s1 = (gb * table[i1]).sum(dim=1)
    return (dw0 * s0 + dw1 * s1) * (R - 1)


def _check(x, line_shape, g=None, line=None):
    if x.dtype != torch.float32 or x.ndim != 1:
        raise ValueError(f"hat_matmul: x {x.dtype} {tuple(x.shape)}: want f32 (N,)")
    if len(line_shape) != 2:
        raise ValueError(f"hat_matmul: line {tuple(line_shape)}: want (R, rank)")
    if line is not None and line.dtype != torch.float32:
        raise TypeError("hat_matmul: the line table must be f32")
    if g is not None and (g.dtype != torch.float32 or g.shape != (x.shape[0], line_shape[1])):
        raise ValueError(f"hat_matmul: cotangent {g.dtype} {tuple(g.shape)}: want f32 (N, rank)")


def hat_fwd(x: torch.Tensor, line: torch.Tensor) -> torch.Tensor:
    """Kernel G8 for CUDA tensors, :func:`hat_interp_matmul_plain` for CPU
    tensors; same contract, bitwise equal."""
    if not cuda.on_card(x, line):
        return hat_interp_matmul_plain(x, line)
    _check(x, line.shape, line=line)
    x, line = x.contiguous(), line.contiguous()
    R, rank = line.shape
    out = torch.empty((x.shape[0], rank), dtype=torch.float32, device=x.device)
    err = cuda.load().hat_fwd(
        cuda.ptr(x), cuda.ptr(line), cuda.ptr(out), x.shape[0], R, rank,
        cuda.stream_ptr(x),
    )
    cuda.check(err, "hat_fwd")
    cuda.LAUNCHES["hat_fwd"] += 1
    return out


def hat_level_fwd(x: torch.Tensor, lines: torch.Tensor, keep_axes: bool):
    """One CP level in one launch of kernel G8 for CUDA tensors,
    :func:`hat_level_plain` for CPU tensors; same contract, bitwise equal.
    Without ``keep_axes`` the kernel writes the product alone."""
    if not cuda.on_card(x, lines):
        return hat_level_plain(x, lines, keep_axes)
    if x.dtype != torch.float32 or lines.dtype != torch.float32:
        raise TypeError("hat_matmul: x and lines must be f32")
    if x.ndim != 2 or x.shape[1] != 3 or lines.ndim != 3 or lines.shape[0] != 3:
        raise ValueError(
            f"hat_matmul: x {tuple(x.shape)}, lines {tuple(lines.shape)}: "
            "want (N, 3) and (3, R, rank)"
        )
    x, lines = x.contiguous(), lines.contiguous()
    n, (_, R, rank) = x.shape[0], lines.shape
    prod = torch.empty((n, rank), dtype=torch.float32, device=x.device)
    axes = torch.empty((3, n, rank), dtype=torch.float32, device=x.device) if keep_axes else None
    err = cuda.load().hat_level_fwd(
        cuda.ptr(x), cuda.ptr(lines), cuda.ptr(prod), cuda.ptr(axes), n, R, rank,
        cuda.stream_ptr(x),
    )
    cuda.check(err, "hat_level_fwd")
    cuda.LAUNCHES["hat_fwd"] += 1
    return prod, axes


def hat_bwd_line(x: torch.Tensor, g: torch.Tensor, R: int) -> torch.Tensor:
    """The table gradient: kernel G9 for CUDA tensors, :func:`hat_bwd_line_plain`
    for CPU tensors.  On the card each block sums its samples in int64 fixed
    point (in any order, with the same result), rounds the sums to f32, and
    the blocks are added in f64 in block order: two calls on the same inputs
    give the same bits."""
    if not cuda.on_card(x, g):
        return hat_bwd_line_plain(x, g, R)
    _check(x, (R, g.shape[1]), g)
    x, g = x.contiguous(), g.contiguous()
    rank = g.shape[1]
    # one (R, rank) slab per block; a 1024-thread block is resident at most
    # twice per SM
    max_blocks = 2 * torch.cuda.get_device_properties(x.device).multi_processor_count
    partials = torch.empty((max_blocks, R, rank), dtype=torch.float32, device=x.device)
    dline = torch.empty((R, rank), dtype=torch.float32, device=x.device)
    err = cuda.load().hat_bwd_line(
        cuda.ptr(x), cuda.ptr(g), cuda.ptr(partials), cuda.ptr(dline), x.shape[0], R,
        rank, max_blocks, cuda.stream_ptr(x),
    )
    cuda.check(err, "hat_bwd_line")
    cuda.LAUNCHES["hat_bwd_line"] += 1
    return dline


def hat_bwd_x(x: torch.Tensor, g: torch.Tensor, line: torch.Tensor) -> torch.Tensor:
    """The coordinate gradient: kernel G10 for CUDA tensors,
    :func:`hat_bwd_x_plain` for CPU tensors.  The rank sums run in another
    order than the plain version's."""
    if not cuda.on_card(x, g, line):
        return hat_bwd_x_plain(x, g, line)
    _check(x, line.shape, g, line)
    x, g, line = x.contiguous(), g.contiguous(), line.contiguous()
    R, rank = line.shape
    dx = torch.empty_like(x)
    err = cuda.load().hat_bwd_x(
        cuda.ptr(x), cuda.ptr(g), cuda.ptr(line), cuda.ptr(dx), x.shape[0], R,
        rank, cuda.stream_ptr(x),
    )
    cuda.check(err, "hat_bwd_x")
    cuda.LAUNCHES["hat_bwd_x"] += 1
    return dx


class _HatInterp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, line):
        ctx.save_for_backward(x, line)
        return hat_fwd(x, line)

    @staticmethod
    def backward(ctx, g):
        x, line = ctx.saved_tensors
        g = g.contiguous()
        dx = hat_bwd_x(x, g, line) if ctx.needs_input_grad[0] else None
        dline = hat_bwd_line(x, g, line.shape[0]) if ctx.needs_input_grad[1] else None
        return dx, dline


def hat_interp_matmul(x: torch.Tensor, line: torch.Tensor) -> torch.Tensor:
    """``(N,) coordinates x (R, rank) line -> (N, rank) features``,
    differentiable in both: kernels G8 forward, G9 for the table and G10 for
    the coordinates (launched only when ``x`` needs a gradient) on CUDA
    tensors; the plain versions on CPU tensors.  Any other device, or a
    mix, raises."""
    return _HatInterp.apply(x, line)


class _HatLevel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, lines):
        prod, axes = hat_level_fwd(x, lines, keep_axes=True)
        ctx.save_for_backward(x, lines, axes)
        return prod

    @staticmethod
    def backward(ctx, g):
        x, lines, (a0, a1, a2) = ctx.saved_tensors
        # the cotangents autograd of (a0 * a1) * a2 forms
        g01 = g * a2
        cots = (g01 * a1, g01 * a0, g * (a0 * a1))
        want_x, want_lines = ctx.needs_input_grad[:2]
        dx = dlines = None
        if want_x:
            dx = torch.stack(
                [hat_bwd_x(x[:, i], cots[i], lines[i]) for i in range(3)], dim=1
            )
        if want_lines:
            R = lines.shape[1]
            dlines = torch.stack([hat_bwd_line(x[:, i], cots[i], R) for i in range(3)])
        return dx, dlines


def hat_cp_level(x: torch.Tensor, lines: torch.Tensor) -> torch.Tensor:
    """One CP level of the hat route, ``(N, 3) points x (3, R, rank) lines ->
    (N, rank)`` ``(a_0 * a_1) * a_2``: one launch of kernel G8 on CUDA
    tensors, differentiable in both (G9 per axis for the tables, G10 per
    axis for the points, each only where asked for), with the same bits as
    the per-axis :func:`hat_interp_matmul` composition.  Where no gradient
    is wanted (grad mode off, or neither input requires one) the kernel
    writes the product alone and nothing is saved."""
    if torch.is_grad_enabled() and (x.requires_grad or lines.requires_grad):
        return _HatLevel.apply(x, lines)
    return hat_level_fwd(x, lines, keep_axes=False)[0]
