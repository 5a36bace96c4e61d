"""One CP level of the line encoder: kernels G1 (forward) and G4 (backward)
and their PyTorch twins.

One level of :class:`~nerfacc_tpu_torch.models.cp_field.CPGridEncoder`
computes, for coordinates ``u`` in [0, 1]^3 and line tables ``L_a`` of shape
(R, rank),

    out[n, :] = (w_x @ L_x) * (w_y @ L_y) * (w_z @ L_z)

with the hat weights ``w_a[i] = max(0, 1 - |u[n, a] * (R - 1) - i|)``.  A hat
row has two nonzeros, at ``i = floor(u (R - 1))`` and the row after it, so
every version here reads two table rows per axis.  The backward gives the
line tables' gradient

    dL_a = w_a^T @ (g * prod_{b != a} (w_b @ L_b))

and none for ``u``: sample positions carry no gradient, the contract of the
TPU kernel (nerfacc_tpu/ops/cp_level.py).  A field whose coordinates need
one encodes through :mod:`~nerfacc_tpu_torch.ops.hat_matmul` instead.

``compute_dtype=torch.bfloat16`` follows the TPU kernels (``_fwd_kernel``,
``_bwd_kernel``): weights and table values are rounded to bf16, and in the
backward the product cotangent ``g * prod f_b`` too; products and sums are
f32.  ``torch.float32`` is exact f32.
"""
from __future__ import annotations

import torch

from .. import cuda


def _taps(u: torch.Tensor, R: int, bf16: bool):
    """Row indices (N, 3) and hat weights (N, 3) of the two taps per axis."""
    pos = u * (R - 1)  # (N, 3)
    i0 = torch.floor(pos).clamp(0, R - 1)
    i1 = i0 + 1
    w0 = (1.0 - (pos - i0).abs()).clamp_min(0.0)
    # at u = 1 the second tap is row R, past the table: weight 0
    w1 = torch.where(i1 < R, (1.0 - (pos - i1).abs()).clamp_min(0.0), 0.0)
    if bf16:
        w0, w1 = _round_bf16(w0), _round_bf16(w1)
    return i0.long(), i1.clamp(max=R - 1).long(), w0, w1


def _axis_features(u, lines, bf16):
    """The per-axis interpolants ``f_a = w_a @ L_a``, each (N, rank), and the
    taps they came from."""
    i0, i1, w0, w1 = _taps(u, lines.shape[1], bf16)
    tables = _round_bf16(lines) if bf16 else lines
    feats = [
        w0[:, a : a + 1] * tables[a][i0[:, a]] + w1[:, a : a + 1] * tables[a][i1[:, a]]
        for a in range(3)
    ]
    return feats, (i0, i1, w0, w1)


def cp_level_encode_plain(
    u: torch.Tensor, lines: torch.Tensor, compute_dtype=torch.bfloat16
) -> torch.Tensor:
    """PyTorch twin of kernel G1, on any device.

    Args:
        u: (N, 3) f32 coordinates in [0, 1].
        lines: (3, R, rank) f32 line tables.

    Returns:
        (N, rank) f32 features.
    """
    (fx, fy, fz), _ = _axis_features(u, lines, compute_dtype == torch.bfloat16)
    return fx * fy * fz


def cp_level_backward_plain(
    u: torch.Tensor, g: torch.Tensor, lines: torch.Tensor, compute_dtype=torch.bfloat16
) -> torch.Tensor:
    """PyTorch twin of kernel G4, on any device: the closed-form line-table
    gradient of :func:`cp_level_encode_plain` for the cotangent ``g``.

    Args:
        u: (N, 3) f32 coordinates, as in the forward.
        g: (N, rank) f32 cotangent of the forward's output.
        lines: (3, R, rank) f32 line tables.

    Returns:
        (3, R, rank) f32 ``dlines``.  In bf16 mode the product cotangent is
        rounded to bf16 before it is spread, as the TPU kernel does.
    """
    bf16 = compute_dtype == torch.bfloat16
    f, (i0, i1, w0, w1) = _axis_features(u, lines, bf16)
    dlines = torch.zeros_like(lines)
    # the TPU kernel's product order: (g * f_first) * f_second
    others = ((1, 2), (0, 2), (0, 1))
    for a, (b, c) in enumerate(others):
        da = g * f[b] * f[c]
        if bf16:
            da = _round_bf16(da)
        dlines[a].index_add_(0, i0[:, a], w0[:, a : a + 1] * da)
        dlines[a].index_add_(0, i1[:, a], w1[:, a : a + 1] * da)
    return dlines


def _check(u, lines, compute_dtype, g=None):
    if u.dtype != torch.float32 or lines.dtype != torch.float32:
        raise TypeError("cp_level: u and lines must be f32")
    if u.ndim != 2 or u.shape[1] != 3 or lines.ndim != 3 or lines.shape[0] != 3:
        raise ValueError(
            f"cp_level: shapes u {tuple(u.shape)}, lines {tuple(lines.shape)}: "
            "want (N, 3) and (3, R, rank)"
        )
    if g is not None and (g.dtype != torch.float32 or g.shape != (u.shape[0], lines.shape[2])):
        raise ValueError(f"cp_level: cotangent {g.dtype} {tuple(g.shape)}: want f32 (N, rank)")
    if compute_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"cp_level: unsupported compute dtype {compute_dtype}")


def _encode_forward(u, lines, compute_dtype):
    """Kernel G1 for CUDA tensors, the twin for CPU tensors."""
    if not cuda.on_card(u, lines):
        return cp_level_encode_plain(u, lines, compute_dtype)
    _check(u, lines, compute_dtype)
    u, lines = u.contiguous(), lines.contiguous()
    n, (_, R, rank) = u.shape[0], lines.shape
    out = torch.empty((n, rank), dtype=torch.float32, device=u.device)
    err = cuda.load().cp_level_fwd(
        cuda.ptr(u), cuda.ptr(lines), cuda.ptr(out), n, R, rank,
        int(compute_dtype == torch.bfloat16), cuda.stream_ptr(u),
    )
    cuda.check(err, "cp_level_fwd")
    cuda.LAUNCHES["cp_level_fwd"] += 1
    return out


def cp_level_backward(
    u: torch.Tensor, g: torch.Tensor, lines: torch.Tensor, compute_dtype=torch.bfloat16
) -> torch.Tensor:
    """The line-table gradient: kernel G4 for CUDA tensors, the twin
    :func:`cp_level_backward_plain` for CPU tensors.  Same contract as the
    twin; on the card the f32 sums run in no fixed order (atomics)."""
    if not cuda.on_card(u, g, lines):
        return cp_level_backward_plain(u, g, lines, compute_dtype)
    _check(u, lines, compute_dtype, g)
    u, g, lines = u.contiguous(), g.contiguous(), lines.contiguous()
    _, R, rank = lines.shape
    dlines = torch.zeros_like(lines)
    err = cuda.load().cp_level_bwd(
        cuda.ptr(u), cuda.ptr(g), cuda.ptr(lines), cuda.ptr(dlines), u.shape[0],
        R, rank, int(compute_dtype == torch.bfloat16), cuda.stream_ptr(u),
    )
    cuda.check(err, "cp_level_bwd")
    cuda.LAUNCHES["cp_level_bwd"] += 1
    return dlines


class _CPLevel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, u, lines, compute_dtype):
        ctx.save_for_backward(u, lines)
        ctx.compute_dtype = compute_dtype
        return _encode_forward(u, lines, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[1]:
            return None, None, None
        u, lines = ctx.saved_tensors
        return None, cp_level_backward(u, g.contiguous(), lines, ctx.compute_dtype), None


def cp_level_encode(
    u: torch.Tensor, lines: torch.Tensor, compute_dtype=torch.bfloat16
) -> torch.Tensor:
    """One CP level, differentiable in ``lines``: kernels G1/G4 for CUDA
    tensors, the twins :func:`cp_level_encode_plain` /
    :func:`cp_level_backward_plain` for CPU tensors.  Same contract as the
    twins.  ``u`` gets no gradient, so a ``u`` that requires one raises
    rather than training on a silent zero.  Any other device, or a mix,
    raises."""
    if u.requires_grad:
        raise ValueError(
            "cp_level_encode gives no position gradient; detach u, or encode "
            "through CPGridEncoder(use_pallas=True), whose per-axis hat "
            "interpolation (ops/hat_matmul.py) returns one"
        )
    return _CPLevel.apply(u, lines, compute_dtype)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)
