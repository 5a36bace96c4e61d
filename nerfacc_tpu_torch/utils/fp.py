"""A fused multiply-add in f32 for plain PyTorch code.

XLA's CPU backend contracts ``a * b + c`` into a fused multiply-add wherever
its fusion allows (the importance sampler's CDF positions, the proposal
path's s-to-t map and sample positions), and the CUDA kernels spell it
``__fmaf_rn``; PyTorch has no such operator.  :func:`fma_f32` computes it
with one rounding, so plain versions match both bit for bit.
"""
from __future__ import annotations

import math

import torch


class _Fma(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, c):
        ctx.save_for_backward(a, b)
        ctx.shapes = a.shape, b.shape, c.shape
        return _fma_f32(a, b, c)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        sa, sb, sc = ctx.shapes
        need = ctx.needs_input_grad
        return (
            (g * b).sum_to_size(sa) if need[0] else None,
            (g * a).sum_to_size(sb) if need[1] else None,
            g.sum_to_size(sc) if need[2] else None,
        )


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 tensors (broadcast), rounded once to f32, with
    the gradients of ``a * b + c`` where autograd asks for them.

    The product of two f32 values is exact in f64, and TwoSum gives the f64
    sum ``s`` and its exact error ``e``.  Rounding ``s`` to f32 is then the
    single rounding of ``a * b + c``, except where ``s`` lies exactly halfway
    between two f32 values and ``e`` is not 0: the sign of ``e`` breaks that
    tie.
    """
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad or c.requires_grad):
        return _Fma.apply(a, b, c)
    return _fma_f32(a, b, c)


def _fma_f32(a, b, c):
    a, b, c = torch.broadcast_tensors(a, b, c)
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    z = s - p
    e = (p - (s - z)) + (cd - z)
    r = s.float()
    rd = r.double()
    # the f32 neighbour of r on s's side, and whether s is their midpoint
    other = torch.nextafter(r, torch.where(s > rd, math.inf, -math.inf).float())
    half = (s - rd).abs() == (other.double() - s).abs()
    toward_other = torch.sign(e) == torch.sign(other.double() - rd)
    fix = half & (s != rd) & (e != 0) & toward_other & torch.isfinite(s)
    return torch.where(fix, other, r)
