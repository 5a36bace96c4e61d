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


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` for f32 tensors (broadcast), rounded once to f32.

    The product of two f32 values is exact in f64, and TwoSum gives the f64
    sum ``s`` and its exact error ``e``.  Rounding ``s`` to f32 is then the
    single rounding of ``a * b + c``, except where ``s`` lies exactly halfway
    between two f32 values and ``e`` is not 0: the sign of ``e`` breaks that
    tie.
    """
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
