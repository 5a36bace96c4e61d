"""Shared pieces of the NGP-style fields: activations, contraction, MLPs.

PyTorch counterpart of nerfacc_tpu/models/ngp.py.  Only what the CP field
uses is here; the hash-grid NGP fields are not ported yet.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x.clamp(max=30.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(max=15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """``exp`` with the forward capped at exp(30) ~ 1e13 and the backward
    ``g * exp(min(x, 15))`` for every ``x``, as nerfacc_tpu/models/ngp.py's
    custom VJP.

    A density of 1e13 is already opacity 1 within any step size, while an
    uncapped exp overflows f32 near 88 and turns the transmittance chain NaN
    on hard surfaces; the clipped backward keeps hard-surface gradients
    finite and nonzero where plain autograd of the capped forward would give
    ``exp(x)`` below 30 and 0 above.
    """
    return _TruncExp.apply(x)


def contract_to_unisphere(x: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF 360 scene contraction to the unit sphere, remapped to [0, 1]."""
    aabb_min, aabb_max = aabb[..., :3], aabb[..., 3:]
    x = (x - aabb_min) / (aabb_max - aabb_min)
    x = x * 2 - 1  # aabb is at [-1, 1]
    mag = torch.linalg.norm(x, dim=-1, keepdim=True)
    mask = mag[..., 0] > 1
    safe_mag = mag.clamp_min(1e-6)
    contracted = (2 - 1 / safe_mag) * (x / safe_mag)
    x = torch.where(mask[..., None], contracted, x)
    return x / 4 + 0.5  # [-inf, inf] is at [0, 1]


def _mlp_init(generator: torch.Generator, dims: Sequence[int]) -> List[torch.Tensor]:
    """Bias-free MLP weights, ``U(-a, a)`` with ``a = sqrt(6 / (in + out))``.

    Drawn on the generator's device (the CPU for a default generator)."""
    weights = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        a = (6.0 / (d_in + d_out)) ** 0.5
        u = torch.rand(
            (d_in, d_out), generator=generator, device=generator.device
        )
        weights.append(u * (2 * a) - a)
    return weights


def _mlp_apply(
    weights: Sequence[torch.Tensor], x: torch.Tensor, compute_dtype=torch.bfloat16
) -> torch.Tensor:
    """Bias-free ReLU MLP with the JAX package's rounding contract.

    Every layer takes ``compute_dtype`` operands and returns an f32 result
    (``preferred_element_type=f32`` in JAX).  Operands are rounded to the
    compute dtype and multiplied as f32: a product of two bf16 values is
    exact in f32, so this is a bf16 matmul with f32 accumulation.  On the
    card the f32 matmul must not run in TF32
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default).
    """
    x = _round(x, compute_dtype)
    last = len(weights) - 1
    for i, w in enumerate(weights):
        x = x @ _round(w, compute_dtype)
        if i < last:
            x = _round(torch.relu(x), compute_dtype)
    return x


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return x
    return x.to(dtype).to(torch.float32)
