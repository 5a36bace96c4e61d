"""CP-factorized radiance field (PyTorch counterpart of
nerfacc_tpu/models/cp_field.py).

Per resolution level, each axis has a line table (R, rank); a point's level
feature is the elementwise product of the three axes' linearly interpolated
rows, and the levels are concatenated.  Each level runs through
:func:`~nerfacc_tpu_torch.ops.cp_level.cp_level_encode` (kernels G1/G4 on
the card, no coordinate gradient), or with ``use_pallas=True`` through
:func:`~nerfacc_tpu_torch.ops.hat_matmul.hat_cp_level` (the hat route: one
launch of kernel G8 a level, G9 and G10 per axis, with a coordinate
gradient).  Only the line levels are ported; tri-plane levels, tensor
parallelism and the TPU layout options are not.  :class:`CPDensityField` is the proposal path's density-only field.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.cp_level import cp_level_encode
from ..ops.hat_matmul import hat_cp_level
from .ngp import DensityField, MLPField


class CPGridEncoder(nn.Module):
    """Multi-resolution CP line encoder.

    Args:
        resolutions: per-level 1D grid sizes.
        ranks: per-level number of CP components (= output features).
        compute_dtype: ``torch.bfloat16`` rounds weights and table values to
            bf16 with f32 sums (the TPU kernel's contract); ``torch.float32``
            is exact f32.
        use_pallas: the JAX encoder's name for its per-axis hat-matmul
            route: each level is ``(a_x * a_y) * a_z`` with
            ``a = hat_interp_matmul(u[:, axis], line[axis])``, taken in one
            launch (:func:`~nerfacc_tpu_torch.ops.hat_matmul.hat_cp_level`),
            always bf16 operands with f32 sums, differentiable in ``u`` too.  False (the
            default) runs the fused CP level, which gives ``u`` no gradient.
    """

    def __init__(
        self,
        resolutions: Sequence[int] = (32, 128, 512),
        ranks: Sequence[int] = (32, 32, 32),
        compute_dtype=torch.bfloat16,
        use_pallas: bool = False,
    ):
        super().__init__()
        self.resolutions = tuple(int(r) for r in resolutions)
        self.ranks = tuple(int(r) for r in ranks)
        self.compute_dtype = compute_dtype
        self.use_pallas = use_pallas
        self.lines = nn.ParameterList(
            [
                nn.Parameter(torch.ones(3, R, rank))
                for R, rank in zip(self.resolutions, self.ranks)
            ]
        )

    @property
    def output_dim(self) -> int:
        return sum(self.ranks)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "CPGridEncoder":
        """Lines ``1 + 0.1 N(0, 1)``: products start near 1 (K-Planes init)."""
        for line in self.lines:
            noise = torch.randn(
                line.shape, generator=generator, device=generator.device
            )
            line.copy_(1.0 + 0.1 * noise)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3) points in [0, 1]^3 (clamped) -> (N, sum(ranks)) features."""
        x = x.clamp(0.0, 1.0)
        if not self.use_pallas:
            return torch.cat(
                [cp_level_encode(x, line, self.compute_dtype) for line in self.lines],
                dim=-1,
            )
        # one launch a level, (a_x * a_y) * a_z in JAX's order
        return torch.cat([hat_cp_level(x, line) for line in self.lines], dim=-1)

    def param_regularizer(self, lines: Optional[Sequence[torch.Tensor]] = None):
        """Total variation of the line tables: the mean squared difference of
        adjacent rows, summed over levels (the JAX encoder's line terms).
        ``lines`` replaces the module's own tables (the trainer passes its
        parameter tensors)."""
        terms = []
        for line in self.lines if lines is None else lines:
            d = line[:, 1:, :] - line[:, :-1, :]
            terms.append((d * d).mean())
        return sum(terms)


class CPRadianceField(MLPField):
    """Radiance field with CP line features and small bias-free MLPs (see
    :class:`~nerfacc_tpu_torch.models.ngp.MLPField`)."""

    def __init__(
        self,
        aabb: Sequence[float],
        unbounded: bool = False,
        resolutions: Sequence[int] = (32, 128, 512),
        ranks: Sequence[int] = (32, 32, 32),
        compute_dtype=torch.bfloat16,
    ):
        super().__init__(
            list(aabb), unbounded, CPGridEncoder(resolutions, ranks, compute_dtype),
            compute_dtype,
        )


class CPDensityField(DensityField):
    """Density-only CP field for proposal resampling (PyTorch counterpart of
    nerfacc_tpu/models/cp_field.py::CPDensityField): CP line levels through
    kernels G1/G4 and a bias-free ``[sum(ranks), hidden_dim, 1]`` MLP
    (:class:`~nerfacc_tpu_torch.models.ngp.DensityField`);
    ``cp_level_encode`` raises on positions that ask for a gradient.
    """

    def __init__(
        self,
        aabb: Sequence[float],
        unbounded: bool = False,
        resolutions: Sequence[int] = (16, 64),
        ranks: Sequence[int] = (16, 16),
        hidden_dim: int = 64,
        compute_dtype=torch.bfloat16,
    ):
        super().__init__(aabb, unbounded, CPGridEncoder(resolutions, ranks, compute_dtype),
                         hidden_dim, compute_dtype)
