"""Dense voxel-grid radiance field (the DVGO / Plenoxels role): multi-level
feature grids read by trilinear interpolation, in front of small bias-free
MLPs.

PyTorch counterpart of nerfacc_tpu/models/voxel_field.py.  The JAX package
builds a neighbourhood table (the 2x2x2 corner block of every cell, 8C wide)
so that one row gather fetches all eight corners on the TPU; here the eight
corners are eight plain PyTorch gathers.  The gradient is JAX's custom VJP
(:class:`_Trilinear`): the table cotangent scattered back onto the grid,
with the edge-replicated high side folded onto the last cell, and the
coordinate cotangent of the unclipped trilinear weights, which ignores the
clip of ``u`` to [0, 1].
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from ..ops.ordered_sums import index_add_rows
from .ngp import MLPField


def _corners(grid_shape, u: torch.Tensor):
    """Flat indices (N, 8) of the 2x2x2 corners of each point's cell, in
    (dx, dy, dz) order, edge-replicated on the high side; their trilinear
    weights (N, 8); and the in-cell fractions (N, 3).  ``i0`` clips to
    ``res - 1``, so at ``u = 1`` the fraction is 0 and both corners of that
    axis are the last cell (JAX's padded table)."""
    X, Y, Z = grid_shape[:3]
    res = torch.tensor([X, Y, Z], dtype=u.dtype, device=u.device)
    pos = torch.clamp(u, 0.0, 1.0) * (res - 1)
    hi = torch.tensor([X - 1, Y - 1, Z - 1], device=u.device)
    i0 = torch.minimum(torch.floor(pos).long().clamp_min(0), hi)
    frac = pos - i0.to(pos.dtype)
    i1 = torch.minimum(i0 + 1, hi)
    ix = torch.stack([i0[:, 0], i1[:, 0]], -1)
    iy = torch.stack([i0[:, 1], i1[:, 1]], -1)
    iz = torch.stack([i0[:, 2], i1[:, 2]], -1)
    flat = ((ix[:, :, None, None] * Y + iy[:, None, :, None]) * Z
            + iz[:, None, None, :]).reshape(-1, 8)
    wx = torch.stack([1.0 - frac[:, 0], frac[:, 0]], -1)
    wy = torch.stack([1.0 - frac[:, 1], frac[:, 1]], -1)
    wz = torch.stack([1.0 - frac[:, 2], frac[:, 2]], -1)
    w = (wx[:, :, None, None] * wy[:, None, :, None] * wz[:, None, None, :]).reshape(-1, 8)
    return flat, w, frac


class _Trilinear(torch.autograd.Function):
    """Trilinear interpolation of an (X, Y, Z, C) grid at (N, 3) points in
    [0, 1]^3 (clipped), with the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, grid: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        C = grid.shape[-1]
        flat, w, frac = _corners(grid.shape, u)
        corners = grid.reshape(-1, C)[flat]  # (N, 8, C)
        ctx.save_for_backward(flat, w, frac, corners)
        ctx.grid_shape = grid.shape
        return (corners * w[..., None]).sum(1)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        flat, w, frac, corners = ctx.saved_tensors
        X, Y, Z, C = ctx.grid_shape
        dgrid = None
        if ctx.needs_input_grad[0]:
            dgrid = torch.zeros(X * Y * Z, C, dtype=g.dtype, device=g.device)
            # each voxel's terms summed in sample order on every device
            index_add_rows(dgrid, flat.reshape(-1), (w[..., None] * g[:, None, :]).reshape(-1, C))
            dgrid = dgrid.reshape(X, Y, Z, C)
        du = None
        if ctx.needs_input_grad[1]:
            # the analytic derivative of the (unclipped) weights, scaled by
            # res - 1; the clip's subgradient is ignored, as in JAX
            cor = corners.reshape(-1, 2, 2, 2, C)
            one = torch.ones_like(frac[:, 0])
            pairs = [torch.stack([1.0 - frac[:, a], frac[:, a]], -1) for a in range(3)]
            dpair = torch.stack([-one, one], -1)
            axes = []
            for axis in range(3):
                wa, wb, wc = (dpair if axis == k else pairs[k] for k in range(3))
                ww = wa[:, :, None, None] * wb[:, None, :, None] * wc[:, None, None, :]
                axes.append(((cor * ww[..., None]).sum((1, 2, 3)) * g).sum(-1))
            scale = torch.tensor([X - 1, Y - 1, Z - 1], dtype=g.dtype, device=g.device)
            du = (torch.stack(axes, -1) * scale).to(frac.dtype)
        return dgrid, du


def trilinear_gather(grid: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Trilinear interpolation of ``grid`` (X, Y, Z, C) at ``u`` (N, 3) in
    [0, 1]^3 (clipped): (N, C), differentiable in both as the JAX
    package's ``_trilinear_gather``."""
    return _Trilinear.apply(grid, u)


class VoxelGridEncoder(nn.Module):
    """Multi-level dense voxel feature grids.

    Args:
        resolutions: per-level cubic grid resolutions.
        channels: per-level feature channels.
    """

    def __init__(self, resolutions: Sequence[int] = (64, 128),
                 channels: Sequence[int] = (4, 4)):
        super().__init__()
        self.resolutions = tuple(int(r) for r in resolutions)
        self.channels = tuple(int(c) for c in channels)
        self.grids = nn.ParameterList(
            [nn.Parameter(torch.zeros(R, R, R, C))
             for R, C in zip(self.resolutions, self.channels)]
        )

    @property
    def output_dim(self) -> int:
        return sum(self.channels)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "VoxelGridEncoder":
        """Grids ``0.1 N(0, 1)``: the voxels learn residual detail (DVGO)."""
        for grid in self.grids:
            grid.copy_(0.1 * torch.randn(grid.shape, generator=generator,
                                         device=generator.device))
        return self

    def forward(self, x: torch.Tensor, grids: Optional[Sequence[torch.Tensor]] = None):
        """(N, 3) points in [0, 1]^3 -> (N, sum(channels)) features;
        ``grids`` replaces the module's own."""
        grids = self.grids if grids is None else grids
        return torch.cat([trilinear_gather(g, x) for g in grids], dim=-1)

    def param_regularizer(self, grids: Optional[Sequence[torch.Tensor]] = None):
        """Total variation of the grids: the mean squared difference of
        adjacent voxels along each axis, summed over axes and levels."""
        terms = []
        for g in self.grids if grids is None else grids:
            dx = g[1:] - g[:-1]
            dy = g[:, 1:] - g[:, :-1]
            dz = g[:, :, 1:] - g[:, :, :-1]
            terms.append((dx * dx).mean() + (dy * dy).mean() + (dz * dz).mean())
        return sum(terms)


class VoxelRadianceField(MLPField):
    """Radiance field over dense voxel features (levels 64/128 x 4 channels)
    with :class:`~nerfacc_tpu_torch.models.ngp.MLPField`'s bias-free MLPs
    (density ``trunc_exp(raw - 1)``, zeroed outside the box when bounded,
    which maps points by the quotient ``(x - lo) / (hi - lo)``; rgb from
    SH-16 of the view beside ``geo_feat_dim`` geometry features, or from
    those alone without view directions).

    Args:
        aabb: the scene box (not cubified).
        unbounded: contract instead of zeroing the density outside ``aabb``.
        resolutions / channels: the encoder's.
        compute_dtype: the MLPs' operand dtype (the grids are f32).
        geo_feat_dim / hidden_dim / use_viewdirs: the MLPs' (see
            :class:`~nerfacc_tpu_torch.models.ngp.MLPField`).
    """

    def __init__(
        self,
        aabb: Sequence[float],
        unbounded: bool = False,
        resolutions: Sequence[int] = (64, 128),
        channels: Sequence[int] = (4, 4),
        compute_dtype=torch.bfloat16,
        geo_feat_dim: int = 15,
        hidden_dim: int = 64,
        use_viewdirs: bool = True,
    ):
        super().__init__(list(aabb), unbounded, VoxelGridEncoder(resolutions, channels),
                         compute_dtype, hidden_dim=hidden_dim, geo_feat_dim=geo_feat_dim,
                         use_viewdirs=use_viewdirs)

    @property
    def max_eval_chunk(self) -> int:
        """The occupancy refresh's chunk, the JAX field's: the whole grid."""
        return 2**21

    def param_regularizer(self, params: Optional[Dict[str, torch.Tensor]] = None):
        """The grids' total variation (weigh it with the trainer's
        ``field_reg_weight``); ``params``, a state dict, replaces the
        module's own grids."""
        grids = None
        if params is not None:
            grids = [params[f"encoder.grids.{i}"] for i in range(len(self.encoder.grids))]
        return self.encoder.param_regularizer(grids)
