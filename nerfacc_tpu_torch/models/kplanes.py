"""K-Planes space-time radiance field (PyTorch counterpart of
nerfacc_tpu/models/kplanes.py).

A 4-D point ``(x, y, z, t)`` reads six feature planes a level, the spatial
pairs (xy, xz, yz) and the space-time pairs (xt, yt, zt); a level's feature
is the elementwise (Hadamard) product of the six bilinear lookups, and the
levels are concatenated in front of the small bias-free MLPs of
:class:`~nerfacc_tpu_torch.models.ngp.MLPField`.  The time planes start at
exactly one, so the scene starts static.

The JAX level is a one-hot "hat" matmul, ``hat_u @ P`` and then a ``hat_v``
contraction, which avoids gathers on the TPU.  It computes a bilinear lookup
of four texels a plane, which this module takes as plain PyTorch gathers
(their backward an ``index_put_`` accumulation), in the rounding of the
jitted JAX level (see :meth:`KPlanesEncoder.level`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
from torch import nn

from .ngp import FrameQuery, MLPField, _round

# (xy, xz, yz, xt, yt, zt): coordinate index pairs into (x, y, z, t)
PAIRS = ((0, 1), (0, 2), (1, 2), (0, 3), (1, 3), (2, 3))


class KPlanesEncoder(nn.Module):
    """Multi-level six-plane space-time encoder.

    Args:
        resolutions: each level's plane resolution, shared by its six planes.
        ranks: each level's feature width (its output features).
        compute_dtype: ``torch.bfloat16`` rounds as the jitted JAX level
            does; ``torch.float32`` is f32 throughout.
        plane_activation: "none" (the raw features) or "tanh", ``f -> 1 +
            tanh(f - 1)`` taken in f32, which bounds each feature to (0, 2)
            and so the product of six to (0, 64).
        amp_prior: adds ``amp_prior * mean((plane - 1)^2)`` a level to
            :meth:`param_regularizer`.
    """

    def __init__(
        self,
        resolutions: Sequence[int] = (32, 64),
        ranks: Sequence[int] = (16, 16),
        compute_dtype=torch.bfloat16,
        plane_activation: str = "none",
        amp_prior: float = 0.0,
    ):
        super().__init__()
        if plane_activation not in ("none", "tanh"):
            raise ValueError(f"plane_activation {plane_activation!r}: 'none' or 'tanh'")
        self.resolutions = tuple(int(r) for r in resolutions)
        self.ranks = tuple(int(r) for r in ranks)
        self.compute_dtype = compute_dtype
        self.plane_activation = plane_activation
        self.amp_prior = float(amp_prior)
        self.planes = nn.ParameterList(
            [nn.Parameter(torch.ones(6, R, R, rank))
             for R, rank in zip(self.resolutions, self.ranks)]
        )

    @property
    def output_dim(self) -> int:
        return sum(self.ranks)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "KPlanesEncoder":
        """Planes ``1 + 0.1 N(0, 1)``, the three time planes exactly 1."""
        for plane in self.planes:
            noise = torch.randn(plane.shape, generator=generator, device=generator.device)
            plane.copy_(1.0 + 0.1 * noise)
            plane[3:] = 1.0
        return self

    def forward(self, q: torch.Tensor, planes: Optional[Sequence[torch.Tensor]] = None):
        """(N, 4) points ``(x, y, z, t)`` in [0, 1]^4 (clamped) -> (N,
        sum(ranks)) features; ``planes`` replaces the module's own."""
        q = q.clamp(0.0, 1.0)
        planes = self.planes if planes is None else planes
        return torch.cat([self.level(q, plane) for plane in planes], dim=-1)

    def level(self, q: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
        """One level, the product of six bilinear lookups, on (N, 4) points
        in [0, 1]^4.

        Each coordinate's two hat weights ``max(0, 1 - |pos - j|)`` at
        ``pos = q (R - 1)`` are formed in f32 and rounded to the compute
        dtype, as JAX forms its hat rows; then, as in the jitted level: the
        lerp along the plane's first axis, ``t = w0 P[i] + w1 P[i + 1]``,
        is rounded once (the dot's output); the lerp of ``t`` along the
        second axis is summed in f32 and rounded once; and the running
        product is rounded after each multiply but the last, whose f32
        result the level returns (XLA drops the round trip through the
        compute dtype before the output's f32 convert)."""
        R, rank = plane.shape[1], plane.shape[-1]
        cd = self.compute_dtype
        pos = q.t() * (R - 1)  # (4, N)
        i0 = torch.floor(pos).clamp(0, R - 2)
        w = torch.stack([
            (1.0 - (pos - i0).abs()).clamp_min(0.0),
            (1.0 - (pos - (i0 + 1)).abs()).clamp_min(0.0),
        ])  # (2, 4, N): the weights of rows i0 and i0 + 1
        w = _round(w, cd)
        i0 = i0.long()
        table = _round(plane, cd).reshape(6 * R * R, rank)
        out = None
        for p, (a, b) in enumerate(PAIRS):
            base = p * R * R + i0[a] * R + i0[b]  # (N,): texel (i0_a, i0_b)
            texels = table[torch.stack([base, base + R, base + 1, base + R + 1])]
            t0 = _round(w[0, a, :, None] * texels[0] + w[1, a, :, None] * texels[1], cd)
            t1 = _round(w[0, a, :, None] * texels[2] + w[1, a, :, None] * texels[3], cd)
            f = _round(t0 * w[0, b, :, None] + t1 * w[1, b, :, None], cd)
            if self.plane_activation == "tanh":
                f = _round(1.0 + torch.tanh(f - 1.0), cd)
            if out is not None:
                f = out * f if p == len(PAIRS) - 1 else _round(out * f, cd)
            out = f
        return out

    def param_regularizer(self, planes: Optional[Sequence[torch.Tensor]] = None):
        """The K-Planes priors, summed over levels: total variation along
        both axes of every plane, the second difference along the time
        axis of the space-time planes, and with ``amp_prior`` the amplitude
        prior.  ``planes`` replaces the module's own."""
        terms = []
        for plane in self.planes if planes is None else planes:
            du = plane[:, 1:] - plane[:, :-1]
            dv = plane[:, :, 1:] - plane[:, :, :-1]
            terms.append((du * du).mean() + (dv * dv).mean())
            t2 = plane[3:, :, 2:] - 2.0 * plane[3:, :, 1:-1] + plane[3:, :, :-2]
            terms.append((t2 * t2).mean())
            if self.amp_prior > 0.0:
                d1 = plane - 1.0
                terms.append(self.amp_prior * (d1 * d1).mean())
        return sum(terms)


class KPlanesRadianceField(FrameQuery, MLPField):
    """Dynamic radiance field over :class:`KPlanesEncoder` (levels 32/64 x
    rank 16/16), with :class:`~nerfacc_tpu_torch.models.ngp.MLPField`'s
    bias-free MLPs (density ``trunc_exp(raw - 1)``, zeroed outside the box
    when bounded; rgb from SH-16 of the view beside ``geo_feat_dim``
    geometry features, or from those alone without view directions).

    Args:
        aabb: the scene box (not cubified); bounded points are scaled to its
            [0, 1]^3, unbounded ones contracted to the unit sphere.
        unbounded: contract instead of zeroing the density outside ``aabb``.
        resolutions / ranks / plane_activation / amp_prior: the encoder's.
        compute_dtype: the encoder's and the MLPs' operand dtype.
        device: where the parameters live: the card unless the caller asks
            for another (the tests pass "cpu").
        geo_feat_dim / hidden_dim / use_viewdirs: the MLPs' (see
            :class:`~nerfacc_tpu_torch.models.ngp.MLPField`).
    """

    def __init__(
        self,
        aabb: Sequence[float] = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
        unbounded: bool = False,
        resolutions: Sequence[int] = (32, 64),
        ranks: Sequence[int] = (16, 16),
        compute_dtype=torch.bfloat16,
        plane_activation: str = "none",
        amp_prior: float = 0.0,
        device="cuda",
        geo_feat_dim: int = 15,
        hidden_dim: int = 64,
        use_viewdirs: bool = True,
    ):
        encoder = KPlanesEncoder(resolutions, ranks, compute_dtype, plane_activation,
                                 amp_prior)
        super().__init__(list(aabb), unbounded, encoder, compute_dtype,
                         hidden_dim=hidden_dim, geo_feat_dim=geo_feat_dim,
                         use_viewdirs=use_viewdirs)
        self.to(device)

    @property
    def max_eval_chunk(self) -> int:
        """The occupancy refresh's chunk, the JAX field's: at most 1.25e8
        over the sum of ``R * rank`` (JAX materialises a (6, N, R * rank)
        dot output a level), at least 2^12, rounded down to a power of 2."""
        per = sum(R * r for R, r in zip(self.encoder.resolutions, self.encoder.ranks))
        cap = max(2**12, int(1.25e8) // max(per, 1))
        return 1 << (cap.bit_length() - 1)

    def query_density(self, x: torch.Tensor, t: torch.Tensor, return_feat: bool = False):
        """(N, 3) points at times (N, 1) or (N,) -> (N, 1) density [, (N,
        geo_feat_dim) geometry features]."""
        u, selector = self.normalize(x)
        tt = t.reshape(-1, 1).to(torch.float32).clamp(0.0, 1.0)
        feats = self.encoder(torch.cat([u, tt], dim=-1))
        return self.density_from_features(feats, selector, return_feat)

    def param_regularizer(self, params: Optional[Dict[str, torch.Tensor]] = None):
        """The encoder's priors (weigh them with the trainer's
        ``field_reg_weight``); ``params``, a state dict, replaces the
        module's own planes."""
        planes = None
        if params is not None:
            planes = [params[f"encoder.planes.{i}"] for i in range(len(self.encoder.planes))]
        return self.encoder.param_regularizer(planes)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                condition: Optional[torch.Tensor] = None):
        """(N, 3) points ``x`` at times (N, 1) seen along unit directions
        ``condition`` (None without view directions) -> (rgb (N, 3),
        density (N, 1))."""
        density, embedding = self.query_density(x, t, return_feat=True)
        return self.query_rgb(condition, embedding), density
