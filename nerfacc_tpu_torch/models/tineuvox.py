"""TiNeuVox-family dynamic radiance field (PyTorch counterpart of
nerfacc_tpu/models/tineuvox.py).

A small deformation MLP warps each sample by ``tanh(raw) * deform_scale``
from its position and time encodings; the warped point is read from the CP
line levels through the per-axis hat interpolation (kernels G8-G10 on the
card), and from the optional tri-plane levels through the CP encoder's
four-texel lookups, whose coordinate gradients are the deformation net's
only training signal; the base MLP reads the grid features beside the time
encoding, and the colour head the SH-16 view encoding beside the geometry
features (or those alone without view directions).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from .cp_field import CPGridEncoder, plane_eval_chunk
from .encoders import SinusoidalEncoder
from .ngp import FrameQuery, MLPField, _mlp_apply, _mlp_init, _weights


class TiNeuVoxRadianceField(FrameQuery, MLPField):
    """Time-aware neural-voxel field at the JAX package's defaults.

    Args:
        aabb: the scene box the encoder's [0, 1]^3 spans (not cubified).
        resolutions / ranks: CP line levels (32/128/512, ranks 16/16/32).
        deform_width / deform_depth: the bias-free deformation MLP,
            (27 + 9) -> 64 x 3 -> 3.
        deform_scale: the warp bound, ``dx = tanh(raw) * deform_scale``.
        compute_dtype: the MLPs' and the plane levels' operand dtype (f32
            results); the line levels round to bf16 whatever it is (the hat
            kernels' contract).
        device: where the parameters live: the card unless the caller asks
            for another (the tests pass "cpu").
        plane_resolutions / plane_ranks: tri-plane levels after the line
            levels, combined by their product (the CP encoder's
            ``plane_mode="product"``, as in the JAX field).
        geo_feat_dim / hidden_dim / use_viewdirs: the MLPs' (see
            :class:`~nerfacc_tpu_torch.models.ngp.MLPField`).
    """

    def __init__(
        self,
        aabb: Sequence[float] = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5),
        resolutions: Sequence[int] = (32, 128, 512),
        ranks: Sequence[int] = (16, 16, 32),
        deform_width: int = 64,
        deform_depth: int = 3,
        deform_scale: float = 0.3,
        compute_dtype=torch.bfloat16,
        device: Union[str, torch.device] = "cuda",
        plane_resolutions: Sequence[int] = (),
        plane_ranks: Sequence[int] = (),
        geo_feat_dim: int = 15,
        hidden_dim: int = 64,
        use_viewdirs: bool = True,
    ):
        posi_encoder = SinusoidalEncoder(3, 0, 4, True)
        time_encoder = SinusoidalEncoder(1, 0, 4, True)
        encoder = CPGridEncoder(resolutions, ranks, compute_dtype, use_pallas=True,
                                plane_resolutions=plane_resolutions, plane_ranks=plane_ranks)
        super().__init__(
            list(aabb), False, encoder, compute_dtype,
            base_extra_dim=time_encoder.latent_dim, hidden_dim=hidden_dim,
            geo_feat_dim=geo_feat_dim, use_viewdirs=use_viewdirs,
        )
        self.posi_encoder, self.time_encoder = posi_encoder, time_encoder
        self.deform_scale = deform_scale
        self.deform_dims = (
            [posi_encoder.latent_dim + time_encoder.latent_dim]
            + [deform_width] * deform_depth + [3]
        )
        self.deform = _weights(self.deform_dims)
        self.to(device)

    @property
    def max_eval_chunk(self) -> int:
        """The occupancy refresh's chunk, the JAX field's
        (:func:`~nerfacc_tpu_torch.models.cp_field.plane_eval_chunk`)."""
        return plane_eval_chunk(self.encoder)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TiNeuVoxRadianceField":
        """JAX's distributions: the deformation MLP's output layer scaled by
        1e-4 (the scene starts rigid), lines ``1 + 0.1 N(0, 1)``, the other
        weights ``U(-a, a)``."""
        weights = _mlp_init(generator, self.deform_dims)
        weights[-1] = weights[-1] * 1e-4
        for p, w in zip(self.deform, weights):
            p.copy_(w)
        return super().init(generator)

    def warp(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The offset ``tanh(raw) * deform_scale`` of points (N, 3) at times
        (N, 1), in world units."""
        h = torch.cat([self.posi_encoder(x), self.time_encoder(t)], dim=-1)
        raw = _mlp_apply(self.deform, h, self.compute_dtype)
        return torch.tanh(raw) * self.deform_scale

    def time_features(self, t: torch.Tensor) -> torch.Tensor:
        """The time encoding the base MLP reads beside the grid features."""
        return self.time_encoder(t.clamp(0.0, 1.0))

    def query_density(self, x: torch.Tensor, t: torch.Tensor, return_feat: bool = False):
        """(N, 3) points at times (N, 1) or (N,) -> (N, 1) density
        [, (N, geo_feat_dim) geometry features]."""
        t = t.reshape(-1, 1).to(torch.float32)
        u, selector = self.normalize(x + self.warp(x, t))
        feats = torch.cat([self.encoder(u), self.time_features(t)], dim=-1)
        return self.density_from_features(feats, selector, return_feat)

    def param_regularizer(self, params: Optional[Dict[str, torch.Tensor]] = None):
        """Total variation of the line and plane tables (weigh it with the
        trainer's ``field_reg_weight``); ``params``, a state dict, replaces
        the module's own tables."""
        if params is None:
            return self.encoder.param_regularizer()
        tables = {
            name: [params[f"encoder.{name}.{i}"] for i in range(len(getattr(self.encoder, name)))]
            for name in ("lines", "planes", "plane_lines")
        }
        return self.encoder.param_regularizer(**tables)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                condition: Optional[torch.Tensor] = None):
        """(N, 3) points ``x`` at times (N, 1) seen along unit directions
        ``condition`` (None without view directions) -> (rgb (N, 3),
        density (N, 1))."""
        density, embedding = self.query_density(x, t, return_feat=True)
        return self.query_rgb(condition, embedding), density
