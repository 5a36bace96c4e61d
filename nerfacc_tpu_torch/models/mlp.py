"""MLP radiance fields: vanilla NeRF, and T-NeRF and NDRT for dynamic scenes.

PyTorch counterpart of nerfacc_tpu/models/mlp.py.  Every layer carries a
bias; a product takes ``compute_dtype`` operands with an f32 result
(``preferred_element_type=f32`` in JAX): f32 by default, and with
``torch.bfloat16`` the operands are rounded to bf16 and multiplied in f32,
whose products of bf16 values are exact.  On the card the f32 matmuls must
not run in TF32 (``NGPOccTrainer`` turns it off).  Each field is an
``nn.Module`` whose state dict follows the JAX parameter tree's paths
(:mod:`~nerfacc_tpu_torch.utils.jax_bridge` moves them), with
``init(generator)`` drawing JAX's distributions.  The vanilla field takes
BARF's coarse-to-fine ``pe_alpha`` window.
"""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch import nn

from .encoders import SinusoidalEncoder
from .ngp import FrameQuery, _round


class Linear(nn.Module):
    """``x @ w + b`` with ``w`` (in, out), JAX's layout, the operands in
    ``compute_dtype`` and an f32 result."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(in_dim, out_dim))
        self.b = nn.Parameter(torch.zeros(out_dim))

    @torch.no_grad()
    def init(self, generator: torch.Generator, scale: Optional[float] = None) -> "Linear":
        """``w`` Xavier-uniform, or ``U(0, scale)`` when ``scale`` is set;
        ``b`` zero."""
        u = torch.rand(self.w.shape, generator=generator, device=generator.device)
        if scale is None:
            a = (6.0 / sum(self.w.shape)) ** 0.5
            self.w.copy_(u * (2 * a) - a)
        else:
            self.w.copy_(u * scale)
        self.b.zero_()
        return self

    def forward(self, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
        return _round(x, compute_dtype) @ _round(self.w, compute_dtype) + self.b


def _skips(skip_layer: Optional[int], i: int) -> bool:
    """Whether the input is concatenated after hidden layer ``i``'s ReLU."""
    return skip_layer is not None and i % skip_layer == 0 and i > 0


class MLP(nn.Module):
    """ReLU MLP with skip connections: after hidden layer ``i``'s ReLU, for
    ``i`` a positive multiple of ``skip_layer``, the features become
    ``[x, inputs]``; an output layer (no activation) when
    ``output_enabled``, initialised ``U(0, output_init_scale)`` when that
    is set."""

    def __init__(
        self,
        input_dim: int,
        output_dim: Optional[int] = None,
        net_depth: int = 8,
        net_width: int = 256,
        skip_layer: Optional[int] = 4,
        output_enabled: bool = True,
        output_init_scale: Optional[float] = None,
        compute_dtype=torch.float32,
    ):
        super().__init__()
        self.input_dim, self.output_dim = input_dim, output_dim
        self.net_depth, self.net_width, self.skip_layer = net_depth, net_width, skip_layer
        self.output_enabled = output_enabled
        self.output_init_scale = output_init_scale
        self.compute_dtype = compute_dtype
        layers, in_features = [], input_dim
        for i in range(net_depth):
            layers.append(Linear(in_features, net_width))
            in_features = net_width + (input_dim if _skips(skip_layer, i) else 0)
        self.hidden = nn.ModuleList(layers)
        if output_enabled:
            self.output = Linear(in_features, output_dim)
        self.final_dim = output_dim if output_enabled else in_features

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MLP":
        for layer in self.hidden:
            layer.init(generator)
        if self.output_enabled:
            self.output.init(generator, self.output_init_scale)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x
        for i, layer in enumerate(self.hidden):
            x = torch.relu(layer(x, self.compute_dtype))
            if _skips(self.skip_layer, i):
                x = torch.cat([x, inputs], dim=-1)
        if self.output_enabled:
            x = self.output(x, self.compute_dtype)
        return x


class NerfMLP(nn.Module):
    """The NeRF trunk: a base MLP, a one-layer sigma head, and the
    view-conditioned colour branch (a bottleneck of the base features beside
    the condition, then an MLP to 3)."""

    def __init__(
        self,
        input_dim: int,
        condition_dim: int,
        net_depth: int = 8,
        net_width: int = 256,
        skip_layer: Optional[int] = 4,
        net_depth_condition: int = 1,
        net_width_condition: int = 128,
        compute_dtype=torch.float32,
    ):
        super().__init__()
        self.base = MLP(input_dim, net_depth=net_depth, net_width=net_width,
                        skip_layer=skip_layer, output_enabled=False,
                        compute_dtype=compute_dtype)
        hidden = self.base.final_dim
        self.sigma = MLP(hidden, 1, net_depth=0, skip_layer=None, compute_dtype=compute_dtype)
        self.bottleneck = MLP(hidden, net_width, net_depth=0, skip_layer=None,
                              compute_dtype=compute_dtype)
        self.rgb = MLP(net_width + condition_dim, 3, net_depth=net_depth_condition,
                       net_width=net_width_condition, skip_layer=None,
                       compute_dtype=compute_dtype)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "NerfMLP":
        for mlp in (self.base, self.sigma, self.bottleneck, self.rgb):
            mlp.init(generator)
        return self

    def query_density(self, x: torch.Tensor) -> torch.Tensor:
        return self.sigma(self.base(x))

    def forward(self, x: torch.Tensor, condition: Optional[torch.Tensor] = None):
        """(raw rgb, raw sigma); ``condition`` broadcast over ``x``'s
        leading axes."""
        h = self.base(x)
        raw_sigma = self.sigma(h)
        if condition is not None:
            if condition.shape[:-1] != h.shape[:-1]:
                condition = condition.reshape(
                    condition.shape[:1] + (1,) * (h.dim() - condition.dim())
                    + condition.shape[-1:]
                ).expand(h.shape[:-1] + condition.shape[-1:])
            h = torch.cat([self.bottleneck(h), condition], dim=-1)
        return self.rgb(h), raw_sigma


class VanillaNeRFRadianceField(nn.Module):
    """The original NeRF field: an 8x256 MLP with a skip at layer 4 on the
    degree-10 encoding of the point, the view direction's degree-4 encoding
    beside a 256-wide bottleneck, 128 wide to rgb.  ``density =
    relu(sigma)``; rgb a sigmoid.

    Args:
        net_depth / net_width / skip_layer: the base MLP.
        net_depth_condition / net_width_condition: the colour MLP.
        compute_dtype: the products' operand dtype (f32 results).
        device: where the parameters live: the card unless the caller asks
            for another (the tests pass "cpu").
    """

    def __init__(
        self,
        net_depth: int = 8,
        net_width: int = 256,
        skip_layer: int = 4,
        net_depth_condition: int = 1,
        net_width_condition: int = 128,
        compute_dtype=torch.float32,
        device: Union[str, torch.device] = "cuda",
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.posi_encoder = SinusoidalEncoder(3, 0, 10, True)
        self.view_encoder = SinusoidalEncoder(3, 0, 4, True)
        self.mlp = NerfMLP(
            self.posi_encoder.latent_dim, self.view_encoder.latent_dim, net_depth,
            net_width, skip_layer, net_depth_condition, net_width_condition, compute_dtype,
        )
        self.to(device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "VanillaNeRFRadianceField":
        self.mlp.init(generator)
        return self

    def query_density(self, x: torch.Tensor, pe_alpha=None) -> torch.Tensor:
        """(N, 3) points -> (N, 1) ``relu(sigma)``; ``pe_alpha`` is BARF's
        coarse-to-fine window of the point's encoding (see
        :func:`~nerfacc_tpu_torch.models.pose.coarse_to_fine_alpha`; None:
        the full spectrum)."""
        return torch.relu(self.mlp.query_density(self.posi_encoder(x, pe_alpha)))

    def query_opacity(self, x: torch.Tensor, step_size: float) -> torch.Tensor:
        """``density * step_size``, the small-step form of ``1 - exp(-density
        * step_size)`` the JAX field uses."""
        return self.query_density(x) * step_size

    def forward(self, x: torch.Tensor, condition: Optional[torch.Tensor] = None,
                pe_alpha=None):
        """(N, 3) points ``x`` seen along unit directions ``condition`` ->
        (rgb (N, 3), density (N, 1)); ``pe_alpha`` as in
        :meth:`query_density`."""
        cond = self.view_encoder(condition) if condition is not None else None
        rgb, sigma = self.mlp(self.posi_encoder(x, pe_alpha), cond)
        return torch.sigmoid(rgb), torch.relu(sigma)


class _DynamicField(FrameQuery, nn.Module):
    """A warp of (point, time) in front of a vanilla NeRF; the occupancy
    refresh reads one frame time a point."""

    def warp(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def query_density(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """(N, 3) points at times (N, 1) -> (N, 1) density."""
        return self.nerf.query_density(self.warp(x, t.reshape(-1, 1)))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                condition: Optional[torch.Tensor] = None):
        """(N, 3) points ``x`` at times (N, 1) seen along unit directions
        ``condition`` -> (rgb (N, 3), density (N, 1))."""
        return self.nerf(self.warp(x, t.reshape(-1, 1)), condition)


class TNeRFRadianceField(_DynamicField):
    """T-NeRF: ``x + warp([PE4(x), PE4(t)])`` through a 4x64 MLP with a
    skip at layer 2, its output layer ``U(0, 1e-4)`` (the scene starts
    still), in front of the full :class:`VanillaNeRFRadianceField`."""

    def __init__(self, compute_dtype=torch.float32,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.posi_encoder = SinusoidalEncoder(3, 0, 4, True)
        self.time_encoder = SinusoidalEncoder(1, 0, 4, True)
        self.warp_mlp = MLP(
            self.posi_encoder.latent_dim + self.time_encoder.latent_dim, 3, net_depth=4,
            net_width=64, skip_layer=2, output_init_scale=1e-4, compute_dtype=compute_dtype,
        )
        self.nerf = VanillaNeRFRadianceField(compute_dtype=compute_dtype, device=device)
        self.to(device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "TNeRFRadianceField":
        self.warp_mlp.init(generator)
        self.nerf.init(generator)
        return self

    def warp(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The warped points (N, 3) of points (N, 3) at times (N, 1)."""
        return x + self.warp_mlp(torch.cat([self.posi_encoder(x), self.time_encoder(t)], -1))


class NDRTNeRFRadianceField(_DynamicField):
    """A dynamic field with an invertible deformation: three coupled blocks,
    each moving the third coordinate by an MLP of the first two and the time,
    then the first two by a 2-D rotation and translation that an MLP of the
    moved third coordinate and the time gives; the axes permute cyclically
    between blocks.  In front of the full :class:`VanillaNeRFRadianceField`.
    The rotation's sine and cosine are taken in f64 and rounded once (see
    :class:`~nerfacc_tpu_torch.models.encoders.SinusoidalEncoder`)."""

    def __init__(self, compute_dtype=torch.float32,
                 device: Union[str, torch.device] = "cuda"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.time_encoder = SinusoidalEncoder(1, 0, 4, True)
        self.posi_encoder_1 = SinusoidalEncoder(2, 0, 4, True)
        self.posi_encoder_2 = SinusoidalEncoder(1, 0, 4, True)
        t_lat = self.time_encoder.latent_dim
        self.warp1 = nn.ModuleList([
            MLP(self.posi_encoder_1.latent_dim + 64, 1, net_depth=2, net_width=128,
                skip_layer=None, output_init_scale=1e-4, compute_dtype=compute_dtype)
            for _ in range(3)
        ])
        self.warp2 = nn.ModuleList([
            MLP(self.posi_encoder_2.latent_dim + 64, 3, net_depth=1, net_width=128,
                skip_layer=None, output_init_scale=1e-4, compute_dtype=compute_dtype)
            for _ in range(3)
        ])
        self.time1 = nn.ModuleList([Linear(t_lat, 64) for _ in range(3)])
        self.time2 = nn.ModuleList([Linear(t_lat, 64) for _ in range(3)])
        self.nerf = VanillaNeRFRadianceField(compute_dtype=compute_dtype, device=device)
        self.to(device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "NDRTNeRFRadianceField":
        for group in (self.warp1, self.warp2, self.time1, self.time2):
            for module in group:
                module.init(generator)
        self.nerf.init(generator)
        return self

    def _block(self, x: torch.Tensor, t_enc: torch.Tensor, i: int) -> torch.Tensor:
        uv, w = x[:, :2], x[:, 2:]
        tfeat1 = self.time1[i](t_enc, self.compute_dtype)
        w = w + self.warp1[i](torch.cat([self.posi_encoder_1(uv), tfeat1], dim=-1))
        tfeat2 = self.time2[i](t_enc, self.compute_dtype)
        rt = self.warp2[i](torch.cat([self.posi_encoder_2(w), tfeat2], dim=-1))
        theta = rt[:, 0].double()
        c, s = torch.cos(theta).to(rt.dtype), torch.sin(theta).to(rt.dtype)
        p = uv - rt[:, 1:]
        uv = torch.stack([c * p[:, 0] - s * p[:, 1], s * p[:, 0] + c * p[:, 1]], dim=-1)
        return torch.cat([uv, w], dim=-1)

    def warp(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """The deformed points (N, 3) of points (N, 3) at times (N, 1)."""
        t_enc = self.time_encoder(t)
        x = self._block(x, t_enc, 0)
        x = self._block(x[..., [1, 2, 0]], t_enc, 1)
        return self._block(x[..., [2, 0, 1]], t_enc, 2)
