"""Input encoders: the multiresolution hash grid, the sinusoidal
(positional) encoding with BARF's coarse-to-fine window, and the
view-direction encoding (PyTorch counterpart of
nerfacc_tpu/models/encoders.py)."""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from ..ops.hash_encode import hash_encode


class HashGridEncoder(nn.Module):
    """Multiresolution hash-grid encoder (Instant-NGP), through kernels
    G6/G7 on the card (:func:`~nerfacc_tpu_torch.ops.hash_encode.hash_encode`).

    Args:
        n_levels: resolution levels (L).
        n_features_per_level: features per level (F).
        log2_hashmap_size: log2 of the rows per level (T).
        base_resolution / max_resolution: coarsest and finest resolution.

    The table gradient is the exact scatter sum (the JAX package's
    ``table_grad`` modes give the same values); positions get no gradient.
    """

    def __init__(
        self,
        n_levels: int = 16,
        n_features_per_level: int = 2,
        log2_hashmap_size: int = 19,
        base_resolution: int = 16,
        max_resolution: int = 4096,
    ):
        super().__init__()
        self.n_levels = n_levels
        self.n_features_per_level = n_features_per_level
        self.log2_hashmap_size = log2_hashmap_size
        self.base_resolution = base_resolution
        self.max_resolution = max_resolution
        self.table = nn.Parameter(
            torch.zeros(n_levels, self.table_size, n_features_per_level)
        )

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def output_dim(self) -> int:
        return self.n_levels * self.n_features_per_level

    @property
    def resolutions(self) -> Tuple[int, ...]:
        """``floor(base * growth^l)``, growth the L-1'th root of max/base,
        evaluated as the JAX package does (the finest can fall one short)."""
        if self.n_levels == 1:
            return (self.base_resolution,)
        growth = math.exp(
            (math.log(self.max_resolution) - math.log(self.base_resolution))
            / (self.n_levels - 1)
        )
        return tuple(
            int(math.floor(self.base_resolution * growth**l))
            for l in range(self.n_levels)
        )

    @torch.no_grad()
    def init(self, generator: torch.Generator, dtype=torch.float32) -> "HashGridEncoder":
        """Table ``U(-1e-4, 1e-4)`` (tcnn's hash-grid init), drawn in f32
        and held in ``dtype``, the table's dtype from then on as in the JAX
        encoder's ``init(key, dtype)``.  Kernels G6/G7 read f32 tables and
        raise on another; the plain versions on the CPU take any."""
        u = torch.rand(self.table.shape, generator=generator, device=generator.device)
        u = u * 2e-4 - 1e-4
        if self.table.dtype != dtype:
            self.table.data = u.to(device=self.table.device, dtype=dtype)
        else:
            self.table.copy_(u)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., 3) points, [0, 1]^3 inside the grid (not clamped) ->
        (..., L*F) features."""
        feats = hash_encode(x.reshape(-1, 3), self.table, self.resolutions)
        return feats.reshape(x.shape[:-1] + (self.output_dim,))


class SinusoidalEncoder(nn.Module):
    """Positional encoding ``[x, sin(2^k x), cos(2^k x)]`` for ``k`` in
    ``[min_deg, max_deg)``, in the JAX package's layout: the scaled inputs
    degree-major (``xb[..., k * x_dim + j] = 2^k x_j``), then
    ``sin(cat([xb, xb + pi/2]))`` (the cosines as shifted sines), with the
    identity first.

    Args:
        x_dim: input width.
        min_deg / max_deg: the frequency range.
        use_identity: put ``x`` itself first.
    """

    def __init__(self, x_dim: int, min_deg: int = 0, max_deg: int = 10,
                 use_identity: bool = True):
        super().__init__()
        self.x_dim, self.min_deg, self.max_deg = x_dim, min_deg, max_deg
        self.use_identity = use_identity
        # a buffer, so that it moves with the module and no call copies it
        # from the host
        self.register_buffer(
            "scales", torch.tensor([2.0**i for i in range(min_deg, max_deg)]),
            persistent=False,
        )

    @property
    def latent_dim(self) -> int:
        return (int(self.use_identity) + (self.max_deg - self.min_deg) * 2) * self.x_dim

    def forward(self, x: torch.Tensor, alpha=None) -> torch.Tensor:
        """(..., x_dim) -> (..., latent_dim); ``alpha`` enables BARF's
        coarse-to-fine window.

        With ``alpha`` set (a scalar in ``[0, max_deg - min_deg]``), band
        ``k`` (0-based from ``min_deg``) is weighted by ``(1 - cos(pi *
        clip(alpha - k, 0, 1))) / 2``, on its sines and its shifted cosines
        alike; the identity part is never windowed.  The cosine is taken in
        f64 of the f32 argument and rounded once, as the sine is."""
        if self.max_deg == self.min_deg:
            return x
        # the width is spelled out: -1 is ambiguous for an empty batch
        xb = (x[..., None, :] * self.scales[:, None]).reshape(
            x.shape[:-1] + (self.scales.numel() * x.shape[-1],))
        args = torch.cat([xb, xb + 0.5 * math.pi], dim=-1)
        # the sine of the f32 arguments in f64, rounded once: the correctly
        # rounded f32 sine, whatever accuracy the library's f32 vector sine
        # runs at (on the CPU PyTorch takes it from MKL's vector math, which
        # has computed a chunk of it at ~11 correct bits in a test process)
        latent = torch.sin(args.double()).to(args.dtype)
        if alpha is not None:
            k = torch.arange(self.scales.numel(), dtype=latent.dtype, device=latent.device)
            arg = math.pi * torch.clamp(alpha - k, 0.0, 1.0)
            w = 0.5 * (1.0 - torch.cos(arg.double()).to(latent.dtype))
            w = w.repeat_interleave(x.shape[-1])  # the degree-major layout of xb
            latent = latent * torch.cat([w, w])
        if self.use_identity:
            latent = torch.cat([x, latent], dim=-1)
        return latent


def spherical_harmonics_16(d: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics basis up to degree 4 (16 components).

    Args:
        d: (..., 3) unit view directions.

    Returns:
        (..., 16) basis values.
    """
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack(
        [
            0.28209479177387814 * torch.ones_like(x),
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ],
        dim=-1,
    )
