"""Instant-NGP radiance field, and the pieces the NGP-style fields share:
activations, contraction, MLPs and the field around an encoder.

PyTorch counterpart of nerfacc_tpu/models/ngp.py.  Ported: ``trunc_exp``,
``contract_to_unisphere``, the bias-free MLPs, ``_cubify_aabb`` and
``NGPRadianceField`` (view directions always on) and the proposal path's
``NGPDensityField``, both on :class:`DensityField`'s and :class:`MLPField`'s
shared pieces, and the time-dependent fields' :class:`FrameQuery`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..utils.fp import fma_f32
from .encoders import HashGridEncoder, spherical_harmonics_16


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


def _box_form(aabb: torch.Tensor) -> str:
    """How jitted XLA compiles the contraction's box map
    ``(x - lo) / (hi - lo) * 2 - 1`` for the constant box ``aabb`` (read off
    the HLO of the jitted JAX fields on its CPU backend): it folds the
    division into a product with the f32 reciprocal ``r`` and the doubling
    into ``s = 2 r``; with one ``s`` for all three axes it fuses
    ``(x - lo) * s - 1`` into a multiply-add, and where ``s`` is 1 and
    ``lo`` one value it drops the product and folds the two constant
    additions into one, ``x + (-lo - 1)``; with ``s`` differing between axes
    it rounds the product and the difference apart.  Worked out once for
    each box tensor (one host read)."""
    form = aabb.__dict__.get("_xla_box_form")
    if form is None:
        lo, hi = aabb[:3].double(), aabb[3:].double()
        s = (2.0 * (1.0 / (hi - lo).float())).tolist()
        if len(set(s)) > 1:
            form = "product"
        elif s[0] == 1.0 and len(set(lo.tolist())) == 1:
            form = "identity"
        else:
            form = "fma"
        aabb.__dict__["_xla_box_form"] = form
    return form


def contract_to_unisphere(x: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Mip-NeRF 360 scene contraction to the unit sphere, remapped to [0, 1],
    with the box map ``(x - lo) / (hi - lo) * 2 - 1`` in the rounding of the
    jitted JAX fields (:func:`_box_form`)."""
    lo, hi = aabb[..., :3], aabb[..., 3:]
    form = _box_form(aabb)
    s = 2.0 * (1.0 / (hi - lo))
    if form == "identity":
        x = x + (-lo - 1.0)
    elif form == "fma":
        x = fma_f32(x - lo, s.expand_as(x), torch.full_like(x, -1.0))
    else:
        x = (x - lo) * (1.0 / (hi - lo)) * 2 - 1  # aabb is at [-1, 1]
    mag = torch.linalg.norm(x, dim=-1, keepdim=True)
    mask = mag[..., 0] > 1
    safe_mag = mag.clamp_min(1e-6)
    contracted = (2 - 1 / safe_mag) * (x / safe_mag)
    x = torch.where(mask[..., None], contracted, x)
    return x / 4 + 0.5  # [-inf, inf] is at [0, 1]


def normalize_points(
    x: torch.Tensor, aabb: torch.Tensor, unbounded: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """World points -> (encoder coordinates, selector): contracted into the
    unit sphere with every point selected (:func:`contract_to_unisphere`),
    or scaled to the AABB's [0, 1]^3 with the points strictly inside it
    selected.  The bounded map keeps the quotient: jitted XLA multiplies by
    the box's f32 reciprocal there too, but that rounding moved the bench
    CP train step's gradients 1.4e-4 of their largest entry from the same
    step in f64 (against 1.4e-6 with the quotient;
    tests/test_torch_train.py)."""
    if unbounded:
        u = contract_to_unisphere(x, aabb)
        return u, torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    lo, hi = aabb[:3], aabb[3:]
    u = (x - lo) / (hi - lo)
    return u, ((u > 0.0) & (u < 1.0)).all(dim=-1)


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


# cuBLAS picks its f32 GEMM kernel by the problem's shape, and on an H100
# the kernels it takes for a few thousand rows sum a row's products in
# another order than those it takes for large batches: rows of a 4096-row
# batch differ in the last bit from the same rows in a 2^20-row batch, rows
# of a 10,000-row batch do not (scripts/diag_field_batch.py).  A bf16
# rounding in the next layer can grow that bit to a percent of a density,
# so a point's output would depend on the batch it came in (the eval
# renderer's late rounds are small).  On the card a smaller batch is padded
# to this many rows.
_GEMM_MIN_ROWS = 1 << 16


def _mlp_apply(
    weights: Sequence[torch.Tensor], x: torch.Tensor, compute_dtype=torch.bfloat16
) -> torch.Tensor:
    """Bias-free ReLU MLP with the JAX package's rounding contract.

    Every layer takes ``compute_dtype`` operands and returns an f32 result
    (``preferred_element_type=f32`` in JAX).  Operands are rounded to the
    compute dtype and multiplied as f32: a product of two bf16 values is
    exact in f32, so this is a bf16 matmul with f32 accumulation.  On the
    card the f32 matmul must not run in TF32
    (``torch.backends.cuda.matmul.allow_tf32 = False``, the default), and
    ``x`` (rows, features) is padded to ``_GEMM_MIN_ROWS`` rows, so that a
    row's output does not depend on the batch.
    """
    n = x.shape[0]
    if x.is_cuda and n < _GEMM_MIN_ROWS:
        x = torch.cat([x, x.new_zeros((_GEMM_MIN_ROWS - n,) + x.shape[1:])])
    x = _round(x, compute_dtype)
    last = len(weights) - 1
    for i, w in enumerate(weights):
        x = x @ _round(w, compute_dtype)
        if i < last:
            x = _round(torch.relu(x), compute_dtype)
    return x[:n]


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return x
    return x.to(dtype).to(torch.float32)


def _weights(dims: Sequence[int]) -> nn.ParameterList:
    return nn.ParameterList(
        [nn.Parameter(torch.zeros(i, o)) for i, o in zip(dims[:-1], dims[1:])]
    )


def _cubify_aabb(aabb: Sequence[float]) -> torch.Tensor:
    """The cube with ``aabb``'s centre and its longest side (f32)."""
    aabb = torch.as_tensor(list(aabb), dtype=torch.float32)
    center = (aabb[:3] + aabb[3:]) / 2.0
    size = torch.max(aabb[3:] - aabb[:3])
    return torch.cat([center - size / 2.0, center + size / 2.0])


class MLPField(nn.Module):
    """A radiance field from an encoder and two small bias-free MLPs.

    ``density = trunc_exp(raw - 1)`` of the base MLP on the encoder's
    features, zeroed outside the AABB (bounded scenes); rgb is a sigmoid of
    the head MLP on [SH-16(dir), geo feats].  The MLPs are 64 wide with 15
    geometry features, as in the JAX package.

    Args:
        aabb: the scene box (6 floats) the encoder's [0, 1]^3 spans.
        unbounded: contract points to the unit sphere instead of zeroing
            the density outside ``aabb``.
        encoder: an ``nn.Module`` with ``output_dim``, ``init(generator)``
            and ``forward(u) -> (N, output_dim)``.
        compute_dtype: the MLPs' operand dtype (f32 results).
        base_extra_dim: inputs of the base MLP after the encoder's features
            (a time embedding).
    """

    HIDDEN_DIM = 64
    GEO_FEAT_DIM = 15

    def __init__(self, aabb, unbounded: bool, encoder: nn.Module, compute_dtype,
                 base_extra_dim: int = 0):
        super().__init__()
        self.register_buffer(
            "aabb", torch.as_tensor(aabb, dtype=torch.float32), persistent=False
        )
        self.unbounded = unbounded
        self.compute_dtype = compute_dtype
        self.encoder = encoder
        hidden, geo = self.HIDDEN_DIM, self.GEO_FEAT_DIM
        self.base_dims = [encoder.output_dim + base_extra_dim, hidden, 1 + geo]
        self.head_dims = [16 + geo, hidden, hidden, 3]
        self.mlp_base = _weights(self.base_dims)
        self.mlp_head = _weights(self.head_dims)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MLPField":
        """Draw every parameter from ``generator`` (JAX's distributions)."""
        self.encoder.init(generator)
        for params, dims in (
            (self.mlp_base, self.base_dims), (self.mlp_head, self.head_dims)
        ):
            for p, w in zip(params, _mlp_init(generator, dims)):
                p.copy_(w)
        return self

    def normalize(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """World points -> (encoder coordinates, inside-the-AABB selector)."""
        return normalize_points(x, self.aabb, self.unbounded)

    def query_density(self, x: torch.Tensor, return_feat: bool = False):
        u, selector = self.normalize(x)
        return self.density_from_features(self.encoder(u), selector, return_feat)

    def density_from_features(
        self, feats: torch.Tensor, selector: torch.Tensor, return_feat: bool = False
    ):
        """Base MLP on encoder features: (N, 1) density [, (N, geo) feats]."""
        h = _mlp_apply(self.mlp_base, feats, self.compute_dtype)
        raw_density, geo_feat = h[..., :1], h[..., 1:]
        density = trunc_exp(raw_density - 1.0) * selector[..., None]
        if return_feat:
            return density, geo_feat
        return density

    def query_rgb(self, dirs: torch.Tensor, embedding: torch.Tensor) -> torch.Tensor:
        h = torch.cat([spherical_harmonics_16(dirs), embedding], dim=-1)
        return torch.sigmoid(_mlp_apply(self.mlp_head, h, self.compute_dtype))

    def forward(self, positions: torch.Tensor, directions: torch.Tensor):
        """(N, 3) points and unit directions -> (rgb (N, 3), density (N, 1))."""
        density, embedding = self.query_density(positions, return_feat=True)
        return self.query_rgb(directions, embedding), density


class FrameQuery:
    """``query_opacity`` of a time-dependent field (one with
    ``query_density(x, t)``): the occupancy refresh's query."""

    def query_opacity(
        self,
        x: torch.Tensor,
        timestamps: torch.Tensor,
        step_size: float,
        frame_idx: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``density * step_size`` at one frame time per point: frame
        ``frame_idx`` (N,) of ``timestamps`` (n_frames, 1), or frames drawn
        uniformly from ``generator`` when none are given (the JAX fields
        draw them inside)."""
        if frame_idx is None:
            frame_idx = torch.randint(
                0, timestamps.shape[0], (x.shape[0],), generator=generator, device=x.device
            )
        return self.query_density(x, timestamps[frame_idx]) * step_size


class NGPRadianceField(MLPField):
    """Instant-NGP radiance field: a hash grid (16 levels x 2 features,
    2^19 rows per level, resolutions 16..4096) through kernels G6/G7 on the
    card, a 32 -> 64 -> 16 density MLP and a 31 -> 64 -> 64 -> 3 colour MLP.

    The AABB is cubified (its centre and longest side), as in the JAX
    package; encoder coordinates are not clamped.
    """

    def __init__(
        self,
        aabb: Sequence[float],
        unbounded: bool = False,
        base_resolution: int = 16,
        max_resolution: int = 4096,
        n_levels: int = 16,
        log2_hashmap_size: int = 19,
        compute_dtype=torch.bfloat16,
    ):
        encoder = HashGridEncoder(
            n_levels=n_levels,
            n_features_per_level=2,
            log2_hashmap_size=log2_hashmap_size,
            base_resolution=base_resolution,
            max_resolution=max_resolution,
        )
        super().__init__(_cubify_aabb(aabb), unbounded, encoder, compute_dtype)


class DensityField(nn.Module):
    """A density-only field for proposal resampling: an encoder and a
    bias-free ``[encoder.output_dim, hidden_dim, 1]`` MLP,
    ``density = trunc_exp(raw - 1)``, zeroed outside the AABB (bounded) or
    on contracted points (unbounded).  Positions carry no gradient (the
    proposal path builds them from detached sample bounds).
    """

    def __init__(self, aabb, unbounded: bool, encoder: nn.Module, hidden_dim: int,
                 compute_dtype):
        super().__init__()
        self.register_buffer(
            "aabb", torch.as_tensor(list(aabb), dtype=torch.float32), persistent=False
        )
        self.unbounded = unbounded
        self.compute_dtype = compute_dtype
        self.encoder = encoder
        self.base_dims = [encoder.output_dim, hidden_dim, 1]
        self.mlp_base = _weights(self.base_dims)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "DensityField":
        """Draw every parameter from ``generator`` (JAX's distributions)."""
        self.encoder.init(generator)
        for p, w in zip(self.mlp_base, _mlp_init(generator, self.base_dims)):
            p.copy_(w)
        return self

    def forward(self, positions: torch.Tensor) -> torch.Tensor:
        """(N, 3) world points -> (N, 1) density."""
        u, selector = normalize_points(positions, self.aabb, self.unbounded)
        raw = _mlp_apply(self.mlp_base, self.encoder(u), self.compute_dtype)
        return trunc_exp(raw - 1.0) * selector[..., None]


class NGPDensityField(DensityField):
    """Instant-NGP density field for proposal resampling (PyTorch
    counterpart of nerfacc_tpu/models/ngp.py::NGPDensityField): a hash grid
    of 5 levels x 2 features, 2^17 rows per level, resolutions 16..128,
    through kernels G6/G7 on the card, and a 10 -> 64 -> 1 MLP.  Unlike
    :class:`NGPRadianceField` the AABB is taken as given (not cubified).
    """

    def __init__(
        self,
        aabb: Sequence[float],
        unbounded: bool = False,
        base_resolution: int = 16,
        max_resolution: int = 128,
        n_levels: int = 5,
        log2_hashmap_size: int = 17,
        hidden_dim: int = 64,
        compute_dtype=torch.bfloat16,
    ):
        encoder = HashGridEncoder(
            n_levels=n_levels,
            n_features_per_level=2,
            log2_hashmap_size=log2_hashmap_size,
            base_resolution=base_resolution,
            max_resolution=max_resolution,
        )
        super().__init__(aabb, unbounded, encoder, hidden_dim, compute_dtype)
