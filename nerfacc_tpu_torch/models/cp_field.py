"""CP-factorized radiance field (PyTorch counterpart of
nerfacc_tpu/models/cp_field.py).

Per resolution level, each axis has a line table (R, rank); a point's level
feature is the elementwise product of the three axes' linearly interpolated
rows, and the levels are concatenated.  Each level runs through
:func:`~nerfacc_tpu_torch.ops.cp_level.cp_level_encode` (kernels G1/G4 on
the card, no coordinate gradient), or with ``use_pallas=True`` through
:func:`~nerfacc_tpu_torch.ops.hat_matmul.hat_cp_level` (the hat route: one
launch of kernel G8 a level, G9 and G10 per axis, with a coordinate
gradient).  Tri-plane levels follow the line levels: three (xy, xz, yz)
planes a level, each read by a bilinear lookup of four texels (plain
PyTorch gathers, in the rounding of the jitted JAX level), combined by
their product (K-Planes) or, in TensoRF's vector-matrix mode, each times a
line of its complementary axis and concatenated.
:class:`TensoRFRadianceField` is the field with TensoRF's levels;
:class:`CPDensityField` the proposal path's density-only field.

Tensor parallelism (JAX's ``tp_axis``): given a ``tp_group`` of n ranks, a
line field keeps rank ``m``'s slice of every level's rank dimension, (3, R,
rank / n), and the matching rows of the first base-MLP weight in
shard-major order (``parallel.tp.tp_w1_permutation``); layer 0's partial
products are summed over the group (:class:`TPAllReduce`, whose backward is
the identity) before the activation, and every later layer is replicated.
Not ported: the TPU layout options (``kernel``, ``block_size``,
``block_min_res``, ``remat``, ``fused_levels``) and the mesh axis name
``tp_axis``, whose role ``tp_group`` takes.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ..ops.cp_level import cp_level_encode
from ..ops.hat_matmul import hat_cp_level
from .ngp import DensityField, MLPField, _round

# (xy, xz, yz): the axes of each plane; the VM line of a plane takes the
# third, complementary axis (z, y, x)
PLANE_PAIRS = ((0, 1), (0, 2), (1, 2))
PLANE_LINE_AXES = (2, 1, 0)


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a (k, N) row index: (k, N, width).  On the CPU its
    backward sums each row's cotangents serially, in sample order
    (``index_add_`` over the (N, k) flattening), where ``index_put_``'s
    accumulation adds in parallel and rounds differently from run to run.
    On the card ``index_put_`` sorts and sums in a fixed order."""
    if table.is_cuda:
        return table[idx]
    k, n = idx.shape
    return table.index_select(0, idx.t().reshape(-1)).view(n, k, -1).transpose(0, 1)


class CPGridEncoder(nn.Module):
    """Multi-resolution CP line encoder, with optional tri-plane levels.

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
        plane_resolutions / plane_ranks: tri-plane levels after the line
            levels, each three (R, R, rank) planes (xy, xz, yz).
        plane_mode: "product", the three plane features' product (rank
            outputs a level), or "vm", TensoRF's vector-matrix mode: each
            plane feature times its complementary axis's line feature (a
            (3, R, rank) ``plane_lines`` table a level), concatenated (3 *
            rank outputs a level).
    """

    def __init__(
        self,
        resolutions: Sequence[int] = (32, 128, 512),
        ranks: Sequence[int] = (32, 32, 32),
        compute_dtype=torch.bfloat16,
        use_pallas: bool = False,
        plane_resolutions: Sequence[int] = (),
        plane_ranks: Sequence[int] = (),
        plane_mode: str = "product",
    ):
        super().__init__()
        if plane_mode not in ("product", "vm"):
            raise ValueError(f"plane_mode {plane_mode!r}: 'product' or 'vm'")
        if len(plane_resolutions) != len(plane_ranks):
            raise ValueError("one plane rank per plane resolution")
        self.resolutions = tuple(int(r) for r in resolutions)
        self.ranks = tuple(int(r) for r in ranks)
        self.plane_resolutions = tuple(int(r) for r in plane_resolutions)
        self.plane_ranks = tuple(int(r) for r in plane_ranks)
        self.plane_mode = plane_mode
        self.compute_dtype = compute_dtype
        self.use_pallas = use_pallas
        self.lines = nn.ParameterList(
            [
                nn.Parameter(torch.ones(3, R, rank))
                for R, rank in zip(self.resolutions, self.ranks)
            ]
        )
        levels = list(zip(self.plane_resolutions, self.plane_ranks))
        self.planes = nn.ParameterList(
            [nn.Parameter(torch.ones(3, R, R, rank)) for R, rank in levels]
        )
        self.plane_lines = nn.ParameterList(
            [nn.Parameter(torch.ones(3, R, rank)) for R, rank in levels]
            if plane_mode == "vm" else []
        )

    @property
    def output_dim(self) -> int:
        per_plane = 3 if self.plane_mode == "vm" else 1
        return sum(self.ranks) + per_plane * sum(self.plane_ranks)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "CPGridEncoder":
        """Every table ``1 + 0.1 N(0, 1)``: products start near 1 (K-Planes
        init); drawn in the JAX encoder's order (the lines, then each plane
        level's planes and VM line)."""
        tables = list(self.lines)
        for i, plane in enumerate(self.planes):
            tables.append(plane)
            if self.plane_mode == "vm":
                tables.append(self.plane_lines[i])
        for table in tables:
            noise = torch.randn(
                table.shape, generator=generator, device=generator.device
            )
            table.copy_(1.0 + 0.1 * noise)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 3) points in [0, 1]^3 (clamped) -> (N, output_dim) features,
        the line levels first."""
        x = x.clamp(0.0, 1.0)
        if not self.use_pallas:
            feats = [cp_level_encode(x, line, self.compute_dtype) for line in self.lines]
        else:
            # one launch a level, (a_x * a_y) * a_z in JAX's order
            feats = [hat_cp_level(x, line) for line in self.lines]
        if self.plane_mode == "vm":
            feats += [self.plane_level(x, p, pl) for p, pl in zip(self.planes, self.plane_lines)]
        else:
            feats += [self.plane_level(x, p) for p in self.planes]
        return torch.cat(feats, dim=-1)

    def plane_level(self, x: torch.Tensor, plane: torch.Tensor,
                    pline: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One tri-plane level on (N, 3) points in [0, 1]^3: (N, rank)
        product features, or (N, 3 * rank) VM features given ``pline``.

        Each coordinate's two hat weights ``max(0, 1 - |pos - j|)`` at
        ``pos = x (R - 1)`` are formed in f32 and rounded to the compute
        dtype, as JAX forms its hat rows.  Then, as in the jitted JAX level
        (``hat_u @ P`` and a ``hat_v`` contraction): the lerp along the
        plane's first axis, ``t = w0 P[i] + w1 P[i + 1]``, is rounded once
        (the dot's output); the lerp of ``t`` along the second axis is
        summed in f32 and rounded once.  Product mode rounds ``f_xy * f_xz``
        and returns its product with ``f_yz`` unrounded (XLA drops the round
        trip through the compute dtype before the output's f32 convert),
        its cotangent rounded to the compute dtype (autodiff hands it back
        through that convert); VM mode rounds the line's lerp once (its dot)
        and each plane feature's product with it.  In bf16 the forward is
        bitwise the jitted JAX level's, and so are both table gradients
        unless a row's f32 sum lies within a summation-order rounding of a
        bf16 tie: XLA's dot sums the samples in its own blocked order, the
        port in sample order, the same from run to run
        (tests/test_torch_planes.py)."""
        R = plane.shape[1]
        rank = plane.shape[-1]
        cd = self.compute_dtype
        pos = x.t() * (R - 1)  # (3, N)
        i0 = torch.floor(pos).clamp(0, R - 2)
        w = torch.stack([
            (1.0 - (pos - i0).abs()).clamp_min(0.0),
            (1.0 - (pos - (i0 + 1)).abs()).clamp_min(0.0),
        ])  # (2, 3, N): the weights of rows i0 and i0 + 1
        w = _round(w, cd)
        i0 = i0.long()
        table = _round(plane, cd).reshape(3 * R * R, rank)
        feats = []
        for p, (a, b) in enumerate(PLANE_PAIRS):
            base = p * R * R + i0[a] * R + i0[b]  # (N,): texel (i0_a, i0_b)
            texels = _take_rows(table, torch.stack([base, base + R, base + 1, base + R + 1]))
            t0 = _round(w[0, a, :, None] * texels[0] + w[1, a, :, None] * texels[1], cd)
            t1 = _round(w[0, a, :, None] * texels[2] + w[1, a, :, None] * texels[3], cd)
            feats.append(_round(t0 * w[0, b, :, None] + t1 * w[1, b, :, None], cd))
        if pline is None:
            out = _round(feats[0] * feats[1], cd) * feats[2]
            return out if cd == torch.float32 else _RoundGrad.apply(out)
        lines = _round(pline, cd).reshape(3 * R, rank)
        out = []
        for p, c in enumerate(PLANE_LINE_AXES):
            row = p * R + i0[c]
            l0, l1 = _take_rows(lines, torch.stack([row, row + 1]))
            lf = _round(w[0, c, :, None] * l0 + w[1, c, :, None] * l1, cd)
            out.append(_round(feats[p] * lf, cd))
        return torch.cat(out, dim=-1)

    def param_regularizer(self, lines: Optional[Sequence[torch.Tensor]] = None,
                          planes: Sequence[torch.Tensor] = (),
                          plane_lines: Sequence[torch.Tensor] = ()):
        """Total variation of the tables: the mean squared difference of
        adjacent rows of every line table, of adjacent rows along both axes
        of every plane, and of adjacent rows of every VM line, summed (the
        JAX encoder's terms).  ``lines`` (with ``planes`` and ``plane_lines``)
        replaces the module's own tables (the trainer passes its parameter
        tensors)."""
        if lines is None:
            lines, planes, plane_lines = self.lines, self.planes, self.plane_lines
        terms = []
        for line in lines:
            d = line[:, 1:, :] - line[:, :-1, :]
            terms.append((d * d).mean())
        for plane in planes:
            du = plane[:, 1:, :, :] - plane[:, :-1, :, :]
            dv = plane[:, :, 1:, :] - plane[:, :, :-1, :]
            terms.append((du * du).mean() + (dv * dv).mean())
        for pline in plane_lines:
            d = pline[:, 1:, :] - pline[:, :-1, :]
            terms.append((d * d).mean())
        return sum(terms)


def plane_eval_chunk(encoder: CPGridEncoder) -> int:
    """The occupancy refresh's chunk of a field on ``encoder``, the JAX
    fields': the whole grid (2^21) for line levels alone; with planes at
    most 2.5e8 over the sum of ``R * rank`` (JAX materialises a (3, N, R *
    rank) dot output a plane level), at least 2^12, rounded down to a power
    of 2."""
    per = sum(R * r for R, r in zip(encoder.plane_resolutions, encoder.plane_ranks))
    if per == 0:
        return 2**21
    cap = max(2**12, int(2.5e8) // per)
    return 1 << (cap.bit_length() - 1)


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the cotangent to bf16: JAX's
    ``astype(f32)`` of a bf16 value hands the cotangent back in bf16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.bfloat16)


class TPAllReduce(torch.autograd.Function):
    """Sum of the tensor-parallel partial products over the model group,
    with an identity backward (JAX's ``tp_allreduce``,
    nerfacc_tpu/models/cp_field.py:31-54): each rank holds the product of
    its feature slice with its rows of the first weight; the sum is
    replicated over the group, so is its cotangent, and each partial enters
    the sum once, so the partial's cotangent is the cotangent itself."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_allreduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum a tensor-parallel partial product over the model ``group``, its
    cotangent passed through unchanged (JAX's ``tp_allreduce(x,
    axis_name)``, the group in place of the mesh axis's name)."""
    return TPAllReduce.apply(x, group)


class _TPReduce:
    """``_mlp_apply``'s ``reduce0`` for a model group."""

    def __init__(self, group):
        self.group = group

    def __call__(self, x):
        return tp_allreduce(x, self.group)


def _tp_ranks(ranks, tp_group, planes) -> tuple:
    """The local ranks of a field sharded over ``tp_group`` (None: the
    ranks), and the group's size and this rank's place in it."""
    if tp_group is None:
        return tuple(ranks), 1, 0
    if planes:
        raise ValueError("tri-plane levels with tensor parallelism are not supported")
    n = dist.get_world_size(tp_group)
    if any(r % n for r in ranks):
        raise ValueError(f"level ranks {tuple(ranks)} must divide over {n} model shards")
    return tuple(r // n for r in ranks), n, dist.get_rank(tp_group)


class _TensorParallel:
    """The tensor-parallel side of a CP line field: ``config`` rebuilds the
    whole field, and a sharded field draws its parameters as the whole field
    does and keeps its slice."""

    def _set_tp(self, config, tp_group, n, m):
        self.config = config
        self.tp_group, self.tp_size, self.tp_rank = tp_group, n, m
        if tp_group is not None:
            self.base_reduce = _TPReduce(tp_group)

    @torch.no_grad()
    def init(self, generator: torch.Generator):
        if self.tp_group is None:
            return super().init(generator)
        from ..parallel.tp import permute_w1, shard_params, tp_w1_permutation

        whole = type(self)(**self.config)
        whole.init(generator)
        params = permute_w1(whole.state_dict(),
                            tp_w1_permutation(whole.encoder.ranks, self.tp_size))
        for name, value in shard_params(params, self.tp_size, self.tp_rank).items():
            self.get_parameter(name).copy_(value)
        return self


class CPRadianceField(_TensorParallel, MLPField):
    """Radiance field with CP line (and tri-plane) features and small
    bias-free MLPs (see :class:`~nerfacc_tpu_torch.models.ngp.MLPField`).

    Args:
        aabb / unbounded: the scene box and the contraction (MLPField's).
        resolutions / ranks: the line levels.
        compute_dtype: the encoder's and the MLPs' operand dtype.
        plane_resolutions / plane_ranks / plane_mode: tri-plane levels
            after the line levels (see :class:`CPGridEncoder`).
        tp_group: shard the line levels and the first base-MLP weight over
            this ``torch.distributed`` group (see the module docstring);
            None: the whole field.  Raises with tri-plane levels.
        num_dim: taken for the JAX field's signature, which declares it and
            reads it nowhere.
        use_viewdirs / geo_feat_dim / hidden_dim: the MLPs' (see
            :class:`~nerfacc_tpu_torch.models.ngp.MLPField`).
    """

    def __init__(
        self,
        aabb: Sequence[float],
        unbounded: bool = False,
        resolutions: Sequence[int] = (32, 128, 512),
        ranks: Sequence[int] = (32, 32, 32),
        compute_dtype=torch.bfloat16,
        plane_resolutions: Sequence[int] = (),
        plane_ranks: Sequence[int] = (),
        plane_mode: str = "product",
        tp_group=None,
        num_dim: int = 3,
        use_viewdirs: bool = True,
        geo_feat_dim: int = 15,
        hidden_dim: int = 64,
    ):
        config = dict(aabb=[float(a) for a in aabb], unbounded=unbounded,
                      resolutions=tuple(resolutions), ranks=tuple(ranks),
                      compute_dtype=compute_dtype, plane_resolutions=tuple(plane_resolutions),
                      plane_ranks=tuple(plane_ranks), plane_mode=plane_mode,
                      num_dim=num_dim, use_viewdirs=use_viewdirs,
                      geo_feat_dim=geo_feat_dim, hidden_dim=hidden_dim)
        local, n, m = _tp_ranks(ranks, tp_group, plane_resolutions)
        encoder = CPGridEncoder(resolutions, local, compute_dtype,
                                plane_resolutions=plane_resolutions,
                                plane_ranks=plane_ranks, plane_mode=plane_mode)
        super().__init__(list(aabb), unbounded, encoder, compute_dtype,
                         hidden_dim=hidden_dim, geo_feat_dim=geo_feat_dim,
                         use_viewdirs=use_viewdirs)
        self.num_dim = num_dim
        self._set_tp(config, tp_group, n, m)

    @property
    def max_eval_chunk(self) -> int:
        """The occupancy refresh's chunk, the JAX field's
        (:func:`plane_eval_chunk`)."""
        return plane_eval_chunk(self.encoder)

    def param_regularizer(self, params: Optional[Dict[str, torch.Tensor]] = None):
        """The encoder's total variation (weigh it with the trainer's
        ``field_reg_weight``); ``params``, a state dict, replaces the
        module's own tables."""
        if params is None:
            return self.encoder.param_regularizer()
        tables = {
            name: [params[f"encoder.{name}.{i}"] for i in range(len(getattr(self.encoder, name)))]
            for name in ("lines", "planes", "plane_lines")
        }
        return self.encoder.param_regularizer(**tables)


class TensoRFRadianceField(CPRadianceField):
    """The CP field at TensoRF's levels: lines 64/192 x rank 32 and
    tri-planes 64/128 x rank 16.  As in the JAX class, the planes take the
    inherited ``plane_mode="product"``; TensoRF's vector-matrix mode is
    ``CPRadianceField(plane_mode="vm")``."""

    def __init__(
        self,
        aabb: Sequence[float],
        unbounded: bool = False,
        resolutions: Sequence[int] = (64, 192),
        ranks: Sequence[int] = (32, 32),
        compute_dtype=torch.bfloat16,
        plane_resolutions: Sequence[int] = (64, 128),
        plane_ranks: Sequence[int] = (16, 16),
        plane_mode: str = "product",
        num_dim: int = 3,
        use_viewdirs: bool = True,
        geo_feat_dim: int = 15,
        hidden_dim: int = 64,
    ):
        super().__init__(aabb, unbounded, resolutions, ranks, compute_dtype,
                         plane_resolutions, plane_ranks, plane_mode, num_dim=num_dim,
                         use_viewdirs=use_viewdirs, geo_feat_dim=geo_feat_dim,
                         hidden_dim=hidden_dim)


class CPDensityField(_TensorParallel, DensityField):
    """Density-only CP field for proposal resampling (PyTorch counterpart of
    nerfacc_tpu/models/cp_field.py::CPDensityField): CP line levels through
    kernels G1/G4 and a bias-free ``[sum(ranks), hidden_dim, 1]`` MLP
    (:class:`~nerfacc_tpu_torch.models.ngp.DensityField`);
    ``cp_level_encode`` raises on positions that ask for a gradient.
    ``tp_group`` shards it as :class:`CPRadianceField`'s.
    """

    def __init__(
        self,
        aabb: Sequence[float],
        unbounded: bool = False,
        resolutions: Sequence[int] = (16, 64),
        ranks: Sequence[int] = (16, 16),
        hidden_dim: int = 64,
        compute_dtype=torch.bfloat16,
        tp_group=None,
    ):
        config = dict(aabb=[float(a) for a in aabb], unbounded=unbounded,
                      resolutions=tuple(resolutions), ranks=tuple(ranks),
                      hidden_dim=hidden_dim, compute_dtype=compute_dtype)
        local, n, m = _tp_ranks(ranks, tp_group, ())
        super().__init__(aabb, unbounded, CPGridEncoder(resolutions, local, compute_dtype),
                         hidden_dim, compute_dtype)
        self._set_tp(config, tp_group, n, m)
