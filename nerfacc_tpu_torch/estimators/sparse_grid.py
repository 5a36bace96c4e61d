"""Sparse-grid estimators: the reference's pluggable VDB and octree family.

PyTorch counterpart of nerfacc_tpu/estimators/sparse_grid.py:

* :class:`SparseGrid`: a bit-packed voxel grid (one bit a voxel, packed
  along z into int32 words, bit for bit the JAX package's layout, so that
  state dicts move between the packages), with its max-pooled mip pyramid;
* :func:`traverse_vdbs`: the flat exact-size march through a sparse grid
  (kernel G2 on the card, its plain version on the CPU);
* :class:`SparseGridEstimator` (alias :data:`VDBEstimator`) and
  :class:`N3TreeEstimator`: the reference's ``sampling()`` /
  ``update_every_n_steps()`` protocol, where an update changes the state of
  the touched voxels only.

Both of the JAX estimator's traversals give the same sample sets here:
``"padded"`` the march of each ray's first ``max_samples`` orbit
candidates, ``"windowed"`` the march of the whole orbit.  JAX reaches the
latter through windowed rounds over a coarse pyramid (N3Tree: a pyramid
descent) that resume from their termination planes; those windows exist for
the TPU's gathers, and their contract is the exact sample set, which G2
gives in one pass.  Every random draw (the update's cell ids and jitter,
the near-plane jitter) can be passed in, else comes from the estimator's
``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..grid import march
from .base import AbstractEstimator
from .occ_grid import (
    OccGridState,
    _draw,
    _draw_occupied_ids,
    _ema_update,
    _eval_cells,
    grid_samples,
)

# bit k of a word has weight 2^k, bit 31 -2^31: every partial sum of
# distinct bits fits an int32, as JAX's int32 sum of ``b * (1 << k)`` does
_BIT_WEIGHTS = [1 << k for k in range(31)] + [-(1 << 31)]


def _pack_bits_z(dense: torch.Tensor) -> torch.Tensor:
    """(rx, ry, rz) bool -> (rx, ry, ceil(rz / 32)) int32 words: bit
    ``iz % 32`` of ``words[ix, iy, iz // 32]`` is voxel (ix, iy, iz)."""
    rx, ry, rz = dense.shape
    bits = torch.zeros((rx, ry, -(-rz // 32) * 32), dtype=torch.int32, device=dense.device)
    bits[..., :rz] = dense.to(torch.int32)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=dense.device)
    return (bits.reshape(rx, ry, -1, 32) * weights).sum(-1, dtype=torch.int32)


def _unpack_bits_z(words: torch.Tensor, rz: int) -> torch.Tensor:
    """The inverse of :func:`_pack_bits_z`: (rx, ry, rz) bool."""
    rx, ry, _ = words.shape
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words[..., None] >> shifts) & 1  # arithmetic shift: bit 31 reads 1
    return bits.reshape(rx, ry, -1)[:, :, :rz] > 0


def _mip_levels(binaries: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """``levels`` max-pooled occupancy levels of (1, rx, ry, rz) bool
    ``binaries``, level ``i`` pooled by ``2**i`` (an ``any`` over 2x2x2
    blocks a level: ``max_pool3d`` takes no bool)."""
    out = [binaries]
    for _ in range(1, levels):
        m, rx, ry, rz = out[-1].shape
        if rx % 2 or ry % 2 or rz % 2:
            raise ValueError(f"cannot pool a {(rx, ry, rz)} level by 2")
        blocks = out[-1].reshape(m, rx // 2, 2, ry // 2, 2, rz // 2, 2)
        out.append(blocks.any(dim=6).any(dim=4).any(dim=2))
    return out


@dataclasses.dataclass
class SparseGrid:
    """Bit-packed voxel grid, the reference's ``GridBatch`` analog.

    Attributes:
        words: (rx, ry, ceil(rz / 32)) int32; bit ``iz % 32`` of
            ``words[ix, iy, iz // 32]`` is voxel (ix, iy, iz) enabled.
        aabb: (6,) f32 world bounds.
        resolution: (rx, ry, rz) voxel counts.
    """

    words: torch.Tensor
    aabb: torch.Tensor
    resolution: Tuple[int, int, int]

    @property
    def total_voxels(self) -> int:
        rx, ry, rz = self.resolution
        return rx * ry * rz

    @property
    def binaries(self) -> torch.Tensor:
        """(1, rx, ry, rz) bool, unpacked anew at each read (the words are
        the storage)."""
        return _unpack_bits_z(self.words, self.resolution[2])[None]

    @property
    def voxel_sizes(self) -> torch.Tensor:
        res = torch.tensor(self.resolution, dtype=torch.float32, device=self.aabb.device)
        return (self.aabb[3:] - self.aabb[:3]) / res

    def ijk_enabled(self) -> torch.Tensor:
        """(n, 3) int64 coordinates of the enabled voxels, row-major."""
        return torch.nonzero(self.binaries[0])

    def mip_pyramid(self, levels: int = 3) -> List[torch.Tensor]:
        """Max-pooled occupancy pyramid (the octree's role): level ``i``
        pools by ``2**i``; level 0 is :attr:`binaries`."""
        return _mip_levels(self.binaries, levels)


def sparse_grid_from_dense(
    dense,
    aabb: Union[Sequence[float], torch.Tensor],
    device: Union[str, torch.device] = "cuda",
) -> SparseGrid:
    """A :class:`SparseGrid` on ``device`` from a dense (rx, ry, rz) bool
    mask (a tensor or an array)."""
    dense = torch.as_tensor(dense, device=device).to(torch.bool)
    if dense.ndim != 3:
        raise ValueError(f"dense must be (rx, ry, rz), got {tuple(dense.shape)}")
    aabb = torch.as_tensor(aabb, dtype=torch.float32, device=device)
    if aabb.shape != (6,):
        raise ValueError(f"aabb must have 6 entries, got {tuple(aabb.shape)}")
    return SparseGrid(_pack_bits_z(dense), aabb, tuple(int(r) for r in dense.shape))


def sparse_grid_from_ijk(
    ijk,
    resolution: Union[int, Sequence[int]],
    aabb: Union[Sequence[float], torch.Tensor],
    device: Union[str, torch.device] = "cuda",
) -> SparseGrid:
    """A :class:`SparseGrid` on ``device`` whose enabled voxels are the (n,
    3) coordinates ``ijk`` (reference: fvdb ``sparse_grid_from_ijk``)."""
    if isinstance(resolution, int):
        resolution = (resolution,) * 3
    dense = torch.zeros(tuple(int(r) for r in resolution), dtype=torch.bool, device=device)
    ijk = torch.as_tensor(ijk, device=device).long().reshape(-1, 3)
    dense[ijk[:, 0], ijk[:, 1], ijk[:, 2]] = True
    return sparse_grid_from_dense(dense, aabb, device)


def traverse_vdbs(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    grid: SparseGrid,
    near_planes: Optional[torch.Tensor] = None,
    far_planes: Optional[torch.Tensor] = None,
    step_size: float = 1e-3,
    cone_angle: float = 0.0,
    max_samples: int = 1024,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """March a sparse grid: flat exact-size ``(t_starts, t_ends,
    ray_indices)`` in (ray, t) order, int32 ray ids (reference:
    ``traverse_vdbs``, vdb.py:20-57).  Each ray emits its occupied orbit
    candidates among its first ``max_samples``, as the JAX package's padded
    lattice does.  Kernel G2 on the card; waits on
    the device once for the count."""
    res = march(rays_o, rays_d, grid.binaries, grid.aabb[None], near_planes, far_planes,
                step_size=step_size, cone_angle=cone_angle, max_samples=max_samples)
    return res.t_starts, res.t_ends, res.ray_indices


class SparseGridEstimator(AbstractEstimator):
    """Sparse-grid transmittance estimator, the reference's ``VDBEstimator``
    (vdb.py:60-337).

    Args:
        init_grid: a :class:`SparseGrid`, or None for an all-disabled grid
            of ``resolution`` over ``roi_aabb`` (the JAX package's code;
            its docstring says "fully enabled").
        roi_aabb: world bounds when ``init_grid`` is None.
        resolution: voxel counts when ``init_grid`` is None.
        max_samples: orbit candidates a ray may emit with
            ``traversal="padded"``.
        seed: seeds the estimator's generator (stratified jitter, the
            update's draws).
        pyramid_levels: levels of :meth:`pyramid`.
        device: where the buffers live: the card unless asked otherwise.

    Buffers (``state_dict`` keys as the JAX package's): ``grid_words``,
    ``grid_aabb``, ``grid_resolution`` (kept, so that a round trip restores
    an ``rz`` that is not a multiple of 32) and ``occs`` (one f32 EMA
    occupancy a voxel).
    """

    def __init__(
        self,
        init_grid: Optional[SparseGrid] = None,
        roi_aabb: Optional[Union[Sequence[float], torch.Tensor]] = None,
        resolution: Union[int, Sequence[int]] = 128,
        max_samples: int = 1024,
        seed: int = 0,
        pyramid_levels: int = 3,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__()
        if init_grid is None:
            if roi_aabb is None:
                raise ValueError("give init_grid or roi_aabb")
            if isinstance(resolution, int):
                resolution = (resolution,) * 3
            dense = torch.zeros(tuple(int(r) for r in resolution), dtype=torch.bool)
            init_grid = sparse_grid_from_dense(dense, roi_aabb, device)
        self.register_buffer("grid_words", init_grid.words.to(device))
        self.register_buffer("grid_aabb", init_grid.aabb.to(device))
        self.register_buffer(
            "grid_resolution", torch.tensor(init_grid.resolution, device=device)
        )
        self._resolution = tuple(init_grid.resolution)
        self.register_buffer(
            "occs", torch.zeros(init_grid.total_voxels, dtype=torch.float32, device=device)
        )
        self.max_samples = max_samples
        self.seed = seed
        self.pyramid_levels = pyramid_levels
        self._generator: Optional[torch.Generator] = None
        self._cache_words: Optional[torch.Tensor] = None
        self._cache_version = -1
        self._cache: dict = {}
        self.register_load_state_dict_post_hook(SparseGridEstimator._after_load)

    @staticmethod
    def _after_load(module, incompatible_keys) -> None:
        module._resolution = tuple(int(r) for r in module.grid_resolution.tolist())

    @property
    def grid(self) -> SparseGrid:
        """The buffers as a :class:`SparseGrid` (shared, not copied)."""
        return SparseGrid(self.grid_words, self.grid_aabb, self._resolution)

    @grid.setter
    def grid(self, grid: SparseGrid) -> None:
        dev = self.occs.device
        self.grid_words = grid.words.to(dev)
        self.grid_aabb = grid.aabb.to(dev)
        self.grid_resolution = torch.tensor(grid.resolution, device=dev)
        self._resolution = tuple(grid.resolution)

    def _cached(self, key: str, make: Callable):
        """``make()`` once per grid: the cache holds the words tensor it was
        built from and that tensor's version, which an in-place write
        (``load_state_dict``) moves."""
        words = self.grid_words
        if self._cache_words is not words or self._cache_version != words._version:
            self._cache_words, self._cache_version, self._cache = words, words._version, {}
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    @property
    def binaries(self) -> torch.Tensor:
        """(1, rx, ry, rz) bool, unpacked once per grid."""
        return self._cached("binaries", lambda: self.grid.binaries)

    def pyramid(self) -> List[torch.Tensor]:
        """The grid's max-pooled occupancy pyramid (``pyramid_levels``
        levels, level ``i`` pooled by ``2**i``), built once per grid."""
        return self._cached("pyramid", lambda: _mip_levels(self.binaries, self.pyramid_levels))

    @property
    def aabbs(self) -> torch.Tensor:
        return self.grid_aabb[None]

    @property
    def generator(self) -> torch.Generator:
        """The estimator's generator, on the buffers' device."""
        dev = self.occs.device
        if self._generator is None or self._generator.device != dev:
            self._generator = torch.Generator(device=dev).manual_seed(self.seed)
        return self._generator

    def sampling(
        self,
        rays_o: torch.Tensor,
        rays_d: torch.Tensor,
        sigma_fn: Optional[Callable] = None,
        alpha_fn: Optional[Callable] = None,
        near_plane: float = 0.0,
        far_plane: float = 1e10,
        t_min: Optional[torch.Tensor] = None,
        t_max: Optional[torch.Tensor] = None,
        render_step_size: float = 1e-3,
        early_stop_eps: float = 1e-4,
        alpha_thre: float = 0.0,
        stratified: bool = False,
        cone_angle: float = 0.0,
        traversal: str = "windowed",
        near_jitter: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Samples in the enabled voxels, exact-size and flattened
        (reference: vdb.py:108-270).

        ``traversal="windowed"`` marches each ray's whole orbit (the sample
        set of the JAX package's windowed rounds); ``"padded"`` its first
        ``max_samples`` candidates (:func:`traverse_vdbs`).  Then, given
        ``sigma_fn`` or ``alpha_fn``, only the visible samples are kept, as
        ``OccGridEstimator.sampling`` keeps them (threshold ``min(alpha_thre,
        mean(occs))``).  ``stratified`` jitters each ray's near plane by up
        to one step: ``near_jitter`` (n_rays,) uniform [0, 1) when given,
        else the estimator's generator.

        Returns:
            ray_indices (n,) int64, sorted; t_starts (n,); t_ends (n,).
        """
        if traversal not in ("windowed", "padded"):
            raise ValueError(f"traversal must be 'windowed' or 'padded', got {traversal!r}")
        return grid_samples(
            self.binaries, self.aabbs, self.occs, rays_o, rays_d, sigma_fn, alpha_fn,
            near_plane, far_plane, t_min, t_max, render_step_size, early_stop_eps,
            alpha_thre, stratified, cone_angle, near_jitter,
            None if traversal == "windowed" else self.max_samples, self.generator,
        )

    @torch.no_grad()
    def update_every_n_steps(
        self,
        step: int,
        occ_eval_fn: Callable,
        occ_thre: float = 1e-2,
        ema_decay: float = 0.95,
        warmup_steps: int = 256,
        n: int = 16,
        *,
        ids: Optional[torch.Tensor] = None,
        jitter: Optional[torch.Tensor] = None,
    ) -> None:
        """EMA update and per-voxel enable/disable when ``step % n == 0``
        (reference: vdb.py:272-337).  Training mode only.

        Only the touched voxels change: before ``warmup_steps`` every voxel,
        after it ``cells // 4`` uniform ids and the first ``cells // 4`` of
        a random order that puts the enabled voxels first.  Each touched
        occupancy decays once (an id drawn twice too), then takes the max
        with the field's occupancy at a jittered point of the voxel; a
        touched voxel is enabled iff its occupancy is at least
        ``min(mean(occs), occ_thre)``.  Unlike ``OccGridEstimator``, no
        untouched voxel is re-binarised.

        Args:
            occ_eval_fn: (N, 3) world points -> (N,) or (N, 1) occupancy,
                called on chunks of at most 2^21 points.
            ids / jitter: the draws, (n,) flat voxel ids and (n, 3) uniform
                [0, 1) offsets; each one None comes from the generator.
        """
        if not self.training:
            raise RuntimeError("You should only call this function only during training.")
        if step % n:
            return
        cells = self.occs.shape[0]
        dev = self.occs.device
        if ids is None:
            if step < warmup_steps:
                ids = torch.arange(cells, device=dev)
            else:
                n_q = cells // 4
                uniform = torch.randint(0, cells, (n_q,), generator=self.generator, device=dev)
                enabled = _draw_occupied_ids(self.binaries, n_q, self.generator)[0]
                ids = torch.cat([uniform, enabled])
        ids = ids.to(dev).long()
        jitter = _draw(jitter, (ids.shape[0], 3), self.generator, dev)
        state = OccGridState(self.aabbs, self.occs, self.binaries)
        occ = _eval_cells(state, ids[None], jitter[None].to(dev), occ_eval_fn)[0]
        self.occs = _ema_update(self.occs, ids, occ, torch.ones_like(ids, dtype=torch.bool),
                                ema_decay)
        thre = torch.clamp(self.occs.mean(), max=occ_thre)
        enabled = self.binaries.reshape(-1).clone()
        enabled[ids] = self.occs[ids] >= thre
        self.grid_words = _pack_bits_z(enabled.reshape(self._resolution))


class N3TreeEstimator(SparseGridEstimator):
    """Octree-flavoured estimator (reference: nerfacc/estimators/n3tree.py).

    In the JAX package it differs from :class:`SparseGridEstimator` only in
    its windowed traversal's coarse phase, a descent through several levels
    of :meth:`pyramid`, whose contract is the exact sample set; here both
    march that set (kernel G2), and :meth:`pyramid` stays the octree's
    accessor."""


# the reference's name: ``from nerfacc import VDBEstimator`` lands here
VDBEstimator = SparseGridEstimator
