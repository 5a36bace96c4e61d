"""Occupancy-grid transmittance estimator (Instant-NGP style).

PyTorch counterpart of nerfacc_tpu/estimators/occ_grid.py: the state and
its initialisation; ``update_occ_grid``'s three modes (the dense refresh of
warmup, the sampled update with its duplicate-safe EMA-max scatter, the
striped dense refresh with decay^S) and the binarisation; ``sampling`` (the
trainers' march, kernel G2); and :class:`OccGridEstimator`, the stateful
``nn.Module`` of the reference's API, whose ``sampling`` returns the
exact-size flattened samples after the visibility filter.  Every random draw
(cell jitter, cell ids, near-plane jitter) is an argument or comes from a
``torch.Generator``, so a test can feed the JAX package's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from ..grid import MarchResult, _enlarge_aabb, march
from ..volrend import render_visibility_from_alpha, render_visibility_from_density
from .base import AbstractEstimator


@dataclasses.dataclass
class OccGridState:
    """Occupancy grid buffers.

    Attributes:
        aabbs: (levels, 6) f32; level ``i`` is the roi enlarged by ``2**i``.
        occs: (levels * cells_per_lvl,) f32 EMA occupancy; ``-1`` marks cells
            invisible to every camera.
        binaries: (levels, rx, ry, rz) bool occupancy used by the march.
    """

    aabbs: torch.Tensor
    occs: torch.Tensor
    binaries: torch.Tensor

    @property
    def levels(self) -> int:
        return self.binaries.shape[0]

    @property
    def resolution(self) -> Tuple[int, int, int]:
        return tuple(self.binaries.shape[1:])

    @property
    def cells_per_lvl(self) -> int:
        rx, ry, rz = self.binaries.shape[1:]
        return rx * ry * rz


def init_occ_grid(
    roi_aabb: Union[Sequence[float], torch.Tensor],
    resolution: Union[int, Sequence[int]] = 128,
    levels: int = 1,
    device: Union[str, torch.device] = "cuda",
) -> OccGridState:
    """An all-empty occupancy grid on ``device`` (the card by default)."""
    if isinstance(resolution, int):
        resolution = [resolution] * 3
    resolution = tuple(int(r) for r in resolution)
    if len(resolution) != 3:
        raise ValueError(f"resolution must have 3 entries, got {resolution}")
    roi = torch.as_tensor(roi_aabb, dtype=torch.float32, device=device)
    if roi.shape != (6,):
        raise ValueError(f"roi_aabb must have 6 entries, got {tuple(roi.shape)}")
    aabbs = torch.stack([_enlarge_aabb(roi, 2**i) for i in range(levels)])
    cells = resolution[0] * resolution[1] * resolution[2]
    return OccGridState(
        aabbs=aabbs,
        occs=torch.zeros(levels * cells, dtype=torch.float32, device=device),
        binaries=torch.zeros((levels,) + resolution, dtype=torch.bool, device=device),
    )


def _cell_coords(ids: torch.Tensor, resolution: Tuple[int, int, int]) -> torch.Tensor:
    """Flat cell id -> (ix, iy, iz), row-major."""
    rx, ry, rz = resolution
    iz = ids % rz
    iy = (ids // rz) % ry
    ix = ids // (ry * rz)
    return torch.stack([ix, iy, iz], dim=-1)


def _eval_cells(
    state: OccGridState,
    cell_ids: torch.Tensor,
    jitter: torch.Tensor,
    occ_eval_fn: Callable,
    eval_chunk: int = 2**21,
    cell_data: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Occupancy at one jittered point inside each cell.

    Args:
        cell_ids: (levels, n) flat ids within a level.
        jitter: (levels, n, 3) uniform [0, 1) offsets inside the cells.
        occ_eval_fn: (N, 3) world points -> (N,) or (N, 1) occupancy; given
            ``cell_data``, it also takes those points' rows of it.
        eval_chunk: most points per ``occ_eval_fn`` call.
        cell_data: (levels * n, ...) per-cell inputs of ``occ_eval_fn`` (a
            time-dependent field's frame per cell), sliced beside the points.

    Returns:
        (levels, n) occupancy.
    """
    levels, n = cell_ids.shape
    res = torch.tensor(state.resolution, dtype=torch.float32, device=jitter.device)
    coords = _cell_coords(cell_ids, state.resolution).to(torch.float32)
    x = (coords + jitter) / res  # in [0, 1]^3
    lo = state.aabbs[:, None, :3]
    hi = state.aabbs[:, None, 3:]
    x_world = (lo + x * (hi - lo)).reshape(-1, 3)
    chunks = [slice(s, s + eval_chunk) for s in range(0, x_world.shape[0], eval_chunk)]
    if cell_data is None:
        occ = [occ_eval_fn(x_world[c]) for c in chunks]
    else:
        occ = [occ_eval_fn(x_world[c], cell_data[c]) for c in chunks]
    occ = torch.cat([o.reshape(-1) for o in occ])
    return occ.reshape(levels, n)


def _ema_update(
    occs: torch.Tensor,
    flat_ids: torch.Tensor,
    occ_vals: torch.Tensor,
    update_mask: torch.Tensor,
    ema_decay: float,
) -> torch.Tensor:
    """Duplicate-safe EMA-max scatter ``occs[ids] = max(occs[ids] * decay,
    occ)``: each touched cell decays once, then takes the max with every
    value written to it (``scatter_reduce`` "amax", whose result does not
    depend on the order of the writes).  Ids where ``update_mask`` is False
    are dropped."""
    n = occs.shape[0]
    safe = torch.where(update_mask, flat_ids.long(), n)  # n: a slot past the end
    touched = torch.zeros(n + 1, dtype=torch.bool, device=occs.device)
    touched[safe] = True
    out = torch.where(touched[:n], occs * ema_decay, occs)
    out = torch.cat([out, out.new_zeros(1)])
    out = out.scatter_reduce(0, safe, occ_vals.to(out.dtype), reduce="amax")
    return out[:n]


def _binarize(state: OccGridState, occs: torch.Tensor, occ_thre: float) -> OccGridState:
    """Threshold at ``min(mean visible occupancy, occ_thre)``."""
    visible = occs >= 0
    mean_occ = torch.where(visible, occs, 0.0).sum() / visible.sum().clamp_min(1)
    thre = torch.clamp(mean_occ, max=occ_thre)
    binaries = (occs > thre).reshape(state.binaries.shape)
    return OccGridState(aabbs=state.aabbs, occs=occs, binaries=binaries)


def _draw(jitter, shape, generator, device) -> torch.Tensor:
    if jitter is not None:
        return jitter
    return torch.rand(shape, generator=generator, device=device)


def _draw_occupied_ids(
    binaries: torch.Tensor, n: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """A uniform draw of ``n`` occupied cells per level without replacement,
    filled up with empty cells where a level holds fewer (the JAX package's
    key sort): random keys, every occupied cell's below every empty one's,
    then the first ``n`` cells in key order.  (levels, n) int64."""
    levels = binaries.shape[0]
    occupied = binaries.reshape(levels, -1)
    keys = torch.rand(occupied.shape, generator=generator, device=binaries.device)
    keys = keys + (~occupied).to(keys.dtype) * 2.0
    return torch.argsort(keys, dim=1)[:, :n]


def update_mode(step: int, warmup_steps: int, dense: bool, dense_stripes: int) -> str:
    """Which of :func:`update_occ_grid`'s modes an update at ``step`` takes:
    "dense" (every cell), "striped" or "sampled"."""
    if step < warmup_steps or (dense and dense_stripes == 1):
        return "dense"
    return "striped" if dense else "sampled"


def cells_evaluated(mode: str, cells: int, dense_stripes: int = 1) -> int:
    """Cells a level that an update in ``mode`` evaluates: all of them, one
    stripe, or ``cells // 4`` uniform and as many occupied ones."""
    return {"dense": cells, "striped": cells // dense_stripes,
            "sampled": 2 * (cells // 4)}[mode]


def update_occ_grid(
    state: OccGridState,
    occ_eval_fn: Callable,
    jitter: Optional[torch.Tensor] = None,
    occ_thre: float = 1e-2,
    ema_decay: float = 0.95,
    eval_chunk: int = 2**21,
    cell_data: Optional[torch.Tensor] = None,
    *,
    step: int = 0,
    warmup_steps: int = 256,
    dense: bool = False,
    dense_stripes: int = 1,
    update_interval: int = 16,
    uniform_ids: Optional[torch.Tensor] = None,
    occupied_ids: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> OccGridState:
    """One EMA occupancy update, then binarisation at ``min(mean visible
    occupancy, occ_thre)``.  Cells marked -1 (invisible) keep their value.

    Modes, as the JAX package's ``update_occ_grid``:
    * ``step < warmup_steps``, or ``dense`` with one stripe: every cell is
      evaluated and takes ``max(occ * ema_decay, new)``;
    * past warmup, not ``dense``: the sampled update: ``cells // 4``
      uniform cell ids and as many occupied ones a level, through the
      duplicate-safe EMA-max scatter (:func:`_ema_update`);
    * past warmup, ``dense`` with ``dense_stripes = S > 1``: the contiguous
      stripe ``(step // update_interval) % S`` of every level's cells, with
      decay ``ema_decay ** S``.

    Args:
        occ_eval_fn: (N, 3) world points -> (N,) or (N, 1) occupancy; given
            ``cell_data``, it also takes those points' rows of it.
        jitter: uniform [0, 1) offsets inside the evaluated cells, (levels,
            cells evaluated a level, 3).
        cell_data: one row per evaluated cell, in (level, cell) order: the
            per-cell inputs of ``occ_eval_fn`` (a time-dependent field's
            frame), sliced beside the points.
        uniform_ids / occupied_ids: the sampled update's (levels, cells //
            4) cell ids.
        generator: draws whatever of ``jitter``, ``uniform_ids`` and
            ``occupied_ids`` is None (the tests feed the JAX package's
            draws instead).
    """
    levels, cells = state.levels, state.cells_per_lvl
    dev = state.occs.device
    mode = update_mode(step, warmup_steps, dense, dense_stripes)
    if mode == "dense":
        ids = torch.arange(cells, device=dev).expand(levels, cells)
        jitter = _draw(jitter, (levels, cells, 3), generator, dev)
        occ = _eval_cells(state, ids, jitter, occ_eval_fn, eval_chunk, cell_data).reshape(-1)
        occs = torch.where(
            state.occs >= 0.0, torch.maximum(state.occs * ema_decay, occ), state.occs
        )
    elif mode == "striped":
        if cells % dense_stripes:
            raise ValueError(f"dense_stripes={dense_stripes} must divide cells={cells}")
        n = cells // dense_stripes
        start = (step // update_interval) % dense_stripes * n
        ids = (start + torch.arange(n, device=dev)).expand(levels, n)
        jitter = _draw(jitter, (levels, n, 3), generator, dev)
        occ = _eval_cells(state, ids, jitter, occ_eval_fn, eval_chunk, cell_data)
        occs2d = state.occs.reshape(levels, cells).clone()
        cur = occs2d[:, start : start + n]
        occs2d[:, start : start + n] = torch.where(
            cur >= 0.0, torch.maximum(cur * ema_decay**dense_stripes, occ), cur
        )
        occs = occs2d.reshape(-1)
    else:
        n = cells // 4
        if uniform_ids is None:
            uniform_ids = torch.randint(0, cells, (levels, n), generator=generator, device=dev)
        if occupied_ids is None:
            occupied_ids = _draw_occupied_ids(state.binaries, n, generator)
        ids = torch.cat([uniform_ids.to(dev).long(), occupied_ids.to(dev).long()], dim=-1)
        jitter = _draw(jitter, (levels, 2 * n, 3), generator, dev)
        occ = _eval_cells(state, ids, jitter, occ_eval_fn, eval_chunk, cell_data)
        flat = (torch.arange(levels, device=dev)[:, None] * cells + ids).reshape(-1)
        occs = _ema_update(state.occs, flat, occ.reshape(-1), state.occs[flat] >= 0.0,
                           ema_decay)
    return _binarize(state, occs, occ_thre)


def sampling(
    state: OccGridState,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    render_step_size: float = 1e-3,
    cone_angle: float = 0.0,
    near_jitter: Optional[torch.Tensor] = None,
    max_samples: Optional[int] = None,
) -> MarchResult:
    """March the occupied cells along every ray, packed exactly (kernel G2).

    The JAX package's ``sampling_padded`` with stratified sampling moves each
    ray's near plane by ``jitter * render_step_size`` with a uniform
    ``jitter`` in [0, 1); here that draw is the explicit (n_rays,)
    ``near_jitter`` (None: no jitter), so a caller can feed the JAX draw.
    ``max_samples`` keeps each ray's occupied candidates among the first
    that many of its orbit (``sampling_padded``'s lattice); None marches
    every orbit to its end.
    """
    n_rays = rays_o.shape[0]
    like = dict(dtype=rays_o.dtype, device=rays_o.device)
    near_planes = torch.full((n_rays,), near_plane, **like)
    if near_jitter is not None:
        near_planes = near_planes + near_jitter * render_step_size
    return march(
        rays_o, rays_d, state.binaries, state.aabbs,
        near_planes=near_planes,
        far_planes=torch.full((n_rays,), far_plane, **like),
        step_size=render_step_size, cone_angle=cone_angle, max_samples=max_samples,
    )


@torch.no_grad()
def visible_samples(
    occs: torch.Tensor,
    ray_indices: torch.Tensor,
    t_starts: torch.Tensor,
    t_ends: torch.Tensor,
    n_rays: int,
    sigma_fn: Optional[Callable] = None,
    alpha_fn: Optional[Callable] = None,
    early_stop_eps: float = 1e-4,
    alpha_thre: float = 0.0,
) -> Optional[torch.Tensor]:
    """The visibility filter of ``sampling_padded``: given ``sigma_fn`` or
    ``alpha_fn`` (``(t_starts, t_ends, ray_indices) -> (n,)``, run without
    gradients), the mask of the samples whose transmittance is at least
    ``early_stop_eps`` and, where the threshold ``min(alpha_thre,
    mean(occs))`` is positive, whose alpha is at least it; None when
    nothing filters."""
    fn = sigma_fn if sigma_fn is not None else alpha_fn
    if fn is None or (alpha_thre <= 0.0 and early_stop_eps <= 0.0):
        return None
    thre = torch.clamp(occs.mean(), max=alpha_thre)
    out = fn(t_starts, t_ends, ray_indices).reshape(t_starts.shape)
    if sigma_fn is not None:
        return render_visibility_from_density(
            t_starts, t_ends, out, ray_indices=ray_indices, n_rays=n_rays,
            early_stop_eps=early_stop_eps, alpha_thre=thre,
        )
    return render_visibility_from_alpha(
        out, ray_indices=ray_indices, n_rays=n_rays,
        early_stop_eps=early_stop_eps, alpha_thre=thre,
    )


class OccGridEstimator(AbstractEstimator):
    """Occupancy grid estimator, the reference's stateful API.

    Args:
        roi_aabb: (6,) region of interest.
        resolution: int or (3,) grid resolution.
        levels: cascade levels; level ``i`` covers the roi enlarged 2^i.
        max_samples: orbit candidates a ray may emit in :meth:`sampling`
            (the JAX package's padded lattice; a longer orbit is cut there).
        seed: seeds the estimator's generator (stratified jitter, cell
            draws).
        device: where the buffers live: the card unless asked otherwise.

    Buffers (``state_dict`` keys as the JAX package's): ``aabbs`` (levels,
    6), ``occs`` (levels * cells,) and ``binaries`` (levels, rx, ry, rz).
    """

    DIM: int = 3

    def __init__(
        self,
        roi_aabb: Union[Sequence[float], torch.Tensor],
        resolution: Union[int, Sequence[int]] = 128,
        levels: int = 1,
        max_samples: int = 1024,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        super().__init__()
        state = init_occ_grid(roi_aabb, resolution, levels, device)
        self.register_buffer("aabbs", state.aabbs)
        self.register_buffer("occs", state.occs)
        self.register_buffer("binaries", state.binaries)
        self.levels = levels
        self.cells_per_lvl = state.cells_per_lvl
        self.max_samples = max_samples
        self.seed = seed
        self._generator: Optional[torch.Generator] = None

    @property
    def state(self) -> OccGridState:
        """The buffers as an :class:`OccGridState` (shared, not copied)."""
        return OccGridState(aabbs=self.aabbs, occs=self.occs, binaries=self.binaries)

    @property
    def resolution(self) -> torch.Tensor:
        return torch.tensor(self.binaries.shape[1:], dtype=torch.int32)

    @property
    def generator(self) -> torch.Generator:
        """The estimator's generator, on the buffers' device."""
        dev = self.occs.device
        if self._generator is None or self._generator.device != dev:
            self._generator = torch.Generator(device=dev).manual_seed(self.seed)
        return self._generator

    def _set_state(self, state: OccGridState) -> None:
        self.occs = state.occs
        self.binaries = state.binaries

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
        near_jitter: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Samples in the occupied cells, exact-size and flattened.

        The march (kernel G2) emits each ray's occupied orbit candidates
        among its first ``max_samples``; then, given ``sigma_fn`` or
        ``alpha_fn`` (``(t_starts, t_ends, ray_indices) -> (n,)``, run
        under ``torch.no_grad()``), only the visible ones are kept:
        transmittance at least ``early_stop_eps`` and, where the threshold
        ``min(alpha_thre, mean(occs))`` is positive, alpha at least it.

        Args:
            t_min / t_max: optional (n_rays,) bounds moving the near and far
                planes in.
            stratified: jitter each ray's near plane by up to one step:
                ``near_jitter`` (n_rays,) uniform [0, 1) when given, else
                the estimator's generator.

        Returns:
            ray_indices (n,) int64, sorted; t_starts (n,); t_ends (n,).
            Waits on the device once for the count (twice with a filter).
        """
        n_rays = rays_o.shape[0]
        like = dict(dtype=rays_o.dtype, device=rays_o.device)
        near_planes = torch.full((n_rays,), near_plane, **like)
        far_planes = torch.full((n_rays,), far_plane, **like)
        if t_min is not None:
            near_planes = torch.maximum(near_planes, t_min)
        if t_max is not None:
            far_planes = torch.minimum(far_planes, t_max)
        if stratified:
            if near_jitter is None:
                near_jitter = torch.rand(n_rays, generator=self.generator, **like)
            near_planes = near_planes + near_jitter * render_step_size
        res = march(
            rays_o, rays_d, self.binaries, self.aabbs, near_planes=near_planes,
            far_planes=far_planes, step_size=render_step_size, cone_angle=cone_angle,
            max_samples=self.max_samples,
        )
        ray_indices, t_starts, t_ends = res.ray_indices.long(), res.t_starts, res.t_ends
        vis = visible_samples(self.occs, ray_indices, t_starts, t_ends, n_rays, sigma_fn,
                              alpha_fn, early_stop_eps, alpha_thre)
        if vis is not None:
            ray_indices, t_starts, t_ends = ray_indices[vis], t_starts[vis], t_ends[vis]
        return ray_indices, t_starts, t_ends

    @torch.no_grad()
    def update_every_n_steps(
        self,
        step: int,
        occ_eval_fn: Callable,
        occ_thre: float = 1e-2,
        ema_decay: float = 0.95,
        warmup_steps: int = 256,
        n: int = 16,
    ) -> None:
        """EMA-update the grid when ``step % n == 0``: every cell before
        ``warmup_steps``, the sampled update after (:func:`update_occ_grid`),
        the draws from the estimator's generator.  Training mode only."""
        if not self.training:
            raise RuntimeError(
                "You should only call this function only during training. "
                "Please call update_occ_grid() directly if you want to update "
                "the field during inference."
            )
        if step % n == 0:
            self._set_state(update_occ_grid(
                self.state, occ_eval_fn, occ_thre=occ_thre, ema_decay=ema_decay,
                step=step, warmup_steps=warmup_steps, generator=self.generator,
            ))

    @torch.no_grad()
    def mark_invisible_cells(
        self,
        K: torch.Tensor,
        c2w: torch.Tensor,
        width: int,
        height: int,
        near_plane: float = 0.0,
        chunk: int = 32**3,
    ) -> None:
        """Mark the cells that no camera sees (or that lie before a camera's
        near plane inside its image) with occupancy -1; run once before
        training.  ``K`` (n_cams, 3, 3), ``c2w`` (n_cams, 3 or 4, 4)."""
        dev = self.occs.device
        K = torch.as_tensor(K, dtype=torch.float32, device=dev)
        c2w = torch.as_tensor(c2w, dtype=torch.float32, device=dev)
        if K.ndim != 3 or K.shape[1:] != (3, 3):
            raise ValueError(f"K must be (n, 3, 3), got {tuple(K.shape)}")
        if c2w.ndim != 3 or c2w.shape[1:] not in ((3, 4), (4, 4)):
            raise ValueError(f"c2w must be (n, 3, 4) or (n, 4, 4), got {tuple(c2w.shape)}")
        n_cams = c2w.shape[0]
        w2c_R = c2w[:, :3, :3].transpose(1, 2)
        w2c_T = -w2c_R @ c2w[:, :3, 3:]
        res = self.binaries.shape[1:]
        res_f = torch.tensor(res, dtype=torch.float32, device=dev)
        cells = self.cells_per_lvl
        occs = self.occs.clone()
        for lvl in range(self.levels):
            lvl_occs = occs[lvl * cells : (lvl + 1) * cells]
            indices = torch.nonzero(lvl_occs >= 0.0)[:, 0]
            for i in range(0, indices.shape[0], chunk):
                ids = indices[i : i + chunk]
                x = _cell_coords(ids, res).to(torch.float32) / (res_f - 1)
                lo, hi = self.aabbs[lvl, :3], self.aabbs[lvl, 3:]
                xyzs_c = w2c_R @ (lo + x * (hi - lo)).T + w2c_T  # (n_cams, 3, chunk)
                uvd = K @ xyzs_c
                uv = uvd[:, :2] / uvd[:, 2:]
                in_image = ((uvd[:, 2] >= 0) & (uv[:, 0] >= 0) & (uv[:, 0] < width)
                            & (uv[:, 1] >= 0) & (uv[:, 1] < height))
                covered = (uvd[:, 2] >= near_plane) & in_image
                count = covered.sum(0) / n_cams
                too_near = ((uvd[:, 2] < near_plane) & in_image).any(0)
                valid = (count > 0) & ~too_near
                occs[lvl * cells + ids] = torch.where(valid, 0.0, -1.0)
        self.occs = occs
