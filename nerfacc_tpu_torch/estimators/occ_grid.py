"""Occupancy-grid state and its dense EMA refresh.

PyTorch counterpart of nerfacc_tpu/estimators/occ_grid.py.  Ported: the
state, its initialisation, ``update_occ_grid`` on the dense path (every
cell re-evaluated at each update, the JAX warmup path) with binarisation,
and ``sampling`` (the padded path's stratified near planes, then the march).
The sampled and striped updates, the OO estimator and invisible-cell marking
are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from ..grid import MarchResult, _enlarge_aabb, march


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
    device: Union[str, torch.device] = "cpu",
) -> OccGridState:
    """An all-empty occupancy grid."""
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
) -> torch.Tensor:
    """Occupancy at one jittered point inside each cell.

    Args:
        cell_ids: (levels, n) flat ids within a level.
        jitter: (levels, n, 3) uniform [0, 1) offsets inside the cells.
        occ_eval_fn: (N, 3) world points -> (N,) or (N, 1) occupancy.
        eval_chunk: most points per ``occ_eval_fn`` call.

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
    occ = torch.cat(
        [
            occ_eval_fn(x_world[s : s + eval_chunk]).reshape(-1)
            for s in range(0, x_world.shape[0], eval_chunk)
        ]
    )
    return occ.reshape(levels, n)


def update_occ_grid(
    state: OccGridState,
    occ_eval_fn: Callable,
    jitter: torch.Tensor,
    occ_thre: float = 1e-2,
    ema_decay: float = 0.95,
    eval_chunk: int = 2**21,
) -> OccGridState:
    """One dense EMA occupancy update, then binarisation.

    Every cell is evaluated at ``jitter`` inside it; visible cells take
    ``max(occ * ema_decay, new)``; the threshold is
    ``min(mean visible occupancy, occ_thre)``.

    Args:
        jitter: (levels, cells_per_lvl, 3) uniform offsets (the tests feed
            the JAX package's own draw).
    """
    levels, cells = state.levels, state.cells_per_lvl
    all_ids = torch.arange(cells, device=state.occs.device).expand(levels, cells)
    occ = _eval_cells(state, all_ids, jitter, occ_eval_fn, eval_chunk).reshape(-1)
    visible = state.occs >= 0.0
    occs = torch.where(
        visible, torch.maximum(state.occs * ema_decay, occ), state.occs
    )
    visible = occs >= 0
    mean_occ = torch.where(visible, occs, 0.0).sum() / visible.sum().clamp_min(1)
    thre = torch.clamp(mean_occ, max=occ_thre)
    binaries = (occs > thre).reshape(state.binaries.shape)
    return OccGridState(aabbs=state.aabbs, occs=occs, binaries=binaries)


def sampling(
    state: OccGridState,
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near_plane: float = 0.0,
    far_plane: float = 1e10,
    render_step_size: float = 1e-3,
    cone_angle: float = 0.0,
    near_jitter: Optional[torch.Tensor] = None,
) -> MarchResult:
    """March the occupied cells along every ray, packed exactly (kernel G2).

    The JAX package's ``sampling_padded`` with stratified sampling moves each
    ray's near plane by ``jitter * render_step_size`` with a uniform
    ``jitter`` in [0, 1); here that draw is the explicit (n_rays,)
    ``near_jitter`` (None: no jitter), so a caller can feed the JAX draw.
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
        step_size=render_step_size, cone_angle=cone_angle,
    )
