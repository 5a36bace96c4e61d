"""BARF: a radiance field trained jointly with per-image SE(3) pose
corrections, from noisy poses.

PyTorch counterpart of nerfacc_tpu/trainers/barf.py.  A step, in the JAX
step's order: a dense occupancy refresh every ``update_interval`` steps
(the field's density at the step's coarse-to-fine window ``pe_alpha``);
rays made from the batch's pixels through the refined poses
(``se3_exp(pose_deltas)`` composed with the noisy poses, differentiable in
the deltas); the march (kernel G2, each ray's first ``max_samples_per_ray``
orbit candidates) and the visibility filter on the rays without gradient;
the render of the kept samples on the differentiable rays through
:func:`~nerfacc_tpu_torch.volrend.rendering` (kernels G3/G5); a smooth-L1
loss; and two Adams (field and poses), each on its own exponential decay,
the pose gradient multiplied by 0 before ``pose_start_step``.  Every pose
product is elementwise f32 (:mod:`~nerfacc_tpu_torch.models.pose`), and
TF32 is off for the field's matmuls.

A batch is ``{img_ids, x, y, rgb, color_bkgd}`` (a loader's
``pixel_batch``): the rays cannot come from the loader, since the poses are
being learned.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..estimators.occ_grid import (
    OccGridState,
    init_occ_grid,
    sampling,
    update_occ_grid,
    visible_samples,
)
from ..models.pose import _numpy, coarse_to_fine_alpha, compose_pose, matvec3, se3_exp
from ..utils.metrics import psnr, ssim
from ..volrend import rendering
from .ngp_occ import OptState, disable_tf32, smooth_l1_loss


class BARFTrainState(NamedTuple):
    params: Dict[str, Any]  # {"field": the field's state dict, "pose_deltas": (n, 6)}
    opt_state: OptState  # one Adam, the field's leaves then the poses'
    occ_state: OccGridState
    step: int


def exponential_decay(init: float, steps: int, rate: float):
    """optax's continuous ``exponential_decay``: ``init * rate^(count /
    steps)`` in f32, a function of the update count."""
    init, rate, steps = np.float32(init), np.float32(rate), np.float32(steps)

    def schedule(count: int) -> float:
        return float(init * np.power(rate, np.float32(count) / steps))

    return schedule


@dataclasses.dataclass
class BARFTrainer:
    """Joint radiance-field and camera-pose trainer.

    Args:
        field: a ``pe_alpha``-aware field (``VanillaNeRFRadianceField``):
            ``init(generator)``, ``forward(positions, dirs, pe_alpha)`` and
            ``query_density(x, pe_alpha)``; moved to ``device``.
        camtoworlds_init: (n_images, 3 or 4, 4) noisy camera-to-world poses
            (OpenGL axes, as the loaders').
        K: (3, 3) shared pinhole intrinsics.
        aabb: the occupancy grid's box (6 floats).
        max_samples_per_ray: orbit candidates a ray may emit (JAX's padded
            lattice); a longer orbit is cut there.
        lr_field / lr_field_end: the field's Adam, decayed exponentially
            from one to the other over ``max_steps``.
        lr_pose / lr_pose_end: the poses' Adam, decayed over
            ``pose_lr_horizon_frac * max_steps`` (None: 0.6 of the
            coarse-to-fine anneal's end, or ``max_steps`` without one).
        pe_c2f: (start, end) fractions of ``max_steps`` of the
            coarse-to-fine window, or None for the full spectrum.
        pose_start_step: the pose gradient is multiplied by 0 before it
            (Adam's count still advances for the poses, as optax's).
        occ_thre / ema_decay / warmup_steps / update_interval: the dense
            occupancy refresh.
        early_stop_eps / alpha_thre: the visibility filter of the samples.
        stratified: jitter each ray's near plane by up to one step.
        seed: seeds the parameters and every step's noise.
        device: where the state lives and everything runs: the card unless
            the caller asks for another (the tests pass "cpu").
    """

    field: Any
    camtoworlds_init: Any
    K: Any
    aabb: Any
    near_plane: float = 0.0
    far_plane: float = 1e10
    render_step_size: float = 5e-3
    grid_resolution: int = 128
    grid_nlvl: int = 1
    max_samples_per_ray: int = 1024
    max_steps: int = 20000
    lr_field: float = 5e-4
    lr_field_end: float = 1e-4
    lr_pose: float = 1e-3
    lr_pose_end: float = 1e-5
    pe_c2f: Optional[Tuple[float, float]] = (0.1, 0.5)
    pose_start_step: int = 200
    pose_lr_horizon_frac: Optional[float] = None
    occ_thre: float = 1e-2
    ema_decay: float = 0.95
    warmup_steps: int = 256
    update_interval: int = 16
    early_stop_eps: float = 1e-4
    alpha_thre: float = 0.0
    stratified: bool = True
    seed: int = 42
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        disable_tf32()
        self.field = self.field.to(self.device)
        c2w = torch.as_tensor(np.asarray(_numpy(self.camtoworlds_init), np.float32))
        self.c2w_init = c2w[:, :3, :4].to(self.device)
        self.n_images = self.c2w_init.shape[0]
        self.intrinsics = torch.as_tensor(np.asarray(_numpy(self.K), np.float32)).to(self.device)
        self.field_schedule = exponential_decay(
            self.lr_field, self.max_steps, self.lr_field_end / self.lr_field
        )
        if self.pose_lr_horizon_frac is not None:
            horizon_frac = self.pose_lr_horizon_frac
        else:
            horizon_frac = 0.6 * self.pe_c2f[1] if self.pe_c2f else 1.0
        self.pose_schedule = exponential_decay(
            self.lr_pose, max(int(self.max_steps * horizon_frac), 1),
            self.lr_pose_end / self.lr_pose,
        )

    def init_state(self) -> BARFTrainState:
        """Field parameters drawn from ``torch.Generator().manual_seed(seed)``
        (on the CPU, so every device starts from the same weights), zero pose
        deltas, fresh Adam moments and an empty occupancy grid."""
        self.field.init(torch.Generator().manual_seed(self.seed))
        params = {
            "field": {k: v.detach().clone().requires_grad_(True)
                      for k, v in self.field.state_dict().items()},
            "pose_deltas": torch.zeros(self.n_images, 6, device=self.device,
                                       requires_grad=True),
        }
        occ_state = init_occ_grid(
            self.aabb, self.grid_resolution, self.grid_nlvl, device=self.device
        )
        return BARFTrainState(params, self.init_optimizer(params), occ_state, 0)

    def init_optimizer(self, params: Dict) -> OptState:
        """One Adam (eps 1e-8) with two groups, the field's leaves and the
        pose deltas, each stepped at its own schedule's learning rate (optax's
        ``multi_transform`` of two ``adam``s)."""
        adam = torch.optim.Adam(
            [{"params": list(params["field"].values())},
             {"params": [params["pose_deltas"]]}],
            lr=self.lr_field, betas=(0.9, 0.999), eps=1e-8,
        )
        return OptState(adam, 0)

    def _generator(self, step: int, stream: int) -> torch.Generator:
        """The noise of one step: stream 0 the refresh's cell jitter, 1 the
        near-plane jitter."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 1_000_003 + int(step)) * 2 + stream)
        return gen

    def _bind(self, params: Dict):
        """The field, carrying ``params``' field values."""
        self.field.load_state_dict(params["field"])
        return self.field

    def pe_alpha(self, step: int) -> Optional[float]:
        """The coarse-to-fine window at ``step`` (None: the full spectrum)."""
        if self.pe_c2f is None:
            return None
        return float(coarse_to_fine_alpha(
            step, self.max_steps, self.field.posi_encoder.max_deg, *self.pe_c2f
        ))

    def refined_camtoworlds(self, pose_deltas: torch.Tensor) -> torch.Tensor:
        """(n_images, 3, 4) refined poses, ``exp(delta) @ noisy``."""
        return compose_pose(se3_exp(pose_deltas), self.c2w_init)

    def rays_from_pixels(self, pose_deltas, img_ids, x, y):
        """Origins and unit directions of pixels ``(x, y)`` of images
        ``img_ids`` (OpenGL axes, through pixel centres), differentiable in
        ``pose_deltas``."""
        c2w = self.refined_camtoworlds(pose_deltas)[img_ids.long()]  # (n, 3, 4)
        K = self.intrinsics
        x = x.to(torch.float32)
        y = y.to(torch.float32)
        dirs = torch.stack(
            [(x + 0.5 - K[0, 2]) / K[0, 0], (y + 0.5 - K[1, 2]) / K[1, 1] * -1.0,
             -torch.ones_like(x)],
            dim=-1,
        )
        rays_d = matvec3(c2w[..., :3], dirs)
        rays_d = rays_d / (rays_d * rays_d).sum(-1, keepdim=True).sqrt()
        return c2w[..., 3], rays_d

    @torch.no_grad()
    def refresh_occ_grid(self, state: BARFTrainState, step: int,
                         jitter: Optional[torch.Tensor] = None) -> BARFTrainState:
        """The dense refresh of every cell with ``density(pe_alpha) *
        render_step_size``, the parameters from before the step; ``jitter``
        (levels, cells, 3) the cells' uniform offsets (None: drawn from the
        step's stream 0)."""
        field = self._bind(state.params)
        alpha = self.pe_alpha(step)
        occ = update_occ_grid(
            state.occ_state,
            lambda x: field.query_density(x, pe_alpha=alpha)[..., 0] * self.render_step_size,
            jitter, occ_thre=self.occ_thre, ema_decay=self.ema_decay, step=step,
            warmup_steps=self.warmup_steps, dense=True,
            generator=self._generator(step, 0),
        )
        return state._replace(occ_state=occ)

    def _samples(self, occ: OccGridState, rays_o, rays_d, sigma_fn, near_jitter=None):
        """The march's samples (G2, the first ``max_samples_per_ray``
        candidates a ray) kept by the visibility filter: (ray ids int64,
        t_starts, t_ends)."""
        res = sampling(
            occ, rays_o.contiguous(), rays_d.contiguous(), near_plane=self.near_plane,
            far_plane=self.far_plane,
            render_step_size=self.render_step_size, near_jitter=near_jitter,
            max_samples=self.max_samples_per_ray,
        )
        ids, t0, t1 = res.ray_indices.long(), res.t_starts, res.t_ends
        vis = visible_samples(occ.occs, ids, t0, t1, rays_o.shape[0], sigma_fn=sigma_fn,
                              early_stop_eps=self.early_stop_eps, alpha_thre=self.alpha_thre)
        if vis is not None:
            ids, t0, t1 = ids[vis], t0[vis], t1[vis]
        return ids, t0, t1

    def _render(self, field_fn, rays_o, rays_d, ids, t0, t1, render_bkgd):
        """Colours of the rays from the kept samples: ``field_fn(positions,
        dirs) -> (rgb, density)`` at each sample's midpoint."""
        def rgb_sigma_fn(t_starts, t_ends, ray_indices):
            t_mid = 0.5 * (t_starts + t_ends)
            d = rays_d[ray_indices]
            rgb, density = field_fn(rays_o[ray_indices] + t_mid[:, None] * d, d)
            return rgb, density[..., 0]

        colors, _, _, _ = rendering(t0, t1, ids, rays_o.shape[0], rgb_sigma_fn=rgb_sigma_fn,
                                    render_bkgd=render_bkgd)
        return colors

    # -- one train step ----------------------------------------------------
    def train_step(
        self,
        state: BARFTrainState,
        batch: Dict,
        near_jitter: Optional[torch.Tensor] = None,
        cell_jitter: Optional[torch.Tensor] = None,
    ):
        """One step; returns the new state and an aux dict.

        Args:
            batch: ``{img_ids, x, y, rgb, color_bkgd}`` on the device.
            near_jitter: (n_rays,) uniform [0, 1) near-plane jitter (None:
                drawn from the step's stream 1).
            cell_jitter: the refresh's cell offsets when this step refreshes
                (None: drawn, see :meth:`refresh_occ_grid`).

        The parameters' ``.grad`` hold this step's gradients afterwards (the
        pose deltas' multiplied by 0 before ``pose_start_step``).  Aux:
        ``loss``, ``mse`` and ``pose_grad_norm`` (taken before the mask) as
        device tensors, ``n_total_samples`` (the samples rendered) an int.
        """
        step = int(state.step)
        if step % self.update_interval == 0:
            state = self.refresh_occ_grid(state, step, cell_jitter)
        params = state.params
        fparams, pose = params["field"], params["pose_deltas"]
        leaves = [*fparams.values(), pose]
        for p in leaves:
            p.grad = None
        alpha = self.pe_alpha(step)
        field = self._bind(params)
        rays_o, rays_d = self.rays_from_pixels(pose, batch["img_ids"], batch["x"], batch["y"])
        # the march and the filter see the rays without gradient
        ro, rd = rays_o.detach(), rays_d.detach()
        if not self.stratified:
            near_jitter = None
        elif near_jitter is None:
            near_jitter = torch.rand(ro.shape[0], generator=self._generator(step, 1),
                                     device=self.device)

        def sigma_fn(t0, t1, rid):
            pos = ro[rid] + (0.5 * (t0 + t1))[:, None] * rd[rid]
            return field.query_density(pos, pe_alpha=alpha)[..., 0]

        ids, t0, t1 = self._samples(state.occ_state, ro, rd, sigma_fn, near_jitter)

        def field_fn(positions, dirs):
            return torch.func.functional_call(self.field, fparams, (positions, dirs),
                                              {"pe_alpha": alpha})

        colors = self._render(field_fn, rays_o, rays_d, ids, t0, t1, batch["color_bkgd"])
        loss = smooth_l1_loss(colors, batch["rgb"])
        loss.backward()
        for p in leaves:  # Adam moves a leaf by its momentum on a zero gradient
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        pose_grad_norm = pose.grad.square().sum().sqrt()
        if step < self.pose_start_step:
            pose.grad.mul_(0.0)
        opt, count = state.opt_state
        for group, schedule in zip(opt.param_groups, (self.field_schedule, self.pose_schedule)):
            group["lr"] = schedule(count)
        opt.step()
        aux = {
            "loss": loss.detach(),
            "mse": ((colors.detach() - batch["rgb"]) ** 2).mean(),
            "n_total_samples": int(ids.shape[0]),
            "pose_grad_norm": pose_grad_norm,
        }
        return BARFTrainState(params, OptState(opt, count + 1), state.occ_state, step + 1), aux

    def train_steps(self, state: BARFTrainState, batches: Dict):
        """``batches['rgb'].shape[0]`` steps over batches stacked along a
        leading axis; the aux values come back stacked the same way."""
        auxs = []
        for i in range(batches["rgb"].shape[0]):
            state, aux = self.train_step(state, {k: v[i] for k, v in batches.items()})
            auxs.append(aux)
        return state, {k: torch.stack([torch.as_tensor(a[k], device=self.device)
                                       for a in auxs]) for k in auxs[0]}

    # -- evaluation ----------------------------------------------------------
    def refined_poses(self, state: BARFTrainState) -> np.ndarray:
        """The current (n_images, 3, 4) camera-to-world estimates."""
        with torch.no_grad():
            return self.refined_camtoworlds(state.params["pose_deltas"]).cpu().numpy()

    @torch.no_grad()
    def render_view(self, state: BARFTrainState, data: Dict, chunk: int = 4096):
        """``data``'s rays (``rays_o``, ``rays_d``, ``color_bkgd``), rendered
        with the full spectrum in chunks of ``chunk`` rays through the
        train step's sampling (no jitter) and render: (colors (n, 3), samples
        rendered)."""
        field = self._bind(state.params)
        rays_o = data["rays_o"].reshape(-1, 3)
        rays_d = data["rays_d"].reshape(-1, 3)
        parts, n_samples = [], 0
        for s in range(0, rays_o.shape[0], chunk):
            o, d = rays_o[s : s + chunk], rays_d[s : s + chunk]

            def sigma_fn(t0, t1, rid):
                return field.query_density(o[rid] + (0.5 * (t0 + t1))[:, None] * d[rid])[..., 0]

            ids, t0, t1 = self._samples(state.occ_state, o, d, sigma_fn)
            parts.append(self._render(field, o, d, ids, t0, t1, data["color_bkgd"]))
            n_samples += ids.shape[0]
        return torch.cat(parts), n_samples

    def render_image(self, state: BARFTrainState, data: Dict, chunk: int = 4096):
        """(n_pixels, 3) colours of one view (:meth:`render_view`)."""
        return self.render_view(state, data, chunk)[0]

    def eval_metrics(self, state: BARFTrainState, dataset,
                     max_images: Optional[int] = None) -> Dict:
        """Mean PSNR and SSIM over the first ``max_images`` test views, with
        a record a view: psnr, ssim, wall seconds, samples, rays and whether
        the colours were finite."""
        n = len(dataset) if max_images is None else min(len(dataset), max_images)
        h, w = dataset.HEIGHT, dataset.WIDTH
        views = []
        for i in range(n):
            data = dataset[i]
            t0 = time.perf_counter()
            colors, n_samples = self.render_view(state, data)
            p = psnr(colors, data["rgb"])
            views.append({
                "psnr": p,
                "ssim": ssim(colors.reshape(h, w, 3), data["rgb"].reshape(h, w, 3)),
                "seconds": time.perf_counter() - t0,
                "n_samples": n_samples,
                "n_rays": colors.shape[0],
                "finite": bool(torch.isfinite(colors).all()),
            })
        return {
            "psnr": float(np.mean([v["psnr"] for v in views])),
            "ssim": float(np.mean([v["ssim"] for v in views])),
            "views": views,
        }
