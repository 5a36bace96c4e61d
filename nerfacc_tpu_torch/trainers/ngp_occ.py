"""NGP + occupancy-grid trainer: the train step and the evaluation.

PyTorch counterpart of nerfacc_tpu/trainers/ngp_occ.py.  One train step runs
``_step_body``'s stages in order: a dense occupancy refresh every
``update_interval`` steps (with the parameters from before the update),
stratified marching cut at the sample budget, the differentiable render, a
smooth-L1 loss over the rays the budget left whole, backward, and Adam.
Ported beside it: the learning-rate schedule, ``train_steps`` and the
PSNR/SSIM evaluation.  Not ported (see ROADMAP.md): the dynamic budget
buckets, update clipping, table learning-rate multipliers, the field and
distortion regularisers, time-dependent fields, the pooled and windowed
traversals and ``train_steps_sampled``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch

from ..estimators.occ_grid import OccGridState, init_occ_grid, sampling, update_occ_grid
from ..utils.metrics import psnr, ssim
from ..utils.rendering import (
    compact_samples,
    render_image_with_occgrid,
    render_rays_with_occgrid,
)


# The JAX trainer's optimizer defaults (Adam with coupled L2 decay, its
# learning rate and warmup).
LR = 1e-2
WARMUP_STEPS = 100
ADAM_EPS = 1e-15
WEIGHT_DECAY = 1e-6


def make_lr_schedule(max_steps: int) -> Callable[[int], float]:
    """The JAX package's schedule, as a function of the optimizer's update
    count: a linear warmup from 0.01x over ``WARMUP_STEPS`` updates, then
    0.33x at 1/2, 3/4 and 9/10 of ``max_steps`` (optax's
    ``join_schedules``; coinciding boundaries collapse as there)."""
    boundaries = list(
        {max_steps // 2: 0.33, max_steps * 3 // 4: 0.33, max_steps * 9 // 10: 0.33}
    )
    init = LR * 0.01

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), WARMUP_STEPS) / WARMUP_STEPS
        lr = (init - LR) * frac + LR
        for i, boundary in enumerate(boundaries):
            if count >= boundary:
                lr = LR * 0.33 ** (i + 1)
        return lr

    return schedule


class OptState(NamedTuple):
    optimizer: torch.optim.Adam  # holds the moments; updates params in place
    count: int  # updates applied so far (the schedule's argument)


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]  # the field's state dict, leaf tensors
    opt_state: Optional[OptState]
    occ_state: OccGridState
    step: int


@dataclasses.dataclass
class NGPOccTrainer:
    """Occupancy-grid trainer and renderer around a radiance field.

    Args:
        field: an ``nn.Module`` with ``init(generator)``,
            ``forward(positions, dirs) -> (rgb, density)`` and
            ``query_density(x)``; moved to ``device``.
        aabb: scene roi (6 floats).
        max_steps: length of the learning-rate schedule.
        grid_resolution / grid_nlvl: occupancy grid shape.
        render_step_size, near_plane, far_plane, cone_angle: marching.
        occ_thre / ema_decay / update_interval: occupancy refresh.
        sample_budget: samples rendered per train step at most; the rays the
            cut leaves incomplete are masked out of the loss.
        stratified: jitter each ray's near plane by up to one step.
        seed: seeds the parameters and every step's noise.
        device: where the state lives and everything runs.
    """

    field: Any
    aabb: Any
    max_steps: int = 20000
    grid_resolution: int = 128
    grid_nlvl: int = 1
    render_step_size: float = 5e-3
    near_plane: float = 0.0
    far_plane: float = 1e10
    cone_angle: float = 0.0
    occ_thre: float = 1e-2
    ema_decay: float = 0.95
    update_interval: int = 16
    sample_budget: int = 2**18
    stratified: bool = True
    seed: int = 42
    device: Union[str, torch.device] = "cpu"

    def __post_init__(self):
        self.device = torch.device(self.device)
        # The field's f32 matmuls carry the JAX package's bf16-operand,
        # f32-result contract; TF32 would round their operands further.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.field = self.field.to(self.device)
        self.schedule = make_lr_schedule(self.max_steps)

    def init_state(self) -> TrainState:
        """Parameters drawn from ``torch.Generator().manual_seed(seed)`` (on
        the CPU, so every device starts from the same weights), fresh Adam
        moments and an empty occupancy grid."""
        self.field.init(torch.Generator().manual_seed(self.seed))
        params = {
            k: v.detach().clone().requires_grad_(True)
            for k, v in self.field.state_dict().items()
        }
        occ_state = init_occ_grid(
            self.aabb, self.grid_resolution, self.grid_nlvl, device=self.device
        )
        return TrainState(params, self.init_optimizer(params), occ_state, 0)

    def init_optimizer(self, params: Dict[str, torch.Tensor]) -> OptState:
        """Adam over ``params``: optax's ``add_decayed_weights`` before
        ``scale_by_adam`` is torch's coupled L2 ``weight_decay``."""
        adam = torch.optim.Adam(
            list(params.values()), lr=self.schedule(0), betas=(0.9, 0.999),
            eps=ADAM_EPS, weight_decay=WEIGHT_DECAY,
        )
        return OptState(adam, 0)

    def apply_gradients(self, opt_state: OptState) -> OptState:
        """One Adam update from the parameters' ``.grad``, at the schedule's
        value for the update count before the increment (as optax)."""
        lr = self.schedule(opt_state.count)
        for group in opt_state.optimizer.param_groups:
            group["lr"] = lr
        opt_state.optimizer.step()
        return OptState(opt_state.optimizer, opt_state.count + 1)

    def _generator(self, step: int, stream: int) -> torch.Generator:
        """The noise of one step: stream 0 the refresh's cell jitter, 1 the
        near-plane jitter."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 1_000_003 + int(step)) * 2 + stream)
        return gen

    def _bind(self, state: TrainState):
        """The field, carrying ``state``'s parameters."""
        self.field.load_state_dict(state.params)
        return self.field

    @torch.no_grad()
    def refresh_occ_grid(
        self, state: TrainState, step: int, jitter: Optional[torch.Tensor] = None
    ) -> TrainState:
        """One dense occupancy update with ``density * render_step_size``.

        ``jitter``: (levels, cells, 3) uniform offsets inside the cells;
        None draws them from a generator seeded by (seed, step), so a
        refresh at a given step is reproducible."""
        field = self._bind(state)
        occ = state.occ_state
        if jitter is None:
            jitter = torch.rand(
                (occ.levels, occ.cells_per_lvl, 3),
                generator=self._generator(step, 0), device=self.device,
            )
        occ = update_occ_grid(
            occ,
            lambda x: field.query_density(x)[..., 0] * self.render_step_size,
            jitter,
            occ_thre=self.occ_thre,
            ema_decay=self.ema_decay,
        )
        return state._replace(occ_state=occ)

    # -- one train step ----------------------------------------------------
    def train_step(
        self,
        state: TrainState,
        batch: Dict,
        near_jitter: Optional[torch.Tensor] = None,
        cell_jitter: Optional[torch.Tensor] = None,
    ):
        """One step; returns the new state and an aux dict.

        Args:
            batch: ``{rays_o, rays_d, rgb, color_bkgd}`` on the device.
            near_jitter: (n_rays,) uniform [0, 1) near-plane jitter of a
                stratified step (None: drawn from the step's generator).
            cell_jitter: the refresh's cell offsets when this step refreshes
                (None: drawn, see :meth:`refresh_occ_grid`).

        The parameters' ``.grad`` hold this step's gradients afterwards.
        Aux: ``loss``, ``mse``, ``n_rays_ok``, ``n_rays_truncated`` as
        device tensors; ``n_rendering_samples``, ``n_total_samples`` (before
        the budget cut) and ``overflow`` as ints.
        """
        step = int(state.step)
        params = state.params
        if step % self.update_interval == 0:
            state = self.refresh_occ_grid(state, step, cell_jitter)
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        pixels, render_bkgd = batch["rgb"], batch["color_bkgd"]
        n_rays = rays_o.shape[0]
        if not self.stratified:
            near_jitter = None
        elif near_jitter is None:
            near_jitter = torch.rand(
                n_rays, generator=self._generator(step, 1), device=self.device
            )
        samples = compact_samples(
            sampling(
                state.occ_state, rays_o, rays_d,
                near_plane=self.near_plane, far_plane=self.far_plane,
                render_step_size=self.render_step_size,
                cone_angle=self.cone_angle, near_jitter=near_jitter,
            ),
            self.sample_budget,
        )
        # The march walks every orbit to its end, so every ray terminates and
        # the JAX package's window mask below is all true; it stays so that
        # the loss reads like its counterpart.
        terminated = torch.ones(n_rays, dtype=torch.bool, device=rays_o.device)
        # Rays cut by the sample budget render wrong colours: no loss there.
        budget_ok = (
            torch.arange(n_rays, device=rays_o.device) < samples.first_incomplete_ray
        )[:, None]

        def rgb_sigma_fn(positions, dirs):
            rgb, density = torch.func.functional_call(
                self.field, params, (positions, dirs)
            )
            return rgb, density[..., 0]

        for p in params.values():
            p.grad = None
        colors, opacities, _, extras = render_rays_with_occgrid(
            rgb_sigma_fn, rays_o, rays_d, samples, render_bkgd
        )
        window_ok = terminated[:, None] | (opacities > 1.0 - 1e-3)
        frac_ok = window_ok.float().mean()
        ray_ok = budget_ok & torch.where(frac_ok > 0.25, window_ok, True)
        n_ok = ray_ok.sum().clamp_min(1)
        diff = (colors - pixels).abs() * ray_ok
        loss = torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5).sum() / (n_ok * 3)
        mse = (diff.detach() ** 2).sum() / (n_ok * 3)
        loss.backward()
        opt_state = self.apply_gradients(state.opt_state)

        aux = {
            "loss": loss.detach(),
            "mse": mse,
            "n_rays_ok": ray_ok.sum(),
            "n_rendering_samples": extras["n_rendering_samples"],
            "n_total_samples": samples.num_valid + samples.overflow,
            "overflow": samples.overflow,
            "n_rays_truncated": (~terminated).sum(),
        }
        return TrainState(params, opt_state, state.occ_state, step + 1), aux

    def train_steps(self, state: TrainState, batches: Dict):
        """``batches['rgb'].shape[0]`` steps over batches stacked along a
        leading axis; the aux values come back stacked the same way."""
        auxs = []
        for i in range(batches["rgb"].shape[0]):
            state, aux = self.train_step(state, {k: v[i] for k, v in batches.items()})
            auxs.append(aux)
        return state, {
            k: torch.stack([torch.as_tensor(a[k], device=self.device) for a in auxs])
            for k in auxs[0]
        }

    # -- evaluation ----------------------------------------------------------
    @torch.inference_mode()
    def render_rays(self, state: TrainState, data: Dict, chunk: int = 8192):
        """Render ``data``'s rays: (colors, opacities, depths, n_samples)."""
        field = self._bind(state)

        def field_fn(positions, dirs):
            rgb, density = field(positions, dirs)
            return rgb, density[..., 0]

        return render_image_with_occgrid(
            field_fn,
            state.occ_state,
            data["rays_o"].reshape(-1, 3),
            data["rays_d"].reshape(-1, 3),
            render_bkgd=data["color_bkgd"],
            near_plane=self.near_plane,
            far_plane=self.far_plane,
            render_step_size=self.render_step_size,
            cone_angle=self.cone_angle,
            chunk=chunk,
        )

    def render_image(self, state: TrainState, data: Dict, chunk: int = 8192):
        """(n_pixels, 3) colours of one view."""
        return self.render_rays(state, data, chunk)[0]

    def eval_metrics(self, state: TrainState, dataset, max_images: Optional[int] = None) -> Dict:
        """Mean PSNR and SSIM over the test views, with a per-view record:
        psnr, ssim, wall seconds (render and PSNR, which ends in a device
        sync), samples rendered, rays, opacity range and whether every
        output was finite."""
        n = len(dataset) if max_images is None else min(len(dataset), max_images)
        h, w = dataset.HEIGHT, dataset.WIDTH
        views = []
        for i in range(n):
            data = dataset[i]
            t0 = time.perf_counter()
            colors, opacities, depths, n_samples = self.render_rays(state, data)
            p = psnr(colors, data["rgb"])
            seconds = time.perf_counter() - t0
            views.append(
                {
                    "psnr": p,
                    "ssim": ssim(colors.reshape(h, w, 3), data["rgb"].reshape(h, w, 3)),
                    "seconds": seconds,
                    "n_samples": n_samples,
                    "n_rays": colors.shape[0],
                    "opacity_min": float(opacities.min()),
                    "opacity_max": float(opacities.max()),
                    "finite": bool(
                        torch.isfinite(colors).all()
                        & torch.isfinite(opacities).all()
                        & torch.isfinite(depths).all()
                    ),
                }
            )
        return {
            "psnr": float(np.mean([v["psnr"] for v in views])),
            "ssim": float(np.mean([v["ssim"] for v in views])),
            "views": views,
        }
