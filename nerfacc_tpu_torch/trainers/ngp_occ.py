"""NGP + occupancy-grid trainer: the train step and the evaluation.

PyTorch counterpart of nerfacc_tpu/trainers/ngp_occ.py.  One train step runs
``_step_body``'s stages in order: an occupancy update every
``update_interval`` steps (with the parameters from before the update; the
dense refresh of every cell through ``warmup_steps``, then the dense, the
striped or the sampled update of ``update_occ_grid``),
stratified marching cut at the sample budget, the differentiable render, a
smooth-L1 loss over the rays the budget left whole (plus the field's
regulariser when ``field_reg_weight`` is set), backward, and Adam.
Time-dependent fields (given ``timestamps``) read each sample's ray time in
training, one random frame time per cell in the refresh, and the view's time
in evaluation.  Ported beside it: the learning-rate schedule,
``train_steps``, ``train_steps_sampled`` (batches drawn on the device) and
the evaluation (PSNR/SSIM through the early-stopping eval renderer), the
distortion regulariser, the update clip and the table learning-rate
multiplier (:class:`ChainAdam`).  Not ported (see ROADMAP.md): the dynamic
budget buckets; the step marches every orbit whole, the sample set of the
JAX step's pooled and windowed traversals (which are entry points of
:mod:`nerfacc_tpu_torch.grid`, not options of the step).  ``alpha_thre`` is
taken and changes no sample, as in the JAX trainer (see the class).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..estimators.occ_grid import (
    OccGridState,
    cells_evaluated,
    init_occ_grid,
    sampling,
    update_mode,
    update_occ_grid,
)
from ..losses import distortion
from ..parallel.mesh import take_block
from ..utils.metrics import psnr, ssim
from ..utils.rendering import (
    compact_samples,
    render_image_with_occgrid,
    render_rays_occgrid_test,
    render_rays_with_occgrid,
)
from ..volrend import render_weight_from_density


# The JAX trainer's defaults for its fields lr, warmup_lr_steps and adam_eps
# (the MLP examples take 5e-4, no warmup and 1e-8).
LR = 1e-2
WARMUP_STEPS = 100
ADAM_EPS = 1e-15
# The eval renderer's settings, the JAX trainer's defaults: rounds of 128
# orbit candidates, at most max_samples_per_ray (1024) // 32 of them, a ray
# retired once its opacity passes 1 - 1e-4.
EVAL_WINDOW = 128
EVAL_MAX_ROUNDS = 1024 // 32
EVAL_EARLY_STOP_EPS = 1e-4


def disable_tf32() -> None:
    """The fields' f32 matmuls carry the JAX package's bf16-operand,
    f32-result contract; TF32 would round their operands further."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_lr_schedule(max_steps: int, base_lr: float = LR,
                     warmup: int = WARMUP_STEPS) -> Callable[[int], float]:
    """The JAX package's schedule, as a function of the optimizer's update
    count: a linear warmup from 0.01x ``base_lr`` over ``warmup`` updates
    (0: the constant ``base_lr``), then 0.33x at 1/2, 3/4 and 9/10 of
    ``max_steps`` (optax's ``join_schedules``; coinciding boundaries
    collapse as there)."""
    boundaries = list(
        {max_steps // 2: 0.33, max_steps * 3 // 4: 0.33, max_steps * 9 // 10: 0.33}
    )
    init = base_lr * 0.01

    def schedule(count: int) -> float:
        lr = base_lr
        if warmup > 0:
            frac = 1.0 - min(max(count, 0), warmup) / warmup
            lr = (init - base_lr) * frac + base_lr
        for i, boundary in enumerate(boundaries):
            if count >= boundary:
                lr = base_lr * 0.33 ** (i + 1)
        return lr

    return schedule


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``torch.nn.functional.smooth_l1_loss`` with beta 1 and the mean
    reduction, in the JAX package's form; the proposal and BARF trainers
    take their loss from it (this trainer's loss is its masked sum over
    the rays the budget left whole)."""
    diff = (pred - target).abs()
    return torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5).mean()


class OptState(NamedTuple):
    optimizer: torch.optim.Optimizer  # holds the moments; updates params in place
    count: int  # updates applied so far (the schedule's argument)


class ChainAdam(torch.optim.Optimizer):
    """optax's chain ``add_decayed_weights(weight_decay)``,
    ``scale_by_adam``, ``clip_by_global_norm(max_norm)`` (0: off), a
    ``scale`` of the updates of the leaves ``scaled`` marks, then the
    learning rate, in that order, over one group of leaves.

    ``torch.optim.Adam`` cannot express the clip: it clips the global norm
    of Adam's *update*, whose step does not depend on the gradient's scale,
    so a clip of the raw gradients would do nothing.  The moments are kept
    under ``torch.optim.Adam``'s names (``step``, ``exp_avg``,
    ``exp_avg_sq``); a leaf whose ``.grad`` is None is skipped, as there.
    """

    def __init__(self, params, lr=1e-2, betas=(0.9, 0.999), eps=ADAM_EPS,
                 weight_decay=0.0, max_norm=0.0, scale=1.0, scaled=()):
        params = list(params)
        scaled = tuple(bool(s) for s in scaled) or (False,) * len(params)
        if len(scaled) != len(params):
            raise ValueError("one entry of scaled per leaf")
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay, max_norm=max_norm,
                                      scale=scale, scaled=scaled))

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        (b1, b2), eps, wd = group["betas"], group["eps"], group["weight_decay"]
        updates = []
        for p in group["params"]:
            if p.grad is None:
                updates.append(None)
                continue
            g = p.grad + wd * p if wd else p.grad
            st = self.state[p]
            if not st:
                st.update(step=torch.zeros(()), exp_avg=torch.zeros_like(p),
                          exp_avg_sq=torch.zeros_like(p))
            st["step"] += 1
            t = float(st["step"])
            st["exp_avg"].mul_(b1).add_(g, alpha=1 - b1)
            st["exp_avg_sq"].mul_(b2).addcmul_(g, g, value=1 - b2)
            m_hat = st["exp_avg"] / (1 - b1**t)
            v_hat = st["exp_avg_sq"] / (1 - b2**t)
            updates.append(m_hat / (v_hat.sqrt() + eps))
        live = [u for u in updates if u is not None]
        if group["max_norm"] > 0 and live:
            norm = torch.stack([u.square().sum() for u in live]).sum().sqrt()
            clip = norm >= group["max_norm"]
            updates = [None if u is None else torch.where(clip, u / norm * group["max_norm"], u)
                       for u in updates]
        for p, u, scaled in zip(group["params"], updates, group["scaled"]):
            if u is not None:
                p.add_(u * group["scale"] if scaled else u, alpha=-group["lr"])


def make_adam(leaves, schedule: Callable[[int], float], weight_decay: float,
              grad_clip: float = 0.0, table_lr_mult: float = 1.0, tables=(),
              eps: float = ADAM_EPS) -> OptState:
    """Adam (epsilon ``eps``) over the tensors ``leaves``.  Without
    ``grad_clip`` and ``table_lr_mult``, ``torch.optim.Adam``: optax's
    ``add_decayed_weights`` before ``scale_by_adam`` is its coupled L2
    ``weight_decay``.  With either, :class:`ChainAdam`, which clips the
    update's global norm at ``grad_clip`` and scales the update of the
    leaves that ``tables`` marks (one bool a leaf) by ``table_lr_mult``."""
    leaves = list(leaves)
    if grad_clip > 0 or table_lr_mult != 1.0:
        opt = ChainAdam(leaves, lr=schedule(0), eps=eps, weight_decay=weight_decay,
                        max_norm=grad_clip, scale=table_lr_mult, scaled=tables)
        return OptState(opt, 0)
    adam = torch.optim.Adam(
        leaves, lr=schedule(0), betas=(0.9, 0.999), eps=eps,
        weight_decay=weight_decay,
    )
    return OptState(adam, 0)


def adam_update(opt_state: OptState, schedule: Callable[[int], float]) -> OptState:
    """One Adam update from the leaves' ``.grad``, at the schedule's value
    for the update count before the increment (as optax).  A leaf whose
    ``.grad`` is None is skipped: its moments do not decay and its step
    count does not advance."""
    lr = schedule(opt_state.count)
    for group in opt_state.optimizer.param_groups:
        group["lr"] = lr
    opt_state.optimizer.step()
    return OptState(opt_state.optimizer, opt_state.count + 1)


def all_reduce_grads(leaves, group, extras=(), average: bool = False):
    """Sum (or, with ``average``, average) the leaves' ``.grad`` and the
    scalars ``extras`` over ``group`` in one all-reduce of a flat f32
    buffer; write the gradients back and return the reduced ``extras``.
    A leaf whose ``.grad`` is None sends zeros and gets the sum."""
    leaves = list(leaves)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads] + [e.reshape(1).float() for e in extras])
    dist.all_reduce(flat, group=group)
    if average:
        flat = flat / dist.get_world_size(group)
    offset = 0
    for p, g in zip(leaves, grads):
        p.grad = flat[offset : offset + g.numel()].view_as(g)
        offset += g.numel()
    return [flat[offset + i] for i in range(len(extras))]


def all_reduce_counts(counts, group):
    """Sum integer counts (ints or 0-d tensors) over ``group``, in one
    all-reduce; ints come back as ints, tensors as int64 tensors."""
    device = next((c.device for c in counts if isinstance(c, torch.Tensor)), None)
    flat = torch.stack([torch.as_tensor(c, dtype=torch.int64, device=device) for c in counts])
    dist.all_reduce(flat, group=group)
    host = flat.tolist()
    return [flat[i] if isinstance(c, torch.Tensor) else host[i] for i, c in enumerate(counts)]


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
            ``query_density(x)``; moved to ``device``.  A time-dependent
            field has ``forward(positions, t, dirs)``,
            ``query_opacity(x, timestamps, step_size, frame_idx)`` and
            ``param_regularizer(params)``.
        aabb: scene roi (6 floats).
        max_steps: length of the learning-rate schedule.
        lr: its base learning rate.
        warmup_lr_steps: updates of its linear warmup from 0.01 ``lr`` (0:
            none, the constant ``lr`` until the first decay).
        adam_eps: Adam's epsilon.
        weight_decay: Adam's coupled L2 decay.
        grid_resolution / grid_nlvl: occupancy grid shape.
        render_step_size, near_plane, far_plane, cone_angle: marching.
        alpha_thre: taken for the JAX trainer's signature; it changes no
            sample.  The JAX trainer hands it to ``sampling_padded``
            (nerfacc_tpu/trainers/ngp_occ.py:463) with no ``sigma_fn`` or
            ``alpha_fn``, and the visibility filter that reads it runs only
            with one of them (nerfacc_tpu/estimators/occ_grid.py:408-431);
            its default pooled traversal and its eval renderer never read
            it.  So the port runs no density pre-pass for it either.
        occ_thre / ema_decay / update_interval: occupancy updates.
        warmup_steps: every update before this step refreshes every cell.
        dense_occ_update: after warmup, refresh every cell (or a stripe, see
            ``occ_refresh_stripes``); False: the reference's sampled update,
            a quarter of the cells drawn uniformly and as many occupied ones.
        occ_refresh_stripes: with ``dense_occ_update``, S > 1 refreshes one
            rotating 1/S stripe of every level's cells per update after
            warmup, with decay ``ema_decay ** S``.
        sample_budget: samples rendered per train step at most; the rays the
            cut leaves incomplete are masked out of the loss.
        stratified: jitter each ray's near plane by up to one step.
        timestamps: (n_frames, 1) frame times, the refresh's draw; given,
            the field is time-dependent and every batch carries
            ``timestamps`` (n_rays, 1).
        field_reg_weight: weight of ``field.param_regularizer`` in the loss
            (0: off).
        distortion_loss_weight: weight of the Mip-NeRF 360 distortion
            loss (:func:`~nerfacc_tpu_torch.losses.distortion`) over the
            rays in the loss (0: off).
        grad_clip: clip the global norm of Adam's update at this (0: off);
            see :class:`ChainAdam`.
        table_lr_mult: scale of the grid tables' updates (the parameters
            under ``encoder.``), after the clip (1: off).
        seed: seeds the parameters and every step's noise.
        device: where the state lives and everything runs: the card
            unless the caller asks for another (the tests pass "cpu").
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
    alpha_thre: float = 0.0
    occ_thre: float = 1e-2
    ema_decay: float = 0.95
    warmup_steps: int = 256
    update_interval: int = 16
    dense_occ_update: bool = True
    occ_refresh_stripes: int = 1
    sample_budget: int = 2**18
    stratified: bool = True
    weight_decay: float = 1e-6
    lr: float = LR
    adam_eps: float = ADAM_EPS
    warmup_lr_steps: int = WARMUP_STEPS
    timestamps: Any = None
    field_reg_weight: float = 0.0
    distortion_loss_weight: float = 0.0
    grad_clip: float = 0.0
    table_lr_mult: float = 1.0
    seed: int = 42
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        disable_tf32()
        self.field = self.field.to(self.device)
        self.schedule = make_lr_schedule(self.max_steps, self.lr, self.warmup_lr_steps)
        if self.timestamps is not None:
            ts = self.timestamps
            if not isinstance(ts, torch.Tensor):
                ts = torch.tensor(np.asarray(ts, np.float32))
            self.timestamps = ts.to(self.device, torch.float32).reshape(-1, 1)

    def init_state(self) -> TrainState:
        """Parameters drawn from ``torch.Generator().manual_seed(seed)`` (on
        the CPU, so every device starts from the same weights), fresh Adam
        moments and an empty occupancy grid."""
        self.field.init(torch.Generator().manual_seed(self.seed))
        params = {
            k: v.detach().clone().requires_grad_(True)
            for k, v in self.field.state_dict().items()
        }
        if self.table_lr_mult != 1.0 and not any(k.startswith("encoder.") for k in params):
            warnings.warn(
                f"table_lr_mult={self.table_lr_mult} has no effect: the field's "
                f"parameters have no 'encoder.' entries (keys: {sorted(params)})",
                stacklevel=2,
            )
        occ_state = init_occ_grid(
            self.aabb, self.grid_resolution, self.grid_nlvl, device=self.device
        )
        return TrainState(params, self.init_optimizer(params), occ_state, 0)

    def init_optimizer(self, params: Dict[str, torch.Tensor]) -> OptState:
        """Adam over ``params`` (:func:`make_adam`), with the trainer's update
        clip and table scale."""
        return make_adam(
            params.values(), self.schedule, self.weight_decay, self.grad_clip,
            self.table_lr_mult, [k.startswith("encoder.") for k in params],
            self.adam_eps,
        )

    def apply_gradients(self, opt_state: OptState) -> OptState:
        """One Adam update from the parameters' ``.grad`` (:func:`adam_update`)."""
        return adam_update(opt_state, self.schedule)

    def _generator(self, step: int, stream: int) -> torch.Generator:
        """The noise of one step: stream 0 the occupancy update's draws (the
        sampled update's cell ids, then the cell jitter), 1 the
        near-plane jitter, 2 the refresh's frame draw, 3 the batch of
        :meth:`train_steps_sampled`, seeded 2^40 above the other three (a
        fourth stream at ``* 3 + 3`` would reuse the next step's stream 0)."""
        key = self.seed * 1_000_003 + int(step)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(key * 3 + stream if stream < 3 else (1 << 40) + key)
        return gen

    def _bind(self, state: TrainState):
        """The field, carrying ``state``'s parameters."""
        self.field.load_state_dict(state.params)
        return self.field

    @torch.no_grad()
    def refresh_occ_grid(
        self,
        state: TrainState,
        step: int,
        jitter: Optional[torch.Tensor] = None,
        frame_idx: Optional[torch.Tensor] = None,
        cell_ids: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> TrainState:
        """One occupancy update with ``density * render_step_size``, in the
        mode ``update_occ_grid`` takes at ``step`` (the dense refresh before
        ``warmup_steps``, then the dense, striped or sampled update the
        trainer's fields ask for), the field's points fed in chunks of at
        most ``min(2^21, field.max_eval_chunk)``.

        ``jitter``: (levels, cells evaluated a level, 3) uniform offsets
        inside the cells; ``cell_ids``: the sampled update's (uniform,
        occupied) (levels, cells // 4) ids; ``frame_idx``: (levels * cells
        evaluated a level,) frame of each cell's time, for a time-dependent
        field.  None draws them: the ids, then the jitter from the step's
        stream 0, the frames from stream 2, so an update at a given step is
        reproducible."""
        field = self._bind(state)
        occ = state.occ_state
        mode = update_mode(step, self.warmup_steps, self.dense_occ_update,
                           self.occ_refresh_stripes)
        n_eval = cells_evaluated(mode, occ.cells_per_lvl, self.occ_refresh_stripes)
        if self.timestamps is None:
            def occ_eval_fn(x):
                return field.query_density(x)[..., 0] * self.render_step_size
        else:
            if frame_idx is None:
                frame_idx = torch.randint(
                    0, self.timestamps.shape[0], (occ.levels * n_eval,),
                    generator=self._generator(step, 2), device=self.device,
                )

            def occ_eval_fn(x, frames):
                return field.query_opacity(
                    x, self.timestamps, self.render_step_size, frames
                )[..., 0]

        uniform_ids, occupied_ids = (None, None) if cell_ids is None else cell_ids
        occ = update_occ_grid(
            occ, occ_eval_fn, jitter, occ_thre=self.occ_thre,
            ema_decay=self.ema_decay,
            eval_chunk=min(2**21, getattr(self.field, "max_eval_chunk", 2**21)),
            cell_data=frame_idx, step=step, warmup_steps=self.warmup_steps,
            dense=self.dense_occ_update, dense_stripes=self.occ_refresh_stripes,
            update_interval=self.update_interval, uniform_ids=uniform_ids,
            occupied_ids=occupied_ids, generator=self._generator(step, 0),
        )
        return state._replace(occ_state=occ)

    # -- one train step ----------------------------------------------------
    def train_step(
        self,
        state: TrainState,
        batch: Dict,
        near_jitter: Optional[torch.Tensor] = None,
        cell_jitter: Optional[torch.Tensor] = None,
        frame_idx: Optional[torch.Tensor] = None,
        cell_ids: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        group=None,
    ):
        """One step; returns the new state and an aux dict.

        Args:
            batch: ``{rays_o, rays_d, rgb, color_bkgd}`` on the device, and
                ``timestamps`` (n_rays, 1) for a time-dependent field.
            near_jitter: (n_rays,) uniform [0, 1) near-plane jitter of a
                stratified step (None: drawn from the step's generator).
            cell_jitter / frame_idx / cell_ids: the update's cell offsets,
                frames and sampled ids when this step updates the grid
                (None: drawn, see :meth:`refresh_occ_grid`).
            group: a ``torch.distributed`` group whose ranks each hold one
                block of a global batch (see ``parallel.mesh``), with the
                JAX step body's collectives under ``axis_name``: the mean of
                ``frac_ok`` and the sum of the completed rays before the
                loss divides by them, the regulariser divided by the group's
                size, the gradients, loss, mse and aux counts summed.  The
                near-plane jitter is the global batch's, drawn from stream 1
                on every rank and cut to this rank's block, so a step equals
                the single-process step on the global batch.  None: one
                process, no collective.

        The parameters' ``.grad`` hold this step's gradients afterwards.
        Aux: ``loss``, ``mse``, ``n_rays_ok``, ``n_rays_truncated`` as
        device tensors; ``n_rendering_samples``, ``n_total_samples`` (before
        the budget cut) and ``overflow`` as ints.
        """
        step = int(state.step)
        params = state.params
        if step % self.update_interval == 0:
            state = self.refresh_occ_grid(state, step, cell_jitter, frame_idx, cell_ids)
        rays_o, rays_d = batch["rays_o"], batch["rays_d"]
        pixels, render_bkgd = batch["rgb"], batch["color_bkgd"]
        n_rays = rays_o.shape[0]
        world, rank = (1, 0) if group is None else (dist.get_world_size(group),
                                                     dist.get_rank(group))
        if not self.stratified:
            near_jitter = None
        elif near_jitter is None:
            near_jitter = torch.rand(
                n_rays * world, generator=self._generator(step, 1), device=self.device
            )[rank * n_rays : (rank + 1) * n_rays]
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

        def rgb_sigma_fn(positions, dirs, ray_indices):
            # a time-dependent field reads each sample's ray time
            times = () if self.timestamps is None else (batch["timestamps"][ray_indices.long()],)
            rgb, density = torch.func.functional_call(
                self.field, params, (positions, *times, dirs)
            )
            return rgb, density[..., 0]

        for p in params.values():
            p.grad = None
        colors, opacities, _, extras = render_rays_with_occgrid(
            rgb_sigma_fn, rays_o, rays_d, samples, render_bkgd
        )
        window_ok = terminated[:, None] | (opacities > 1.0 - 1e-3)
        frac_ok = window_ok.float().mean()
        if group is None:
            ray_ok = budget_ok & torch.where(frac_ok > 0.25, window_ok, True)
            n_ok = ray_ok.sum().clamp_min(1)
        else:
            # one all-reduce: the shards' frac_ok and their completed rays
            # under either branch of the mask
            sums = torch.stack([frac_ok.double(), (budget_ok & window_ok).sum().double(),
                                budget_ok.sum().double()])
            dist.all_reduce(sums, group=group)
            frac_ok = sums[0].float() / world
            ray_ok = budget_ok & torch.where(frac_ok > 0.25, window_ok, True)
            n_ok = torch.where(frac_ok > 0.25, sums[1], sums[2]).long().clamp_min(1)
        diff = (colors - pixels).abs() * ray_ok
        loss = torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5).sum() / (n_ok * 3)
        mse = (diff.detach() ** 2).sum() / (n_ok * 3)
        if self.distortion_loss_weight > 0:
            # differentiable weights (G3's carry no gradient)
            weights, _, _ = render_weight_from_density(
                samples.t_starts, samples.t_ends, extras["sigmas"],
                ray_indices=samples.ray_indices, n_rays=n_rays, indices_sorted=True,
                seg_starts=samples.seg_starts, seg_ends=samples.seg_ends,
            )
            per_ray = distortion(weights, samples.t_starts, samples.t_ends,
                                 samples.ray_indices, n_rays)
            loss = loss + self.distortion_loss_weight * (per_ray * ray_ok).sum() / n_ok
        if self.field_reg_weight > 0:
            # replicated parameters and summed shard losses: divide by the
            # group's size so the global loss carries the term once
            loss = loss + self.field_reg_weight * self.field.param_regularizer(params) / world
        loss.backward()
        loss = loss.detach()
        counts = (ray_ok.sum(), extras["n_rendering_samples"],
                  samples.num_valid + samples.overflow, samples.overflow, (~terminated).sum())
        if group is not None:
            loss, mse = all_reduce_grads(params.values(), group, (loss, mse))
            counts = all_reduce_counts(counts, group)
        opt_state = self.apply_gradients(state.opt_state)

        aux = {
            "loss": loss,
            "mse": mse,
            "n_rays_ok": counts[0],
            "n_rendering_samples": counts[1],
            "n_total_samples": counts[2],
            "overflow": counts[3],
            "n_rays_truncated": counts[4],
        }
        return TrainState(params, opt_state, state.occ_state, step + 1), aux

    def train_steps(self, state: TrainState, batches: Dict, group=None):
        """``batches['rgb'].shape[0]`` steps over batches stacked along a
        leading axis; the aux values come back stacked the same way.
        ``group``: see :meth:`train_step` (each rank passes its blocks)."""
        auxs = []
        for i in range(batches["rgb"].shape[0]):
            state, aux = self.train_step(
                state, {k: v[i] for k, v in batches.items()}, group=group
            )
            auxs.append(aux)
        return state, self._stack(auxs)

    def train_steps_sampled(self, state: TrainState, sampler, n_steps: int, group=None):
        """``n_steps`` steps, each on a batch that ``sampler`` (a
        :class:`~nerfacc_tpu_torch.data.device_sampler.DeviceRaySampler`)
        draws on the device from the step's own generator (stream 3), so a
        run resumed at a step draws the batches the whole run drew.  The
        aux values come back stacked, as from :meth:`train_steps`.  With a
        ``group`` (see :meth:`train_step`) every rank draws the global batch
        and trains on its block of it."""
        if self.timestamps is not None:
            raise ValueError(
                "train_steps_sampled draws no ray times: use train_steps for a "
                "time-dependent field"
            )
        auxs = []
        for _ in range(int(n_steps)):
            batch = sampler.sample(self._generator(state.step, 3))
            if group is not None:
                batch = take_block(batch, dist.get_rank(group), dist.get_world_size(group))
            state, aux = self.train_step(state, batch, group=group)
            auxs.append(aux)
        return state, self._stack(auxs)

    def _stack(self, auxs):
        return {
            k: torch.stack([torch.as_tensor(a[k], device=self.device) for a in auxs])
            for k in auxs[0]
        }

    # -- evaluation ----------------------------------------------------------
    def _field_fn(self, state: TrainState, data: Dict):
        """The field with ``state``'s parameters as ``(positions, dirs) ->
        (rgb, sigma)``; a time-dependent field sees every sample at the
        view's time, ``data["timestamps"]``'s first entry."""
        field = self._bind(state)
        t = data["timestamps"].reshape(-1)[:1] if self.timestamps is not None else None

        def field_fn(positions, dirs):
            if t is None:
                rgb, density = field(positions, dirs)
            else:
                rgb, density = field(positions, t.expand(positions.shape[0], 1), dirs)
            return rgb, density[..., 0]

        return field_fn

    @torch.inference_mode()
    def render_rays(self, state: TrainState, data: Dict, chunk: int = 8192):
        """Render ``data``'s rays with every occupied sample (the exact
        renderer): (colors, opacities, depths, n_samples)."""
        return render_image_with_occgrid(
            self._field_fn(state, data),
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

    @torch.inference_mode()
    def render_view(self, state: TrainState, data: Dict, chunk: int = 8192):
        """Render ``data``'s rays through the eval renderer,
        :func:`render_rays_occgrid_test` with windows of ``EVAL_WINDOW``
        candidates, at most ``EVAL_MAX_ROUNDS`` rounds per chunk of rays, and
        early stopping at ``1 - EVAL_EARLY_STOP_EPS``: (colors, opacities,
        depths, n_samples over the rounds).  The JAX trainer's three eval
        renderers ("cursor", "pooled" and "") render this image: its cursor
        and pooled renderers are TPU reorganisations of it (one coarse pass
        per chunk, a pooled window list), not other images."""
        field_fn = self._field_fn(state, data)
        rays_o = data["rays_o"].reshape(-1, 3)
        rays_d = data["rays_d"].reshape(-1, 3)
        outs, n_samples = [], 0
        for s in range(0, rays_o.shape[0], chunk):
            *out, stats = render_rays_occgrid_test(
                field_fn, state.occ_state, rays_o[s : s + chunk], rays_d[s : s + chunk],
                render_bkgd=data["color_bkgd"], near_plane=self.near_plane,
                far_plane=self.far_plane, render_step_size=self.render_step_size,
                cone_angle=self.cone_angle,
                early_stop_eps=EVAL_EARLY_STOP_EPS, window=EVAL_WINDOW,
                max_iters=EVAL_MAX_ROUNDS, return_stats=True,
            )
            outs.append(out)
            n_samples += stats["n_samples"]
        colors, opacities, depths = (torch.cat(parts) for parts in zip(*outs))
        return colors, opacities, depths, n_samples

    def render_image(self, state: TrainState, data: Dict, chunk: int = 8192):
        """(n_pixels, 3) colours of one view, through :meth:`render_view`."""
        return self.render_view(state, data, chunk)[0]

    def eval_metrics(self, state: TrainState, dataset, max_images: Optional[int] = None) -> Dict:
        """Mean PSNR and SSIM over the test views, rendered by
        :meth:`render_view`, with a per-view record: psnr, ssim, wall
        seconds (render and PSNR, which ends in a device sync), samples
        rendered over the rounds, rays, opacity range and whether every
        output was finite."""
        n = len(dataset) if max_images is None else min(len(dataset), max_images)
        h, w = dataset.HEIGHT, dataset.WIDTH
        views = []
        for i in range(n):
            data = dataset[i]
            t0 = time.perf_counter()
            colors, opacities, depths, n_samples = self.render_view(state, data)
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

    def eval_psnr(self, state: TrainState, dataset, max_images: Optional[int] = None) -> float:
        """Mean PSNR over the test views (:meth:`eval_metrics`)."""
        return self.eval_metrics(state, dataset, max_images)["psnr"]
