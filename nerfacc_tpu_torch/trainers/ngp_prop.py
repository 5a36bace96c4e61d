"""Proposal-network trainer: the train step and the evaluation.

PyTorch counterpart of nerfacc_tpu/trainers/ngp_prop.py.  One train step:
hierarchical sampling through the proposal levels' CDFs (kernel G14 per
resampling, the proposal fields through G1, and G4 on steps that train
them), the radiance field on the final samples, compositing on the batched
layout (G3, G5), a smooth-L1 loss plus, on steps with ``requires_grad``,
the interlevel loss that trains the proposal fields, one backward, and one
Adam update of both parameter groups.  Ported beside it: ``train_steps``,
``train_steps_sampled`` (batches drawn on the device by
:class:`~nerfacc_tpu_torch.data.device_sampler.DeviceRaySampler`),
``render_image`` and the PSNR/SSIM evaluation.  With a ``group`` a step is
the JAX body's data-parallel ``axis_name`` path (``parallel.mesh``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from ..estimators.prop_net import propnet_loss, propnet_sampling
from ..parallel.mesh import take_block
from ..utils.metrics import psnr, ssim
from ..volrend import rendering
from .ngp_occ import (
    OptState,
    adam_update,
    all_reduce_grads,
    disable_tf32,
    make_adam,
    make_lr_schedule,
    smooth_l1_loss,
)

class PropTrainState(NamedTuple):
    params: Dict[str, Any]  # {"field": state dict, "props": [state dict, ...]}
    opt_state: Optional[OptState]
    step: int


@dataclasses.dataclass
class NGPPropTrainer:
    """Radiance field + proposal-network trainer and renderer.

    Args:
        field: an ``nn.Module`` with ``init(generator)`` and
            ``forward(positions, dirs) -> (rgb, density)``.
        prop_fields: proposal density fields, coarse to fine, each with
            ``init(generator)`` and ``forward(positions) -> density``.
        prop_samples: samples per proposal level (e.g. [128]).
        num_samples: final samples per ray.
        sampling_type: "uniform" (bounded scenes) or "lindisp".
        opaque_bkgd: make each ray's last sample opaque (infinite density).
        prop_loss_scaler: scale of the interlevel loss.
        max_steps: length of the learning-rate schedule.
        lr: the schedule's base learning rate.
        weight_decay: Adam's coupled L2 decay.
        seed: seeds the parameters and every step's noise.
        stratified: jitter each resampling in training (never in
            evaluation).
        device: where the state lives and everything runs: the card unless
            the caller asks for another (the tests pass "cpu").
    """

    field: Any
    prop_fields: Sequence[Any]
    prop_samples: Sequence[int] = (128,)
    num_samples: int = 64
    near_plane: float = 2.0
    far_plane: float = 6.0
    sampling_type: str = "uniform"
    opaque_bkgd: bool = False
    prop_loss_scaler: float = 1024.0
    max_steps: int = 20000
    lr: float = 1e-2
    weight_decay: float = 0.0
    seed: int = 42
    stratified: bool = True
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self):
        if len(self.prop_fields) != len(self.prop_samples):
            raise ValueError("one proposal field per proposal sample count")
        self.device = torch.device(self.device)
        disable_tf32()
        self.field = self.field.to(self.device)
        self.prop_fields = [p.to(self.device) for p in self.prop_fields]
        self.schedule = make_lr_schedule(self.max_steps, self.lr)

    def init_state(self) -> PropTrainState:
        """Parameters drawn in order (field, then each proposal field) from
        ``torch.Generator().manual_seed(seed)`` on the CPU, so every device
        starts from the same weights; fresh Adam moments."""
        gen = torch.Generator().manual_seed(self.seed)
        self.field.init(gen)
        for prop in self.prop_fields:
            prop.init(gen)

        def leaves(module):
            return {k: v.detach().clone().requires_grad_(True)
                    for k, v in module.state_dict().items()}

        params = {"field": leaves(self.field),
                  "props": [leaves(p) for p in self.prop_fields]}
        return PropTrainState(params, self.init_optimizer(params), 0)

    @staticmethod
    def leaves(params: Dict) -> List[torch.Tensor]:
        """Every parameter tensor: the field's, then each proposal field's."""
        out = list(params["field"].values())
        for prop in params["props"]:
            out.extend(prop.values())
        return out

    def init_optimizer(self, params: Dict) -> OptState:
        """One Adam over both groups, as the JAX trainer's single optax
        chain over ``{"field", "props"}``."""
        return make_adam(self.leaves(params), self.schedule, self.weight_decay)

    def _generator(self, step: int, stream: int) -> torch.Generator:
        """The noise of one step: stream 1 the resamplings' jitter, 2 the
        device sampler's batch."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed((self.seed * 1_000_003 + int(step)) * 3 + stream)
        return gen

    def _sample_and_render(
        self, params, rays_o, rays_d, render_bkgd, requires_grad: bool,
        stratified: bool, generator=None, biases=None,
    ):
        n_rays = rays_o.shape[0]

        def positions(t0, t1):
            t_mid = 0.5 * (t0 + t1)
            return rays_o[:, None, :] + t_mid[..., None] * rays_d[:, None, :]

        def prop_sigma_fn(prop, prop_params):
            def fn(t0, t1):
                density = torch.func.functional_call(
                    prop, prop_params, (positions(t0, t1).reshape(-1, 3),)
                )
                return density.reshape(t0.shape)

            return fn

        t_starts, t_ends, cache = propnet_sampling(
            [prop_sigma_fn(p, pp) for p, pp in zip(self.prop_fields, params["props"])],
            list(self.prop_samples), self.num_samples, n_rays, self.near_plane,
            self.far_plane, self.sampling_type, stratified, requires_grad,
            generator, biases, self.device,
        )

        def rgb_sigma_fn(t0, t1, _ray_indices):
            pos = positions(t0, t1)
            dirs = rays_d[:, None, :].expand(pos.shape)
            rgb, density = torch.func.functional_call(
                self.field, params["field"], (pos.reshape(-1, 3), dirs.reshape(-1, 3))
            )
            sigmas = density.reshape(t0.shape)
            if self.opaque_bkgd:
                sigmas = torch.cat(
                    [sigmas[..., :-1], torch.full_like(sigmas[..., -1:], torch.inf)], dim=-1
                )
            return rgb.reshape(t0.shape + (3,)), sigmas

        colors, opacities, depths, extras = rendering(
            t_starts, t_ends, rgb_sigma_fn=rgb_sigma_fn, render_bkgd=render_bkgd
        )
        return colors, opacities, depths, extras, cache

    # -- one train step ----------------------------------------------------
    def train_step(
        self,
        state: PropTrainState,
        batch: Dict,
        requires_grad: bool = False,
        biases: Optional[Sequence[torch.Tensor]] = None,
        group=None,
    ):
        """One step; returns the new state and ``{loss, mse, prop_loss}``
        (device tensors; ``loss`` includes ``prop_loss``).

        Args:
            batch: ``{rays_o, rays_d, rgb, color_bkgd}`` on the device.
            requires_grad: this step trains the proposal fields too.
            biases: the resamplings' stratified jitter, one (n_rays,)
                uniform draw per proposal level and one for the final
                samples (None: drawn from the step's generator).
            group: a ``torch.distributed`` group whose ranks each hold one
                block of a global batch: gradients, loss, mse and
                ``prop_loss`` are averaged over it (JAX's ``pmean``), and
                the jitter is the global batch's, drawn level by level on
                every rank and cut to this rank's block.  None: one
                process, no collective.

        Every parameter's ``.grad`` holds this step's gradient afterwards;
        the proposal fields' are zeros on a step without ``requires_grad``,
        so Adam decays their moments and moves them by their momentum, as
        optax does with the zero gradients of ``stop_gradient``.
        """
        step = int(state.step)
        params = state.params
        leaves = self.leaves(params)
        for p in leaves:
            p.grad = None
        gen = self._generator(step, 1) if biases is None and self.stratified else None
        if gen is not None and group is not None:
            n, world, rank = batch["rays_o"].shape[0], dist.get_world_size(group), dist.get_rank(group)
            biases = [
                torch.rand(n * world, generator=gen, device=self.device)[rank * n : (rank + 1) * n]
                for _ in range(len(self.prop_samples) + 1)
            ]
        colors, _, _, extras, cache = self._sample_and_render(
            params, batch["rays_o"], batch["rays_d"], batch["color_bkgd"],
            requires_grad, self.stratified, gen, biases,
        )
        pixels = batch["rgb"]
        loss = smooth_l1_loss(colors, pixels)
        mse = ((colors.detach() - pixels) ** 2).mean()
        if requires_grad:
            p_loss = propnet_loss(cache, extras["trans"], self.prop_loss_scaler)
        else:
            p_loss = torch.zeros((), device=self.device)
        loss = loss + p_loss
        loss.backward()
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss, p_loss = loss.detach(), p_loss.detach()
        if group is not None:
            loss, mse, p_loss = all_reduce_grads(leaves, group, (loss, mse, p_loss), average=True)
        opt_state = adam_update(state.opt_state, self.schedule)
        aux = {"loss": loss, "mse": mse, "prop_loss": p_loss}
        return PropTrainState(params, opt_state, step + 1), aux

    def train_steps(self, state: PropTrainState, batches: Dict, requires_grads, group=None):
        """``len(requires_grads)`` steps over batches stacked along a leading
        axis; the aux values come back stacked the same way.  ``group``: see
        :meth:`train_step` (each rank passes its blocks)."""
        auxs = []
        for i, rg in enumerate(requires_grads):
            state, aux = self.train_step(
                state, {k: v[i] for k, v in batches.items()}, bool(rg), group=group
            )
            auxs.append(aux)
        return state, self._stack(auxs)

    def train_steps_sampled(self, state: PropTrainState, sampler, requires_grads, group=None):
        """``len(requires_grads)`` steps, each on a batch that ``sampler``
        (a :class:`~nerfacc_tpu_torch.data.device_sampler.DeviceRaySampler`)
        draws on the device from the step's generator: no host data per
        step.  With a ``group`` (see :meth:`train_step`) every rank draws
        the global batch and trains on its block of it."""
        auxs = []
        for rg in requires_grads:
            batch = sampler.sample(self._generator(state.step, 2))
            if group is not None:
                batch = take_block(batch, dist.get_rank(group), dist.get_world_size(group))
            state, aux = self.train_step(state, batch, bool(rg), group=group)
            auxs.append(aux)
        return state, self._stack(auxs)

    @staticmethod
    def _stack(auxs):
        return {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}

    # -- evaluation ----------------------------------------------------------
    @torch.inference_mode()
    def render_rays(self, state: PropTrainState, data: Dict, chunk: int = 8192):
        """Render ``data``'s rays in chunks, with no jitter: (colors,
        opacities, depths)."""
        rays_o = data["rays_o"].reshape(-1, 3)
        rays_d = data["rays_d"].reshape(-1, 3)
        outs = [
            self._sample_and_render(
                state.params, rays_o[s : s + chunk], rays_d[s : s + chunk],
                data["color_bkgd"], requires_grad=False, stratified=False,
            )[:3]
            for s in range(0, rays_o.shape[0], chunk)
        ]
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def render_image(self, state: PropTrainState, data: Dict, chunk: int = 8192):
        """(n_pixels, 3) colours of one view."""
        return self.render_rays(state, data, chunk)[0]

    def eval_metrics(self, state: PropTrainState, dataset, max_images: Optional[int] = None) -> Dict:
        """Mean PSNR and SSIM over the test views, with a per-view record:
        psnr, ssim, wall seconds (render and PSNR, which ends in a device
        sync), samples rendered, rays, opacity range and whether every
        output was finite."""
        n = len(dataset) if max_images is None else min(len(dataset), max_images)
        h, w = dataset.HEIGHT, dataset.WIDTH
        per_ray = sum(self.prop_samples) + self.num_samples
        views = []
        for i in range(n):
            data = dataset[i]
            t0 = time.perf_counter()
            colors, opacities, depths = self.render_rays(state, data)
            p = psnr(colors, data["rgb"])
            seconds = time.perf_counter() - t0
            views.append({
                "psnr": p,
                "ssim": ssim(colors.reshape(h, w, 3), data["rgb"].reshape(h, w, 3)),
                "seconds": seconds,
                "n_samples": colors.shape[0] * per_ray,
                "n_rays": colors.shape[0],
                "opacity_min": float(opacities.min()),
                "opacity_max": float(opacities.max()),
                "finite": bool(
                    torch.isfinite(colors).all()
                    & torch.isfinite(opacities).all()
                    & torch.isfinite(depths).all()
                ),
            })
        return {
            "psnr": float(np.mean([v["psnr"] for v in views])),
            "ssim": float(np.mean([v["ssim"] for v in views])),
            "views": views,
        }

    def eval_psnr(self, state: PropTrainState, dataset, max_images: Optional[int] = None) -> float:
        """Mean PSNR over the test views (:meth:`eval_metrics`)."""
        return self.eval_metrics(state, dataset, max_images)["psnr"]
