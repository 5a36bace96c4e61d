"""Proposal-network transmittance estimator (Mip-NeRF 360 style), batched
layout.

PyTorch counterpart of nerfacc_tpu/estimators/prop_net.py:
:func:`propnet_sampling` returns the final sample bounds and the proposal
cache, :func:`propnet_loss` reads the cache, and
:func:`get_proposal_requires_grad_fn` is the schedule of proposal gradient
steps.  Each level resamples through kernel G14
(:func:`~nerfacc_tpu_torch.pdf.importance_sampling`).
:class:`PropNetEstimator` is the reference's stateful PyTorch form
(``PropNetEstimator(optimizer, scheduler)``): where the JAX package re-traces
the proposal fields from their parameters to differentiate, the estimator
keeps autograd's tape in its cache.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple, Union

import torch

from ..data_specs import RayIntervals
from ..pdf import importance_sampling, searchsorted
from ..utils.fp import fma_f32
from ..volrend import render_transmittance_from_density
from .base import AbstractEstimator


def _transform_stot(
    transform_type: str, s_vals: torch.Tensor, t_min: float, t_max: float
) -> torch.Tensor:
    """Map normalised s in [0, 1] to metric t: uniform in t, or uniform in
    1/t ("lindisp").  ``s * s_max + (1 - s) * s_min`` with the first product
    fused, as XLA's CPU backend computes it in the JAX trainer's step."""
    if transform_type == "uniform":
        s_min, s_max = t_min, t_max
    elif transform_type == "lindisp":
        s_min, s_max = 1 / t_min, 1 / t_max
    else:
        raise ValueError(f"Unknown transform_type: {transform_type}")
    f32 = dict(dtype=s_vals.dtype, device=s_vals.device)
    s_min, s_max = torch.tensor(s_min, **f32), torch.tensor(s_max, **f32)
    t = fma_f32(s_vals, s_max, (1 - s_vals) * s_min)
    return t if transform_type == "uniform" else 1 / t


def _pdf_loss(
    segments_query: RayIntervals,
    cdfs_query: torch.Tensor,
    segments_key: RayIntervals,
    cdfs_key: torch.Tensor,
    eps: float = 1e-7,
) -> torch.Tensor:
    """Interlevel PDF-matching loss per query interval: the query weights'
    excess over the key CDF's outer measure of the same interval, squared,
    over the weight.  The JAX package reads the key CDF through one-hot
    selections; the gather here gives the same values."""
    w = cdfs_query[..., 1:] - cdfs_query[..., :-1]
    ids_left, ids_right = searchsorted(segments_key, segments_query)
    w_outer = cdfs_key.gather(-1, ids_right[..., 1:]) - cdfs_key.gather(-1, ids_left[..., :-1])
    return (w - w_outer).clamp(min=0) ** 2 / (w + eps)


def propnet_sampling(
    prop_sigma_fns: Sequence[Callable],
    prop_samples: Sequence[int],
    num_samples: int,
    n_rays: int,
    near_plane: float,
    far_plane: float,
    sampling_type: str = "lindisp",
    stratified: bool = False,
    requires_grad: bool = False,
    generator: Optional[torch.Generator] = None,
    biases: Optional[Sequence[torch.Tensor]] = None,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[torch.Tensor, torch.Tensor, List[Tuple[torch.Tensor, Optional[torch.Tensor]]]]:
    """Hierarchical sampling through the proposal levels' CDFs.

    Args:
        prop_sigma_fns: per level, ``(t_starts, t_ends) -> sigmas``, all
            (n_rays, n).
        prop_samples: samples per proposal level.
        num_samples: final samples per ray.
        stratified: jitter each resampling by one uniform draw per ray:
            ``biases[level]`` ((n_rays,), one per level and one for the
            final samples) when given, else from ``generator``.
        requires_grad: evaluate the proposal levels with gradients and
            return their ``(edges, cdfs)`` for :func:`propnet_loss`.

    Returns:
        (t_starts (n_rays, num_samples), t_ends, prop_cache).  The edges
        and CDFs fed to each resampling carry no gradient.
    """
    if len(prop_sigma_fns) != len(prop_samples):
        raise ValueError("one proposal function per proposal sample count")
    cdfs = torch.zeros((n_rays, 2), dtype=torch.float32, device=device)
    cdfs[:, 1] = 1.0
    intervals = RayIntervals(vals=cdfs)
    biases = [None] * (len(prop_samples) + 1) if biases is None else list(biases)
    prop_cache: List = []

    for level, (level_fn, level_samples) in enumerate(zip(prop_sigma_fns, prop_samples)):
        intervals, _ = importance_sampling(
            RayIntervals(vals=intervals.vals.detach()), cdfs.detach(), level_samples,
            stratified, generator, biases[level],
        )
        t_vals = _transform_stot(sampling_type, intervals.vals, near_plane, far_plane)
        t_starts, t_ends = t_vals[..., :-1], t_vals[..., 1:]
        with torch.set_grad_enabled(requires_grad and torch.is_grad_enabled()):
            sigmas = level_fn(t_starts, t_ends)
        if sigmas.shape != t_starts.shape:
            raise ValueError(f"proposal sigmas {tuple(sigmas.shape)}: want {tuple(t_starts.shape)}")
        trans, _ = render_transmittance_from_density(t_starts, t_ends, sigmas)
        cdfs = 1.0 - torch.cat([trans, torch.zeros_like(trans[:, :1])], dim=-1)
        if requires_grad:
            prop_cache.append((intervals.vals, cdfs))

    intervals, _ = importance_sampling(
        RayIntervals(vals=intervals.vals.detach()), cdfs.detach(), num_samples,
        stratified, generator, biases[-1],
    )
    t_vals = _transform_stot(sampling_type, intervals.vals, near_plane, far_plane)
    if requires_grad:
        prop_cache.append((intervals.vals, None))
    return t_vals[..., :-1], t_vals[..., 1:], prop_cache


def propnet_loss(
    prop_cache: List[Tuple[torch.Tensor, Optional[torch.Tensor]]],
    trans: torch.Tensor,
    loss_scaler: float = 1.0,
) -> torch.Tensor:
    """Interlevel loss over the cached proposal CDFs against the final
    samples' transmittance ``trans`` (n_rays, num_samples), which carries no
    gradient: only the proposal CDFs are trained by it."""
    if len(prop_cache) == 0:
        return torch.zeros((), device=trans.device)
    final_vals, _ = prop_cache[-1]
    cdfs = (1.0 - torch.cat([trans, torch.zeros_like(trans[:, :1])], dim=-1)).detach()
    intervals = RayIntervals(vals=final_vals)
    loss = 0.0
    for prop_vals, prop_cdfs in prop_cache[:-1]:
        loss = loss + _pdf_loss(intervals, cdfs, RayIntervals(vals=prop_vals), prop_cdfs).mean()
    return loss * loss_scaler


def get_proposal_requires_grad_fn(
    target: float = 5.0, num_steps: int = 1000
) -> Callable[[int], bool]:
    """Schedule that thins proposal-gradient steps: a step takes one when
    more steps have passed since the last than ``min(step / num_steps, 1) *
    target``."""
    steps_since_last_grad = 0

    def proposal_requires_grad_fn(step: int) -> bool:
        nonlocal steps_since_last_grad
        requires_grad = steps_since_last_grad > min(step / num_steps, 1.0) * target
        if requires_grad:
            steps_since_last_grad = 0
        steps_since_last_grad += 1
        return requires_grad

    return proposal_requires_grad_fn


class PropNetEstimator(AbstractEstimator):
    """Proposal-network estimator, the reference's stateful API.

    Args:
        optimizer: a ``torch.optim.Optimizer`` over the proposal fields'
            parameters, stepped by :meth:`update_every_n_steps`.
        scheduler: an optional learning-rate scheduler stepped beside it.
    """

    def __init__(self, optimizer=None, scheduler=None) -> None:
        super().__init__()
        self.optimizer = optimizer
        self.scheduler = scheduler
        self.prop_cache: List = []

    def sampling(
        self,
        prop_sigma_fns: Sequence[Callable],
        prop_samples: Sequence[int],
        num_samples: int,
        n_rays: int,
        near_plane: float,
        far_plane: float,
        sampling_type: str = "lindisp",
        stratified: bool = False,
        requires_grad: bool = False,
        generator: Optional[torch.Generator] = None,
        biases: Optional[Sequence[torch.Tensor]] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sample through the proposal levels (:func:`propnet_sampling`);
        with ``requires_grad`` the proposal CDFs, on autograd's tape, are
        cached for :meth:`compute_loss`.  ``generator`` / ``biases`` give
        the stratified jitter; the samples live on ``device`` (the card
        unless asked otherwise).

        Returns:
            t_starts, t_ends: (n_rays, num_samples), no gradient.
        """
        t_starts, t_ends, cache = propnet_sampling(
            prop_sigma_fns, prop_samples, num_samples, n_rays, near_plane, far_plane,
            sampling_type, stratified, requires_grad, generator, biases, device,
        )
        if requires_grad:
            self.prop_cache = cache
        return t_starts, t_ends

    def compute_loss(self, trans: torch.Tensor, loss_scaler: float = 1.0) -> torch.Tensor:
        """The interlevel loss of the cached proposal CDFs against the final
        samples' transmittance ``trans`` (n_rays, num_samples), which is
        detached; empties the cache."""
        if len(self.prop_cache) == 0:
            return torch.zeros((), device=trans.device)
        with torch.enable_grad():
            loss = propnet_loss(self.prop_cache, trans, loss_scaler)
        self.prop_cache = []
        return loss

    def update_every_n_steps(
        self, trans: torch.Tensor, requires_grad: bool = False, loss_scaler: float = 1.0
    ) -> float:
        """With ``requires_grad``: the cached interlevel loss, one backward
        and one step of the optimizer (a parameter the loss does not reach
        gets a zero gradient, so Adam moves it by its momentum, as optax
        does), and the loss as a float.  Without: 0.0.  The scheduler steps
        either way."""
        loss = 0.0
        if requires_grad:
            if not self.prop_cache:
                raise RuntimeError("no proposal cache: call sampling(requires_grad=True)")
            if self.optimizer is None:
                raise RuntimeError("PropNetEstimator has no optimizer")
            loss_t = self.compute_loss(trans, loss_scaler)
            self.optimizer.zero_grad()
            loss_t.backward()
            for group in self.optimizer.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            self.optimizer.step()
            loss = float(loss_t.detach())
        if self.scheduler is not None:
            self.scheduler.step()
        return loss
