"""Train a radiance field with an occupancy grid.

PyTorch counterpart of examples/train_ngp_nerf_occ.py::

    python -m nerfacc_tpu_torch.examples.train_ngp_nerf_occ --field cp
    python -m nerfacc_tpu_torch.examples.train_ngp_nerf_occ --scene procedural360

trains the bench ``CPRadianceField`` (resolutions 32/128/512, rank 32, bf16;
``--plane_res R... --plane_rank r...`` appends tri-plane levels) or, with
``--field ngp``, the full-width hash-grid ``NGPRadianceField``, with
``--field tensorf`` the ``TensoRFRadianceField`` (lines 64/192 x 32, planes
64/128 x 16) and with ``--field voxel`` the dense ``VoxelRadianceField``
(grids 64/128 x 4 channels); ``--field_reg_weight w`` adds ``w`` times the
field's total variation to the loss.  Each trains with
a 2^18-sample budget a step and a ray batch that the controller grows from
``--init_batch_size``, then evaluates the test views through the
early-stopping eval renderer.  The scene branches are the JAX script's:

- an unbounded scene (``procedural360`` or a Mip-NeRF 360 name) takes the
  unbounded configuration: a 4-level grid over the box +-1, step 1e-3,
  cone 0.004, ``alpha_thre`` 1e-2, near plane 0.2, contracted fields, no
  weight decay; without ``--data_root`` it trains the procedural 360
  scene (24 views, random backgrounds, 6 test views);
- with ``--data_root``, the Mip-NeRF 360 loader at ``factor=4`` for an
  unbounded scene, the Blender (nerf_synthetic) loader of
  ``--train_split`` otherwise (weight decay 1e-5 on materials, ficus and
  drums, 1e-6 on the rest); reading the images needs ``imageio``;
- otherwise the procedural scene ``--scene`` names (``procedural``, the
  translucent blob scene, ``proceduralopaque``, ``proceduraltextured``,
  ``proceduralthin`` or ``proceduralmixed``; a name not in
  ``PROCEDURAL_SCENES`` falls back to ``procedural``, as in the JAX
  script), box +-1.5, one grid level, step 5e-3.

``--sampled_occ_update`` takes the reference's sampled occupancy update
after warmup in place of the dense refresh, and ``--occ_stripes S`` refreshes
one rotating 1/S stripe of the grid an update.  Batches are drawn on the
device (``--device_sampler 1``) or by the host loader.  With ``--model_path``
the run resumes from that checkpoint when it exists and saves it every
``--ckpt_every`` steps.  Everything runs on the card unless ``--device cpu``
is given.

The controller: after each call of ``--steps_per_call`` steps, the ray count
becomes ``num_rays * budget / n_total_samples``, growing at most 2x, rounded
down to the 1k-128k buckets.  Its aux reads lag two calls, so that reading
them never waits on the call just dispatched.

``--traversal`` is the trainer's: "padded" cuts each ray at 1024 orbit
candidates, as the JAX script's trainer does; "pooled" and "windowed" march
every orbit whole (see :class:`~nerfacc_tpu_torch.trainers.ngp_occ.
NGPOccTrainer`).  ``--window_budget`` and ``--fine_probes`` size the JAX
traversals' TPU window pools and are taken and ignored, as the trainer
takes them.

The flag of the JAX script that the port leaves out, ``--encoder_remat``,
chooses a rematerialisation under XLA's memory planning; autograd here
keeps the encoder's inputs and nothing to recompute.

In process, :func:`build` makes the trainer and the loaders (its keyword
arguments shrink them, as the tests do) and :func:`train_loop` runs the
loop and returns the final state, metrics and a record of every call.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..data.device_sampler import DeviceRaySampler
from ..data.procedural import (
    PROCEDURAL_SCENES,
    UNBOUNDED_SCENES,
    ProceduralSceneLoader,
    ProceduralUnboundedSceneLoader,
)
from ..models.cp_field import CPRadianceField, TensoRFRadianceField
from ..models.ngp import NGPRadianceField
from ..models.voxel_field import VoxelRadianceField
from ..trainers.ngp_occ import NGPOccTrainer, TrainState
from ..utils.checkpoint import load_checkpoint, save_checkpoint

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
AABB_UNBOUNDED = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
# the JAX script's marching configurations (after the reference's)
BOUNDED = dict(grid_nlvl=1, render_step_size=5e-3)
UNBOUNDED = dict(grid_nlvl=4, render_step_size=1e-3, cone_angle=0.004, alpha_thre=1e-2,
                 near_plane=0.2)
MIPNERF360_UNBOUNDED_SCENES = [
    "garden", "bicycle", "bonsai", "counter", "kitchen", "room", "stump",
]
FIELDS = {"cp": CPRadianceField, "ngp": NGPRadianceField,
          "tensorf": TensoRFRadianceField, "voxel": VoxelRadianceField}
# 1k .. 128k rays, ~1.33x spacing (the JAX script's buckets)
BUCKETS = sorted({1024 * 2**i for i in range(8)} | {1536 * 2**i for i in range(7)})


def round_to_bucket(n: int, buckets) -> int:
    """The largest bucket at most ``n`` (the smallest if none is): rounding
    down lets the controller shrink the batch when the budget overflows."""
    chosen = buckets[0]
    for b in buckets:
        if b <= n:
            chosen = b
    return chosen


def next_num_rays(num_rays: int, n_total: int, budget: int, buckets=BUCKETS) -> int:
    """The controller's next ray count: scale by ``budget / n_total``, grow
    at most 2x (the demand swings with every occupancy refresh, and an
    undamped controller oscillates between the extreme buckets), round down
    to a bucket."""
    want = int(num_rays * (budget / float(n_total)))
    return round_to_bucket(min(want, num_rays * 2), buckets)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", default=None,
                    help="a nerf_synthetic or Mip-NeRF 360 root (needs imageio); "
                         "none: a procedural scene")
    ap.add_argument("--scene", default="procedural")
    ap.add_argument("--train_split", default="train")
    ap.add_argument("--field", default="cp", choices=["cp", "ngp", "tensorf", "voxel"],
                    help="cp: CP lines (and --plane_res planes); ngp: the hash grid; "
                         "tensorf: TensoRF's line and tri-plane levels; voxel: dense "
                         "voxel grids")
    ap.add_argument("--max_steps", type=int, default=20000)
    ap.add_argument("--target_sample_batch_size", type=int, default=1 << 18)
    ap.add_argument("--init_batch_size", type=int, default=1024)
    ap.add_argument("--steps_per_call", type=int, default=8)
    ap.add_argument("--traversal", default="pooled", choices=["pooled", "windowed", "padded"])
    ap.add_argument("--window_budget", type=int, default=None,
                    help="the JAX traversal's window pool; taken and ignored")
    ap.add_argument("--fine_probes", type=lambda v: v if v == "auto" else int(v),
                    default="auto", help="the JAX traversal's fine probes; taken and ignored")
    ap.add_argument("--device_sampler", type=int, default=1,
                    help="draw ray batches on the device (0: the host loader)")
    ap.add_argument("--eval_every", type=int, default=0)
    ap.add_argument("--log_every", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--plane_res", type=int, nargs="*", default=[],
                    help="tri-plane levels appended to the cp field (e.g. 64)")
    ap.add_argument("--plane_rank", type=int, nargs="*", default=[],
                    help="their ranks (e.g. 16)")
    ap.add_argument("--field_reg_weight", type=float, default=0.0,
                    help="weight of the field's total variation in the loss")
    ap.add_argument("--occ_stripes", type=int, default=1,
                    help="S > 1 refreshes one rotating 1/S stripe of the grid per "
                         "update after warmup (NGPOccTrainer.occ_refresh_stripes)")
    ap.add_argument("--sampled_occ_update", action="store_true",
                    help="the reference's sampled occupancy update instead of the "
                         "dense refresh of every cell")
    ap.add_argument("--model_path", default=None,
                    help="checkpoint path: resumes from it when present; "
                         "saved every --ckpt_every steps")
    ap.add_argument("--ckpt_every", type=int, default=5000)
    ap.add_argument("--device", default="cuda")
    return ap


def is_unbounded(scene: str) -> bool:
    """The JAX script's test: a Mip-NeRF 360 name or an unbounded
    procedural scene."""
    return scene in MIPNERF360_UNBOUNDED_SCENES or scene in UNBOUNDED_SCENES


def _loaders(args, unbounded: bool, scene_kwargs: Dict):
    """The train and test loaders of the JAX script's branch for ``args``,
    with the branch's box and weight decay."""
    if args.data_root is not None and unbounded:
        from ..data.nerf_360_v2 import SubjectLoader as Loader360

        data = dict(subject_id=args.scene, root_fp=args.data_root, factor=4,
                    device=args.device)
        train = Loader360(split="train", num_rays=args.init_batch_size,
                          color_bkgd_aug="random", seed=args.seed, **data)
        return train, Loader360(split="test", **data), AABB_UNBOUNDED, 0.0
    if args.data_root is not None:
        from ..data.nerf_synthetic import SubjectLoader

        data = dict(subject_id=args.scene, root_fp=args.data_root, device=args.device)
        train = SubjectLoader(split=args.train_split, num_rays=args.init_batch_size,
                              seed=args.seed, **data)
        decay = 1e-5 if args.scene in ("materials", "ficus", "drums") else 1e-6
        return train, SubjectLoader(split="test", **data), AABB, decay
    scene_kwargs = dict(scene_kwargs, device=args.device)
    if unbounded:
        loader_cls = UNBOUNDED_SCENES.get(args.scene, ProceduralUnboundedSceneLoader)
        train = loader_cls(split="train", num_rays=args.init_batch_size, seed=args.seed,
                           **{**scene_kwargs, "color_bkgd_aug": "random"})
        test = loader_cls(split="test", **{"n_test": 6, **scene_kwargs})
        return train, test, AABB_UNBOUNDED, 0.0
    loader_cls = PROCEDURAL_SCENES.get(args.scene, ProceduralSceneLoader)
    train = loader_cls(split="train", num_rays=args.init_batch_size, seed=args.seed,
                       **scene_kwargs)
    return train, loader_cls(split="test", **scene_kwargs), AABB, 1e-6


def build(args, scene_kwargs: Optional[Dict] = None, field_kwargs: Optional[Dict] = None,
          trainer_kwargs: Optional[Dict] = None):
    """The trainer, the train loader (``args.init_batch_size`` rays a batch)
    and the test loader of ``args``'s branch; the keyword dicts pass more
    arguments to the procedural loaders, the field and the trainer."""
    unbounded = is_unbounded(args.scene)
    train_ds, test_ds, aabb, weight_decay = _loaders(args, unbounded, scene_kwargs or {})
    field_kwargs = dict(field_kwargs or {})
    if args.field == "cp":
        field_kwargs = {"plane_resolutions": tuple(args.plane_res),
                        "plane_ranks": tuple(args.plane_rank), **field_kwargs}
    field_cls = FIELDS[args.field]
    trainer = NGPOccTrainer(
        field=field_cls(aabb, unbounded=unbounded, **field_kwargs),
        aabb=aabb,
        max_steps=args.max_steps,
        weight_decay=weight_decay,
        field_reg_weight=args.field_reg_weight,
        sample_budget=args.target_sample_batch_size,
        max_samples_per_ray=1024,
        seed=args.seed,
        traversal=args.traversal,
        window_budget=args.window_budget,
        fine_probes=args.fine_probes,
        dense_occ_update=not args.sampled_occ_update,
        occ_refresh_stripes=args.occ_stripes,
        device=args.device,
        **{**(UNBOUNDED if unbounded else BOUNDED), **(trainer_kwargs or {})},
    )
    return trainer, train_ds, test_ds


class LoopResult(NamedTuple):
    state: TrainState
    metrics: Dict  # the final eval_metrics
    log: List[Dict]  # one record per call, in call order
    train_seconds: float  # wall seconds of the loop, the final evaluation excluded


def train_loop(trainer: NGPOccTrainer, train_ds, test_ds, args,
               log: Optional[List[Dict]] = None) -> LoopResult:
    """Train from ``args.model_path``'s checkpoint if it exists (else from
    the trainer's initial state) until the step passes ``args.max_steps``,
    ``args.steps_per_call`` steps a call, then evaluate on ``test_ds``.

    Each call's record goes to ``log`` (a new list by default; a caller's
    list keeps the records of a loop that does not return), read two calls
    late: ``step`` after the call, ``num_rays``, the mean ``loss`` over its
    steps, its last step's ``n_rendering_samples``, ``n_total_samples`` and
    ``n_rays_truncated``, and ``samples`` rendered over its steps."""
    state = trainer.init_state()
    start_step = 0
    if args.model_path is not None and os.path.exists(args.model_path):
        state = load_checkpoint(args.model_path, like=state, device=trainer.device)
        start_step = int(state.step)
        print(f"resumed from {args.model_path} at step {start_step}")

    base_sampler = None
    if args.device_sampler:
        base_sampler = DeviceRaySampler.from_loader(train_ds, num_rays=train_ds.num_rays)
    rng = np.random.default_rng(args.seed)
    M = max(1, args.steps_per_call)
    budget = args.target_sample_batch_size
    log = [] if log is None else log
    trunc_ema = 0.0
    samples_done = 0
    tic = time.time()
    # Aux reads are deferred two calls: reading the call just dispatched
    # would wait for it on every call.  The controller and the truncation
    # warning react two calls late, which is harmless for both.
    pending = []

    def consume(entry):
        nonlocal samples_done, trunc_ema
        auxs, aux_step, aux_nrays = entry
        n_samples = auxs["n_rendering_samples"].tolist()
        n_total = int(auxs["n_total_samples"][-1])
        n_trunc = int(auxs["n_rays_truncated"][-1])
        samples_done += sum(n_samples)
        log.append({
            "step": aux_step, "num_rays": aux_nrays,
            "loss": float(auxs["loss"].mean()), "n_rendering_samples": n_samples[-1],
            "n_total_samples": n_total, "n_rays_truncated": n_trunc,
            "samples": sum(n_samples),
        })
        if n_total > 0 and budget > 0:
            train_ds.update_num_rays(next_num_rays(train_ds.num_rays, n_total, budget))
        # a persistently high truncated share means the sample budget is too
        # small for the scene, and quality suffers silently
        frac = n_trunc / max(aux_nrays, 1)
        trunc_ema = 0.9 * trunc_ema + 0.1 * frac if aux_step > M else frac
        if trunc_ema > 0.5 and aux_step % args.log_every < M and aux_step > 500:
            print(f"WARNING: {trunc_ema:.0%} of rays are budget-truncated "
                  f"(step {aux_step}). Raise --target_sample_batch_size or "
                  "quality will suffer.")

    step = start_step
    while step <= args.max_steps:
        if base_sampler is not None:
            n_rays_now = train_ds.num_rays
            sampler = base_sampler.with_num_rays(n_rays_now)
            state, auxs = trainer.train_steps_sampled(state, sampler, M)
        else:
            datas = [train_ds[int(rng.integers(0, len(train_ds)))] for _ in range(M)]
            batches = {k: torch.stack([d[k] for d in datas]) for k in datas[0]}
            n_rays_now = datas[0]["rgb"].shape[0]
            state, auxs = trainer.train_steps(state, batches)
        step += M

        pending.append((auxs, step, n_rays_now))
        if len(pending) > 2:
            consume(pending.pop(0))

        if step % args.log_every < M:
            mse = float(auxs["mse"][-1])  # waits for the call
            elapsed = time.time() - tic
            print(
                f"elapsed_time={elapsed:.2f}s | step={step} | "
                f"loss={float(auxs['loss'][-1]):.5f} | "
                f"psnr={-10.0 * np.log10(max(mse, 1e-10)):.2f} | "
                f"n_rendering_samples={log[-1]['n_rendering_samples'] if log else 0} | "
                f"num_rays={n_rays_now} | "
                f"samples/s={samples_done / max(elapsed, 1e-9):.3g}",
                flush=True,
            )
        if args.eval_every and step % args.eval_every < M and step > M:
            print(f"evaluation: step={step} psnr_avg={trainer.eval_psnr(state, test_ds):.2f}")
        if args.model_path is not None and step % args.ckpt_every < M and step > start_step:
            save_checkpoint(args.model_path, state)

    for entry in pending:
        consume(entry)
    train_seconds = time.time() - tic
    metrics = trainer.eval_metrics(state, test_ds)
    print(f"evaluation: psnr_avg={metrics['psnr']:.2f} ssim_avg={metrics['ssim']:.4f}")
    return LoopResult(state, metrics, log, train_seconds)


def main(argv=None):
    args = parser().parse_args(argv)
    train_loop(*build(args), args)


if __name__ == "__main__":
    main()
