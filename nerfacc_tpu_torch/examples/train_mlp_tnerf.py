"""Train a dynamic (time-dependent) radiance field with an occupancy grid.

PyTorch counterpart of examples/train_mlp_tnerf.py::

    python -m nerfacc_tpu_torch.examples.train_mlp_tnerf
    python -m nerfacc_tpu_torch.examples.train_mlp_tnerf --field kplanes
    python -m nerfacc_tpu_torch.examples.train_mlp_tnerf --field tineuvox --lr 5e-3

trains ``--field``: ``tnerf`` (the reference's model: a 4x64 warp MLP in
front of the 8x256 vanilla NeRF), ``kplanes`` (six space-time feature
planes a level and small MLPs) or ``tineuvox`` (CP line levels behind a
small deformation MLP), with the per-field settings of the JAX script:

- tnerf: lr 5e-4, Adam epsilon 1e-8, no warmup, no regulariser;
- kplanes: lr 1e-2, epsilon 1e-15, 100 warmup steps, the plane priors at
  ``--field_reg_weight`` 1e-3 (1e-4 with ``--plane_activation tanh``);
- tineuvox: lr 1e-2, epsilon 1e-15, 100 warmup steps, line TV at 1e-4;

all with no weight decay, step 5e-3 in the box +-1.5 and a 2^16-sample
budget a step.  Without ``--data_root`` it trains the procedural scene
``--scene`` names (``procedurallocaldyn`` the local-motion scene; another
name, the default ``lego`` included, the moving-blob scene
``proceduraldynamic``, as in the JAX script), with ``--data_root`` the
D-NeRF loader (reading its images needs ``imageio``).  Each train batch is
a loader item (rays, colours and per-ray ``timestamps``, already on the
device), ``--steps_per_call`` of them a call.  Everything runs on the card
unless ``--device cpu`` is given.

The controller: after each call, the ray count becomes ``num_rays * budget
/ n_total_samples`` of the call's last step, rounded down to the 1k-64k
buckets, with no growth cap, read from the call just finished (the JAX
script's rule; the occupancy example's caps growth at 2x).

The JAX script's ``max_samples_per_ray=1024`` sizes its padded candidate
lattice; the port marches every orbit to its end, which at step 5e-3 in the
box +-1.5 is at most ~1040 candidates, the JAX trainer's pooled 160 x 8
windows included, so no flag is needed.

At the end it prints ``evaluation: psnr_avg=... ssim_avg=... |
train_wall=...`` and the JAX script's JSON summary line.  In process,
:func:`build` makes the trainer and the loaders (its keyword arguments
shrink them, as the tests do) and :func:`train_loop` runs the loop.
"""
from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..data.procedural import PROCEDURAL_SCENES, ProceduralDynamicSceneLoader
from ..models.kplanes import KPlanesRadianceField
from ..models.mlp import TNeRFRadianceField
from ..models.tineuvox import TiNeuVoxRadianceField
from ..trainers.ngp_occ import NGPOccTrainer, TrainState
from .train_ngp_nerf_occ import round_to_bucket

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
# 1k .. 64k rays, ~1.33x spacing (both MLP scripts' buckets)
BUCKETS = sorted({1024 * 2**i for i in range(7)} | {1536 * 2**i for i in range(6)})


def next_num_rays(num_rays: int, n_total: int, budget: int, buckets=BUCKETS) -> int:
    """The MLP scripts' controller: scale by ``budget / n_total`` and round
    down to a bucket, with no growth cap."""
    return round_to_bucket(int(num_rays * (budget / float(n_total))), buckets)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", default=None,
                    help="a D-NeRF root (needs imageio); none: a procedural scene")
    ap.add_argument("--scene", default="lego")
    ap.add_argument("--train_split", default="train")
    ap.add_argument("--max_steps", type=int, default=30000)
    ap.add_argument("--target_sample_batch_size", type=int, default=1 << 16)
    ap.add_argument("--init_batch_size", type=int, default=1024)
    ap.add_argument("--log_every", type=int, default=5000)
    ap.add_argument("--steps_per_call", type=int, default=8)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--field", default="tnerf", choices=["tnerf", "kplanes", "tineuvox"],
                    help="tnerf: the time-warp MLP (the reference's model); kplanes: "
                         "space-time feature planes; tineuvox: time-aware neural voxels "
                         "behind a deformation MLP")
    ap.add_argument("--field_reg_weight", type=float, default=None,
                    help="the field's prior weight; none: the field's default (kplanes "
                         "1e-3, 1e-4 with --plane_activation tanh; tineuvox 1e-4; tnerf 0)")
    ap.add_argument("--lr", type=float, default=None,
                    help="the base learning rate; none: the field's default")
    ap.add_argument("--plane_activation", default="none", choices=["none", "tanh"],
                    help="kplanes only: bound each plane feature by 1 + tanh(f - 1)")
    ap.add_argument("--amp_prior", type=float, default=0.0,
                    help="kplanes only: add amp_prior * mean((plane - 1)^2) to the prior")
    ap.add_argument("--log_plane_norms", action="store_true",
                    help="kplanes only: print each level's plane magnitudes at every log")
    ap.add_argument("--device", default="cuda")
    return ap


def _loaders(args, scene_kwargs: Dict):
    """The train and test loaders of the JAX script's branch for ``args``."""
    if args.data_root is not None:
        from ..data.dnerf_synthetic import SubjectLoader

        data = dict(subject_id=args.scene, root_fp=args.data_root, device=args.device)
        train = SubjectLoader(split=args.train_split, num_rays=args.init_batch_size,
                              seed=args.seed, **data)
        return train, SubjectLoader(split="test", **data)
    loader_cls = PROCEDURAL_SCENES.get(args.scene, ProceduralDynamicSceneLoader)
    scene_kwargs = dict(scene_kwargs, device=args.device)
    train = loader_cls(split="train", num_rays=args.init_batch_size, seed=args.seed,
                       **scene_kwargs)
    return train, loader_cls(split="test", **scene_kwargs)


def field_settings(args, field_kwargs: Optional[Dict] = None):
    """(field, lr, Adam epsilon, warmup steps, default prior weight) of
    ``args.field``: the JAX script's; ``field_kwargs`` passes more
    arguments to the field."""
    kw = dict(device=args.device, **(field_kwargs or {}))
    if args.field == "kplanes":
        field = KPlanesRadianceField(tuple(AABB), plane_activation=args.plane_activation,
                                     amp_prior=args.amp_prior, **kw)
        # TV 1e-3 keeps the raw six-plane product stable; the bounded tanh
        # activation needs only 1e-4
        reg = 1e-3 if args.plane_activation == "none" else 1e-4
        return field, 1e-2, 1e-15, 100, reg
    if args.field == "tineuvox":
        return TiNeuVoxRadianceField(tuple(AABB), **kw), 1e-2, 1e-15, 100, 1e-4
    return TNeRFRadianceField(**kw), 5e-4, 1e-8, 0, 0.0


def build(args, scene_kwargs: Optional[Dict] = None, field_kwargs: Optional[Dict] = None,
          trainer_kwargs: Optional[Dict] = None):
    """The trainer, the train loader (``args.init_batch_size`` rays a batch)
    and the test loader; the keyword dicts pass more arguments to the
    procedural loaders, the field and the trainer."""
    train_ds, test_ds = _loaders(args, scene_kwargs or {})
    field, lr, adam_eps, warmup, reg = field_settings(args, field_kwargs)
    trainer = NGPOccTrainer(
        field=field,
        aabb=AABB,
        max_steps=args.max_steps,
        render_step_size=5e-3,
        lr=lr if args.lr is None else args.lr,
        weight_decay=0.0,
        adam_eps=adam_eps,
        warmup_lr_steps=warmup,
        sample_budget=args.target_sample_batch_size,
        timestamps=train_ds.timestamps,
        field_reg_weight=reg if args.field_reg_weight is None else args.field_reg_weight,
        seed=args.seed,
        device=args.device,
        **(trainer_kwargs or {}),
    )
    return trainer, train_ds, test_ds


class LoopResult(NamedTuple):
    state: TrainState
    metrics: Dict  # the final eval_metrics
    log: List[Dict]  # one record per call, in call order
    train_seconds: float  # wall seconds of the loop, the final evaluation excluded
    summary: Dict  # the JSON summary line's fields


def run_calls(trainer: NGPOccTrainer, train_ds, args, state: TrainState, log: List[Dict],
              on_log: Optional[Callable[[TrainState], None]] = None):
    """Train ``state`` until the step passes ``args.max_steps``,
    ``args.steps_per_call`` loader batches a call, the controller setting
    the next call's ray count from the call just finished.  Each call's
    record goes to ``log``: ``step`` after the call, ``num_rays``, the mean
    ``loss`` over its steps, its last step's ``n_total_samples`` and
    ``n_rendering_samples``, ``samples`` rendered over its steps, and the
    share of its rays that the loss masked (``masked``).  Every
    ``args.log_every`` steps it prints the log line, then calls
    ``on_log(state)``.  Returns the state, the loop's wall seconds and the
    steps' sample demand before the budget cut."""
    rng = np.random.default_rng(args.seed)
    M = max(1, args.steps_per_call)
    budget = args.target_sample_batch_size
    total_samples = 0
    tic = time.time()
    step = int(state.step)
    while step <= args.max_steps:
        datas = [train_ds[int(rng.integers(0, len(train_ds)))] for _ in range(M)]
        batches = {k: torch.stack([d[k] for d in datas]) for k in datas[0]}
        n_rays = datas[0]["rgb"].shape[0]
        state, auxs = trainer.train_steps(state, batches)
        step += M
        n_total = auxs["n_total_samples"].tolist()  # waits for the call
        total_samples += sum(n_total)
        n_rendered = auxs["n_rendering_samples"].tolist()
        log.append({
            "step": step, "num_rays": n_rays, "loss": float(auxs["loss"].mean()),
            "n_total_samples": n_total[-1], "n_rendering_samples": n_rendered[-1],
            "samples": sum(n_rendered),
            "masked": 1.0 - float(auxs["n_rays_ok"].sum()) / (M * n_rays),
        })
        if n_total[-1] > 0 and budget > 0:
            train_ds.update_num_rays(next_num_rays(train_ds.num_rays, n_total[-1], budget))

        if step % args.log_every < M:
            mse = float(auxs["mse"][-1])
            print(f"elapsed_time={time.time() - tic:.2f}s | step={step} | "
                  f"psnr={-10.0 * np.log10(max(mse, 1e-10)):.2f} | num_rays={n_rays}",
                  flush=True)
            if on_log is not None:
                on_log(state)
    return state, time.time() - tic, total_samples


def _print_plane_norms(trainer: NGPOccTrainer, state: TrainState) -> None:
    """Collapse diagnosis: the product's feedback shows as |p - 1| drifting
    up level by level before the train PSNR moves."""
    for li in range(len(trainer.field.encoder.planes)):
        p = state.params[f"encoder.planes.{li}"].detach()
        d = (p - 1.0).abs()
        print(f"  planes L{li}: mean|p-1|={float(d.mean()):.4f} "
              f"max|p-1|={float(d.max()):.3f} "
              f"rms={float(p.square().mean().sqrt()):.4f}", flush=True)


def train_loop(trainer: NGPOccTrainer, train_ds, test_ds, args,
               log: Optional[List[Dict]] = None) -> LoopResult:
    """Train from the trainer's initial state through :func:`run_calls`
    (its records go to ``log``), then evaluate on ``test_ds`` and print
    the summary line."""
    log = [] if log is None else log
    on_log = None
    if args.log_plane_norms and args.field == "kplanes":
        on_log = functools.partial(_print_plane_norms, trainer)
    state, train_wall, total_samples = run_calls(trainer, train_ds, args,
                                                 trainer.init_state(), log, on_log)
    metrics = trainer.eval_metrics(state, test_ds)
    print(f"evaluation: psnr_avg={metrics['psnr']:.2f} ssim_avg={metrics['ssim']:.4f} | "
          f"train_wall={train_wall:.1f}s")
    # the JAX script's summary line (samples_per_sec: the steps' sample
    # demand before the budget cut, over the training's wall time)
    summary = {
        "name": f"{args.field}@{args.scene}",
        "field": args.field,
        "scene": args.scene,
        "steps": args.max_steps,
        "psnr": round(metrics["psnr"], 2),
        "ssim": round(metrics["ssim"], 4),
        "train_wall_s": round(train_wall, 1),
        "samples_per_sec": round(total_samples / max(train_wall, 1e-9)),
    }
    print(json.dumps(summary), flush=True)
    return LoopResult(state, metrics, log, train_wall, summary)


def main(argv=None):
    args = parser().parse_args(argv)
    train_loop(*build(args), args)


if __name__ == "__main__":
    main()
