"""BARF: a radiance field and per-image camera poses trained jointly, from
noisy poses.

PyTorch counterpart of examples/train_barf.py::

    python -m nerfacc_tpu_torch.examples.train_barf [--max_steps N]

trains the full-width vanilla NeRF (8x256, a skip at layer 4) with a
per-image SE(3) correction and BARF's coarse-to-fine window
(:class:`~nerfacc_tpu_torch.trainers.barf.BARFTrainer`) on the procedural
scene (or, with ``--data_root``, a nerf_synthetic scene, which needs
``imageio``), starting from poses perturbed by gaussian twists
(``--rot_std``, ``--trans_std``, drawn from ``--seed + 1``), and reports the
Sim3-aligned pose errors beside the eval PSNR.  The poses stay frozen for
``--pose_start`` steps (default ``min(500, max_steps / 4)``); ``--no_c2f``
trains with the full spectrum; ``--pose_horizon`` sets the pose learning
rate's decay horizon as a fraction of ``--max_steps``.  It prints
``elapsed_time=... | step=... | train_psnr=... | pose R ... deg T ...``
every ``--log_every`` steps, ``evaluation: psnr=... ssim=... | pose R ...``
and the JAX script's JSON summary line.  Everything runs on the card unless
``--device cpu`` is given.

In process, :func:`build` makes the trainer and the loaders (its keyword
arguments shrink them, as the tests do) and :func:`train_loop` runs the
loop and returns the final state, metrics, pose errors, a record of every
call and the summary.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..data.procedural import ProceduralSceneLoader
from ..models.mlp import VanillaNeRFRadianceField
from ..models.pose import perturb_poses, pose_registration_errors
from ..trainers.barf import BARFTrainer, BARFTrainState

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", default=None,
                    help="a nerf_synthetic root (needs imageio); none: the procedural scene")
    ap.add_argument("--scene", default="lego")
    ap.add_argument("--train_split", default="train")
    ap.add_argument("--max_steps", type=int, default=10000)
    ap.add_argument("--num_rays", type=int, default=1024)
    ap.add_argument("--rot_std", type=float, default=0.05)
    ap.add_argument("--trans_std", type=float, default=0.05)
    ap.add_argument("--no_c2f", action="store_true",
                    help="disable the coarse-to-fine window (ablation)")
    ap.add_argument("--pose_start", type=int, default=None,
                    help="step at which pose updates unfreeze (default min(500, "
                         "max_steps/4))")
    ap.add_argument("--pose_horizon", type=float, default=None,
                    help="pose-lr decay horizon as a fraction of max_steps (default: 0.6 "
                         "of the window's end)")
    ap.add_argument("--log_every", type=int, default=1000)
    ap.add_argument("--steps_per_call", type=int, default=8)
    ap.add_argument("--eval_images", type=int, default=3)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=320)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    return ap


def build(args, scene_kwargs: Optional[Dict] = None, field_kwargs: Optional[Dict] = None,
          trainer_kwargs: Optional[Dict] = None):
    """The trainer (from the loader's poses perturbed by twists drawn from
    ``torch.Generator().manual_seed(args.seed + 1)``), the train loader
    (``args.num_rays`` pixels a batch) and the test loader; the keyword
    dicts pass more arguments to the procedural loaders, the field and the
    trainer."""
    if args.data_root is not None:
        from ..data.nerf_synthetic import SubjectLoader

        data = dict(subject_id=args.scene, root_fp=args.data_root, device=args.device)
        train_ds = SubjectLoader(split=args.train_split, num_rays=args.num_rays,
                                 seed=args.seed, **data)
        test_ds = SubjectLoader(split="test", **data)
    else:
        scene = dict(width=args.width, height=args.height, device=args.device,
                     **(scene_kwargs or {}))
        train_ds = ProceduralSceneLoader(split="train", num_rays=args.num_rays,
                                         seed=args.seed, **scene)
        test_ds = ProceduralSceneLoader(split="test", **scene)
    c2w_gt = torch.tensor(np.asarray(train_ds.camtoworlds, np.float32)[:, :3, :4])
    noisy, _ = perturb_poses(c2w_gt, args.rot_std, args.trans_std,
                             generator=torch.Generator().manual_seed(args.seed + 1))
    trainer = BARFTrainer(
        field=VanillaNeRFRadianceField(device=args.device, **(field_kwargs or {})),
        camtoworlds_init=noisy,
        K=train_ds.K,
        aabb=AABB,
        render_step_size=5e-3,
        max_steps=args.max_steps,
        lr_pose=1e-3,
        # joint optimisation from a random field lets the poses absorb early
        # photometric noise: they stay frozen while the field fits coarse
        # structure
        pose_start_step=(args.pose_start if args.pose_start is not None
                         else min(500, args.max_steps // 4)),
        pe_c2f=None if args.no_c2f else (0.1, 0.5),
        pose_lr_horizon_frac=args.pose_horizon,
        seed=args.seed,
        device=args.device,
        **(trainer_kwargs or {}),
    )
    return trainer, train_ds, test_ds


class LoopResult(NamedTuple):
    state: BARFTrainState
    metrics: Dict  # the final eval_metrics
    pose_errors: Dict  # {"initial": ..., "final": ...} registration errors
    log: List[Dict]  # one record per call, in call order
    train_seconds: float  # wall seconds of the loop, the final evaluation excluded
    summary: Dict  # the JSON summary line


def train_loop(trainer: BARFTrainer, train_ds, test_ds, args,
               log: Optional[List[Dict]] = None) -> LoopResult:
    """Train from the trainer's initial state, ``args.steps_per_call``
    steps a call, until the step reaches ``args.max_steps``, then evaluate
    the first ``args.eval_images`` test views.  Each call's record goes to
    ``log``: ``step`` after the call, its mean ``loss``, its last ``mse``,
    ``samples`` rendered over its steps and the last ``pose_grad_norm``."""
    c2w_gt = np.asarray(train_ds.camtoworlds, np.float32)[:, :3, :4]
    err0 = pose_registration_errors(trainer.c2w_init, c2w_gt)
    print(f"initial pose error: R {err0['rot_deg']:.3f} deg | T {err0['trans']:.4f}")
    state = trainer.init_state()
    rng = np.random.default_rng(args.seed)
    M = max(1, args.steps_per_call)
    log = [] if log is None else log
    tic = time.time()
    step = 0
    while step < args.max_steps:
        datas = [train_ds.pixel_batch(int(rng.integers(0, len(train_ds)))) for _ in range(M)]
        batches = {k: torch.stack([d[k] for d in datas]) for k in datas[0]}
        state, auxs = trainer.train_steps(state, batches)
        step += M
        log.append({
            "step": step, "loss": float(auxs["loss"].mean()), "mse": float(auxs["mse"][-1]),
            "samples": int(auxs["n_total_samples"].sum()),
            "pose_grad_norm": float(auxs["pose_grad_norm"][-1]),
        })
        if step % args.log_every < M:
            psnr = -10.0 * np.log10(max(log[-1]["mse"], 1e-10))
            err = pose_registration_errors(trainer.refined_poses(state), c2w_gt)
            print(f"elapsed_time={time.time() - tic:.2f}s | step={step} | "
                  f"train_psnr={psnr:.2f} | pose R {err['rot_deg']:.3f} deg T "
                  f"{err['trans']:.4f}", flush=True)
    train_seconds = time.time() - tic
    err = pose_registration_errors(trainer.refined_poses(state), c2w_gt)
    metrics = trainer.eval_metrics(state, test_ds, args.eval_images)
    print(f"evaluation: psnr={metrics['psnr']:.2f} ssim={metrics['ssim']:.4f} | "
          f"pose R {err['rot_deg']:.3f} deg (from {err0['rot_deg']:.3f}) | "
          f"T {err['trans']:.4f} (from {err0['trans']:.4f})")
    summary = {
        "name": f"barf@{args.scene if args.data_root else 'procedural'}",
        "steps": args.max_steps,
        "psnr": round(metrics["psnr"], 2),
        "ssim": round(metrics["ssim"], 4),
        "rot_deg": round(err["rot_deg"], 4),
        "trans": round(err["trans"], 5),
        "rot_deg_init": round(err0["rot_deg"], 4),
        "trans_init": round(err0["trans"], 5),
        "train_wall_s": round(train_seconds, 1),
    }
    print(json.dumps(summary), flush=True)
    return LoopResult(state, metrics, {"initial": err0, "final": err}, log, train_seconds,
                      summary)


def main(argv=None):
    args = parser().parse_args(argv)
    train_loop(*build(args), args)


if __name__ == "__main__":
    main()
