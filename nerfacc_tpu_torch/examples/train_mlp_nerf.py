"""Train the vanilla (MLP) NeRF with an occupancy grid.

PyTorch counterpart of examples/train_mlp_nerf.py::

    python -m nerfacc_tpu_torch.examples.train_mlp_nerf --max_steps 50000 --model_path ckpt.pt

trains :class:`~nerfacc_tpu_torch.models.mlp.VanillaNeRFRadianceField` (an
8x256 MLP on sinusoidal encodings) at the JAX script's settings: lr 5e-4,
Adam epsilon 1e-8, no warmup, no weight decay, step 5e-3 in the box +-1.5,
a 2^16-sample budget a step and the ray-batch controller of
:mod:`~nerfacc_tpu_torch.examples.train_mlp_tnerf` (no growth cap, 1k-64k
buckets).  Without ``--data_root`` it trains the translucent procedural
scene, with it the Blender (nerf_synthetic) loader of ``--train_split``
(reading the images needs ``imageio``).  With ``--model_path`` the run
resumes from that checkpoint when it exists, at its step, and saves it at
every log (``--log_every`` steps).  At the end it prints ``evaluation:
psnr_avg=...``.  Everything runs on the card unless ``--device cpu`` is
given.  As in that example the march walks every orbit to its end, so the
JAX script's ``max_samples_per_ray=1024`` needs no flag.

In process, :func:`build` makes the trainer and the loaders (its keyword
arguments shrink them, as the tests do) and :func:`train_loop` runs the
loop.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, NamedTuple, Optional

from ..data.procedural import ProceduralSceneLoader
from ..models.mlp import VanillaNeRFRadianceField
from ..trainers.ngp_occ import NGPOccTrainer, TrainState
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .train_mlp_tnerf import AABB, run_calls


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", default=None,
                    help="a nerf_synthetic root (needs imageio); none: the procedural scene")
    ap.add_argument("--scene", default="lego")
    ap.add_argument("--train_split", default="train")
    ap.add_argument("--max_steps", type=int, default=50000)
    ap.add_argument("--target_sample_batch_size", type=int, default=1 << 16)
    ap.add_argument("--init_batch_size", type=int, default=1024)
    ap.add_argument("--log_every", type=int, default=5000)
    ap.add_argument("--steps_per_call", type=int, default=8)
    ap.add_argument("--model_path", default=None,
                    help="checkpoint path: resumes from it when present; saved at every log")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    return ap


def build(args, scene_kwargs: Optional[Dict] = None, field_kwargs: Optional[Dict] = None,
          trainer_kwargs: Optional[Dict] = None):
    """The trainer, the train loader (``args.init_batch_size`` rays a batch)
    and the test loader; the keyword dicts pass more arguments to the
    procedural loaders, the field and the trainer."""
    if args.data_root is not None:
        from ..data.nerf_synthetic import SubjectLoader

        data = dict(subject_id=args.scene, root_fp=args.data_root, device=args.device)
        train_ds = SubjectLoader(split=args.train_split, num_rays=args.init_batch_size,
                                 seed=args.seed, **data)
        test_ds = SubjectLoader(split="test", **data)
    else:
        scene_kwargs = dict(scene_kwargs or {}, device=args.device)
        train_ds = ProceduralSceneLoader(split="train", num_rays=args.init_batch_size,
                                         seed=args.seed, **scene_kwargs)
        test_ds = ProceduralSceneLoader(split="test", **scene_kwargs)
    trainer = NGPOccTrainer(
        field=VanillaNeRFRadianceField(device=args.device, **(field_kwargs or {})),
        aabb=AABB,
        max_steps=args.max_steps,
        render_step_size=5e-3,
        lr=5e-4,
        weight_decay=0.0,
        adam_eps=1e-8,
        warmup_lr_steps=0,
        sample_budget=args.target_sample_batch_size,
        seed=args.seed,
        device=args.device,
        **(trainer_kwargs or {}),
    )
    return trainer, train_ds, test_ds


class LoopResult(NamedTuple):
    state: TrainState
    metrics: Dict  # the final eval_metrics (its "psnr" is eval_psnr's)
    log: List[Dict]  # one record per call, in call order
    train_seconds: float  # wall seconds of the loop, the final evaluation excluded


def train_loop(trainer: NGPOccTrainer, train_ds, test_ds, args,
               log: Optional[List[Dict]] = None) -> LoopResult:
    """Train from ``args.model_path``'s checkpoint if it exists (else from
    the trainer's initial state) through the dynamic example's
    :func:`~nerfacc_tpu_torch.examples.train_mlp_tnerf.run_calls` (its
    records go to ``log``), saving the checkpoint at every log, then
    evaluate on ``test_ds``."""
    state = trainer.init_state()
    if args.model_path and os.path.exists(args.model_path):
        state = load_checkpoint(args.model_path, like=state, device=trainer.device)
        print(f"resumed from {args.model_path} at step {int(state.step)}")

    def save(state):
        if args.model_path:
            save_checkpoint(args.model_path, state)

    log = [] if log is None else log
    state, train_seconds, _ = run_calls(trainer, train_ds, args, state, log, save)
    metrics = trainer.eval_metrics(state, test_ds)
    print(f"evaluation: psnr_avg={metrics['psnr']:.2f}")
    return LoopResult(state, metrics, log, train_seconds)


def main(argv=None):
    args = parser().parse_args(argv)
    train_loop(*build(args), args)


if __name__ == "__main__":
    main()
