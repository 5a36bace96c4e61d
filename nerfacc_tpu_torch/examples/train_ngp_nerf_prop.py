"""Train a radiance field with proposal networks.

PyTorch counterpart of examples/train_ngp_nerf_prop.py::

    python -m nerfacc_tpu_torch.examples.train_ngp_nerf_prop --field cp

trains the full-width ``CPRadianceField`` behind one ``CPDensityField`` or,
with ``--field ngp``, the hash-grid ``NGPRadianceField`` behind one
``NGPDensityField``, on ``--batch_size`` rays a step, then evaluates the test
views (``--eval_images`` of them; 0 skips the evaluation).  The scene and
configuration follow ``--scene`` as in the JAX script:

- ``procedural360``: the unbounded procedural scene
  (``ProceduralUnboundedSceneLoader``, six test views) with the unbounded
  configuration: two proposal levels [256, 96] -> 48 final samples, uniform
  in disparity (lindisp), an opaque last sample, the box +-1 contracted,
  and the scene's own near and far planes (0.05, 20);
- a Mip-NeRF 360 scene name (``garden``, ``bicycle``, ...): that unbounded
  configuration with near 0.2 and far 1e3 on the bounded procedural scene;
- any other name (the default ``lego``): the bounded procedural scene with
  one proposal level [128] -> 64, uniform, near 2 and far 6, over the box
  +-1.5;
- with ``--data_root``, the Blender (nerf_synthetic) loader of
  ``--train_split`` under that root in place of the procedural scene, with
  the scene name's configuration, as in the JAX script (reading the images
  needs ``imageio``).

The proposal fields take a gradient step on the steps that
``get_proposal_requires_grad_fn`` picks.  Batches are drawn on the device
(``--device_sampler 1``) or by the host loader, ``--steps_per_call`` steps a
call.  Everything runs on the card unless ``--device cpu`` is given.

Flags of the JAX script that the port leaves out:

- ``--encoder_remat``: rematerialisation under XLA's memory planning;
  autograd here keeps the encoder's inputs and has nothing to recompute.

In process, :func:`build` makes the trainer and the loaders (its keyword
arguments shrink them, as the tests do) and :func:`train_loop` runs the loop
and returns the final state, metrics and a record of every step.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..data.device_sampler import DeviceRaySampler
from ..data.procedural import UNBOUNDED_SCENES, ProceduralSceneLoader
from ..estimators.prop_net import get_proposal_requires_grad_fn
from ..models.cp_field import CPDensityField, CPRadianceField
from ..models.ngp import NGPDensityField, NGPRadianceField
from ..trainers.ngp_prop import NGPPropTrainer, PropTrainState

MIPNERF360_UNBOUNDED_SCENES = [
    "garden", "bicycle", "bonsai", "counter", "kitchen", "room", "stump",
]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", default=None,
                    help="a nerf_synthetic root (needs imageio); none: a procedural scene")
    ap.add_argument("--scene", default="lego")
    ap.add_argument("--train_split", default="train")
    ap.add_argument("--max_steps", type=int, default=20000)
    ap.add_argument("--batch_size", type=int, default=4096)
    ap.add_argument("--log_every", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--field", default="cp", choices=["cp", "ngp"])
    ap.add_argument("--steps_per_call", type=int, default=32)
    ap.add_argument("--eval_images", type=int, default=None)
    ap.add_argument("--device_sampler", type=int, default=1,
                    help="draw ray batches on the device (0: the host loader)")
    ap.add_argument("--device", default="cuda")
    return ap


def config(scene: str) -> Dict:
    """The JAX script's configuration for ``scene``: the box, whether the
    fields contract it, the proposal and final sample counts, the planes,
    the sampling and the opaque background (before an unbounded procedural
    scene takes its own planes)."""
    if scene in MIPNERF360_UNBOUNDED_SCENES or scene in UNBOUNDED_SCENES:
        return dict(aabb=[-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], unbounded=True,
                    prop_samples=[256, 96], num_samples=48, near_plane=0.2,
                    far_plane=1e3, sampling_type="lindisp", opaque_bkgd=True)
    return dict(aabb=[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], unbounded=False,
                prop_samples=[128], num_samples=64, near_plane=2.0, far_plane=6.0,
                sampling_type="uniform", opaque_bkgd=False)


def build(args, scene_kwargs: Optional[Dict] = None, field_kwargs: Optional[Dict] = None,
          trainer_kwargs: Optional[Dict] = None, prop_kwargs: Optional[Dict] = None):
    """The trainer, the train loader (``args.batch_size`` rays a batch) and
    the test loader of ``args``; the keyword dicts pass more arguments to the
    loaders, the radiance field, the trainer and each proposal field."""
    cfg = config(args.scene)
    scene_kwargs = dict(scene_kwargs or {}, device=args.device)
    train_split = "train"
    if args.data_root is not None:
        from ..data.nerf_synthetic import SubjectLoader

        loader_cls, train_split = SubjectLoader, args.train_split
        scene_kwargs = dict(subject_id=args.scene, root_fp=args.data_root, device=args.device)
        test_kwargs = scene_kwargs
    elif args.scene in UNBOUNDED_SCENES:
        loader_cls = UNBOUNDED_SCENES[args.scene]
        test_kwargs = {"n_test": 6, **scene_kwargs}
        cfg["near_plane"], cfg["far_plane"] = loader_cls.NEAR, loader_cls.FAR
    else:
        loader_cls, test_kwargs = ProceduralSceneLoader, scene_kwargs
    train_ds = loader_cls(split=train_split, num_rays=args.batch_size, seed=args.seed,
                          **scene_kwargs)
    test_ds = loader_cls(split="test", **test_kwargs)
    field_cls, prop_cls = ((CPRadianceField, CPDensityField) if args.field == "cp"
                           else (NGPRadianceField, NGPDensityField))
    aabb, unbounded = cfg.pop("aabb"), cfg.pop("unbounded")
    trainer = NGPPropTrainer(
        field=field_cls(aabb, unbounded=unbounded, **(field_kwargs or {})),
        prop_fields=[prop_cls(aabb, unbounded=unbounded, **(prop_kwargs or {}))
                     for _ in cfg["prop_samples"]],
        max_steps=args.max_steps,
        seed=args.seed,
        device=args.device,
        **{**cfg, **(trainer_kwargs or {})},
    )
    return trainer, train_ds, test_ds


class LoopResult(NamedTuple):
    state: PropTrainState
    metrics: Optional[Dict]  # the final eval_metrics (None with --eval_images 0)
    log: Dict[str, np.ndarray]  # loss, mse, prop_loss, requires_grad: one entry a step
    train_seconds: float  # wall seconds of the loop, the final evaluation excluded


def train_loop(trainer: NGPPropTrainer, train_ds, test_ds, args) -> LoopResult:
    """Train from the trainer's initial state until the step passes
    ``args.max_steps``, ``args.steps_per_call`` steps a call, printing the
    JAX script's log line when a call crosses a multiple of
    ``args.log_every`` and its evaluation line at the end."""
    state = trainer.init_state()
    requires_grad_fn = get_proposal_requires_grad_fn()
    sampler = None
    if args.device_sampler:
        sampler = DeviceRaySampler.from_loader(train_ds, num_rays=args.batch_size)
    rng = np.random.default_rng(args.seed)
    per_ray = trainer.num_samples + sum(trainer.prop_samples)
    M = max(1, args.steps_per_call)
    auxs_all, rgs_all = [], []
    tic = time.time()
    step = 0
    while step <= args.max_steps:
        rgs = [requires_grad_fn(step + i) for i in range(M)]
        if sampler is not None:
            state, auxs = trainer.train_steps_sampled(state, sampler, rgs)
        else:
            datas = [train_ds[int(rng.integers(0, len(train_ds)))] for _ in range(M)]
            batches = {k: torch.stack([d[k] for d in datas]) for k in datas[0]}
            state, auxs = trainer.train_steps(state, batches, rgs)
        step += M
        auxs_all.append(auxs)
        rgs_all.extend(rgs)

        if (step - M) // args.log_every != step // args.log_every:
            mse = float(auxs["mse"][-1])  # waits for the call
            elapsed = time.time() - tic
            print(
                f"elapsed_time={elapsed:.2f}s | step={step} | "
                f"loss={float(auxs['loss'][-1]):.5f} | "
                f"psnr={-10.0 * np.log10(max(mse, 1e-10)):.2f} | "
                f"prop_loss={float(auxs['prop_loss'].max()):.5f} | "
                f"samples/s={step * args.batch_size * per_ray / elapsed:.3g}",
                flush=True,
            )
    log = {k: torch.cat([a[k] for a in auxs_all]).cpu().numpy() for k in auxs_all[0]}
    log["requires_grad"] = np.array(rgs_all)
    train_seconds = time.time() - tic
    metrics = None
    if args.eval_images != 0:
        metrics = trainer.eval_metrics(state, test_ds, max_images=args.eval_images)
        print(f"evaluation: psnr_avg={metrics['psnr']:.2f} ssim_avg={metrics['ssim']:.4f}")
    return LoopResult(state, metrics, log, train_seconds)


def main(argv=None):
    args = parser().parse_args(argv)
    train_loop(*build(args), args)


if __name__ == "__main__":
    main()
