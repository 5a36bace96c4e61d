#!/usr/bin/env python3
"""Train the dynamic example's T-NeRF field in the JAX package and in the
PyTorch port side by side on the CPU, and compare the share of each step's
rays that the loss masked.

Run from the root of a checkout (needs JAX and PyTorch; no GPU):

    JAX_PLATFORMS=cpu python3 scripts/masked_share_vs_jax.py \\
        [--steps 96] [--every 8] [--rays 256] [--budget 16384] [--grid 64] \\
        [--size 64] [--jax_traversals pooled padded] [--out build/masked_share]

The configuration is the dynamic example's (``train_mlp_tnerf --field
tnerf`` in both packages: the 4x64 warp MLP in front of the 8x256 vanilla
NeRF, f32; lr 5e-4, Adam epsilon 1e-8, no warmup, no weight decay; step
5e-3 in the box +-1.5; the moving-blob scene; the JAX trainer's dynamic
budget).  The JAX trainer runs once for each of ``--jax_traversals``: its
default "pooled" window pool (a fifth of the budget in windows of 8
candidates), and "padded", the lattice of 1024 candidates a ray whose
step the CPU tests hold the port to.  It is cut
where a CPU must, keeping the ratio that masks the rays: ``--rays`` rays a
step for the controller's floor of 1024, ``--budget`` samples for its 2^16
(a ray holds ~160 samples either way, so a batch at the floor asks for
more than the budget holds), a ``--grid``^3 occupancy grid for 128^3 (a
dense refresh of every cell each 16 steps), ``--size`` pixels a side of
the 24 views (320).  At the floor both controllers stay there (each
package's proposal is printed), so the ray count is fixed.

Both trainers start from the JAX trainer's parameters and grid (seed 42,
carried over by ``nerfacc_tpu_torch.utils.jax_bridge``), take the same
batches (the JAX loader's, with their per-ray times) and the same draws:
each step's near-plane jitter, the refresh's cell offsets and frames, from
the JAX trainer's key, are handed to the port's ``train_step``.  A ray is
masked when the loss leaves it out: cut by the budget, or, once more than
a quarter of the rays finish (terminated or saturated), cut by the window
pool (JAX's pooled step; below that quarter it trains those rays on the
samples the pool kept).  Every ``--every`` steps one JSON line (printed,
and appended to ``<out>/readings.jsonl``) holds each run's mean masked
share, the share of rays the traversal cut (JAX: ``n_rays_truncated``),
demand (samples before the cut), rendered samples, loss and its
controller's proposal since the last reading; the last line holds the
means over the run.
"""
import argparse
import json
import os
import sys
import time

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from nerfacc_tpu.data.procedural import ProceduralDynamicSceneLoader  # noqa: E402
from nerfacc_tpu.models.mlp import TNeRFRadianceField as JaxTNeRF  # noqa: E402
from nerfacc_tpu.trainers.ngp_occ import NGPOccTrainer as JaxTrainer  # noqa: E402
from nerfacc_tpu_torch.examples.train_mlp_tnerf import next_num_rays  # noqa: E402
from nerfacc_tpu_torch.models.mlp import TNeRFRadianceField  # noqa: E402
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer, TrainState  # noqa: E402
from nerfacc_tpu_torch.utils.jax_bridge import (  # noqa: E402
    field_params_from_numpy,
    occ_state_from_numpy,
)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
# both examples' settings for --field tnerf (examples/train_mlp_tnerf.py)
SETTINGS = dict(render_step_size=5e-3, lr=5e-4, weight_decay=0.0, adam_eps=1e-8,
                warmup_lr_steps=0, field_reg_weight=0.0, max_steps=30000, seed=42)


def draws(key, n_rays, cells, n_frames):
    """The JAX step's near-plane jitter, and its refresh's cell offsets and
    frames, as its step body splits its key (tests/test_torch_mlp_train.py)."""
    _, k_occ, k_strat, k_time = jax.random.split(key, 4)
    near = np.asarray(jax.random.uniform(k_strat, (n_rays,)))
    offsets = np.asarray(jax.random.uniform(jax.random.split(k_occ, 4)[3], (1, cells, 3)))
    frames = np.asarray(jax.random.randint(k_time, (cells,), 0, n_frames))
    return near, offsets, frames


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=96)
    ap.add_argument("--every", type=int, default=8)
    ap.add_argument("--rays", type=int, default=256)
    ap.add_argument("--budget", type=int, default=1 << 14)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--jax_traversals", nargs="+", default=["pooled", "padded"],
                    choices=["pooled", "padded"])
    ap.add_argument("--out", default="build/masked_share")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    loader = ProceduralDynamicSceneLoader("train", width=args.size, height=args.size,
                                          num_rays=args.rays)
    timestamps = np.asarray(loader.timestamps)
    runs = {}
    for traversal in args.jax_traversals:
        jax_trainer = JaxTrainer(
            field=JaxTNeRF(), aabb=AABB, grid_resolution=args.grid, sample_budget=args.budget,
            max_samples_per_ray=1024, time_dependent=True, timestamps=timestamps,
            traversal=traversal, windowed=traversal != "padded", **SETTINGS)
        runs[f"jax-{traversal}"] = [jax_trainer, jax_trainer.init_state()]
    jstate = next(iter(runs.values()))[1]
    trainer = NGPOccTrainer(field=TNeRFRadianceField(device="cpu"), aabb=AABB,
                            grid_resolution=args.grid, sample_budget=args.budget,
                            timestamps=timestamps, device="cpu", **SETTINGS)
    params = field_params_from_numpy(jax.tree.map(np.asarray, jstate.params), device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    occ = jstate.occ_state
    state = TrainState(params, trainer.init_optimizer(params), occ_state_from_numpy(
        *(np.asarray(a) for a in (occ.aabbs, occ.occs, occ.binaries)), device="cpu"), 0)

    cells = args.grid ** 3
    floor = args.rays
    buckets = [floor * 2**i for i in range(7)]
    keys = ("masked", "truncated", "n_total_samples", "n_rendering_samples", "loss",
            "proposal")
    names = [*runs, "port"]
    window = {name: {k: [] for k in keys} for name in names}
    whole = {name: {k: [] for k in keys} for name in names}
    log = open(os.path.join(args.out, "readings.jsonl"), "a")
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = {k: np.asarray(v) for k, v in loader[0].items()}
        # every JAX run splits the same key the same way: one set of draws
        near, offsets, frames = draws(next(iter(runs.values()))[1].key, args.rays, cells,
                                      len(timestamps))
        auxs = {}
        for name, run in runs.items():
            run[1], auxs[name] = run[0].train_step(run[1], batch)
        state, auxs["port"] = trainer.train_step(
            state, {k: torch.tensor(v) for k, v in batch.items()},
            near_jitter=torch.tensor(near), cell_jitter=torch.tensor(offsets),
            frame_idx=torch.tensor(frames))
        for name, a in auxs.items():
            n_total = int(a["n_total_samples"])
            reading = {
                "masked": 1.0 - float(a["n_rays_ok"]) / args.rays,
                "truncated": float(a.get("n_rays_truncated", 0)) / args.rays,
                "n_total_samples": n_total,
                "n_rendering_samples": int(a["n_rendering_samples"]),
                "loss": float(a["loss"]),
                "proposal": next_num_rays(args.rays, max(n_total, 1), args.budget, buckets),
            }
            for k, v in reading.items():
                window[name][k].append(v)
                whole[name][k].append(v)
        if (step + 1) % args.every == 0 or step + 1 == args.steps:
            line = {"step": step + 1, "seconds": round(time.perf_counter() - t0, 1)}
            for name, w in window.items():
                line[name] = {k: float(np.mean(v)) for k, v in w.items()}
                for v in w.values():
                    v.clear()
            print(json.dumps(line), flush=True)
            log.write(json.dumps(line) + "\n")
    summary = {"steps": args.steps, "rays": args.rays, "budget": args.budget,
               "grid": args.grid, "size": args.size,
               **{name: {k: float(np.mean(v)) for k, v in w.items()}
                  for name, w in whole.items()}}
    print(json.dumps(summary), flush=True)
    log.write(json.dumps(summary) + "\n")


if __name__ == "__main__":
    main()
