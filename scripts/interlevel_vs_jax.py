#!/usr/bin/env python3
"""Train the proposal path's unbounded two-level cascade in the JAX package
and in the PyTorch port side by side on the CPU, and compare their losses,
the interlevel (proposal) loss above all.

Run from the root of a checkout (needs JAX and PyTorch; no GPU):

    JAX_PLATFORMS=cpu python3 scripts/interlevel_vs_jax.py \
        [--steps 300] [--every 25] [--out build/interlevel]

The configuration is the proposal example's ``--scene procedural360 --field
cp`` (``chip_smoke.py`` phase 21): the bench ``CPRadianceField`` behind two
``CPDensityField``s (16/64 x rank 16, hidden 64), every field bf16 and
contracted over the box +-1, [256, 96] -> 48 samples uniform in disparity
from 0.05 to 20, the opaque last sample, lr 1e-2 with 100 warmup steps over a
1000-step schedule, the proposal-gradient schedule of the example.  It is
cut where a CPU must: ``--rays`` rays a step (phase 21: 4096), ``--size``
pixels a side of the 24 training views (320) and ``--steps`` steps (1000).

Both trainers start from the JAX trainer's parameters (seed 42, carried
over by ``nerfacc_tpu_torch.utils.jax_bridge``), take the same batches (the
JAX loader's) and the same noise: each resampling's stratified draw, from
the JAX trainer's key, is handed to the port's ``train_step``.  Every
``--every`` steps one JSON line (printed, and appended to
``<out>/readings.jsonl``) holds each package's mean loss and mean
interlevel loss over the proposal-gradient steps since the last reading;
the last line holds the first and last readings of both.
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
from nerfacc_tpu.data.procedural import ProceduralUnboundedSceneLoader  # noqa: E402
from nerfacc_tpu.models.cp_field import CPDensityField as JaxDensityField  # noqa: E402
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField  # noqa: E402
from nerfacc_tpu.trainers.ngp_prop import NGPPropTrainer as JaxPropTrainer  # noqa: E402
from nerfacc_tpu_torch.estimators.prop_net import get_proposal_requires_grad_fn  # noqa: E402
from nerfacc_tpu_torch.models.cp_field import CPDensityField, CPRadianceField  # noqa: E402
from nerfacc_tpu_torch.trainers.ngp_prop import NGPPropTrainer, PropTrainState  # noqa: E402
from nerfacc_tpu_torch.utils.jax_bridge import prop_params_from_numpy  # noqa: E402

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
CASCADE = dict(prop_samples=[256, 96], num_samples=48,
               near_plane=ProceduralUnboundedSceneLoader.NEAR,
               far_plane=ProceduralUnboundedSceneLoader.FAR, sampling_type="lindisp",
               opaque_bkgd=True, max_steps=1000)


def trainers():
    jax_trainer = JaxPropTrainer(
        field=JaxField(aabb=AABB, unbounded=True),
        prop_fields=[JaxDensityField(aabb=AABB, unbounded=True) for _ in range(2)], **CASCADE)
    port = NGPPropTrainer(
        field=CPRadianceField(AABB, unbounded=True),
        prop_fields=[CPDensityField(AABB, unbounded=True) for _ in range(2)], device="cpu",
        **CASCADE)
    return jax_trainer, port


def biases(key, n_rays, levels):
    """Each resampling's stratified draw, as the JAX step splits its key."""
    k_strat = jax.random.split(key)[1]
    return [torch.tensor(np.asarray(jax.random.uniform(k, (n_rays, 1)))).reshape(-1)
            for k in jax.random.split(k_strat, levels + 1)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--every", type=int, default=25)
    ap.add_argument("--rays", type=int, default=256)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--out", default="build/interlevel")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    out = open(os.path.join(args.out, "readings.jsonl"), "a")

    ds = ProceduralUnboundedSceneLoader("train", width=args.size, height=args.size,
                                        num_rays=args.rays)
    jax_trainer, port = trainers()
    jstate = jax_trainer.init_state()
    params = prop_params_from_numpy(jax.tree.map(np.asarray, jstate.params), device="cpu")
    for leaf in port.leaves(params):
        leaf.requires_grad_(True)
    state = PropTrainState(params, port.init_optimizer(params), 0)
    requires_grad_fn = get_proposal_requires_grad_fn()
    window = {"jax": [], "port": []}
    readings = []
    t0 = time.time()
    for step in range(args.steps):
        rg = requires_grad_fn(step)
        batch = {k: np.asarray(v) for k, v in ds[step % len(ds)].items()}
        noise = biases(jstate.key, args.rays, len(CASCADE["prop_samples"]))
        jstate, jaux = jax_trainer.train_step(jstate, batch, requires_grad=rg)
        state, aux = port.train_step(state, {k: torch.tensor(v) for k, v in batch.items()},
                                     requires_grad=rg, biases=noise)
        for name, a in (("jax", jaux), ("port", aux)):
            window[name].append((float(a["loss"]), float(a["prop_loss"]), rg))
        if (step + 1) % args.every == 0:
            line = {"step": step + 1, "seconds": round(time.time() - t0, 1)}
            for name, rows in window.items():
                line[f"{name}_loss"] = float(np.mean([r[0] for r in rows]))
                line[f"{name}_interlevel"] = float(np.mean([r[1] for r in rows if r[2]]
                                                           or [np.nan]))
            window = {"jax": [], "port": []}
            readings.append(line)
            print(json.dumps(line), flush=True)
            out.write(json.dumps(line) + "\n")
    first, last = readings[0], readings[-1]
    verdict = {"verdict": {
        "steps": args.steps, "rays": args.rays, "size": args.size,
        **{f"{name}_{key}_{when}": r[f"{name}_{key}"] for name in ("jax", "port")
           for key in ("loss", "interlevel") for when, r in (("first", first), ("last", last))},
    }}
    print(json.dumps(verdict), flush=True)
    out.write(json.dumps(verdict) + "\n")
    out.close()


if __name__ == "__main__":
    main()
