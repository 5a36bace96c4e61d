#!/usr/bin/env python3
"""Train the TiNeuVox path in the JAX package and in the PyTorch port side by
side on the CPU, and read how far the deformation MLP saturates in each.

Run from the root of a checkout (needs JAX and PyTorch; no GPU):

    JAX_PLATFORMS=cpu python3 scripts/tineuvox_saturation_vs_jax.py \
        [--steps 400] [--every 50] [--draws 3] [--out build/tineuvox_saturation]

The configuration is ``chip_smoke.py``'s phase 12 (the dynamic example's
TiNeuVox: the full-width bf16 field, lr 1e-2 with 100 warmup steps over a
1000-step schedule, Adam eps 1e-15, no weight decay, TV weight 1e-4, the
dense refresh every 16 steps on a 128^3 grid), cut where a CPU must:
``--rays`` rays a step (phase 12: 1024), ``--budget`` samples (2^16),
``--grid`` cells a side (128), ``--size`` pixels a side of the 24 training
views (256), and ``--steps`` steps (1000).

Both trainers start from the JAX trainer's parameters of seed 42 (carried
over by ``nerfacc_tpu_torch.utils.jax_bridge``) and take the same batches
(the JAX loader's) and the same noise: each step's near-plane jitter, and on
refresh steps the refresh's cell jitter and frame draw, are drawn from the
JAX trainer's key and handed to the port's ``train_step``.  A noise draw is
the JAX trainer's step key chain started from ``PRNGKey(1000 + draw)``.  The
JAX field runs its hat-matmul route with the Pallas kernel interpreted, as
its tests run it on a CPU; the port runs its plain versions.

Every ``--every`` steps, for each package, on the same 2^16 points drawn
uniformly in the box at training-frame times, through the same (the port's)
forward of the deformation MLP: the share of outputs whose ``1 - tanh(raw)^2``
is 0 in f32 (no gradient reaches the MLP there), the largest |raw|, the share
of units that fire on any point in each hidden layer, and the step's loss.
One JSON line a reading, printed and appended to ``<out>/readings.jsonl``,
and a last line with the verdict's numbers.

With ``--control`` a third trainer runs beside them: the port again, from
the same parameters each moved by one f32 ulp (``nextafter`` away from 0),
on the same batches and noise.  Each reading then adds ``raw_gap``, the
largest difference of the deformation outputs on the points over their
largest magnitude, for JAX against the port and for the port against its
one-ulp twin: where the two gaps grow alike, the packages depart by the
amplification of last-bit differences that the port shows against itself.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import nerfacc_tpu.ops  # noqa: E402
from nerfacc_tpu.data.procedural import ProceduralDynamicSceneLoader  # noqa: E402
from nerfacc_tpu.models.tineuvox import TiNeuVoxRadianceField as JaxTiNeuVox  # noqa: E402
from nerfacc_tpu.ops.hat_matmul import hat_interp_matmul  # noqa: E402
from nerfacc_tpu.trainers.ngp_occ import NGPOccTrainer as JaxTrainer  # noqa: E402
from nerfacc_tpu_torch.models.ngp import _mlp_apply  # noqa: E402
from nerfacc_tpu_torch.models.tineuvox import TiNeuVoxRadianceField  # noqa: E402
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer, TrainState  # noqa: E402
from nerfacc_tpu_torch.utils.jax_bridge import (  # noqa: E402
    occ_state_from_numpy,
    tineuvox_field_params_from_numpy,
)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
# phase 12's trainer settings beside the trainers' shared defaults
PHASE12 = dict(weight_decay=0.0, field_reg_weight=1e-4, max_steps=1000)
SEED = 42
N_POINTS = 2**16


def interpret_hat():
    """The JAX encoder's hat route reaches K3 through ``nerfacc_tpu.ops``,
    which a CPU runs only interpreted."""
    nerfacc_tpu.ops.hat_interp_matmul = lambda x, line: hat_interp_matmul(x, line, True)


def jax_trainer(args, timestamps):
    field = JaxTiNeuVox(aabb=AABB, compute_dtype=jnp.bfloat16)
    object.__setattr__(field, "encoder", dataclasses.replace(field.encoder, use_pallas=True))
    return JaxTrainer(
        field=field, aabb=AABB, grid_resolution=args.grid, traversal="padded",
        windowed=False, max_samples_per_ray=1400, dynamic_budget=False,
        sample_budget=args.budget, timestamps=timestamps, time_dependent=True,
        seed=SEED, **PHASE12,
    )


def port_trainer(args, timestamps):
    field = TiNeuVoxRadianceField(AABB, compute_dtype=torch.bfloat16, device="cpu")
    return NGPOccTrainer(
        field=field, aabb=AABB, grid_resolution=args.grid, sample_budget=args.budget,
        timestamps=timestamps, seed=SEED, device="cpu", **PHASE12,
    )


def step_noise(key, n_rays, cells, n_frames):
    """The noise of the JAX trainer's step at ``key`` (its ``_step_body``
    and ``update_occ_grid`` draws): near-plane jitter, cell jitter, frames."""
    _, k_occ, k_strat, k_time = jax.random.split(key, 4)
    near = np.asarray(jax.random.uniform(k_strat, (n_rays,)))
    jitter = np.asarray(jax.random.uniform(jax.random.split(k_occ, 4)[3], (1, cells, 3)))
    frames = np.asarray(jax.random.randint(k_time, (cells,), 0, n_frames))
    return near, jitter, frames


@torch.no_grad()
def deform_readings(field, params, x, t):
    """Saturated share, largest |raw| and each hidden layer's firing share
    of the deformation MLP with ``params`` at points ``x``, times ``t``."""
    field.load_state_dict(params)
    h = torch.cat([field.posi_encoder(x), field.time_encoder(t)], dim=-1)
    raw = _mlp_apply(field.deform, h, field.compute_dtype)
    shares = []
    for w in list(field.deform)[:-1]:
        h = torch.relu(h @ w.float())
        shares.append(float((h > 0).any(dim=0).float().mean()))
    saturated = (1.0 - torch.tanh(raw) ** 2) == 0.0
    return {"saturated_share": float(saturated.float().mean()),
            "raw_abs_max": float(raw.abs().max()), "active_share": shares, "raw": raw}


def run_draw(args, draw, batches, timestamps, points, out):
    jtrainer = jax_trainer(args, timestamps)
    jstate = jtrainer.init_state()
    jstate = jstate._replace(key=jax.random.PRNGKey(1000 + draw))
    jparams = jax.tree.map(np.asarray, jstate.params)
    jocc = tuple(np.asarray(a) for a in (jstate.occ_state.aabbs, jstate.occ_state.occs,
                                         jstate.occ_state.binaries))
    trainer = port_trainer(args, timestamps)
    params = tineuvox_field_params_from_numpy(jparams, device="cpu")
    for p in params.values():
        p.requires_grad_(True)
    state = TrainState(params, trainer.init_optimizer(params),
                       occ_state_from_numpy(*jocc, device="cpu"), 0)
    twin = None
    if args.control:
        moved = {k: torch.nextafter(v.detach(), torch.where(v >= 0, np.inf, -np.inf))
                 .requires_grad_(True) for k, v in params.items()}
        twin = TrainState(moved, trainer.init_optimizer(moved),
                          occ_state_from_numpy(*jocc, device="cpu"), 0)
    reader = TiNeuVoxRadianceField(AABB, compute_dtype=torch.bfloat16, device="cpu")
    rows = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = batches[step]
        near, jitter, frames = step_noise(
            jstate.key, args.rays, args.grid**3, timestamps.shape[0])
        jstate, jaux = jtrainer.train_step(jstate, batch)
        noise = dict(near_jitter=torch.tensor(near), cell_jitter=torch.tensor(jitter),
                     frame_idx=torch.tensor(frames))
        tbatch = {k: torch.tensor(v) for k, v in batch.items()}
        state, aux = trainer.train_step(state, tbatch, **noise)
        if twin is not None:
            twin, twin_aux = trainer.train_step(twin, tbatch, **noise)
        if (step + 1) % args.every and step + 1 != args.steps:
            continue
        row = {"draw": draw, "step": step + 1, "seconds": time.perf_counter() - t0}
        runs = [
            ("jax", tineuvox_field_params_from_numpy(
                jax.tree.map(np.asarray, jstate.params), device="cpu"), jaux["loss"]),
            ("port", {k: v.detach() for k, v in state.params.items()}, aux["loss"]),
        ]
        if twin is not None:
            runs.append(("port_ulp", {k: v.detach() for k, v in twin.params.items()},
                         twin_aux["loss"]))
        raws = {}
        for name, p, loss in runs:
            readings = deform_readings(reader, p, *points)
            raws[name] = readings.pop("raw")
            row[name] = {"loss": float(loss), **readings}
        if twin is not None:
            row["raw_gap"] = {
                f"{a}_vs_{b}": float((raws[a] - raws[b]).abs().max() / raws[b].abs().max())
                for a, b in (("jax", "port"), ("port_ulp", "port"))
            }
        rows.append(row)
        print(json.dumps(row), flush=True)
        with open(os.path.join(out, "readings.jsonl"), "a") as f:
            f.write(json.dumps(row) + "\n")
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--rays", type=int, default=256)
    ap.add_argument("--budget", type=int, default=2**14)
    ap.add_argument("--grid", type=int, default=64)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--control", action="store_true",
                    help="also train the port from parameters one ulp away")
    ap.add_argument("--out", default="build/tineuvox_saturation")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    interpret_hat()
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    os.environ.setdefault("NERFACC_TPU_GT_CACHE", "")
    ds = ProceduralDynamicSceneLoader(
        "train", width=args.size, height=args.size, num_rays=args.rays)
    timestamps = np.asarray(ds.timestamps)
    batches = [{k: np.asarray(v) for k, v in ds[0].items()} for _ in range(args.steps)]
    g = torch.Generator().manual_seed(0)
    lo, hi = torch.tensor(AABB[:3]), torch.tensor(AABB[3:])
    x = lo + (hi - lo) * torch.rand((N_POINTS, 3), generator=g)
    t = torch.tensor(timestamps)[torch.randint(timestamps.shape[0], (N_POINTS,), generator=g)]
    head = {"config": vars(args), "phase12": PHASE12, "seed": SEED,
            "torch": torch.__version__, "jax": jax.__version__}
    print(json.dumps(head), flush=True)
    rows = [r for d in range(args.draws) for r in run_draw(args, d, batches, timestamps,
                                                            (x, t), args.out)]
    # per reading step: each package's saturated share over the draws, and
    # the largest JAX-port gap beside the port's own spread over the draws
    verdict = []
    for step in sorted({r["step"] for r in rows}):
        at = [r for r in rows if r["step"] == step]
        jax_s = [r["jax"]["saturated_share"] for r in at]
        port_s = [r["port"]["saturated_share"] for r in at]
        verdict.append({
            "step": step, "jax": jax_s, "port": port_s,
            "gap_max": max(abs(a - b) for a, b in zip(jax_s, port_s)),
            "spread_port": max(port_s) - min(port_s), "spread_jax": max(jax_s) - min(jax_s),
        })
    print(json.dumps({"verdict": verdict}), flush=True)


if __name__ == "__main__":
    main()
