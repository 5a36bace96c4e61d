#!/usr/bin/env python3
"""Train ``chip_smoke.py`` phase 27's loop (the quick start's bench CP
field behind ``VDBEstimator``, 128^3 over +-1.5, the field's density times
the step as the update's occupancy) in a few variants on the card, and
print how many voxels its VDB update leaves occupied.

Run from the root of a checkout on a machine with a card:

    python3 scripts/vdb_occupancy_probe.py

Variants: the hard-surface scene (``proceduralopaque``, 6 train views at
256x256, 2048 rays) for 200 and 1000 steps at the loop's lr 1e-2, 1000
steps at lr 1e-3, 1000 steps on 24 views at 320x320, and the translucent
scene for 1000 steps.  Every 100 steps one line: the loss, the samples the
visibility filter kept, the occupied share and the occupancies' mean,
median and least value (a voxel stays enabled while it is above
``min(mean, 0.01)``); then the mean loss of the first and last 20 steps.
"""
import os
import statistics
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
import nerfacc_tpu_torch  # noqa: E402


def run(dev, label, steps, lr=1e-2, views=(6, 256), scene="opaque"):
    loader = cs.ProceduralOpaqueSceneLoader if scene == "opaque" else cs.ProceduralSceneLoader
    train = loader(split="train", n_train=views[0], width=views[1], height=views[1],
                   num_rays=cs.TRAIN["cp"][1], seed=cs.QUALITY_SEEDS[0], device=dev)
    field = cs.port_module("models.cp_field").CPRadianceField(cs.AABB).to(dev)
    field.init(torch.Generator().manual_seed(cs.QUALITY_SEEDS[0]))
    est = nerfacc_tpu_torch.VDBEstimator(roi_aabb=cs.AABB, resolution=cs.QS_RES, device=dev)
    opt = torch.optim.Adam(field.parameters(), lr=lr, eps=1e-15)

    def occ_eval_fn(x):
        return field.query_density(x)[..., 0] * cs.QS_STEP

    t0, losses = time.time(), []
    for step in range(steps):
        est.update_every_n_steps(step, occ_eval_fn, warmup_steps=cs.QS_WARMUP)
        loss, n = cs.qs_loss(field, est, train[0])
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if step % 100 == 0 or step == steps - 1:
            occs = est.occs
            print(f"{label} step {step}: loss {losses[-1]:.5f}, {n} samples, occupied share "
                  f"{float(est.binaries.float().mean()):.5f}, occupancy mean "
                  f"{float(occs.mean()):.4g} median {float(occs.median()):.4g} least "
                  f"{float(occs.min()):.3g}", flush=True)
    print(f"{label}: {time.time() - t0:.1f} s, mean loss of the first 20 steps "
          f"{statistics.mean(losses[:20]):.5f}, of the last 20 "
          f"{statistics.mean(losses[-20:]):.5f} ({cs.card()})", flush=True)


def main():
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.cuda.load()
    run(dev, "opaque, 200 steps", 200)
    run(dev, "opaque, 1000 steps", 1000)
    run(dev, "opaque, lr 1e-3", 1000, lr=1e-3)
    run(dev, "opaque, 24 views", 1000, views=(24, 320))
    run(dev, "translucent, 1000 steps", 1000, scene="translucent")


if __name__ == "__main__":
    main()
