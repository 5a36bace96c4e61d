#!/usr/bin/env python3
"""Time kernels G2 (march) and G9 (hat table gradient) of one tree of the
PyTorch port on one GPU, at the shapes of the train steps and the eval chunk.

Run from the root of a checkout:

    python3 scripts/time_march_hat.py [--root DIR] [--label NAME] [--out build/time_march_hat]

``--root`` names the tree whose ``nerfacc_tpu_torch`` is imported and built
(default: this checkout), so that two designs are compared on one card in
one call, e.g. with an older commit unpacked by ``git archive`` into a
git-ignored directory:

    python3 scripts/time_march_hat.py --root build/parent --label parent
    python3 scripts/time_march_hat.py --label change

G2 runs on the full-width ``CPRadianceField`` trainer's grid after four
dense refreshes (parameters from seed 42, ``chip_smoke.py``'s phase 1): the
middle 8192 rays of test view 0 (the eval chunk) with near plane 0, and a
2048-ray train batch (6 views at 256x256) with the trainer's stratified near
planes ``0 + jitter * step``; it prints each call's sample count, the rays
whose count differs from the twin (on the refreshed grid and on that grid
with half its cells cleared), the CUDA-event time of one call, and the
device time of its kernels alone from ``torch.profiler``.  G9 runs at each of
TiNeuVox's levels (R, rank) = (32, 16), (128, 16), (512, 32) at N = 2^16
(the TiNeuVox train step's budget) and N = 2^18 on coordinates uniform in
[0, 1] and a seeded cotangent: error against the plain version, whether two
calls give the same bits, the kernel's and ``index_add_``'s (on the
precomputed taps and updates: the scatter stage alone) times, both ways.
Each result is one JSON line; all go to ``<out>/time_march_hat_<label>.json``.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
HAT_LEVELS = ((32, 16), (128, 16), (512, 32))


def cuda_ms(fn, reps=20):
    """Median milliseconds of one call by CUDA events (host path included)."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps=20):
    """Mean device time of the kernels of one call, from torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start
             for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3


def refreshed_cp_grid(dev):
    """The full-width CP trainer's occupancy state after four dense
    refreshes, and its render step."""
    from nerfacc_tpu_torch.models.cp_field import CPRadianceField
    from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer

    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, compute_dtype=torch.bfloat16), aabb=AABB, device=dev
    )
    state = trainer.init_state()
    for step in range(4):
        state = trainer.refresh_occ_grid(state, step)
    return state.occ_state, trainer.render_step_size


def march_rows(dev):
    from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
    from nerfacc_tpu_torch.grid import march, march_plain

    occ, step = refreshed_cp_grid(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    cleared = occ.binaries & (torch.rand(occ.binaries.shape, generator=g, device=dev) < 0.5)

    test = ProceduralSceneLoader(split="test", device=dev)[0]
    n = test["rays_o"].shape[0]
    mid = slice(n // 2 - 4096, n // 2 + 4096)
    train = ProceduralSceneLoader(split="train", n_train=6, width=256, height=256,
                                  num_rays=2048, device=dev)[0]
    jitter = torch.rand(2048, generator=g, device=dev)
    cases = {
        "8192-ray eval chunk, near 0": (
            test["rays_o"][mid].contiguous(), test["rays_d"][mid].contiguous(),
            torch.zeros(8192, device=dev)),
        "2048-ray train batch, near 0 + jitter * step": (
            train["rays_o"].contiguous(), train["rays_d"].contiguous(),
            (0.0 + jitter * step).contiguous()),
    }
    rows = []
    for name, (o, d, near) in cases.items():
        far = torch.full_like(near, 1e10)
        differ = {}
        for grid_name, binaries in (("refreshed", occ.binaries), ("half-cleared", cleared)):
            args = (o, d, binaries, occ.aabbs, near, far, step)
            out, ref = march(*args), march_plain(*args)
            differ[grid_name] = int((out.counts != ref.counts).sum())
            if grid_name == "refreshed":
                samples = out.ray_indices.shape[0]
                same = all(torch.equal(a, b) for a, b in zip(out, ref))
        args = (o, d, occ.binaries, occ.aabbs, near, far, step)
        rows.append({
            "kernel": "G2 march", "case": name, "rays": o.shape[0], "samples": samples,
            "rays_differ_from_twin": differ, "bitwise_equal_to_twin": same,
            "ms": cuda_ms(lambda: march(*args)),
            "device_ms": device_ms(lambda: march(*args)),
        })
    return rows


def hat_rows(dev):
    from nerfacc_tpu_torch.ops.hat_matmul import hat_bwd_line, hat_bwd_line_plain, hat_taps

    g = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for n in (2**16, 2**18):
        for R, rank in HAT_LEVELS:
            x = torch.rand(n, generator=g, device=dev)
            cot = torch.randn((n, rank), generator=g, device=dev)
            out = hat_bwd_line(x, cot, R)
            ref = hat_bwd_line_plain(x, cot, R)
            i0, i1, w0, w1, _, _ = hat_taps(x, R)
            taps = torch.stack([i0, i1], dim=1).reshape(-1)
            cot_b = cot.to(torch.bfloat16).to(torch.float32)
            upd = (torch.stack([w0, w1], dim=1)[:, :, None] * cot_b[:, None, :]).reshape(-1, rank)
            acc = torch.zeros((R, rank), device=dev)
            rows.append({
                "kernel": "G9 hat_bwd_line", "N": n, "R": R, "rank": rank,
                "err_of_max": float((out - ref).abs().max() / ref.abs().max()),
                "same_bits_twice": bool(torch.equal(
                    out.view(torch.int32), hat_bwd_line(x, cot, R).view(torch.int32))),
                "ms": cuda_ms(lambda: hat_bwd_line(x, cot, R)),
                "device_ms": device_ms(lambda: hat_bwd_line(x, cot, R)),
                "index_add_ms": cuda_ms(lambda: acc.index_add_(0, taps, upd)),
                "index_add_device_ms": device_ms(lambda: acc.index_add_(0, taps, upd)),
                # x and g read once, the table written once
                "bound_ms": 1e3 * (4 * n * (1 + rank) + 4 * R * rank) / 3.35e12,
            })
    return rows


def timing_main(name, doc, rows_of):
    """Parse ``--root``/``--label``/``--out``, import the port from ``--root``,
    print the card and each row of ``rows_of(dev)`` as one JSON line, and
    append them all to ``<out>/<name>_<label>.json``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default=f"build/{name}")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import nerfacc_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    head = {"label": args.label, "package": os.path.dirname(nerfacc_tpu_torch.__file__),
            "card": smi}
    print(json.dumps(head))
    rows = []
    for row in rows_of(dev):
        print(json.dumps({"label": args.label, **row}), flush=True)
        rows.append(row)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{name}_{args.label}.json"), "a") as f:
        f.write(json.dumps({**head, "rows": rows}) + "\n")


if __name__ == "__main__":
    timing_main("time_march_hat", __doc__, lambda dev: march_rows(dev) + hat_rows(dev))
