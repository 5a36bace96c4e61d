#!/usr/bin/env python3
"""Profile one 320x320 frame of the PyTorch port's serving path, or one
train step, on one GPU.

Run from the root of a checkout:

    python3 scripts/profile_torch_eval.py [--view 0] [--out build/profile]
    python3 scripts/profile_torch_eval.py --train [--warmup 1000]

Serving (the default) sets up the slice as ``chip_smoke.py`` does
(full-width ``CPRadianceField`` 32/128/512 x rank 32 in bf16, parameters
from seed 42, four dense refreshes of the 128^3 grid), times a dense refresh
and three renders of one test view on the host clock, then renders the view
once more under ``torch.profiler``.  ``--train`` sets up the train slice of
``chip_smoke.py``'s phase 4 (6 views at 256x256, 2048 rays, a 2^18-sample
budget), runs ``--warmup`` steps so that the grid is no longer the untrained
one, times three steps and profiles one more (none of them refreshes the
grid; the refresh is timed on its own).  It prints:

- the device busy share: the union of all kernel and memcpy intervals over
  the profiled frame's or step's wall time;
- each kernel class's share of device time (the port's kernels G1-G5, the
  MLP GEMMs, concatenation, Adam, other PyTorch kernels);
- the PyTorch ops with the most self device time.

The Chrome trace goes to ``<out>/profile_torch_{eval,train}_trace.json``.
Imports torch and the port only.
"""
import argparse
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from nerfacc_tpu_torch import cuda  # noqa: E402
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader  # noqa: E402
from nerfacc_tpu_torch.models.cp_field import CPRadianceField  # noqa: E402
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer  # noqa: E402

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
N_REFRESH = 4

TRAIN_RAYS = 2048
TRAIN_BUDGET = 2**18

# kernel-name substring -> class, first match wins
CLASSES = (
    ("cp_level_fwd_kernel", "G1 cp_level"),
    ("march_count_kernel", "G2 march count"),
    ("march_fill_kernel", "G2 march fill"),
    ("composite_fwd_kernel", "G3 composite"),
    ("cp_level_bwd_kernel", "G4 cp_level backward"),
    ("composite_bwd_kernel", "G5 composite backward"),
    ("gemm", "GEMM (MLPs)"),
    ("multi_tensor_apply", "Adam (foreach)"),
    ("CatArrayBatchedCopy", "cat"),
    ("Memcpy", "memcpy"),
    ("Memset", "memset"),
)


def kernel_class(name):
    for key, cls in CLASSES:
        if key.lower() in name.lower():
            return cls
    return "other PyTorch kernels"


def union_length(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def self_device_us(evt):
    value = getattr(evt, "self_device_time_total", None)
    return value if value is not None else evt.self_cuda_time_total


def eval_target(dev, view):
    """The serving slice; returns the profiled call and its label."""
    ds = ProceduralSceneLoader(split="test", device=dev)
    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, compute_dtype=torch.bfloat16),
        aabb=AABB, device=dev,
    )
    state = trainer.init_state()
    for step in range(N_REFRESH):
        state = trainer.refresh_occ_grid(state, step)
    time_refresh(trainer, state, N_REFRESH)
    data = ds[view]

    def run():
        return f"{trainer.render_rays(state, data)[3]} samples"

    return run, f"view {view}", "eval"


def train_target(dev, warmup):
    """The train slice after ``warmup`` steps; the profiled call is one
    train step that does not refresh the grid."""
    ds = ProceduralSceneLoader(
        split="train", n_train=6, width=256, height=256, num_rays=TRAIN_RAYS,
        device=dev,
    )
    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, compute_dtype=torch.bfloat16), aabb=AABB,
        max_steps=warmup + 8, sample_budget=TRAIN_BUDGET, device=dev,
    )
    state = trainer.init_state()
    for _ in range(warmup):
        state, _ = trainer.train_step(state, ds[0])
    time_refresh(trainer, state, state.step)
    batches = [ds[0] for _ in range(8)]
    holder = {"state": state}

    def run():
        st = holder["state"]
        if st.step % trainer.update_interval == 0:  # keep the refresh out
            st = st._replace(step=st.step + 1)
        st, aux = trainer.train_step(st, batches[st.step % len(batches)])
        holder["state"] = st
        return (f"{aux['n_rendering_samples']} samples of "
                f"{aux['n_total_samples']}, loss {float(aux['loss']):.5f}")

    return run, "train step", "train"


def time_refresh(trainer, state, step):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.refresh_occ_grid(state, step)
    torch.cuda.synchronize()
    occupied = float(state.occ_state.binaries.float().mean())
    print(f"dense refresh of the {trainer.grid_resolution}^3 grid: "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms wall; occupied share "
          f"{occupied:.4f}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--view", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="profile a train step instead of a frame")
    ap.add_argument("--warmup", type=int, default=1000,
                    help="train steps before the profiled one (--train)")
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_eval: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    cuda.load()
    if args.train:
        run, label, kind = train_target(dev, args.warmup)
    else:
        run, label, kind = eval_target(dev, args.view)
    for _ in range(3):
        t0 = time.perf_counter()
        what = run()
        torch.cuda.synchronize()
        print(f"{label}: {time.perf_counter() - t0:.4f} s wall, {what}")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    device_events = [
        e for e in prof.events() if e.device_type == DeviceType.CUDA
    ]
    busy_us = union_length(
        [(e.time_range.start, e.time_range.end) for e in device_events]
    )
    print(f"profiled {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%)")

    by_class, count = {}, {}
    for e in device_events:
        cls = kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + (e.time_range.end - e.time_range.start)
        count[cls] = count.get(cls, 0) + 1
    total = sum(by_class.values())
    print(f"device time by kernel class (total {total / 1e3:.3f} ms):")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {100 * us / total:5.1f}%  {us / 1e3:8.3f} ms  "
              f"{count[cls]:5d} launches  {cls}")

    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    ops.sort(key=self_device_us, reverse=True)
    print("ops with the most self device time:")
    for e in ops[:10]:
        us = self_device_us(e)
        print(f"  {100 * us / total:5.1f}%  {us / 1e3:8.3f} ms  "
              f"{e.count:5d} calls  {e.key}")

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"profile_torch_{kind}_trace.json")
    prof.export_chrome_trace(path)
    print(f"trace: {path}")


if __name__ == "__main__":
    main()
