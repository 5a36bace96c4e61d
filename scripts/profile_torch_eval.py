#!/usr/bin/env python3
"""Profile one 320x320 frame of the PyTorch port's serving path, or one
train step, on one GPU.

Run from the root of a checkout:

    python3 scripts/profile_torch_eval.py [--view 0] [--out build/profile]
    python3 scripts/profile_torch_eval.py --train [--warmup 1000]
    python3 scripts/profile_torch_eval.py --field ngp [--train]
    python3 scripts/profile_torch_eval.py --field tineuvox [--train]
    python3 scripts/profile_torch_eval.py --field prop [--train]
    python3 scripts/profile_torch_eval.py --field tnerf|kplanes [--train]
    python3 scripts/profile_torch_eval.py --field tensorf|voxel|cp-planes|barf --train
    python3 scripts/profile_torch_eval.py --renderer eval [--field ngp]

Serving (the default) sets up the slice as ``chip_smoke.py`` does
(``--field cp``: the full-width ``CPRadianceField`` 32/128/512 x rank 32;
``--field ngp``: the full-width hash-grid ``NGPRadianceField``, 16 levels x
2 features, 2^19 rows per level; ``--field tineuvox``: the full-width
``TiNeuVoxRadianceField`` on the moving-blob scene, each view at its own
time; all bf16, parameters from seed 42, four dense refreshes of the 128^3
grid; ``--field prop``: the proposal-network path of phase 15, the CP field
behind one ``CPDensityField``, 128 proposal and 64 final samples per ray, no
grid; ``--field tnerf`` / ``kplanes``: the dynamic example's full-width
field, built by its own ``build`` on the moving-blob scene), times a dense
refresh and three renders of one test view on the host
clock, then renders the view once more under ``torch.profiler``.  An
occupancy-grid field renders through the exact renderer (``render_rays``,
``--renderer exact``, the default) or the early-stopping eval renderer
(``render_view``, ``--renderer eval``).
``--train`` sets up the train slice of ``chip_smoke.py``'s phase 4 (6 views
at 256x256, 2048 rays, a 2^18-sample budget; for TiNeuVox phase 12's: 24
views at 320x320, 1024 rays, a 2^16-sample budget and the dynamic example's
optimiser; for ``prop`` phase 16's: 4096 rays drawn on the card by
``DeviceRaySampler``, the proposal-gradient schedule; for ``tnerf`` and
``kplanes`` phase 23's: the example's loader batches, a 2^16 budget and
its controller, applied every 8 steps; for ``tensorf``, ``voxel`` and
``cp-planes`` phase 25's: the occupancy example's field built by its own
``build``, loader batches and its controller; for ``barf`` phase 26's: the
BARF example's pixel batches), runs ``--warmup``
steps so that the grid is no longer the untrained one, times three steps and
profiles one more (none of them refreshes the grid; the refresh is timed on
its own; the proposal path's timed and profiled steps all train the
proposal field, its heavier kind of step).  It prints:

- the device busy share: the union of all kernel and memcpy intervals over
  the profiled frame's or step's wall time;
- each kernel class's share of device time (the port's kernels G1-G14, the
  MLP GEMMs, concatenation, Adam, the indexing gathers and their
  accumulating backward with its sort, K-Planes' plane lookup, other
  PyTorch kernels);
- the PyTorch ops with the most self device time;
- the host syncs: calls of ``aten::_local_scalar_dense``, each a read of a
  device value on the host.

The Chrome trace goes to ``<out>/profile_torch_<field>_{eval,eval_early_stop,train}_trace.json``.
Imports torch, the port and chip_smoke.py's settings.
"""
import argparse
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (  # noqa: E402
    MLP_CALL,
    N_REFRESH,
    OCC_FIELD_PATHS,
    PROP_RAYS,
    TRAIN,
    barf_example,
    make_prop_trainer,
    make_trainer,
    mlp_example,
    occ_field_example,
    train_loader,
)
from nerfacc_tpu_torch import cuda  # noqa: E402
from nerfacc_tpu_torch.data.device_sampler import DeviceRaySampler  # noqa: E402
from nerfacc_tpu_torch.estimators.prop_net import get_proposal_requires_grad_fn  # noqa: E402
from nerfacc_tpu_torch.data.procedural import (  # noqa: E402
    ProceduralDynamicSceneLoader,
    ProceduralSceneLoader,
)

# kernel-name substring -> class, first match wins
CLASSES = (
    ("cp_level_fwd_kernel", "G1 cp_level"),
    ("march_count_kernel", "G2 march count"),
    ("march_fill_kernel", "G2 march fill"),
    ("composite_fwd_kernel", "G3 composite"),
    ("cp_level_bwd_kernel", "G4 cp_level backward"),
    ("composite_bwd_kernel", "G5 composite backward"),
    ("hash_fwd_kernel", "G6 hash encode"),
    ("hash_bwd_kernel", "G7 hash encode backward"),
    ("hat_fwd_kernel", "G8 hat interp"),
    ("hat_bwd_line_kernel", "G9 hat interp table gradient"),
    ("hat_bwd_line_reduce_kernel", "G9 hat interp table gradient"),  # its second launch
    ("hat_bwd_x_kernel", "G10 hat interp coordinate gradient"),
    ("importance_sampling_kernel", "G14 importance sampling"),
    ("gemm", "GEMM (MLPs)"),
    ("multi_tensor_apply", "Adam (foreach)"),
    ("CatArrayBatchedCopy", "cat"),
    ("indexing_backward_kernel", "index_put_ accumulate (gather backward)"),
    ("indexFunc", "index_add_ (scatter)"),
    ("RadixSort", "sort (gather backward)"),
    ("index_elementwise_kernel", "indexing gather"),
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


MLP_FIELDS = ("tnerf", "kplanes")


def eval_target(dev, field, view, renderer="exact"):
    """The serving slice; returns the profiled call and its label."""
    if field == "prop":
        trainer = make_prop_trainer(dev)
        state = trainer.init_state()
        data = ProceduralSceneLoader(split="test", device=dev)[view]

        def run_prop():
            trainer.render_rays(state, data)
            return f"{trainer.prop_samples[0]} + {trainer.num_samples} samples per ray"

        return run_prop, f"view {view}", "eval"
    if field in MLP_FIELDS:
        ex, args = mlp_example(field, 8)
        trainer, _, ds = ex.build(args)
    elif field == "tineuvox":
        ds = ProceduralDynamicSceneLoader(split="test", device=dev)
        trainer = make_trainer(dev, field, timestamps=train_loader(dev, field).timestamps)
    else:
        ds = ProceduralSceneLoader(split="test", device=dev)
        trainer = make_trainer(dev, field)
    state = trainer.init_state()
    for step in range(N_REFRESH):
        state = trainer.refresh_occ_grid(state, step)
    time_refresh(trainer, state, N_REFRESH)
    data = ds[view]

    render = trainer.render_view if renderer == "eval" else trainer.render_rays

    def run():
        return f"{render(state, data)[3]} samples"

    return run, f"view {view} ({renderer} renderer)", "eval"


def prop_train_target(dev, warmup):
    """Phase 16's proposal training after ``warmup`` steps on the
    proposal-gradient schedule; the profiled call is one step that trains
    the proposal field."""
    ds = ProceduralSceneLoader(split="train", n_train=6, width=256, height=256,
                               num_rays=PROP_RAYS, device=dev)
    sampler = DeviceRaySampler.from_loader(ds)
    trainer = make_prop_trainer(dev, max_steps=warmup + 8)
    rg_fn = get_proposal_requires_grad_fn()
    state, _ = trainer.train_steps_sampled(
        trainer.init_state(), sampler, [rg_fn(s) for s in range(warmup)])
    holder = {"state": state}

    def run():
        st, aux = trainer.train_steps_sampled(holder["state"], sampler, [True])
        holder["state"] = st
        return f"loss {float(aux['loss'][0]):.5f}, prop loss {float(aux['prop_loss'][0]):.5f}"

    return run, "train step", "train"


def mlp_train_target(dev, field, warmup):
    """Phase 23's (23b's, 25's) training after ``warmup`` steps of loader
    batches, the ray count set by the example's controller every
    ``MLP_CALL`` steps; the profiled call is one step at the last ray
    count."""
    if field in OCC_FIELD_PATHS:
        ex, args = occ_field_example(field, warmup + MLP_CALL)
    else:
        ex, args = mlp_example(field, warmup + MLP_CALL)
    trainer, ds, _ = ex.build(args)
    state = trainer.init_state()
    for i in range(warmup):
        state, aux = trainer.train_step(state, ds[0])
        if i % MLP_CALL == MLP_CALL - 1:
            ds.update_num_rays(ex.next_num_rays(ds.num_rays, int(aux["n_total_samples"]),
                                                trainer.sample_budget))
    print(f"{field}: {ds.num_rays} rays a step after {warmup} steps")
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


def barf_train_target(dev, warmup):
    """Phase 26's BARF training after ``warmup`` steps of pixel batches; the
    profiled call is one step that does not refresh the grid."""
    ex, args = barf_example(warmup + MLP_CALL)
    trainer, ds, _ = ex.build(args)
    state = trainer.init_state()
    for _ in range(warmup):
        state, _ = trainer.train_step(state, ds.pixel_batch(0))
    print(f"barf: pose error after {warmup} steps "
          f"{ex.pose_registration_errors(trainer.refined_poses(state), ds.camtoworlds)}")
    batches = [ds.pixel_batch(0) for _ in range(8)]
    holder = {"state": state}

    def run():
        st = holder["state"]
        if st.step % trainer.update_interval == 0:  # keep the refresh out
            st = st._replace(step=st.step + 1)
        st, aux = trainer.train_step(st, batches[st.step % len(batches)])
        holder["state"] = st
        return f"{aux['n_total_samples']} samples, loss {float(aux['loss']):.5f}"

    return run, "train step", "train"


def train_target(dev, field, warmup):
    """The train slice after ``warmup`` steps; the profiled call is one
    train step that does not refresh the grid."""
    if field == "prop":
        return prop_train_target(dev, warmup)
    if field == "barf":
        return barf_train_target(dev, warmup)
    if field in MLP_FIELDS or field in OCC_FIELD_PATHS:
        return mlp_train_target(dev, field, warmup)
    ds = train_loader(dev, field)
    trainer = make_trainer(
        dev, field, timestamps=getattr(ds, "timestamps", None), max_steps=warmup + 8,
        sample_budget=TRAIN[field][2],
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
    ap.add_argument("--field", choices=sorted(TRAIN) + ["prop", *MLP_FIELDS, *OCC_FIELD_PATHS,
                                                        "barf"], default="cp",
                    help="the radiance field: CP lines, the hash grid, TiNeuVox, T-NeRF "
                         "or K-Planes behind the occupancy grid, or the proposal-network "
                         "path; with --train also the occupancy example's tensorf, voxel "
                         "and cp-planes fields and the BARF example")
    ap.add_argument("--train", action="store_true",
                    help="profile a train step instead of a frame")
    ap.add_argument("--warmup", type=int, default=1000,
                    help="train steps before the profiled one (--train)")
    ap.add_argument("--renderer", choices=["exact", "eval"], default="exact",
                    help="an occupancy-grid field's renderer: render_rays or render_view")
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args()
    if not args.train and (args.field in OCC_FIELD_PATHS or args.field == "barf"):
        raise SystemExit(f"profile_torch_eval: --field {args.field} profiles --train only")
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_eval: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    cuda.load()
    if args.train:
        run, label, kind = train_target(dev, args.field, args.warmup)
    else:
        run, label, kind = eval_target(dev, args.field, args.view, args.renderer)
    print(f"field: {args.field}")
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

    syncs = sum(e.count for e in prof.key_averages() if e.key == "aten::_local_scalar_dense")
    print(f"host syncs (aten::_local_scalar_dense calls): {syncs}")

    os.makedirs(args.out, exist_ok=True)
    if kind == "eval" and args.renderer == "eval":
        kind = "eval_early_stop"
    path = os.path.join(args.out, f"profile_torch_{args.field}_{kind}_trace.json")
    prof.export_chrome_trace(path)
    print(f"trace: {path}")


if __name__ == "__main__":
    main()
