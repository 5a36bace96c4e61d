#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU,
and check them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``nerfacc_tpu_torch/csrc`` and runs:

1. each forward kernel (G1 CP level, G2 march, G3 composite) against its
   PyTorch twin on the card at the slice's shapes, timed with CUDA events
   (G2 and G3 also on a 2048-ray train batch at the trainer's near planes,
   G3 on that batch cut at the 2^18 budget, and alone by
   ``torch.profiler``); G1 bitwise, at every level of the CP field on
   uniform coordinates and on that cut batch's sample midpoints, and at
   every level of ``CPDensityField`` on the proposal field's points;
   1b. the backward kernels (G4 CP level, G5 composite) likewise, and at
   the train steps' shapes: G5 on the CP train buffer (that batch cut at the
   2^18 budget), G4 on the proposal field's coordinates in ray order (4096
   rays x 128 samples, (R, rank) = (16, 16), both compute dtypes);
   1c. the hash-encode kernels (G6 forward, G7 table gradient) at the NGP
   field's full width (2^18 points, 16 levels, 2^19 rows per level), with
   ``F.embedding_bag`` and ``index_add_`` timed on the precomputed corner
   rows as the library's gather and scatter stages, and G7 again on the NGP
   train step's sample positions in ray order;
2. the serving slice: ``NGPOccTrainer`` with the full-width
   ``CPRadianceField`` (resolutions 32/128/512, rank 32, bf16), parameters
   from seed 42, four dense refreshes of the 128^3 occupancy grid, then
   ``eval_metrics`` over the procedural scene's four 320x320 test views; the
   kernels' launch counts over this phase must all be positive;
3. view 0 rendered again through the twins alone, against phase 2's image;
4. the training slice: ``train_step`` on the train split (6 views at
   256x256, 2048 rays, a 2^18-sample budget, stratified, a dense refresh
   every 16 steps) for ``TRAIN_STEPS`` steps; the loss must halve and all
   five kernels' launch counts over this phase must be positive;
5. one train step through the kernels against the same step through the
   plain twins, from phase 4's state with the same batch and jitter, for
   the bf16 field and for an f32 field on the same parameters;
6. ``eval_metrics`` on phase 4's trained field, which must beat phase 2's
   untrained PSNR by 3 dB;
7. phase 2 with the full-width hash-grid ``NGPRadianceField`` (16 levels x
   2 features, 2^19 rows per level, resolutions 16..4096, bf16 MLPs);
8. phase 4 with that field;
9. phase 5 with that field;
10. phase 6 with that field, against phase 7's PSNR;
11. phase 2 with the full-width TiNeuVox dynamic field (CP lines 32/128/512
    x ranks 16/16/32 through the hat kernels G8-G10, the deformation MLP,
    bf16 MLPs) on the moving-blob scene, each test view at its own time, the
    refresh drawing one training frame time per cell;
12. phase 4 with that field, at the dynamic example's settings (24 views at
    320x320, 1024 rays, a 2^16-sample budget, lr 1e-2, Adam eps 1e-15, no
    weight decay, TV weight 1e-4); G8, G9 and G10 must launch;
13. phase 5 with that field, the deformation leaves included;
14. phase 6 with that field, against phase 11's PSNR;
15. the proposal-network path served: ``NGPPropTrainer.eval_metrics`` with
    the full-width ``CPRadianceField`` and one ``CPDensityField`` (16/64 x
    rank 16, hidden 64, bf16), parameters from seed 42, 128 proposal and 64
    final samples per ray, on the four test views; G1, G3 and G14 must
    launch;
16. that path trained at ``bench.py``'s proposal configuration (4096 rays, 6
    views at 256x256, batches drawn on the card by ``DeviceRaySampler``, the
    proposal-gradient schedule, no weight decay) through
    ``train_steps_sampled`` for ``TRAIN_STEPS`` steps; the reconstruction
    loss must halve and G1, G3, G4, G5 and G14 must launch;
17. one proposal train step with ``requires_grad`` through the kernels
    against the same step through the plain versions (phase 5's bounds),
    the proposal field's leaves included;
18. phase 15 on phase 16's trained fields, against phase 15's PSNR.

Phase 1d holds the hat kernels G8 (forward), G9 (table gradient) and G10
(coordinate gradient) against their plain versions at N = 2^18 on each of
TiNeuVox's levels (R = 32, 128, 512), with 1% of the coordinates outside
[0, 1] and some on grid points, timed at R = 512, rank 32, with
``F.embedding_bag`` and ``index_add_`` timed on the precomputed taps as the
library's gather and scatter stages; G9 must give the same bits in two calls;
G9 and G10 are also timed at each level at the TiNeuVox train step's 2^16
samples.
Phase 13 also runs the f32 TiNeuVox plain step against itself, and the
kernel step with the composite (G3, G5) on its plain versions and PyTorch's
scatter-adds in a fixed order, so that the hat kernels see the plain step's
cotangents bit for bit.

Phase 1e is the gather probe: G11 (the coarse-occupancy lookup, N = 2^18
into a (256, 1024) summary), G13 (the row gather of
scripts/pallas_gather_probe.py, 2^18 rows of a (2^14, 128) and a (2^14, 2)
table) and G12 (the per-lane gather of scripts/pallas_gather_probe2.py, 64
blocks of T rows at T = 512, 2^14 and 2^16, and its 16-level NGP-shaped
lookup), each run once through its entry point with the launch counts
zeroed before, then held bitwise against its plain version and timed beside
the one PyTorch call that computes the same function.  Phase 1f holds G14
(importance sampling) bitwise against its plain version at the proposal
path's shapes.

Every check raises on failure, so the exit code is nonzero and the result
line is not printed.  The last line of standard output is a JSON object with
``"ok": true`` and the device; the line before it lists each kernel's launch
count (over the four training phases 4, 8, 12 and 16; for G11-G13, over the
gather probe's run), error, times and bound.  Without a CUDA device the
script fails at once.
"""
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nerfacc_tpu_torch import cuda  # noqa: E402
from nerfacc_tpu_torch.cuda import _build  # noqa: E402
from nerfacc_tpu_torch.data.procedural import (  # noqa: E402
    ProceduralDynamicSceneLoader,
    ProceduralSceneLoader,
)
from nerfacc_tpu_torch import pdf  # noqa: E402
from nerfacc_tpu_torch.data.device_sampler import DeviceRaySampler  # noqa: E402
from nerfacc_tpu_torch.estimators.prop_net import (  # noqa: E402
    get_proposal_requires_grad_fn,
)
from nerfacc_tpu_torch.grid import march, march_plain  # noqa: E402
from nerfacc_tpu_torch.models.cp_field import CPDensityField, CPRadianceField  # noqa: E402
from nerfacc_tpu_torch.models.encoders import HashGridEncoder  # noqa: E402
from nerfacc_tpu_torch.models.ngp import NGPRadianceField, normalize_points  # noqa: E402
from nerfacc_tpu_torch.models.tineuvox import TiNeuVoxRadianceField  # noqa: E402
from nerfacc_tpu_torch.ops import cp_level as cp_level_ops  # noqa: E402
from nerfacc_tpu_torch.ops.coarse_occ import (  # noqa: E402
    coarse_occ_lookup,
    coarse_occ_lookup_plain,
)
from nerfacc_tpu_torch.ops.cp_level import (  # noqa: E402
    cp_level_backward,
    cp_level_backward_plain,
    cp_level_encode,
    cp_level_encode_plain,
)
from nerfacc_tpu_torch.ops.hash_encode import (  # noqa: E402
    hash_corners_plain,
    hash_encode_backward,
    hash_encode_backward_plain,
    hash_encode_forward,
    hash_encode_plain,
)
from nerfacc_tpu_torch.ops.hat_matmul import (  # noqa: E402
    hat_bwd_line,
    hat_bwd_line_plain,
    hat_bwd_x,
    hat_bwd_x_plain,
    hat_fwd,
    hat_interp_matmul_plain,
    hat_taps,
)
from nerfacc_tpu_torch.ops import sorted_segments  # noqa: E402
from nerfacc_tpu_torch.ops.lane_gather import lane_gather, lane_gather_plain  # noqa: E402
from nerfacc_tpu_torch.ops.row_gather import row_gather, row_gather_plain  # noqa: E402
from nerfacc_tpu_torch.ops.sorted_segments import (  # noqa: E402
    composite_sorted,
    composite_sorted_backward,
    composite_sorted_backward_plain,
    composite_sorted_plain,
)
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer, TrainState  # noqa: E402
from nerfacc_tpu_torch.trainers.ngp_prop import NGPPropTrainer, PropTrainState  # noqa: E402
from nerfacc_tpu_torch.utils import flops  # noqa: E402
from nerfacc_tpu_torch.utils.rendering import compact_samples  # noqa: E402

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
N_REFRESH = 4
G1_N = 2**18
HASH_N = 2**18  # phase 1c: the train step's sample budget
HASH_OUTSIDE = 0.01  # share of phase 1c's points outside [0, 1]^3
HAT_N = 2**18  # phase 1d: the train step's sample budget at most
HAT_LEVELS = ((32, 16), (128, 16), (512, 32))  # TiNeuVox's (R, rank); timed at the last
HAT_OUTSIDE = 0.01  # share of phase 1d's coordinates outside [0, 1]
HAT_ON_GRID = 4096  # phase 1d's coordinates on grid points
G2_RAYS = 8192
G2_TRAIN_RAYS = 2048  # phase 1: a CP train batch, at the trainer's near planes
FLIP_ALLOWANCE = 1e-3  # share of rays whose sample count may differ
# Rays whose count differed from the twin under the earlier design of G2
# (one thread per ray, walking from the near plane): 0 on both grids in every
# earlier chip_smoke.py run and in scripts/time_kernels.py's G2 rows on that
# tree (PERF.md §6).  The warp-per-ray design evaluates the same rounded
# operations per candidate, so it may differ on no more rays.
PARENT_G2_RAYS_DIFFER = 0
HAT_TRAIN_N = 2**16  # phase 1d: the TiNeuVox train step's sample budget
TRAIN_STEPS = 1000  # not a multiple of the refresh interval: phase 5's step
# Phase 5: each gradient leaf of a kernel step against the twin step, by
# relative Frobenius norm, worst of STEP_REPEATS runs.  f32: only the order of
# the atomic sums differs (readings up to 2.5e-5 on an H100, PERF.md §6).
# bf16: the field rounds each MLP weight gradient to bf16 last, so order-only
# differences of ~1e-5 flip a few entries by one bf16 ulp, which is at most
# 2^-7 of the entry: a leaf reads below 2^-7 = 7.8e-3 even if every entry
# flipped, and read 1.3e-4 to 8.5e-4 on an H100.  Lost bf16 roundings read
# >= 2.2e-2 (the twins' f32 field against their bf16 field, printed), a
# detached gradient ~1.  The kernels' own roundings are held elementwise in
# phase 1b.
# An f32 TiNeuVox field is not f32 throughout: its hat kernels round the
# cotangent g to bf16 (the TPU kernels' contract), so last-bit differences
# upstream (G3 and G5 against their plain versions, and index_add_'s atomic
# order inside those) flip a few of those roundings and move the
# deformation leaves, whose only signal is G10's: the plain step against
# itself reads up to 3.8e-5, the kernel step up to 1.3e-4 on an H100
# (PERF.md §6), hence F32_HAT_STEP_FRO.  With the composite on its plain
# versions and fixed-order scatter-adds the hat kernels see the plain
# step's cotangents bit for bit, and that step read 1.6e-7 (G9's summation
# order and G10's rank sums): HAT_ALONE_STEP_FRO.
STEP_REPEATS = 8
F32_STEP_FRO = 1e-4
F32_HAT_STEP_FRO = 5e-4
HAT_ALONE_STEP_FRO = 1e-5
BF16_STEP_FRO = 5e-3
# Phase 1e: the gather probe's shapes (scripts/pallas_gather_probe.py and
# pallas_gather_probe2.py): K5's summary and lookups, P1's table and index
# count, P2's table heights with 64 blocks of T rows each, and its NGP-shaped
# lookup (16 levels of at most 2^16 rows packed into 128 lanes, 2^18 rows).
COARSE_SUMMARY = (256, 1024)
COARSE_N = 2**18
ROW_TABLE, ROW_N = 2**14, 2**18
LANE_HEIGHTS = (512, 2**14, 2**16)
LANE_BLOCKS = 64
NGP_T, NGP_N = 2**16, 2**18
GATHER_OUTSIDE = 0.01  # share of the checked indices outside the table
# Phases 15-18: the proposal path at bench.py's bench_prop configuration
PROP_RAYS = 4096
PROP_SAMPLES, PROP_FINAL = 128, 64
PROP_EVAL_RAYS = 8192  # render_image's chunk


# The least time the card could take for a kernel's work: the bytes the
# function must move over the H100's memory rate, or
# its f32 operations over the f32 peak outside the tensor cores, whichever
# is larger.  Operations are counted from the kernel's arithmetic per item
# (a fused multiply-add counts two), a lower count of the work.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# field kind -> full-width field in a compute dtype
FIELDS = {
    "cp": lambda dtype: CPRadianceField(AABB, compute_dtype=dtype),
    "ngp": lambda dtype: NGPRadianceField(AABB, compute_dtype=dtype),
    "tineuvox": lambda dtype: TiNeuVoxRadianceField(AABB, compute_dtype=dtype),
}
# field kind -> its encoder's kernels, forward then backward
ENCODER_KERNELS = {
    "cp": ("cp_level_fwd", "cp_level_bwd"),
    "ngp": ("hash_fwd", "hash_bwd"),
    "tineuvox": ("hat_fwd", "hat_bwd_line", "hat_bwd_x"),
}
# field kind -> (trainer settings beside the defaults, rays per train step,
# sample budget): the bench configuration, and for TiNeuVox the dynamic
# example's (examples/train_mlp_tnerf.py --field tineuvox; its lr 1e-2,
# Adam eps 1e-15 and warmup are the trainer's)
TRAIN = {
    "cp": ({}, 2048, 2**18),
    "ngp": ({}, 2048, 2**18),
    "tineuvox": (dict(weight_decay=0.0, field_reg_weight=1e-4), 1024, 2**16),
}


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps=10):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
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


def device_ms(fn, reps=10):
    """Mean device time of ``fn`` per call, in milliseconds: the kernels it
    launches, summed from ``torch.profiler``'s records over ``reps`` calls.
    Where a call's work takes microseconds, CUDA events around it measure
    the host's launch path instead (the wrapper's checks, allocation and the
    ctypes call, ~0.05 ms); this is the kernels' own share."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.end - e.time_range.start
             for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / reps / 1e3


def nbytes(*args):
    """Bytes of the tensors among ``args``."""
    return sum(t.numel() * t.element_size() for t in args if isinstance(t, torch.Tensor))


def bound_ms(moved, ops):
    """The least milliseconds for ``moved`` bytes and ``ops`` f32 operations."""
    return 1e3 * max(moved / HBM_BYTES_PER_S, ops / F32_FLOPS)


def measured(err, ms, plain_ms, moved, ops, library_ms=None):
    """One kernel's record: its error and times, and the bound of its work
    (``moved`` bytes, ``ops`` f32 operations)."""
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / F32_FLOPS
    return {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms(moved, ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }


def make_trainer(dev, kind="cp", dtype=torch.bfloat16, timestamps=None, **kw):
    """The field of ``kind`` in a trainer with its settings; a dynamic
    field's refresh draws from the training frames' ``timestamps``."""
    return NGPOccTrainer(
        field=FIELDS[kind](dtype), aabb=AABB, device=dev, timestamps=timestamps,
        **TRAIN[kind][0], **kw,
    )


def make_prop_trainer(dev, dtype=torch.bfloat16, **kw):
    """``bench.py``'s proposal configuration: the full-width CP radiance
    field and one CPDensityField (16/64 x rank 16, hidden 64) in a compute
    dtype, 128 proposal and 64 final samples, near 2, far 6, uniform."""
    return NGPPropTrainer(
        field=CPRadianceField(AABB, compute_dtype=dtype),
        prop_fields=[CPDensityField(AABB, compute_dtype=dtype)],
        prop_samples=[PROP_SAMPLES], num_samples=PROP_FINAL, near_plane=2.0,
        far_plane=6.0, device=dev, **kw,
    )


def train_loader(dev, kind):
    """The train split of ``kind``'s scene."""
    if kind == "tineuvox":
        return ProceduralDynamicSceneLoader(
            split="train", num_rays=TRAIN[kind][1], device=dev
        )
    return ProceduralSceneLoader(
        split="train", n_train=6, width=256, height=256, num_rays=TRAIN[kind][1],
        device=dev,
    )


def refreshed_state(trainer):
    state = trainer.init_state()
    for step in range(N_REFRESH):
        state = trainer.refresh_occ_grid(state, step)
    return state


@torch.inference_mode()
def phase_kernels(dev, trainer, state, ds):
    """Each kernel against its twin at the slice's shapes."""
    report = {}
    g = torch.Generator(device=dev).manual_seed(0)

    # G1: every level of the field, both compute dtypes, bitwise
    worst, g1_ms, g1_plain_ms = 0.0, None, None
    u = torch.rand((G1_N, 3), generator=g, device=dev)
    for line in trainer.field.encoder.lines:
        R = line.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            out = cp_level_encode(u, line, dtype)
            ref = cp_level_encode_plain(u, line, dtype)
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            n_unequal = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
            require(err <= 1e-5 * scale, f"G1 R={R} {dtype}: err {err} scale {scale}")
            require(n_unequal == 0, f"G1 R={R} {dtype}: {n_unequal} entries unequal")
            ms = cuda_ms(lambda: cp_level_encode(u, line, dtype))
            plain = cuda_ms(lambda: cp_level_encode_plain(u, line, dtype))
            print(f"G1 cp_level R={R} {str(dtype)[6:]}: max_abs_err={err:.3g} "
                  f"(scale {scale:.3g}, {n_unequal} of {out.numel()} entries unequal) "
                  f"kernel {ms:.4f} ms, alone "
                  f"{device_ms(lambda: cp_level_encode(u, line, dtype)):.4f} ms, twin "
                  f"{plain:.4f} ms")
            worst = max(worst, err)
            if R == 512 and dtype == torch.bfloat16:
                g1_ms, g1_plain_ms, g1_bytes = ms, plain, nbytes(u, line, out)
    # per point three cell weights (scale, floor, subtract); per point and
    # rank three lerps (subtract, fused multiply-add) and two products
    report["cp_level_fwd"] = measured(
        worst, g1_ms, g1_plain_ms, g1_bytes, G1_N * (9 + 32 * 8)
    )

    # G2: the middle 8192 rays of test view 0 on the refreshed grid, and on
    # that grid with half its cells cleared at random (an untrained field
    # can occupy every cell, which would leave the occupancy test unchecked)
    data = ds[0]
    n = data["rays_o"].shape[0]
    sl = slice(n // 2 - G2_RAYS // 2, n // 2 + G2_RAYS // 2)
    o, d = data["rays_o"][sl].contiguous(), data["rays_d"][sl].contiguous()
    occ = state.occ_state
    near = torch.zeros(G2_RAYS, device=dev)
    far = torch.full((G2_RAYS,), 1e10, device=dev)
    cleared = occ.binaries & (
        torch.rand(occ.binaries.shape, generator=g, device=dev) < 0.5
    )
    t_err = 0.0
    for name, binaries in (("refreshed", occ.binaries), ("half-cleared", cleared)):
        args = (o, d, binaries, occ.aabbs, near, far, trainer.render_step_size)
        out, ref = march(*args), march_plain(*args)
        differ = out.counts != ref.counts
        n_differ = int(differ.sum())
        print(f"G2 march, {name} grid ({float(binaries.float().mean()):.3f} "
              f"occupied): {out.ray_indices.shape[0]} samples over {G2_RAYS} "
              f"rays, {n_differ} rays differ in count (the parent design: "
              f"{PARENT_G2_RAYS_DIFFER})")
        require(n_differ <= FLIP_ALLOWANCE * G2_RAYS, f"G2: {n_differ} rays differ")
        require(n_differ <= PARENT_G2_RAYS_DIFFER,
                f"G2: {n_differ} rays differ, the parent design "
                f"{PARENT_G2_RAYS_DIFFER}")
        keep = ~differ[out.ray_indices.long()]
        keep_ref = ~differ[ref.ray_indices.long()]
        require(torch.equal(out.ray_indices[keep], ref.ray_indices[keep_ref]),
                "G2 ray ids")
        t_err = max(
            t_err,
            float((out.t_starts[keep] - ref.t_starts[keep_ref]).abs().max()),
            float((out.t_ends[keep] - ref.t_ends[keep_ref]).abs().max()),
        )
        require(t_err <= 1e-6, f"G2: t differs by {t_err}")
        term_err = float((out.termination_planes - ref.termination_planes).abs().max())
        require(term_err <= 1e-6, f"G2: termination planes differ by {term_err}")
    # timed on the refreshed grid, the one the slice marches
    args = (o, d, occ.binaries, occ.aabbs, near, far, trainer.render_step_size)
    out = march(*args)
    # per sample its bounds, midpoint, position and cell (~15 operations)
    report["march"] = measured(
        t_err, cuda_ms(lambda: march(*args)), cuda_ms(lambda: march_plain(*args)),
        nbytes(*args, *out), 15 * out.ray_indices.shape[0],
    )
    r = report["march"]
    print(f"G2 march {G2_RAYS} rays (eval chunk, near 0): t max_abs_err={t_err:.3g}, "
          f"kernel {r['ms']:.4f} ms, alone {device_ms(lambda: march(*args)):.4f} ms, "
          f"bound {r['bound_ms']:.4f} ms, twin {r['plain_ms']:.4f} ms")
    # a train batch of G2_TRAIN_RAYS rays at the trainer's stratified near
    # planes (near plane + jitter * step), on the same grid
    batch = train_loader(dev, "cp")[0]
    jitter = torch.rand(G2_TRAIN_RAYS, generator=g, device=dev)
    near_t = trainer.near_plane + jitter * trainer.render_step_size
    targs = (batch["rays_o"][:G2_TRAIN_RAYS].contiguous(),
             batch["rays_d"][:G2_TRAIN_RAYS].contiguous(), occ.binaries, occ.aabbs,
             near_t, torch.full_like(near_t, trainer.far_plane), trainer.render_step_size)
    tout, tref = march(*targs), march_plain(*targs)
    n_differ = int((tout.counts != tref.counts).sum())
    require(n_differ <= PARENT_G2_RAYS_DIFFER, f"G2 train batch: {n_differ} rays differ")
    require(all(torch.equal(a, b) for a, b in zip(tout, tref)),
            "G2 train batch: samples or termination planes differ from the twin")
    train = measured(0.0, cuda_ms(lambda: march(*targs)),
                     cuda_ms(lambda: march_plain(*targs)), nbytes(*targs, *tout),
                     15 * tout.ray_indices.shape[0])
    print(f"G2 march {G2_TRAIN_RAYS} rays (train batch, near {trainer.near_plane} + "
          f"jitter * step): {tout.ray_indices.shape[0]} samples, {n_differ} rays differ "
          f"in count (the parent design: {PARENT_G2_RAYS_DIFFER}), kernel "
          f"{train['ms']:.4f} ms, alone {device_ms(lambda: march(*targs)):.4f} ms, bound "
          f"{train['bound_ms']:.4f} ms, twin {train['plain_ms']:.4f} ms")

    # G3: on that buffer, seeded densities and colours
    s = compact_samples(out)
    n_s = s.num_valid
    sigmas = 10.0 ** (torch.rand(n_s, generator=g, device=dev) * 4 - 1)
    rgbs = torch.rand((n_s, 3), generator=g, device=dev)
    cargs = (s.t_starts, s.t_ends, sigmas, rgbs, s.ray_indices, G2_RAYS,
             s.seg_starts, s.seg_ends)
    # with the weights, which the occupancy-grid path asks for on every call
    fargs = cargs + (None, True)
    c, a, dep, weights = composite_sorted(*fargs)
    rc, ra, rdep, rweights = composite_sorted_plain(*fargs)
    err = max(float((c - rc).abs().max()), float((a - ra).abs().max()),
              float((weights - rweights).abs().max()))
    dep_err = float((dep - rdep).abs().max())
    require(err <= 1e-5, f"G3: rgb/opacity/weights differ by {err}")
    require(dep_err <= 1e-4, f"G3: depth differs by {dep_err}")
    # per sample its optical depth, alpha, transmittance, weight and four
    # weighted sums (~12 operations, the exponential counted as one); the
    # kernel reads no ray ids
    report["composite_fwd"] = measured(
        err,
        cuda_ms(lambda: composite_sorted(*fargs)),
        cuda_ms(lambda: composite_sorted_plain(*fargs)),
        nbytes(*cargs, c, a, dep, weights) - nbytes(s.ray_indices), 12 * n_s,
    )
    print(f"G3 composite: {n_s} samples, rgb/opacity/weights max_abs_err={err:.3g}, "
          f"depth {dep_err:.3g}, kernel {report['composite_fwd']['ms']:.4f} ms, alone "
          f"{device_ms(lambda: composite_sorted(*fargs)):.4f} ms, bound "
          f"{report['composite_fwd']['bound_ms']:.4f} ms, twin "
          f"{report['composite_fwd']['plain_ms']:.4f} ms")
    # G3 on the CP train buffer: G2's train batch cut at the budget, with
    # the weights the train path asks for (ray lengths up to the whole box)
    ts = compact_samples(tout, TRAIN["cp"][2])
    n_t = ts.num_valid
    ct_args = (ts.t_starts, ts.t_ends,
               10.0 ** (torch.rand(n_t, generator=g, device=dev) * 4 - 1),
               torch.rand((n_t, 3), generator=g, device=dev), ts.ray_indices,
               G2_TRAIN_RAYS, ts.seg_starts, ts.seg_ends, None, True)
    out = composite_sorted(*ct_args)
    ref = composite_sorted_plain(*ct_args)
    t_err = max(float((out[0] - ref[0]).abs().max()), float((out[1] - ref[1]).abs().max()))
    t_dep_err = float((out[2] - ref[2]).abs().max())
    w_err = float((out[3] - ref[3]).abs().max())
    require(t_err <= 1e-5, f"G3 train buffer: rgb/opacity differ by {t_err}")
    require(t_dep_err <= 1e-4, f"G3 train buffer: depth differs by {t_dep_err}")
    require(w_err <= 1e-5, f"G3 train buffer: weights differ by {w_err}")
    longest = int((ts.seg_ends - ts.seg_starts).max()) + 1
    t_bound = bound_ms(nbytes(*ct_args, *out) - nbytes(ts.ray_indices), 12 * n_t)
    print(f"G3 composite, CP train buffer ({G2_TRAIN_RAYS} rays, {n_t} samples, "
          f"longest ray {longest}): rgb/opacity max_abs_err={t_err:.3g}, depth "
          f"{t_dep_err:.3g}, weights {w_err:.3g}, kernel "
          f"{cuda_ms(lambda: composite_sorted(*ct_args)):.4f} ms, alone "
          f"{device_ms(lambda: composite_sorted(*ct_args)):.4f} ms, bound {t_bound:.4f} ms")

    # 1b. G4: every level at N = 2^18, both compute dtypes, seeded cotangent;
    # its sums run in atomic order, hence 1e-4 of the largest entry
    worst, g4_ms, g4_plain_ms = 0.0, None, None
    cot = torch.randn((G1_N, 32), generator=g, device=dev)
    for line in trainer.field.encoder.lines:
        R = line.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            out = cp_level_backward(u, cot, line, dtype)
            ref = cp_level_backward_plain(u, cot, line, dtype)
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            require(err <= 1e-4 * scale, f"G4 R={R} {dtype}: err {err} scale {scale}")
            ms = cuda_ms(lambda: cp_level_backward(u, cot, line, dtype))
            plain = cuda_ms(lambda: cp_level_backward_plain(u, cot, line, dtype))
            print(f"G4 cp_level_bwd R={R} {str(dtype)[6:]}: max_abs_err={err:.3g} "
                  f"(scale {scale:.3g}) kernel {ms:.4f} ms, twin {plain:.4f} ms")
            worst = max(worst, err)
            if R == 512 and dtype == torch.bfloat16:
                g4_ms, g4_plain_ms, g4_bytes = ms, plain, nbytes(u, cot, line, out)
    # per point three cell weights; per point, rank and axis the product of
    # the other two axes' lerps and two weighted taps
    report["cp_level_bwd"] = measured(
        worst, g4_ms, g4_plain_ms, g4_bytes, G1_N * (9 + 32 * 3 * 4)
    )

    # G5: G3's buffer, seeded cotangents of the three per-ray sums
    cots = [torch.randn((G2_RAYS, c), generator=g, device=dev) for c in (3, 1, 1)]
    bargs = cargs + tuple(cots)
    out = composite_sorted_backward(*bargs)
    ref = composite_sorted_backward_plain(*bargs)
    err = 0.0
    for name, a, b in zip(("dsigma", "drgb"), out, ref):
        e, scale = float((a - b).abs().max()), float(b.abs().max())
        require(e <= 1e-5 * scale, f"G5 {name}: err {e} scale {scale}")
        err = max(err, e)
    # per sample the forward's ~12 operations again and ~8 for the two
    # gradients from the suffix sums; the kernel reads no ray ids
    report["composite_bwd"] = measured(
        err,
        cuda_ms(lambda: composite_sorted_backward(*bargs)),
        cuda_ms(lambda: composite_sorted_backward_plain(*bargs)),
        nbytes(*bargs, *out) - nbytes(s.ray_indices), 20 * n_s,
    )
    print(f"G5 composite_bwd: {n_s} samples, max_abs_err={err:.3g}, kernel "
          f"{report['composite_bwd']['ms']:.4f} ms, bound "
          f"{report['composite_bwd']['bound_ms']:.4f} ms, twin "
          f"{report['composite_bwd']['plain_ms']:.4f} ms")

    # G5 on the CP train buffer, the shape G5 runs at in phase 4
    bt_args = (ts.t_starts, ts.t_ends,
             10.0 ** (torch.rand(n_t, generator=g, device=dev) * 4 - 1),
             torch.rand((n_t, 3), generator=g, device=dev), ts.ray_indices,
             G2_TRAIN_RAYS, ts.seg_starts, ts.seg_ends,
             *[torch.randn((G2_TRAIN_RAYS, c), generator=g, device=dev) for c in (3, 1, 1)])
    out = composite_sorted_backward(*bt_args)
    ref = composite_sorted_backward_plain(*bt_args)
    t_err = 0.0
    for name, a, b in zip(("dsigma", "drgb"), out, ref):
        e, scale = float((a - b).abs().max()), float(b.abs().max())
        require(e <= 1e-5 * scale, f"G5 train buffer {name}: err {e} scale {scale}")
        t_err = max(t_err, e / scale)
    t_bound = bound_ms(nbytes(*bt_args, *out) - nbytes(ts.ray_indices), 20 * n_t)
    print(f"G5 composite_bwd, CP train buffer ({G2_TRAIN_RAYS} rays, {n_t} samples, "
          f"longest ray {longest}): {t_err:.3g} of the largest gradient, kernel "
          f"{cuda_ms(lambda: composite_sorted_backward(*bt_args)):.4f} ms, alone "
          f"{device_ms(lambda: composite_sorted_backward(*bt_args)):.4f} ms, bound "
          f"{t_bound:.4f} ms")

    # G4 on the proposal field's coordinates at its first level, (16, 16),
    # N = 2^19: PROP_RAYS train rays x PROP_SAMPLES stratified samples over
    # [2, 6], in ray order, clamped to the AABB as CPGridEncoder does, so
    # long runs of samples share a row (many on the box's faces)
    prays = ProceduralSceneLoader(split="train", n_train=6, width=256, height=256,
                                  num_rays=PROP_RAYS, device=dev)[0]
    t_prop = 2.0 + (torch.arange(PROP_SAMPLES, device=dev) + torch.rand(
        (PROP_RAYS, PROP_SAMPLES), generator=g, device=dev)) * (4.0 / PROP_SAMPLES)
    pts = prays["rays_o"][:, None] + t_prop[..., None] * prays["rays_d"][:, None]
    lo, hi = torch.tensor(AABB[:3], device=dev), torch.tensor(AABB[3:], device=dev)
    u_prop = ((pts.reshape(-1, 3) - lo) / (hi - lo)).clamp(0.0, 1.0).contiguous()
    lines_prop = 1 + 0.1 * torch.randn((3, 16, 16), generator=g, device=dev)
    cot_prop = torch.randn((u_prop.shape[0], 16), generator=g, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        out = cp_level_backward(u_prop, cot_prop, lines_prop, dtype)
        ref = cp_level_backward_plain(u_prop, cot_prop, lines_prop, dtype)
        err = float((out - ref).abs().max())
        scale = float(ref.abs().max())
        require(err <= 1e-4 * scale, f"G4 ray order (16, 16) {dtype}: err {err} scale {scale}")
        print(f"G4 cp_level_bwd, proposal field's coordinates in ray order, N = "
              f"{u_prop.shape[0]}, (R, rank) = (16, 16), {str(dtype)[6:]}: "
              f"{err / scale:.3g} of the largest entry, kernel "
              f"{cuda_ms(lambda: cp_level_backward(u_prop, cot_prop, lines_prop, dtype)):.4f}"
              f" ms, alone "
              f"{device_ms(lambda: cp_level_backward(u_prop, cot_prop, lines_prop, dtype)):.4f}"
              f" ms")

    # G1 on ray-ordered coordinates, bitwise: the CP train buffer's sample
    # midpoints (normalised to the AABB and clamped, as CPGridEncoder does)
    # at every level of the CP field, and the proposal field's points at
    # every level of CPDensityField (seeded tables)
    ids = ts.ray_indices.long()
    o_t, d_t = targs[0], targs[1]
    mids = o_t[ids] + (0.5 * (ts.t_starts + ts.t_ends))[:, None] * d_t[ids]
    u_train = ((mids - lo) / (hi - lo)).clamp(0.0, 1.0).contiguous()
    density = CPDensityField(AABB).encoder
    levels = [("CP train buffer", u_train, line) for line in trainer.field.encoder.lines]
    levels += [("proposal field", u_prop,
                1 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev))
               for R, rank in zip(density.resolutions, density.ranks)]
    for name, u_ray, line in levels:
        _, R, rank = line.shape
        for dtype in (torch.float32, torch.bfloat16):
            out = cp_level_encode(u_ray, line, dtype)
            ref = cp_level_encode_plain(u_ray, line, dtype)
            n_unequal = int((out.view(torch.int32) != ref.view(torch.int32)).sum())
            require(n_unequal == 0,
                    f"G1 {name} ray order R={R} {dtype}: {n_unequal} entries unequal")
            print(f"G1 cp_level, {name} in ray order, N = {u_ray.shape[0]}, (R, rank) = "
                  f"({R}, {rank}), {str(dtype)[6:]}: {n_unequal} of {out.numel()} entries "
                  f"unequal, kernel {cuda_ms(lambda: cp_level_encode(u_ray, line, dtype)):.4f}"
                  f" ms, alone "
                  f"{device_ms(lambda: cp_level_encode(u_ray, line, dtype)):.4f} ms, bound "
                  f"{bound_ms(nbytes(u_ray, line, out), 0):.4f} ms")
    return report


@torch.inference_mode()
def phase_hash_kernels(dev):
    """1c. G6 and G7 against their twins at the NGP field's full width:
    ``HASH_N`` points uniform in [0, 1]^3 but ``HASH_OUTSIDE`` of them
    pushed out (their corners below 0 wrap in uint32), an O(1) table and a
    seeded cotangent."""
    g = torch.Generator(device=dev).manual_seed(6)
    enc = HashGridEncoder()
    L, T, res = enc.n_levels, enc.table_size, enc.resolutions
    x = torch.rand((HASH_N, 3), generator=g, device=dev)
    n_out = int(HASH_OUTSIDE * HASH_N)
    below = torch.rand(n_out, generator=g, device=dev) < 0.5
    push = 0.1 * torch.rand(n_out, generator=g, device=dev)
    x[:n_out, 0] = torch.where(below, -push, 1.0 + push)
    table = torch.rand((L, T, 2), generator=g, device=dev) * 2.0 - 1.0
    cot = torch.randn((HASH_N, 2 * L), generator=g, device=dev)
    report = {}

    # the corner rows and weights, for the library calls and the bound
    idx, w = hash_corners_plain(x, res, T)
    rows = (idx + T * torch.arange(L, device=dev)[None, :, None]).reshape(-1, 8)
    w = w.reshape(-1, 8).contiguous()
    touched = int(torch.unique(rows).numel())

    # G6: the twin emulates each fused multiply-add in f64 and rounds once
    # to f32, which can differ from the kernel's single rounding in the last
    # bit where the f64 sum lands on an f32 tie (double rounding): hence
    # 1e-6 of the largest entry, with the count of unequal entries printed
    out = hash_encode_forward(x, table, res)
    ref = hash_encode_plain(x, table, res)
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    unequal = int((out != ref).sum())
    require(err <= 1e-6 * scale, f"G6: err {err} scale {scale}")
    flat = table.reshape(-1, 2)
    bag = torch.nn.functional.embedding_bag(
        rows, flat, mode="sum", per_sample_weights=w
    )
    bag_err = float((bag.reshape(HASH_N, -1) - ref).abs().max())
    # per point and level: position, floor and fraction per axis (9), the
    # eight corners' weights (3 complements, 16 products) and 16 fused
    # multiply-adds (32)
    report["hash_fwd"] = measured(
        err,
        cuda_ms(lambda: hash_encode_forward(x, table, res)),
        cuda_ms(lambda: hash_encode_plain(x, table, res)),
        nbytes(x, out) + touched * 2 * 4, HASH_N * L * (9 + 19 + 32),
        cuda_ms(lambda: torch.nn.functional.embedding_bag(
            rows, flat, mode="sum", per_sample_weights=w)),
    )
    r = report["hash_fwd"]
    print(f"G6 hash_fwd N={HASH_N} L={L} T={T}: max_abs_err={err:.3g} (scale "
          f"{scale:.3g}, {unequal} of {out.numel()} entries unequal), kernel "
          f"{r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms; {touched} table rows "
          f"touched, bound {r['bound_ms']:.4f} ms; embedding_bag on the "
          f"precomputed rows (gather stage only) {r['library_ms']:.4f} ms, "
          f"max_abs_err {bag_err:.3g}")

    # G7: its f32 sums run in atomic order (as index_add_'s on the card),
    # hence 1e-5 of the largest entry
    out = hash_encode_backward(x, cot, (L, T, 2), res)
    ref = hash_encode_backward_plain(x, cot, (L, T, 2), res)
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    require(err <= 1e-5 * scale, f"G7: err {err} scale {scale}")
    upd = (w[:, :, None] * cot.reshape(-1, 1, 2)).reshape(-1, 2)
    acc = torch.zeros_like(flat)
    # per point and level: the forward's 28 for the corners, 16 products
    report["hash_bwd"] = measured(
        err,
        cuda_ms(lambda: hash_encode_backward(x, cot, (L, T, 2), res)),
        cuda_ms(lambda: hash_encode_backward_plain(x, cot, (L, T, 2), res)),
        nbytes(x, cot, out), HASH_N * L * (9 + 19 + 16),
        cuda_ms(lambda: acc.index_add_(0, rows.reshape(-1), upd)),
    )
    r = report["hash_bwd"]
    print(f"G7 hash_bwd N={HASH_N} L={L} T={T}: max_abs_err={err:.3g} (scale "
          f"{scale:.3g}), kernel {r['ms']:.4f} ms, alone "
          f"{device_ms(lambda: hash_encode_backward(x, cot, (L, T, 2), res)):.4f} ms, "
          f"twin {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms; index_add_ on "
          f"the precomputed rows and updates (scatter stage only) "
          f"{r['library_ms']:.4f} ms, alone "
          f"{device_ms(lambda: acc.index_add_(0, rows.reshape(-1), upd)):.4f} ms")

    # G7 on the NGP train step's positions in ray order: a train batch of
    # G2_TRAIN_RAYS rays at the trainer's near planes, marched on the
    # full-width NGP trainer's grid after N_REFRESH dense refreshes and cut at
    # the budget, the sample midpoints mapped to [0, 1]^3 as the field maps
    # them (unclamped); neighbouring samples share corner rows
    ngp = make_trainer(dev, "ngp")
    occ = refreshed_state(ngp).occ_state
    batch = train_loader(dev, "ngp")[0]
    o = batch["rays_o"][:G2_TRAIN_RAYS].contiguous()
    d = batch["rays_d"][:G2_TRAIN_RAYS].contiguous()
    near = ngp.near_plane + torch.rand(G2_TRAIN_RAYS, generator=g, device=dev) * (
        ngp.render_step_size)
    s = compact_samples(march(o, d, occ.binaries, occ.aabbs, near,
                              torch.full_like(near, ngp.far_plane), ngp.render_step_size),
                        TRAIN["ngp"][2])
    ids = s.ray_indices.long()
    pts = o[ids] + (0.5 * (s.t_starts + s.t_ends))[:, None] * d[ids]
    x_ray = normalize_points(pts, torch.tensor(AABB, device=dev), False)[0].contiguous()
    cot_ray = torch.randn((x_ray.shape[0], 2 * L), generator=g, device=dev)
    out = hash_encode_backward(x_ray, cot_ray, (L, T, 2), res)
    ref = hash_encode_backward_plain(x_ray, cot_ray, (L, T, 2), res)
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    require(err <= 1e-5 * scale, f"G7 ray order: err {err} scale {scale}")
    level0 = hash_corners_plain(x_ray, res[:1], T)[0][:, 0, 0]
    same = float((level0[1:] == level0[:-1]).float().mean())
    print(f"G7 hash_bwd, NGP train step's positions in ray order, N={x_ray.shape[0]} "
          f"({same:.3f} of samples on the previous sample's level-0 row): "
          f"{err / scale:.3g} of the largest entry, kernel "
          f"{cuda_ms(lambda: hash_encode_backward(x_ray, cot_ray, (L, T, 2), res)):.4f} ms, "
          f"alone "
          f"{device_ms(lambda: hash_encode_backward(x_ray, cot_ray, (L, T, 2), res)):.4f} ms, "
          f"bound {bound_ms(nbytes(x_ray, cot_ray, out), 0):.4f} ms")
    return report


def hat_library_inputs(x, cot, R):
    """``index_add_``'s inputs for G9's function: both taps' rows of each
    point and the bf16 products of their weights with the cotangent."""
    i0, i1, w0, w1, _, _ = hat_taps(x, R)
    rows = torch.stack([i0, i1], dim=1).reshape(-1)
    cot_b = cot.to(torch.bfloat16).to(torch.float32)
    upd = (torch.stack([w0, w1], dim=1)[:, :, None] * cot_b[:, None, :])
    return rows, upd.reshape(-1, cot.shape[1])


def time_hat_line(x, cot, R):
    """G9 at one of TiNeuVox's levels at the train step's shape: CUDA events
    around one call, the kernels alone, the bound and index_add_."""
    rows, upd = hat_library_inputs(x, cot, R)
    acc = torch.zeros((R, cot.shape[1]), device=x.device)
    r = measured(0.0, cuda_ms(lambda: hat_bwd_line(x, cot, R)), None,
                 nbytes(x, cot, acc), x.shape[0] * (6 + 4 * cot.shape[1]),
                 cuda_ms(lambda: acc.index_add_(0, rows, upd)))
    alone = device_ms(lambda: hat_bwd_line(x, cot, R))
    lib_alone = device_ms(lambda: acc.index_add_(0, rows, upd))
    print(f"G9 hat_bwd_line N={x.shape[0]} R={R} rank={cot.shape[1]}: kernel "
          f"{r['ms']:.4f} ms, alone {alone:.4f} ms ({100 * r['bound_ms'] / alone:.1f}% "
          f"of the {r['bound_ms']:.4f} ms bound); index_add_ on the precomputed taps "
          f"and updates {r['library_ms']:.4f} ms, alone {lib_alone:.4f} ms")


def time_hat_x(x, cot, line):
    """G10 at one of TiNeuVox's levels at the train step's shape: CUDA events
    around one call, the kernel alone and the bound."""
    R, rank = line.shape
    dx = hat_bwd_x(x, cot, line)
    bound = bound_ms(nbytes(x, cot, line, dx), x.shape[0] * (8 + 4 * rank))
    alone = device_ms(lambda: hat_bwd_x(x, cot, line))
    print(f"G10 hat_bwd_x N={x.shape[0]} R={R} rank={rank}: kernel "
          f"{cuda_ms(lambda: hat_bwd_x(x, cot, line)):.4f} ms, alone {alone:.4f} ms "
          f"({100 * bound / alone:.1f}% of the {bound:.4f} ms bound)")


def hat_inputs(g, R, rank):
    """Phase 1d's inputs at one level: ``HAT_N`` coordinates uniform in
    [0, 1], ``HAT_OUTSIDE`` of them pushed out by up to 1.5 cells,
    ``HAT_ON_GRID`` on grid points (and the mask of those that are), a table
    near 1 and a seeded cotangent."""
    dev = g.device
    x = torch.rand(HAT_N, generator=g, device=dev)
    n_out = int(HAT_OUTSIDE * HAT_N)
    below = torch.rand(n_out, generator=g, device=dev) < 0.5
    push = 1.5 / (R - 1) * torch.rand(n_out, generator=g, device=dev)
    x[:n_out] = torch.where(below, -push, 1.0 + push)
    grid = torch.randint(0, R, (HAT_ON_GRID,), generator=g, device=dev) / (R - 1)
    x[n_out : n_out + HAT_ON_GRID] = grid
    on_grid = (x * (R - 1)) == torch.round(x * (R - 1))
    line = 1.0 + 0.1 * torch.randn((R, rank), generator=g, device=dev)
    cot = torch.randn((HAT_N, rank), generator=g, device=dev)
    return x, on_grid, line, cot


@torch.inference_mode()
def phase_hat_kernels(dev):
    """1d. G8, G9 and G10 against their plain versions on each of
    TiNeuVox's levels (:func:`hat_inputs`), timed at the last.  G8 is
    bitwise; G9 within 1e-6 of its largest entry (each block sums in int64
    fixed point and rounds to f32; the blocks are added in f64 in block
    order), and two calls give the same bits; G10 within 1e-5 (the
    rank sums in another order) and exactly 0 on grid points.  G9 and G10
    are also timed at each level at the TiNeuVox train step's budget
    ``HAT_TRAIN_N``, G9 beside ``index_add_`` on the precomputed taps."""
    g = torch.Generator(device=dev).manual_seed(8)
    worst = {"hat_fwd": 0.0, "hat_bwd_line": 0.0, "hat_bwd_x": 0.0}
    for R, rank in HAT_LEVELS:
        x, on_grid, line, cot = hat_inputs(g, R, rank)
        out = hat_fwd(x, line)
        unequal = int((out != hat_interp_matmul_plain(x, line)).sum())
        require(unequal == 0, f"G8 R={R}: {unequal} entries differ from the plain version")
        dline = hat_bwd_line(x, cot, R)
        ref = hat_bwd_line_plain(x, cot, R)
        err9, scale9 = float((dline - ref).abs().max()), float(ref.abs().max())
        require(err9 <= 1e-6 * scale9, f"G9 R={R}: err {err9} scale {scale9}")
        require(same_bits(dline, hat_bwd_line(x, cot, R)), f"G9 R={R}: two calls differ")
        time_hat_line(x[:HAT_TRAIN_N], cot[:HAT_TRAIN_N], R)
        time_hat_x(x[:HAT_TRAIN_N], cot[:HAT_TRAIN_N], line)
        dx = hat_bwd_x(x, cot, line)
        ref = hat_bwd_x_plain(x, cot, line)
        err10, scale10 = float((dx - ref).abs().max()), float(ref.abs().max())
        require(err10 <= 1e-5 * scale10, f"G10 R={R}: err {err10} scale {scale10}")
        n_grid = int(on_grid.sum())
        # k / (R - 1) times (R - 1) gives k back for about half of the k
        require(n_grid >= HAT_ON_GRID // 4 and bool((dx[on_grid] == 0).all()),
                f"G10 R={R}: a nonzero gradient on a grid point")
        print(f"hat R={R} rank={rank} N={HAT_N}: G8 0 of {out.numel()} entries "
              f"unequal; G9 max_abs_err={err9:.3g} = {err9 / scale9:.3g} of its "
              f"largest entry, two calls bitwise equal; G10 max_abs_err={err10:.3g} = "
              f"{err10 / scale10:.3g} of its largest entry, exactly 0 on all {n_grid} "
              f"grid points")
        worst["hat_bwd_line"] = max(worst["hat_bwd_line"], err9)
        worst["hat_bwd_x"] = max(worst["hat_bwd_x"], err10)

    # timed at the last level; the taps for the library calls: two rows and
    # bf16 weights per point
    i0, i1, w0, w1, _, _ = hat_taps(x, R)
    taps = torch.stack([i0, i1], dim=1)
    w = torch.stack([w0, w1], dim=1)
    line_b = line.to(torch.bfloat16).to(torch.float32)
    report = {}
    bag = torch.nn.functional.embedding_bag(taps, line_b, mode="sum", per_sample_weights=w)
    bag_err = float((bag - hat_interp_matmul_plain(x, line)).abs().max())
    # per point its position, floor, two weights (~6); per point and rank
    # two products and an addition
    report["hat_fwd"] = measured(
        worst["hat_fwd"],
        cuda_ms(lambda: hat_fwd(x, line)),
        cuda_ms(lambda: hat_interp_matmul_plain(x, line)),
        nbytes(x, line, out), HAT_N * (6 + 3 * rank),
        cuda_ms(lambda: torch.nn.functional.embedding_bag(
            taps, line_b, mode="sum", per_sample_weights=w)),
    )
    rows, upd = hat_library_inputs(x, cot, R)
    acc = torch.zeros((R, rank), device=dev)
    # per point the taps (~6); per point and rank two products and two sums
    report["hat_bwd_line"] = measured(
        worst["hat_bwd_line"],
        cuda_ms(lambda: hat_bwd_line(x, cot, R)),
        cuda_ms(lambda: hat_bwd_line_plain(x, cot, R)),
        nbytes(x, cot, dline), HAT_N * (6 + 4 * rank),
        cuda_ms(lambda: acc.index_add_(0, rows, upd)),
    )
    # per point the taps and slopes (~8); per point and rank two fused
    # multiply-adds; no library call computes it
    report["hat_bwd_x"] = measured(
        worst["hat_bwd_x"],
        cuda_ms(lambda: hat_bwd_x(x, cot, line)),
        cuda_ms(lambda: hat_bwd_x_plain(x, cot, line)),
        nbytes(x, cot, line, dx), HAT_N * (8 + 4 * rank),
    )
    r8, r9, r10 = report["hat_fwd"], report["hat_bwd_line"], report["hat_bwd_x"]
    print(f"G8 hat_fwd N={HAT_N} R={R} rank={rank}: kernel {r8['ms']:.4f} ms, plain "
          f"{r8['plain_ms']:.4f} ms, bound {r8['bound_ms']:.4f} ms; embedding_bag on "
          f"the precomputed taps (gather stage only) {r8['library_ms']:.4f} ms, "
          f"max_abs_err {bag_err:.3g}")
    print(f"G9 hat_bwd_line: kernel {r9['ms']:.4f} ms, alone "
          f"{device_ms(lambda: hat_bwd_line(x, cot, R)):.4f} ms, plain "
          f"{r9['plain_ms']:.4f} ms, bound {r9['bound_ms']:.4f} ms; index_add_ on the "
          f"precomputed taps and updates (scatter stage only) {r9['library_ms']:.4f} ms, "
          f"alone {device_ms(lambda: acc.index_add_(0, rows, upd)):.4f} ms")
    print(f"G10 hat_bwd_x: kernel {r10['ms']:.4f} ms, plain {r10['plain_ms']:.4f} ms, "
          f"bound {r10['bound_ms']:.4f} ms")
    return report


def same_bits(a, b):
    """Bitwise equality, NaNs included."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return torch.equal(a.view(view), b.view(view))


def with_outside(g, idx, low, high):
    """``idx`` with ``GATHER_OUTSIDE`` of its entries redrawn from [low,
    high), a range reaching past the table on both sides."""
    out = idx.clone().reshape(-1)
    k = int(GATHER_OUTSIDE * out.numel())
    out[:k] = torch.randint(low, high, (k,), generator=g, device=idx.device,
                            dtype=idx.dtype)
    return out.reshape(idx.shape)


@torch.inference_mode()
def phase_gather_kernels(dev):
    """1e. The gather probe.  Every case's inputs are made first; the
    probe's run calls each entry point once per case with the launch counts
    zeroed just before and read just after; then each output is held
    bitwise against the plain version (and once more on indices with
    ``GATHER_OUTSIDE`` of them out of range), and the kernel, the plain
    version and the one PyTorch call that computes the same function are
    timed.  Returns the report and the probe's launches."""
    g = torch.Generator(device=dev).manual_seed(11)
    i32 = dict(generator=g, device=dev, dtype=torch.int32)
    rows, lanes = COARSE_SUMMARY
    summary = torch.rand(COARSE_SUMMARY, generator=g, device=dev)
    cases = [("K5 coarse_occ", coarse_occ_lookup, coarse_occ_lookup_plain,
              (torch.randint(0, rows, (COARSE_N,), **i32),
               torch.randint(0, lanes, (COARSE_N,), **i32), summary))]
    for width in (128, 2):
        tab = torch.randn((ROW_TABLE, width), generator=g, device=dev)
        cases.append((f"P1 row_gather ({ROW_TABLE}, {width})", row_gather, row_gather_plain,
                      (tab, torch.randint(0, ROW_TABLE, (ROW_N,), **i32))))
    for T in LANE_HEIGHTS:
        src = torch.randn((T, 128), generator=g, device=dev)
        cases.append((f"P2 lane_gather T={T}", lane_gather, lane_gather_plain,
                      (src, torch.randint(0, T, (LANE_BLOCKS * T, 128), **i32))))
    # P2's NGP emulation: lane l reads level l % 16, of min(2^(10 + l % 16), T) rows
    sizes = torch.clamp(2 ** (10 + torch.arange(128, device=dev) % 16), max=NGP_T)
    idx = (torch.randint(0, 2**30, (NGP_N, 128), **i32) % sizes).to(torch.int32)
    cases.append(("P2 NGP-shaped lane_gather", lane_gather, lane_gather_plain,
                  (torch.randn((NGP_T, 128), generator=g, device=dev), idx)))
    torch.cuda.synchronize()

    cuda.reset_launches()
    outs = [fn(*args) for _, fn, _, args in cases]
    torch.cuda.synchronize()
    probe_launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    print(f"gather probe run: launches {probe_launches}")

    report = {}
    for (name, fn, plain, args), out in zip(cases, outs):
        require(same_bits(out, plain(*args)), f"{name}: differs from its plain version")
        if name.startswith("K5"):
            row, lane, table = args
            checked = (with_outside(g, row, -8, rows + 8), with_outside(g, lane, -8, lanes + 8), table)
            lib_args = (table, row.long(), lane.long())
            library = lambda t, r, c: t[r, c]  # noqa: E731
            what, key = "summary[row, lane]", "coarse_occ"
        elif name.startswith("P1"):
            table, idx = args
            T = table.shape[0]
            checked = (table, with_outside(g, idx, -T - 8, T + 8))
            lib_args = (table, idx)
            library = lambda t, i: torch.index_select(t, 0, i)  # noqa: E731
            what, key = "torch.index_select(tab, 0, idx)", "row_gather"
        else:
            src, idx = args
            T = src.shape[0]
            checked = (src, with_outside(g, idx, -T - 8, T + 8))
            lib_args = (src, idx.long())
            library = lambda t, i: torch.gather(t, 0, i)  # noqa: E731
            what, key = "torch.gather(src, 0, idx)", "lane_gather"
        require(same_bits(fn(*checked), plain(*checked)),
                f"{name}: differs from its plain version on out-of-range indices")
        lib_out = library(*lib_args)
        lib_equal = torch.equal(lib_out, out) if key != "coarse_occ" else None
        del checked, lib_out
        # each output is one indexed load: ~2 integer operations per element
        rec = measured(
            0.0, cuda_ms(lambda: fn(*args)), cuda_ms(lambda: plain(*args)),
            nbytes(*args, out), 2 * out.numel(), cuda_ms(lambda: library(*lib_args)),
        )
        kernel_dev, library_dev = device_ms(lambda: fn(*args)), device_ms(lambda: library(*lib_args))
        print(f"{name}: {out.numel()} outputs, 0 unequal to the plain version "
              f"(also with {100 * GATHER_OUTSIDE:g}% of the indices out of range); "
              f"kernel {rec['ms']:.4f} ms ({1e6 * rec['ms'] / out.numel():.4f} ns per "
              f"output), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
              f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it; plain {rec['plain_ms']:.4f} "
              f"ms; {what} {rec['library_ms']:.4f} ms"
              + ("" if lib_equal is None else f", equal to the kernel: {lib_equal}")
              + f"; device time alone: kernel {kernel_dev:.4f} ms, {what} {library_dev:.4f} ms")
        # the kernels line times K5, P1 at 128 lanes and P2 at T = 2^14
        if name in ("K5 coarse_occ", f"P1 row_gather ({ROW_TABLE}, 128)",
                    f"P2 lane_gather T={2**14}"):
            report[key] = rec
        del lib_args
    del outs, cases
    torch.cuda.empty_cache()
    return report, probe_launches


def prop_level_inputs(g, n_rays):
    """Importance sampling's inputs at the proposal path's two levels: the
    first level's ([0, 1] edges and CDF, E = 2) and the final resampling's
    (the first level's 129 edges in s and a CDF from seeded densities, a
    third of them zero, so the CDF has plateaus)."""
    dev = g.device
    unit = torch.tensor([[0.0, 1.0]], device=dev).expand(n_rays, 2).contiguous()
    bias = torch.rand(n_rays, generator=g, device=dev)
    _, edges = pdf._importance_sampling(unit, unit, bias, PROP_SAMPLES)
    sigma = torch.rand((n_rays, PROP_SAMPLES), generator=g, device=dev) * 40.0
    sigma = torch.where(torch.rand(sigma.shape, generator=g, device=dev) < 1 / 3, 0.0, sigma)
    sdt = sigma * (edges[:, 1:] - edges[:, :-1])
    trans = torch.exp(-torch.cumsum(sdt, dim=-1) + sdt)
    cdfs = 1.0 - torch.cat([trans, torch.zeros_like(trans[:, :1])], dim=-1)
    return (unit, unit, PROP_SAMPLES), (edges, cdfs, PROP_FINAL), bias


@torch.inference_mode()
def phase_pdf_kernel(dev):
    """1f. G14 against its plain version, bitwise: at ``PROP_RAYS`` rays on
    both levels (E = 2 -> 128 samples, then E = 129 -> 64), stratified, and
    at the eval chunk's ``PROP_EVAL_RAYS`` rays (E = 129 -> 64, bias 0.5);
    timed on the final level at ``PROP_RAYS`` (and, device time alone, on
    the first).  No PyTorch call computes it
    (``torch.searchsorted`` is the search alone)."""
    g = torch.Generator(device=dev).manual_seed(14)
    first, final, bias = prop_level_inputs(g, PROP_RAYS)
    eval_final = prop_level_inputs(g, PROP_EVAL_RAYS)[1]
    half = torch.full((PROP_EVAL_RAYS,), 0.5, device=dev)
    for what, (vals, cdfs, n), b in (
        (f"{PROP_RAYS} rays, E = 2 -> {PROP_SAMPLES}", first, bias),
        (f"{PROP_RAYS} rays, E = {PROP_SAMPLES + 1} -> {PROP_FINAL}", final, bias),
        (f"{PROP_EVAL_RAYS} rays, E = {PROP_SAMPLES + 1} -> {PROP_FINAL}, eval", eval_final, half),
    ):
        out = pdf._importance_sampling(vals, cdfs, b, n)
        ref = pdf.importance_sampling_plain(vals, cdfs, b, n)
        require(same_bits(out[0], ref[0]) and same_bits(out[1], ref[1]),
                f"G14 {what}: differs from its plain version")
        print(f"G14 importance_sampling {what}: samples and edges bitwise equal "
              f"to the plain version")
    vals, cdfs, n = final
    out = pdf._importance_sampling(vals, cdfs, bias, n)
    # per sample its position (3), the E - 1 compares with their selects
    # (~3 each) and the lerp (~6); per edge ~3
    ops = PROP_RAYS * (n * (3 * (vals.shape[1] - 1) + 9) + 3 * (n + 1))
    rec = measured(
        0.0, cuda_ms(lambda: pdf._importance_sampling(vals, cdfs, bias, n)),
        cuda_ms(lambda: pdf.importance_sampling_plain(vals, cdfs, bias, n)),
        nbytes(vals, cdfs, bias, *out), ops,
    )
    first_dev = device_ms(lambda: pdf._importance_sampling(*first[:2], bias, first[2]))
    print(f"G14 importance_sampling {PROP_RAYS} rays, E = {vals.shape[1]} -> {n}: kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); device time alone: kernel "
          f"{device_ms(lambda: pdf._importance_sampling(vals, cdfs, bias, n)):.4f} ms, and "
          f"{first_dev:.4f} ms on the first level (E = 2 -> {first[2]})")
    return {"importance_sampling": rec}


def phase_slice(dev, ds, kind="cp", timestamps=None):
    """The serving path through the user's entry points, launches counted."""
    cuda.reset_launches()
    t0 = time.perf_counter()
    trainer = make_trainer(dev, kind, timestamps=timestamps)
    state = refreshed_state(trainer)
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t0
    metrics = trainer.eval_metrics(state, ds)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)

    occupied = float(state.occ_state.binaries.float().mean())
    print(f"slice {kind}: init + {N_REFRESH} dense refreshes of the "
          f"{trainer.grid_resolution}^3 grid {t_refresh:.3f} s; occupied "
          f"share {occupied:.4f}")
    for i, v in enumerate(metrics["views"]):
        print(f"slice {kind} view {i}: {v['seconds']:.4f} s, "
              f"{v['n_samples'] / v['n_rays']:.2f} samples/ray, "
              f"{v['n_samples'] / v['seconds']:.4g} rendered samples/s, "
              f"psnr {v['psnr']:.3f}, opacity [{v['opacity_min']:.4g}, "
              f"{v['opacity_max']:.6g}]")
        require(v["finite"], f"view {i}: non-finite output")
        require(v["opacity_min"] >= 0.0 and v["opacity_max"] <= 1.0 + 1e-4,
                f"view {i}: opacity out of [0, 1]")
        require(v["n_rays"] == ds.WIDTH * ds.HEIGHT, f"view {i}: ray count")
    print(f"slice {kind}: psnr vs GT {metrics['psnr']:.3f} (random field), ssim "
          f"{metrics['ssim']:.4f}, launches {launches}")
    for name in (ENCODER_KERNELS[kind][0], "march", "composite_fwd"):
        require(launches[name] > 0, f"kernel {name} never launched on the slice")
    return trainer, state, metrics["psnr"]


def plain_features(field):
    """The field's encoder through its plain twins, differentiable in its
    tables: the CP levels on clamped points, the hat route's per-axis
    products (differentiable in the points too), or the hash encode."""
    enc = field.encoder
    if isinstance(enc, HashGridEncoder):
        return lambda u: PlainHash.apply(u, enc.table, enc.resolutions)
    if enc.use_pallas:
        def hat_levels(u):
            u = u.clamp(0.0, 1.0)
            return torch.cat(
                [PlainHat.apply(u[:, 0], line[0]) * PlainHat.apply(u[:, 1], line[1])
                 * PlainHat.apply(u[:, 2], line[2]) for line in enc.lines], dim=-1,
            )
        return hat_levels
    return lambda u: torch.cat(
        [PlainCPLevel.apply(u.clamp(0.0, 1.0), line, field.compute_dtype)
         for line in enc.lines], dim=-1,
    )


def render_through_twins(trainer, o, d, occ, near, composite, budget=None, times=None):
    """Rays rendered through the plain twins alone: march, the encoder
    (:func:`plain_features`), composite (by ``composite``); a dynamic
    field's samples at their rays' ``times`` (n_rays, 1), warped by its
    deformation net.  Returns colours before the background blend,
    opacities and the packed samples."""
    field = trainer.field
    n = o.shape[0]
    far = torch.full((n,), trainer.far_plane, device=o.device)
    smp = compact_samples(
        march_plain(o, d, occ.binaries, occ.aabbs, near, far,
                    trainer.render_step_size, trainer.cone_angle),
        budget,
    )
    ids = smp.ray_indices.long()
    t_mid = 0.5 * (smp.t_starts + smp.t_ends)
    dirs = d[ids]
    positions = o[ids] + t_mid[:, None] * dirs
    if times is None:
        u, selector = field.normalize(positions)
        feats = plain_features(field)(u)
    else:
        t = times[ids]
        u, selector = field.normalize(positions + field.warp(positions, t))
        feats = torch.cat([plain_features(field)(u), field.time_features(t)], dim=-1)
    density, embedding = field.density_from_features(feats, selector, True)
    rgb = field.query_rgb(dirs, embedding)
    colors, opacities = composite(
        smp.t_starts, smp.t_ends, density[:, 0], rgb, smp.ray_indices, n,
        smp.seg_starts, smp.seg_ends,
    )[:2]
    return colors, opacities, smp


@torch.inference_mode()
def render_view_plain(trainer, state, data, chunk=8192):
    """View colours through the twins only."""
    trainer.field.load_state_dict(state.params)
    rays_o, rays_d = data["rays_o"], data["rays_d"]
    out = []
    for s in range(0, rays_o.shape[0], chunk):
        o, d = rays_o[s : s + chunk], rays_d[s : s + chunk]
        near = torch.full((o.shape[0],), trainer.near_plane, device=o.device)
        colors, opacities, _ = render_through_twins(
            trainer, o, d, state.occ_state, near, composite_sorted_plain,
        )
        out.append(colors + data["color_bkgd"] * (1.0 - opacities))
    return torch.cat(out)


class PlainCPLevel(torch.autograd.Function):
    """The CP level through its plain twins, forward and backward."""

    @staticmethod
    def forward(ctx, u, lines, compute_dtype):
        ctx.save_for_backward(u, lines)
        ctx.compute_dtype = compute_dtype
        return cp_level_encode_plain(u, lines, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        u, lines = ctx.saved_tensors
        return None, cp_level_backward_plain(u, g.contiguous(), lines, ctx.compute_dtype), None


class PlainHat(torch.autograd.Function):
    """One axis of the hat route through its plain versions, forward and
    both gradients."""

    @staticmethod
    def forward(ctx, x, line):
        ctx.save_for_backward(x, line)
        return hat_interp_matmul_plain(x, line)

    @staticmethod
    def backward(ctx, g):
        x, line = ctx.saved_tensors
        g = g.contiguous()
        dx = hat_bwd_x_plain(x, g, line) if ctx.needs_input_grad[0] else None
        return dx, hat_bwd_line_plain(x, g, line.shape[0])


class PlainHash(torch.autograd.Function):
    """The hash encode through its plain twins, forward and backward."""

    @staticmethod
    def forward(ctx, u, table, resolutions):
        ctx.save_for_backward(u)
        ctx.table_shape, ctx.resolutions = tuple(table.shape), resolutions
        return hash_encode_plain(u, table, resolutions)

    @staticmethod
    def backward(ctx, g):
        (u,) = ctx.saved_tensors
        return None, hash_encode_backward_plain(
            u, g.contiguous(), ctx.table_shape, ctx.resolutions
        ), None


class PlainComposite(torch.autograd.Function):
    """Compositing through its plain twins, forward and backward."""

    @staticmethod
    def forward(ctx, t0, t1, sigmas, rgbs, ids, n_rays, ss, se):
        ctx.save_for_backward(t0, t1, sigmas, rgbs, ids, ss, se)
        ctx.n_rays = n_rays
        return composite_sorted_plain(t0, t1, sigmas, rgbs, ids, n_rays, ss, se)[:3]

    @staticmethod
    def backward(ctx, gc, go, gd):
        t0, t1, sigmas, rgbs, ids, ss, se = ctx.saved_tensors
        n = ctx.n_rays
        cots = [torch.zeros((n, c), device=t0.device) if x is None else x.contiguous()
                for x, c in ((gc, 3), (go, 1), (gd, 1))]
        d_s, d_r = composite_sorted_backward_plain(t0, t1, sigmas, rgbs, ids, n, ss, se, *cots)
        return None, None, d_s, d_r, None, None, None, None


def train_loss_plain(trainer, params, occ, batch, near_jitter):
    """The train step's loss and gradients (no refresh, no update) through
    the plain twins alone."""
    field = trainer.field
    field.load_state_dict(params)
    field.zero_grad(set_to_none=True)
    o, d = batch["rays_o"], batch["rays_d"]
    n = o.shape[0]
    near = trainer.near_plane + near_jitter * trainer.render_step_size
    colors, opacities, smp = render_through_twins(
        trainer, o, d, occ, near, PlainComposite.apply, trainer.sample_budget,
        batch["timestamps"] if trainer.timestamps is not None else None,
    )
    colors = colors + batch["color_bkgd"] * (1.0 - opacities)
    ray_ok = (torch.arange(n, device=o.device) < smp.first_incomplete_ray)[:, None]
    n_ok = ray_ok.sum().clamp_min(1)
    diff = (colors - batch["rgb"]).abs() * ray_ok
    loss = torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5).sum() / (n_ok * 3)
    if trainer.field_reg_weight > 0:
        loss = loss + trainer.field_reg_weight * field.param_regularizer()
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in field.named_parameters()}


def phase_train(dev, kind="cp", ds=None):
    """The training path through the user's entry points, launches counted
    (on ``ds``, or a new train split of ``kind``'s scene)."""
    t0 = time.perf_counter()
    ds = train_loader(dev, kind) if ds is None else ds
    _, rays, budget = TRAIN[kind]
    trainer = make_trainer(
        dev, kind, timestamps=getattr(ds, "timestamps", None), max_steps=TRAIN_STEPS,
        sample_budget=budget,
    )
    field = trainer.field
    state = trainer.init_state()
    # batches drawn and staged on the card before the clock, as bench.py does
    batches = [ds[0] for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    print(f"train {kind}: {len(ds)} views {ds.WIDTH}x{ds.HEIGHT}, {rays} rays, "
          f"budget {budget}, set-up {time.perf_counter() - t0:.2f} s")

    cuda.reset_launches()
    losses, n_samples, n_total, n_ok = [], 0, 0, []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        state, aux = trainer.train_step(state, batches[i])
        losses.append(aux["loss"])
        n_ok.append(aux["n_rays_ok"])
        n_samples += aux["n_rendering_samples"]
        n_total += aux["n_total_samples"]
        if i % 100 == 0 or i == TRAIN_STEPS - 1:
            print(f"train {kind} step {i}: loss {float(aux['loss']):.6f}, "
                  f"{aux['n_rendering_samples']} samples of {aux['n_total_samples']}, "
                  f"{int(aux['n_rays_ok'])} rays in the loss")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)

    losses = torch.stack(losses).cpu()
    require(bool(torch.isfinite(losses).all()), "train: non-finite loss")
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    masked = 1.0 - float(torch.stack(n_ok).sum()) / (rays * TRAIN_STEPS)
    rate = ""
    if kind == "cp":  # utils/flops.py counts the CP field's matmuls
        refreshes = -(-TRAIN_STEPS // trainer.update_interval)
        work = (n_samples * flops.cp_field_flops_per_sample(field)
                + refreshes * trainer.grid_resolution**3
                * flops.cp_density_query_flops_per_sample(field))
        rate = (f", {work / seconds / 1e12:.4f} TFLOP/s = "
                f"{100 * work / seconds / flops.H100_PEAK_BF16_FLOPS:.4f}% of 989 "
                f"bf16 TFLOP/s")
    print(f"train {kind}: {TRAIN_STEPS} steps in {seconds:.3f} s, "
          f"{1e3 * seconds / TRAIN_STEPS:.3f} ms/step, "
          f"{n_samples / seconds:.6g} train samples/s "
          f"({n_samples / TRAIN_STEPS:.1f} rendered, {n_total / TRAIN_STEPS:.1f} "
          f"demanded per step){rate}; {100 * masked:.2f}% of rays masked by "
          f"the budget")
    print(f"train {kind}: mean loss of the first 50 steps {first:.6f}, of the "
          f"last 50 {last:.6f}; launches {launches}, per step "
          + ", ".join(f"{k} {v / TRAIN_STEPS:.3f}" for k, v in launches.items()))
    require(last < 0.5 * first, f"train {kind}: loss {first} -> {last} did not halve")
    for name in (*ENCODER_KERNELS[kind], "march", "composite_fwd", "composite_bwd"):
        require(launches[name] > 0, f"kernel {name} never launched in training")
    return trainer, state, batches[TRAIN_STEPS], launches


def kernel_step_grads(trainer, state, batch, near):
    """One ``train_step`` through the kernels from a copy of ``state``: its
    loss and the parameters' gradients, each checked finite and nonzero."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.params.items()}
    st = TrainState(params, trainer.init_optimizer(params), state.occ_state, state.step)
    _, aux = trainer.train_step(st, batch, near_jitter=near)
    for name, p in params.items():
        require(torch.isfinite(p.grad).all() and float(p.grad.abs().max()) > 0,
                f"train step: gradient of {name} is zero or not finite")
    return float(aux["loss"]), {k: p.grad for k, p in params.items()}


def relative_fro(grads, ref):
    return {k: float(torch.linalg.norm(g - ref[k]) / torch.linalg.norm(ref[k]))
            for k, g in grads.items()}


@contextlib.contextmanager
def hat_kernels_alone():
    """Inside: the differentiable composite runs its plain versions in place
    of G3 and G5, and PyTorch's own scatter-adds (``index_add_``) run in a
    fixed order, so that a kernel train step and the plain step hand the hat
    kernels and their plain versions the same cotangents, bit for bit."""
    saved = sorted_segments._composite_forward, sorted_segments.composite_sorted_backward
    sorted_segments._composite_forward = sorted_segments.composite_sorted_plain
    sorted_segments.composite_sorted_backward = sorted_segments.composite_sorted_backward_plain
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        sorted_segments._composite_forward, sorted_segments.composite_sorted_backward = saved


def step_readings(what, step, plain, limit=None):
    """``STEP_REPEATS`` runs of ``step() -> (loss, grads)`` against the
    ``plain`` step's: prints the worst relative Frobenius per leaf, the
    range of each run's worst leaf and the worst relative loss difference;
    returns the check (what, worst leaf, limit, loss difference)."""
    loss_plain, grads_plain = plain
    worst, per_run, loss_rel = {}, [], 0.0
    for _ in range(STEP_REPEATS):
        loss, grads = step()
        loss_rel = max(loss_rel, abs(loss - loss_plain) / abs(loss_plain))
        rel = relative_fro(grads, grads_plain)
        per_run.append(max(rel.values()))
        for k, v in rel.items():
            worst[k] = max(worst.get(k, 0.0), v)
    bound = f", limit {limit:g}" if limit is not None else ""
    print(f"{what} over {STEP_REPEATS} runs: loss relative <= {loss_rel:.3g}; worst "
          f"leaf per run {min(per_run):.3g} to {max(per_run):.3g}{bound}; worst "
          f"relative Frobenius per leaf: "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    return what, max(per_run), limit, loss_rel


def phase_train_twins(trainer, state, batch, kind="cp"):
    """One train step through the kernels against the same step through the
    plain twins: the same state, batch and near-plane jitter, for the
    trained bf16 field and for the same parameters in an f32 field.  Each
    kernel step runs ``STEP_REPEATS`` times, since atomics reorder its sums
    from run to run.  For the hat route's f32 field also the plain step
    against itself, and the kernel step under :func:`hat_kernels_alone`
    against the plain step there (held to ``HAT_ALONE_STEP_FRO``)."""
    require(state.step % trainer.update_interval != 0, "phase 5 step refreshes")
    gen = torch.Generator(device=trainer.device).manual_seed(5)
    near = torch.rand(batch["rays_o"].shape[0], generator=gen, device=trainer.device)
    f32 = make_trainer(
        trainer.device, kind, torch.float32, timestamps=trainer.timestamps,
        max_steps=TRAIN_STEPS, sample_budget=trainer.sample_budget,
    )
    hat = "hat_fwd" in ENCODER_KERNELS[kind]
    plain, checks = {}, []
    for mode, tr, limit in (("f32", f32, F32_HAT_STEP_FRO if hat else F32_STEP_FRO),
                            ("bf16", trainer, BF16_STEP_FRO)):
        def plain_step():
            return train_loss_plain(tr, state.params, state.occ_state, batch, near)

        def kernel_step():
            return kernel_step_grads(tr, state, batch, near)

        what = f"train step {kind} {mode}"
        ref = plain_step()
        plain[mode] = ref[1]
        checks.append(step_readings(f"{what}, kernels vs twins", kernel_step, ref, limit))
        if hat and mode == "f32":
            step_readings(f"{what}, twins vs twins", plain_step, ref)
            with hat_kernels_alone():
                checks.append(step_readings(
                    f"{what}, hat kernels vs twins (composite on its twins, "
                    "fixed-order scatter-adds)", kernel_step, plain_step(), HAT_ALONE_STEP_FRO,
                ))
    for what, reading, limit, loss_rel in checks:
        require(reading <= limit, f"{what}: a gradient leaf off by {reading} > {limit}")
        require(loss_rel <= 1e-5, f"{what}: losses differ by {loss_rel}")
    contract = relative_fro(plain["f32"], plain["bf16"])
    print(f"train step {kind}, twins f32 field vs bf16 field (what lost bf16 "
          "roundings read): "
          + ", ".join(f"{k} {v:.3g}" for k, v in contract.items()))


def phase_serve_trained(trainer, state, ds, untrained_psnr, kind="cp"):
    """The serving path on the trained field and its grid."""
    metrics = trainer.eval_metrics(state, ds)
    occupied = float(state.occ_state.binaries.float().mean())
    for i, v in enumerate(metrics["views"]):
        print(f"trained {kind} view {i}: {v['seconds']:.4f} s, "
              f"{v['n_samples'] / v['n_rays']:.2f} samples/ray, psnr "
              f"{v['psnr']:.3f}, ssim {v['ssim']:.4f}")
        require(v["finite"], f"trained view {i}: non-finite output")
    seconds = sum(v["seconds"] for v in metrics["views"]) / len(metrics["views"])
    print(f"trained {kind} field: {seconds:.4f} s/frame, occupied share {occupied:.4f}, "
          f"psnr {metrics['psnr']:.3f} (untrained {untrained_psnr:.3f}), ssim "
          f"{metrics['ssim']:.4f}")
    require(metrics["psnr"] >= untrained_psnr + 3.0,
            f"trained {kind} psnr {metrics['psnr']} not 3 dB above {untrained_psnr}")


def phase_prop_serve(dev, ds, trainer=None, state=None, untrained_psnr=None):
    """15 (untrained, seed-42 weights) and 18 (``trainer`` and ``state``
    from phase 16, against ``untrained_psnr``): ``NGPPropTrainer``'s
    evaluation on the test views, launches counted."""
    label = "prop" if untrained_psnr is None else "trained prop"
    if trainer is None:
        trainer = make_prop_trainer(dev)
        state = trainer.init_state()
    cuda.reset_launches()
    metrics = trainer.eval_metrics(state, ds)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
    for i, v in enumerate(metrics["views"]):
        print(f"{label} view {i}: {v['seconds']:.4f} s, {v['n_samples'] / v['n_rays']:.0f} "
              f"samples/ray, {v['n_samples'] / v['seconds']:.4g} rendered samples/s, psnr "
              f"{v['psnr']:.3f}, ssim {v['ssim']:.4f}, opacity [{v['opacity_min']:.4g}, "
              f"{v['opacity_max']:.6g}]")
        require(v["finite"], f"{label} view {i}: non-finite output")
        require(v["opacity_min"] >= 0.0 and v["opacity_max"] <= 1.0 + 1e-4,
                f"{label} view {i}: opacity out of [0, 1]")
    seconds = sum(v["seconds"] for v in metrics["views"]) / len(metrics["views"])
    print(f"{label}: {seconds:.4f} s/frame, psnr {metrics['psnr']:.3f}, ssim "
          f"{metrics['ssim']:.4f}; launches {launches}")
    for name in ("cp_level_fwd", "composite_fwd", "importance_sampling"):
        require(launches.get(name, 0) > 0, f"kernel {name} never launched in {label} serving")
    if untrained_psnr is not None:
        require(metrics["psnr"] >= untrained_psnr + 3.0,
                f"trained prop psnr {metrics['psnr']} not 3 dB above {untrained_psnr}")
    return metrics["psnr"]


def phase_prop_train(dev):
    """16. The proposal path trained at bench.py's configuration through
    ``train_steps_sampled`` and the proposal-gradient schedule, launches
    counted; batches drawn on the card from the step's generator."""
    t0 = time.perf_counter()
    ds = ProceduralSceneLoader(split="train", n_train=6, width=256, height=256,
                               num_rays=PROP_RAYS, device=dev)
    sampler = DeviceRaySampler.from_loader(ds)
    trainer = make_prop_trainer(dev, max_steps=TRAIN_STEPS)
    state = trainer.init_state()
    rg_fn = get_proposal_requires_grad_fn()
    rgs = [rg_fn(step) for step in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    print(f"train prop: {len(ds)} views {ds.WIDTH}x{ds.HEIGHT} staged on the card, "
          f"{PROP_RAYS} rays, {PROP_SAMPLES} + {PROP_FINAL} samples per ray, "
          f"{sum(rgs)} of {TRAIN_STEPS} steps train the proposal field, set-up "
          f"{time.perf_counter() - t0:.2f} s")

    cuda.reset_launches()
    losses, prop_losses = [], []
    t0 = time.perf_counter()
    for start in range(0, TRAIN_STEPS, 100):
        state, aux = trainer.train_steps_sampled(state, sampler, rgs[start : start + 100])
        losses.append(aux["loss"])
        prop_losses.append(aux["prop_loss"])
        print(f"train prop step {start}: loss {float(aux['loss'][0]):.6f}, prop loss "
              f"{float(aux['prop_loss'][0]):.6f}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)

    losses, prop_losses = torch.cat(losses).cpu(), torch.cat(prop_losses).cpu()
    require(bool(torch.isfinite(losses).all()), "train prop: non-finite loss")
    recon = losses - prop_losses
    first, last = float(recon[:50].mean()), float(recon[-50:].mean())
    n_rg = sum(rgs)
    samples = TRAIN_STEPS * PROP_RAYS * (PROP_SAMPLES + PROP_FINAL)  # as bench.py counts
    prop = trainer.prop_fields[0]
    work = PROP_RAYS * (
        TRAIN_STEPS * PROP_FINAL * flops.cp_field_flops_per_sample(trainer.field)
        + PROP_SAMPLES * ((TRAIN_STEPS - n_rg) * flops.cp_density_flops_per_sample(prop)
                          + n_rg * flops.cp_density_flops_per_sample(prop, backward=True)))
    print(f"train prop: {TRAIN_STEPS} steps in {seconds:.3f} s, "
          f"{1e3 * seconds / TRAIN_STEPS:.3f} ms/step, {samples / seconds:.6g} train "
          f"samples/s (bench.py's count, {PROP_RAYS} x ({PROP_SAMPLES} + {PROP_FINAL}) per "
          f"step), {work / seconds / 1e12:.4f} TFLOP/s = "
          f"{100 * work / seconds / flops.H100_PEAK_BF16_FLOPS:.4f}% of 989 bf16 TFLOP/s")
    print(f"train prop: mean reconstruction loss of the first 50 steps {first:.6f}, of the "
          f"last 50 {last:.6f}; mean loss (with the interlevel loss) "
          f"{float(losses[:50].mean()):.6f} -> {float(losses[-50:].mean()):.6f}; mean "
          f"prop loss over its steps {float(prop_losses[:50][torch.tensor(rgs[:50])].mean()):.6f} "
          f"-> {float(prop_losses[-200:][torch.tensor(rgs[-200:])].mean()):.6f} (first 50, "
          f"last 200 steps); launches {launches}, per step "
          + ", ".join(f"{k} {v / TRAIN_STEPS:.3f}" for k, v in launches.items() if v))
    require(last < 0.5 * first, f"train prop: loss {first} -> {last} did not halve")
    for name in ("cp_level_fwd", "cp_level_bwd", "composite_fwd", "composite_bwd",
                 "importance_sampling"):
        require(launches[name] > 0, f"kernel {name} never launched in prop training")
    batch = sampler.sample(trainer._generator(TRAIN_STEPS, 2))
    return trainer, state, batch, launches


@contextlib.contextmanager
def plain_kernels():
    """Inside: every kernel of the proposal path runs its plain version (G1
    and G4, G3 and G5, G14), through the same autograd Functions."""
    saved = (cp_level_ops._encode_forward, cp_level_ops.cp_level_backward,
             sorted_segments._composite_forward, sorted_segments.composite_sorted_backward,
             pdf._importance_sampling)
    cp_level_ops._encode_forward = cp_level_encode_plain
    cp_level_ops.cp_level_backward = cp_level_backward_plain
    sorted_segments._composite_forward = sorted_segments.composite_sorted_plain
    sorted_segments.composite_sorted_backward = sorted_segments.composite_sorted_backward_plain
    pdf._importance_sampling = pdf.importance_sampling_plain
    try:
        yield
    finally:
        (cp_level_ops._encode_forward, cp_level_ops.cp_level_backward,
         sorted_segments._composite_forward, sorted_segments.composite_sorted_backward,
         pdf._importance_sampling) = saved


def prop_step_grads(trainer, state, batch, biases, plain=False):
    """One ``train_step`` with ``requires_grad`` from a copy of ``state``,
    through the kernels or (``plain``) their plain versions: its loss and
    every leaf's gradient, each checked finite and nonzero."""
    params = {
        "field": {k: v.detach().clone().requires_grad_(True) for k, v in state.params["field"].items()},
        "props": [{k: v.detach().clone().requires_grad_(True) for k, v in p.items()}
                  for p in state.params["props"]],
    }
    st = PropTrainState(params, trainer.init_optimizer(params), state.step)
    before = dict(cuda.LAUNCHES)
    with plain_kernels() if plain else contextlib.nullcontext():
        _, aux = trainer.train_step(st, batch, requires_grad=True, biases=biases)
    if plain:
        require(cuda.LAUNCHES == before, "the plain prop step launched a kernel")
    grads = {f"field.{k}": v.grad for k, v in params["field"].items()}
    for i, p in enumerate(params["props"]):
        grads.update({f"props.{i}.{k}": v.grad for k, v in p.items()})
    for name, g in grads.items():
        require(torch.isfinite(g).all() and float(g.abs().max()) > 0,
                f"prop train step: gradient of {name} is zero or not finite")
    return float(aux["loss"]), grads


def phase_prop_train_twins(trainer, state, batch):
    """17. One proposal train step with ``requires_grad`` through the
    kernels against the same step through the plain versions, from phase
    16's state with the same batch and jitter, for the trained bf16 fields
    and for the same parameters in f32 fields (phase 5's bounds)."""
    gen = torch.Generator(device=trainer.device).manual_seed(17)
    biases = [torch.rand(PROP_RAYS, generator=gen, device=trainer.device) for _ in range(2)]
    f32 = make_prop_trainer(trainer.device, torch.float32, max_steps=TRAIN_STEPS)
    checks = []
    for mode, tr, limit in (("f32", f32, F32_STEP_FRO), ("bf16", trainer, BF16_STEP_FRO)):
        ref = prop_step_grads(tr, state, batch, biases, plain=True)
        checks.append(step_readings(
            f"train step prop {mode}, kernels vs plain versions",
            lambda: prop_step_grads(tr, state, batch, biases), ref, limit,
        ))
    for what, reading, limit, loss_rel in checks:
        require(reading <= limit, f"{what}: a gradient leaf off by {reading} > {limit}")
        require(loss_rel <= 1e-5, f"{what}: losses differ by {loss_rel}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s) from {_build.library_path().name}")
    for line in _build.build_log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    ds = ProceduralSceneLoader(split="test", device=dev)
    torch.cuda.synchronize()
    print(f"scene: {len(ds)} test views {ds.WIDTH}x{ds.HEIGHT}, ground truth "
          f"rendered in {time.perf_counter() - t0:.2f} s")

    trainer = make_trainer(dev)
    report = phase_kernels(dev, trainer, refreshed_state(trainer), ds)
    del trainer
    report.update(phase_hash_kernels(dev))
    report.update(phase_hat_kernels(dev))
    gather_report, probe_launches = phase_gather_kernels(dev)
    report.update(gather_report)
    report.update(phase_pdf_kernel(dev))
    trainer, state, untrained_psnr = phase_slice(dev, ds)

    with torch.inference_mode():
        main_colors = trainer.render_image(state, ds[0])
    plain_colors = render_view_plain(trainer, state, ds[0])
    diff = float((main_colors - plain_colors).abs().max())
    print(f"view 0, kernels vs twins: max colour difference {diff:.3g}")
    require(diff <= 2e-3, f"view 0: kernel and twin paths differ by {diff}")

    trainer, state, batch, launches = phase_train(dev)
    phase_train_twins(trainer, state, batch)
    phase_serve_trained(trainer, state, ds, untrained_psnr)
    del trainer, state

    # 7-10: the hash-grid NGP field through the same entry points
    _, _, untrained_psnr = phase_slice(dev, ds, "ngp")
    trainer, state, batch, ngp_launches = phase_train(dev, "ngp")
    phase_train_twins(trainer, state, batch, "ngp")
    phase_serve_trained(trainer, state, ds, untrained_psnr, "ngp")
    del trainer, state

    # 11-14: the TiNeuVox dynamic field on the moving scene
    t0 = time.perf_counter()
    dyn_train = train_loader(dev, "tineuvox")
    dyn_test = ProceduralDynamicSceneLoader(split="test", device=dev)
    torch.cuda.synchronize()
    print(f"dynamic scene: {len(dyn_train)} train and {len(dyn_test)} test views "
          f"{dyn_test.WIDTH}x{dyn_test.HEIGHT}, test times "
          f"{[round(float(t), 4) for t in dyn_test.view_times]}, ground truth "
          f"rendered in {time.perf_counter() - t0:.2f} s")
    _, _, untrained_psnr = phase_slice(
        dev, dyn_test, "tineuvox", timestamps=dyn_train.timestamps
    )
    trainer, state, batch, tnv_launches = phase_train(dev, "tineuvox", dyn_train)
    phase_train_twins(trainer, state, batch, "tineuvox")
    phase_serve_trained(trainer, state, dyn_test, untrained_psnr, "tineuvox")
    del trainer, state

    # 15-18: the proposal-network path
    untrained_psnr = phase_prop_serve(dev, ds)
    trainer, state, batch, prop_launches = phase_prop_train(dev)
    phase_prop_train_twins(trainer, state, batch)
    phase_prop_serve(dev, ds, trainer, state, untrained_psnr)
    # each kernel's launches over the four training runs (phases 4, 8, 12,
    # 16), and the gather kernels' over the gather probe's run
    launches = {k: v + ngp_launches[k] + tnv_launches[k] + prop_launches[k]
                for k, v in launches.items()}
    launches.update(probe_launches)

    sources = {
        "cp_level_fwd": ("nerfacc_tpu_torch/csrc/cp_level.cu",
                         "nerfacc_tpu/ops/cp_level.py:59"),
        "cp_level_bwd": ("nerfacc_tpu_torch/csrc/cp_level_bwd.cu",
                         "nerfacc_tpu/ops/cp_level.py:66"),
        "march": ("nerfacc_tpu_torch/csrc/march.cu", "nerfacc_tpu/grid.py:1333"),
        "composite_fwd": ("nerfacc_tpu_torch/csrc/composite.cu",
                          "nerfacc_tpu/volrend.py:60"),
        "composite_bwd": ("nerfacc_tpu_torch/csrc/composite.cu",
                          "nerfacc_tpu/ops/sorted_segments.py:238"),
        "hash_fwd": ("nerfacc_tpu_torch/csrc/hash_encode.cu",
                     "nerfacc_tpu/ops/hash_vmem.py:133"),
        "hash_bwd": ("nerfacc_tpu_torch/csrc/hash_encode.cu",
                     "nerfacc_tpu/models/encoders.py:94"),
        "hat_fwd": ("nerfacc_tpu_torch/csrc/hat_matmul.cu",
                    "nerfacc_tpu/ops/hat_matmul.py:39"),
        "hat_bwd_line": ("nerfacc_tpu_torch/csrc/hat_matmul.cu",
                         "nerfacc_tpu/ops/hat_matmul.py:49"),
        "hat_bwd_x": ("nerfacc_tpu_torch/csrc/hat_matmul.cu",
                      "nerfacc_tpu/ops/hat_matmul.py:68"),
        "coarse_occ": ("nerfacc_tpu_torch/csrc/gather.cu",
                       "nerfacc_tpu/ops/coarse_occ.py:27"),
        "lane_gather": ("nerfacc_tpu_torch/csrc/gather.cu",
                        "nerfacc_tpu/ops/lane_gather.py:35"),
        "row_gather": ("nerfacc_tpu_torch/csrc/gather.cu",
                       "scripts/pallas_gather_probe.py:84"),
        "importance_sampling": ("nerfacc_tpu_torch/csrc/pdf.cu",
                                "nerfacc_tpu/pdf.py:135"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        require(launches.get(name, 0) > 0, f"kernel {name} never launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], **report[name],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
