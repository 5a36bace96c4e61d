#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU,
and check them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``nerfacc_tpu_torch/csrc`` and runs:

1. each forward kernel (G1 CP level, G2 march, G3 composite) against its
   PyTorch twin on the card at the slice's shapes, timed with CUDA events
   (G2 also with a window, round by round as the eval renderer runs it,
   bitwise, and G3 on its busiest round behind the earlier rounds' opacity,
   ``prefix_trans = 1 - opacity``; G2 and G3 also on a 2048-ray train batch at the trainer's near planes,
   G3 on that batch cut at the 2^18 budget, and alone by
   ``torch.profiler``); G1 bitwise, at every level of the CP field on
   uniform coordinates and on that cut batch's sample midpoints, and at
   every level of ``CPDensityField`` on the proposal field's points;
   1b. the backward kernels (G4 CP level, G5 composite) likewise, and at
   the train steps' shapes: G5 on the CP train buffer (that batch cut at the
   2^18 budget), G4 on the proposal field's coordinates in ray order (4096
   rays x 128 samples, (R, rank) = (16, 16), both compute dtypes); G4
   bitwise its plain version and over two calls at each (both sum in
   fixed point);
   1c. the hash-encode kernels (G6 forward, G7 table gradient) at the NGP
   field's full width (2^18 points, 16 levels, 2^19 rows per level), with
   ``F.embedding_bag`` and ``index_add_`` timed on the precomputed corner
   rows as the library's gather and scatter stages, and both again on the
   NGP train step's sample positions in ray order, G6 also on the dense
   refresh's 2^21 points in cell order (G6 bitwise at each, G7 bitwise its
   plain version over two calls and within 1e-6 of the exact sum, with its
   operations counted by replay: bulk reductions, 64-bit atomics, adds in
   shared memory);
2. the serving slice: ``NGPOccTrainer`` with the full-width
   ``CPRadianceField`` (resolutions 32/128/512, rank 32, bf16), parameters
   from seed 42, four dense refreshes of the 128^3 occupancy grid, then
   ``eval_metrics`` over the procedural scene's four 320x320 test views; the
   kernels' launch counts over this phase must all be positive;
3. view 0 rendered again through the twins alone, against phase 2's image
   through the exact renderer, and through the eval renderer
   (``render_view``) on the plain versions of its kernels, against the same
   through the kernels;
4. the training slice: ``train_step`` on the train split (6 views at
   256x256, 2048 rays, a 2^18-sample budget, stratified, a dense refresh
   every 16 steps) for ``TRAIN_STEPS`` steps; the loss must halve and all
   five kernels' launch counts over this phase must be positive;
5. one train step through the kernels against the same step through the
   plain twins, from phase 4's state with the same batch and jitter, for
   the bf16 field and for an f32 field on the same parameters;
6. ``eval_metrics`` on phase 4's trained field, which must beat phase 2's
   untrained PSNR by 3 dB;
   6b. its test views through the early-stopping eval renderer and the exact
   renderer: samples a ray and seconds a frame of both, the early stop's
   own colour change within 2e-3, as is every ray whose resumed rounds emit
   its whole orbit's samples; the other rays at most 1e-3 of all, and every
   ray within 1e-2;
   6c. the same on the hard-surface scene served through its own analytic
   density, on a grid refreshed from it;
   6d. the occupancy example (``nerfacc_tpu_torch.examples.train_ngp_nerf_occ
   --field cp --device_sampler 1``) for 3200 steps, 8 a call, stopped after
   its checkpoint at 1600 (loaded back bitwise) and resumed from it: the
   controller must grow the batch past 1024 rays, the loss halve and the
   PSNR end 3 dB above phase 2's;
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
    14b. phases 12 and 14 again from the other seeds of the first
    ``SMOKE_QUALITY_SEEDS`` (three) of ``QUALITY_SEEDS``, and from all of
    them (each run in a process of its own, side by side on the card)
    with every kernel of the path (G2, G3, G5, G8-G10) on its plain version
    in training and serving: the mean trained PSNR through the kernels must
    be at most ``PSNR_MARGIN`` below the mean through the plain versions;
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
18. phase 15 on phase 16's trained fields, against phase 15's PSNR;
    18b. 14b for phases 16 and 18, G1, G3, G4, G5 and G14 on their plain
    versions;
19. the library API as the README's quick start uses it, in a user's own
    loop: the full-width bf16 CP field from seed 42 behind an
    ``OccGridEstimator`` (128^3 over +-1.5), ``QS_STEPS`` steps on phase 4's
    train split of ``update_every_n_steps`` (the sampled update from step
    ``QS_WARMUP``), ``sampling`` with a density callback and stratified
    near planes, ``rendering`` on the flattened samples, smooth L1 plus
    ``distortion`` at ``QS_DISTORTION``, and ``torch.optim.Adam``; the loss
    must fall below ``QS_LOSS_RATIO`` of its start and G1-G5 must launch;
    one step through the kernels against their plain versions (phase 5's
    bounds); view 0 through ``sampling`` + ``rendering`` against
    ``trainer.render_rays`` within 2e-3; the flat-layout scans timed
    beside G5; a loop step timed against ``NGPOccTrainer.train_step`` and a
    frame against ``render_rays``;
    19b. the proposal leg: ``PropNetEstimator`` with its own Adam over
    ``bench_prop``'s proposal field, ``QS_PROP_STEPS`` steps; the proposal
    loss must fall, G14, G3 and G5 must launch, and one step must stay
    within phase 17's bounds of its plain versions;
20. the proposal example's hash-grid path, built by its own ``build``
    (``train_ngp_nerf_prop --field ngp``: the full-width ``NGPRadianceField``
    behind one ``NGPDensityField``, 5 levels x 2^17 rows, [128] -> 64
    samples, 24 views at 320x320, 4096 rays): served untrained, trained
    ``TRAIN_STEPS`` steps through ``train_steps_sampled`` (the
    reconstruction loss must fall; G6, G7, G3, G5 and G14 must launch), one
    step through the kernels against the plain versions (phase 17's
    bounds), served trained 3 dB above untrained;
21. phase 20 for the 360 cascade (``--scene procedural360 --field cp``: the
    CP field behind two ``CPDensityField``s over the box +-1 contracted,
    [256, 96] -> 48 samples uniform in disparity, the opaque last sample,
    the unbounded scene's near 0.05 and far 20, six test views); G1, G4,
    G3, G5 and G14 must launch;
22. the occupancy example's unbounded branch, built by its own ``build``
    (``train_ngp_nerf_occ --scene procedural360 --field cp``: the bench CP
    field contracted over the box +-1, a 4 x 128^3 grid, step 1e-3, cone
    0.004, near 0.2, a 2^18 budget, the ray-batch controller from 1024
    rays): served untrained on its six test views (the grid refreshed
    ``N_REFRESH`` times), trained ``TRAIN_STEPS`` steps through its
    ``train_loop`` (``train_steps_sampled``, 8 steps a call; the loss must
    fall; G1-G5 must launch), one step through the kernels against the
    plain versions (phase 5's bounds), served trained 3 dB above untrained;
    22b. the occupancy updates past warmup: the bench CP trainer trained
    through its warmup (``warmup_steps`` steps, dense refreshes), then
    ``OCC_MODE_STEPS`` steps from that one state with the sampled update
    (``dense_occ_update=False``) and again with ``occ_refresh_stripes=4``;
    each update is made twice with the same draws, through G1 and through
    its plain version, and the two grids' binaries must be equal;
23. the dynamic example, built by its own ``build``
    (``train_mlp_tnerf --scene proceduraldynamic``: the full-width T-NeRF,
    a 4x64 warp MLP in front of the 8x256 vanilla NeRF, f32; 24 views of
    the moving-blob scene at 320x320, a 2^16 budget, the controller from
    1024 rays): served untrained, trained ``MLP_STEPS`` steps through its
    ``train_loop`` (the loss must fall; G2, G3 and G5 must launch), one
    step through the kernels against their plain versions (phase 5's f32
    bound, the plain step against itself printed beside it), served
    trained 3 dB above untrained; it prints ms/step, train samples/s, the
    ray counts and the share of rays the loss masked;
    23b. the same with ``--field kplanes`` (levels 32/64 x rank 16, bf16,
    TV 1e-3), and one dense occupancy refresh timed;
    23c. the same with ``--field tineuvox`` (G8-G10 too), no step check;
24. the vanilla example (``train_mlp_nerf --model_path P``, the 8x256
    NeRF on the translucent scene, a 2^16 budget) for ``VANILLA_STEPS``
    steps with a checkpoint at each log, stopped after the first and
    resumed from it in a second ``train_loop``: the step carries over, the
    loss keeps falling, the trained PSNR ends 3 dB above the untrained;
25. the occupancy example's other fields, each built by its ``build`` at
    full width (``--field tensorf``: lines 64/192 x 32 and tri-planes
    64/128 x 16; ``--field voxel``: grids 64/128 x 4; ``--field cp
    --plane_res 64 --plane_rank 16 --field_reg_weight 1e-3``): served
    untrained, trained ``FIELD_STEPS`` steps through its ``train_loop``
    (the loss must fall; G2, G3, G5 and for the CP-line fields G1, G4 must
    launch), one step through the kernels against the plain versions
    (phase 5's bounds), served trained 3 dB above untrained, and one dense
    refresh timed;
26. the BARF example (``train_barf``: the 8x256 vanilla NeRF with
    per-image SE(3) deltas, 320x320 views from poses perturbed by 0.05 rad
    / 0.05) for ``BARF_STEPS`` steps: the initial and final pose errors
    printed, the loss must fall and G2, G3, G5 launch; one step through the
    kernels against the plain versions (phase 5's f32 bound, the pose
    deltas' gradient included); and the pose math's precision floor
    (tests/test_pose.py:113) on the card with TF32 allowed;
27. phase 19's loop with ``VDBEstimator`` (128^3 over +-1.5; the update
    changes the touched voxels only) in place of ``OccGridEstimator``: the
    loss must fall below ``QS_LOSS_RATIO`` of its start and G1-G5 must
    launch; one step through the kernels against their plain versions
    (phase 5's bounds); on the trained grid, ``VDBEstimator`` and
    ``N3TreeEstimator`` on view 0's rays, ``traversal="windowed"`` bit for
    bit ``OccGridEstimator``'s samples over the whole orbit and
    ``"padded"`` its samples at 1024 candidates; view 0 through
    ``sampling`` + ``rendering`` against ``trainer.render_rays`` within
    2e-3; a loop step timed by ``utils.profiler.benchmark`` against the same
    step with ``OccGridEstimator``, beside phase 19's; then the loop again on
    the hard-surface scene (``proceduralopaque``), its VDB update driven by
    the scene's own density, which must disable voxels (the occupied share
    printed, below 1), and that grid's samples of the scene's view 0 held
    bit for bit to ``OccGridEstimator``'s as above;
28. the distributed layer (``nerfacc_tpu_torch.parallel``) at the bench
    widths, ranks started by ``spawn``: a) NCCL at world size 1,
    ``make_dp_train_step`` against ``train_step`` bit for bit through every
    kernel, NCCL with two ranks on one card refused; b) gloo, two ranks on the card: a
    stratified DP step against the single-process step, 200 DP steps (the
    loss must halve; ms/step, the collectives' share), a DP step through
    the kernels against the plain versions; c) gloo, four ranks on a
    (2, 2) data x model mesh: two tensor-parallel steps against the
    single-process steps, rank 16 a shard, the checkpoint round trip; d)
    the proposal DP step on two ranks; e) the dry run of
    ``dryrun_multichip(4)`` on c's four ranks;
29. the occupancy estimator's windowed and pooled entry points on phase
    4's trained bench CP field and its 128^3 grid (step 5e-3), a train
    batch of 2048 rays with its near-plane jitter: ``sampling_padded`` (the
    whole orbit's lattice, and windowed) and ``sampling_pooled`` with
    ``compact_samples_from_windows`` must emit ``sampling``'s samples (G2)
    bit for bit; ``render_rays_occgrid_pooled`` without the early stop, in
    one round, must give the exact renderer's image on those rays bit for
    bit, and with its default early stop, like ``make_cursor_eval_chunk``,
    within 2e-3 of it; G1, G2 and G3 must launch; each call timed beside
    the exact renderer;
30. the public options the port takes as the JAX package does, at full
    width: ``render_image_with_occgrid`` at JAX's defaults (1024 orbit
    candidates a ray, a 2^18 budget a chunk) on phase 4's trained field,
    view 0, through the kernels against the plain versions, the share of
    rays the window cuts printed; two ``render_rays_with_occgrid`` rounds
    carrying ``prefix_trans`` against one round, gradients through G3/G5;
    the bench CP field at hidden 128, 31 geometry features and no view
    directions trained 50 steps (the loss must fall); NGP at hidden 128;
    TiNeuVox with a 64^2 x 16 tri-plane level; and the trainer's
    ``traversal="padded"`` at 256 candidates a ray: each with a step
    through the kernels against the plain versions; G1-G10 must launch;
31. repeat: each train path trained twice from one seed in one process,
    ``REPEAT_STEPS`` steps through every kernel, with PyTorch's
    deterministic algorithms off (the bench CP trainer of phase 4,
    ``bench_prop`` of 16, NGP of 8, TiNeuVox of 12, the occupancy
    example's ``tensorf`` and ``voxel`` of 25, the dynamic example's
    K-Planes of 23b, BARF of 26 and the quick start's loop of 19): every
    parameter, the Adam moments, the occupancy grid and every step's loss
    must be equal bit for bit, else the first leaf and step that differ
    are named; each path's SHA-256 of them is printed
    (``scripts/tree_phases.py digest`` prints it for another tree).

Phase 6b classifies a ray by its sample set: the early-stop renderer's
rounds against the ray's whole orbit, the same count and every bound
within 1e-2 of a step (:func:`same_sample_sets`), and prints the worst ray
of each class.

Phase 1d holds the hat kernels G8 (forward), G9 (table gradient) and G10
(coordinate gradient) against their plain versions at N = 2^18 on each of
TiNeuVox's levels (R = 32, 128, 512), with 1% of the coordinates outside
[0, 1] and some on grid points, and G8's launch for one whole CP level
(three axes and their product, as ``CPGridEncoder(use_pallas=True)`` runs
it) bitwise beside its one-axis launches, timed against the per-axis
sequence it replaced; all timed at R = 512, rank 32, with
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
blocks of T rows at T = 512, 2^14 and 2^16, f32 and bf16, and its 16-level
NGP-shaped lookup), each run once through its entry point with the launch
counts zeroed before, then held bitwise against its plain version and timed
beside the one PyTorch call that computes the same function (CUDA events,
device time alone, and host microseconds per call); each G12 line names the
route its table took.  Phase 1f holds G14
(importance sampling) bitwise against its plain version at the proposal
path's shapes and the 360 cascade's three (E = 2 -> 256, 257 -> 96,
97 -> 48); phase 1c also G6 (bitwise) and G7 at ``NGPDensityField``'s
shape (5 levels, T = 2^17) on both proposal paths' first-level points, G7
bitwise its plain version over two calls and within 1e-6 of the exact
sum's largest entry, and phase 1 G1 at the 360 cascade's first level (N = 2^20).
Phase 1 also holds G2 bitwise against its plain version on a train batch
of phase 22's unbounded configuration (``G2_TRAIN_RAYS`` rays, 4 levels,
step 1e-3, cone 0.004, near 0.2 + jitter * step) and times it there.

With ``--quality tineuvox prop [--seeds ...] [--routes kernels plain
plain:<kernel>,...] [--root DIR] [--label NAME] [--out DIR]`` the script
only trains and serves those paths as phases 12-14 and 16-18 do, from each
seed, through each route (the kernels; every kernel of the path on its
plain version; the named kernels alone on theirs), on this checkout or on
the tree ``--root`` names (an older commit unpacked by ``git archive`` into
a git-ignored directory), and prints one JSON line a run.  With ``--example cp|ngp|occ360 [--steps N] [--seeds
...]`` it runs the occupancy example alone from each seed (``--field cp``,
``--field ngp``, ``--scene procedural360 --field cp``; ``--max_steps N``,
its defaults otherwise) and prints one JSON line a run: PSNR, SSIM, steps,
training seconds, train samples/s, ray counts, samples a step, and both
renderers' frames.
With ``--example tensorf|voxel|cp-planes|barf [--steps N] [--seeds ...]
[--routes kernels plain ...]`` it runs phase 25's or 26's example alone
from each seed through each route, one JSON line a run: PSNR, SSIM,
ms/step, train samples/s, the losses, seconds a frame and, for BARF, the
pose errors.
With ``--example tnerf|kplanes|tineuvox|mlp-nerf [--steps N] [--seeds ...]
[--routes kernels plain ...]`` it runs the dynamic example (``--field``, on
the moving-blob scene, TiNeuVox at ``--lr 5e-3``) or the vanilla example
alone from each seed through each route, one JSON line a run: PSNR, SSIM,
training seconds, ms/step, train samples/s, ray counts, the masked share
and seconds a frame.
With ``--example prop-cp|prop-ngp|prop360 [--steps N] [--seeds ...]
[--routes kernels plain ...]`` it runs the proposal example alone
(``--field cp``, ``--field ngp``, ``--scene procedural360``) from each seed
through each route, one JSON line a run: PSNR, SSIM, training seconds,
train samples/s, the losses and seconds a frame.

Every check raises on failure, so the exit code is nonzero and the result
line is not printed.  The last line of standard output is a JSON object with
``"ok": true`` and the device; the line before it lists each kernel's launch
count (over the training phases 4, 6d, 8, 12, 16, 19, 20, 21, 22, 23-23c,
24, 25, 26, 27, 28 and 31, every rank of 28, and the paths of 29 and 30; for
G11-G13, over
the gather probe's run), error, times and bound.  Without a CUDA device the
script fails at once.
"""
import argparse
import contextlib
import copy
import dataclasses
import hashlib
import importlib
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import nerfacc_tpu_torch  # noqa: E402
from nerfacc_tpu_torch import cuda  # noqa: E402
from nerfacc_tpu_torch.cuda import _build  # noqa: E402
from nerfacc_tpu_torch.data.procedural import (  # noqa: E402
    ProceduralDynamicSceneLoader,
    ProceduralOpaqueSceneLoader,
    ProceduralSceneLoader,
)
from nerfacc_tpu_torch import pdf  # noqa: E402
from nerfacc_tpu_torch.data.device_sampler import DeviceRaySampler  # noqa: E402
from nerfacc_tpu_torch.estimators.occ_grid import (  # noqa: E402
    init_occ_grid,
    update_occ_grid,
)
from nerfacc_tpu_torch.estimators.prop_net import (  # noqa: E402
    get_proposal_requires_grad_fn,
)
from nerfacc_tpu_torch.grid import march, march_plain  # noqa: E402
from nerfacc_tpu_torch.models.cp_field import CPDensityField  # noqa: E402
from nerfacc_tpu_torch.models.encoders import HashGridEncoder  # noqa: E402
from nerfacc_tpu_torch.models.ngp import NGPDensityField, normalize_points  # noqa: E402
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
    hat_level_fwd,
    hat_level_plain,
    hat_taps,
)
from nerfacc_tpu_torch.ops import sorted_segments  # noqa: E402
from nerfacc_tpu_torch.ops.lane_gather import (  # noqa: E402
    lane_gather,
    lane_gather_plain,
    lane_gather_route,
)
from nerfacc_tpu_torch.ops.row_gather import row_gather, row_gather_plain  # noqa: E402
from nerfacc_tpu_torch.ops.sorted_segments import (  # noqa: E402
    composite_sorted,
    composite_sorted_backward,
    composite_sorted_backward_plain,
    composite_sorted_plain,
)
from nerfacc_tpu_torch.trainers.ngp_occ import (  # noqa: E402
    EVAL_WINDOW,
    NGPOccTrainer,
    TrainState,
)
from nerfacc_tpu_torch.trainers.ngp_prop import PropTrainState  # noqa: E402
from nerfacc_tpu_torch.utils import flops  # noqa: E402
from nerfacc_tpu_torch.utils.checkpoint import load_checkpoint  # noqa: E402
from nerfacc_tpu_torch.utils.rendering import (  # noqa: E402
    compact_samples,
    render_image_with_occgrid,
    render_rays_occgrid_test,
)
from nerfacc_tpu_torch.volrend import render_transmittance_from_density  # noqa: E402

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
# Phases 6b and 6c: the early-stop renderer's colours against the exact
# renderer's.  A ray retired at opacity 1 - eps misses at most eps of its
# colour, and the background it then blends in differs by at most 1.  A
# round resumes its orbit from the last round's termination plane, which
# moves the candidates by rounding: one that crosses a voxel face adds or
# drops a sample of alpha up to the occupancy threshold (~1e-2), as in the
# JAX renderer.  Such rays are counted against FLIP_ALLOWANCE, and their
# colours held to RENDERER_FLIP_COLOUR_ERR: the candidate that moves lies in a
# cell at the grid's edge, whose refreshed density x step is near the
# occupancy threshold 1e-2, so it adds or drops a sample of alpha ~1e-2 (the
# worst ray read 8.27e-3 over six runs of 6b and 6c on an H100, PERF.md §6).
RENDERER_COLOUR_ERR = 2e-3
RENDERER_FLIP_COLOUR_ERR = 1e-2
# Phase 6d: the occupancy example (nerfacc_tpu_torch.examples.train_ngp_nerf_occ)
# run as a user runs it, stopped after its checkpoint at EXAMPLE_CKPT and
# resumed from it: EXAMPLE_STEPS steps in all, 8 a call.  The untrained
# field occupies every cell, and the refresh's EMA (x0.95 every 16 steps)
# takes tens of refreshes to clear one: over 320 steps the demand stayed
# above the budget and the controller at 1024 rays on an H100 (PERF.md
# §6), so the run is long enough for the grid to clear and the batch to grow.
EXAMPLE_STEPS, EXAMPLE_CKPT, EXAMPLE_CALL = 3200, 1600, 8  # multiples of a call
TRAIN_STEPS = 1000  # not a multiple of the refresh interval: phase 5's step
# Phase 5: each gradient leaf of a kernel step against the twin step, by
# relative Frobenius norm, worst of STEP_REPEATS runs.  f32: only the order of
# the sums differs, a kernel's against its plain version's (readings up to
# 2.5e-5 on an H100 when the kernels summed by atomics, PERF.md §6).
# bf16: the field rounds each MLP weight gradient to bf16 last, so order-only
# differences of ~1e-5 flip a few entries by one bf16 ulp, which is at most
# 2^-7 of the entry: a leaf reads below 2^-7 = 7.8e-3 even if every entry
# flipped, and read 1.3e-4 to 8.5e-4 on an H100.  Lost bf16 roundings read
# >= 2.2e-2 (the twins' f32 field against their bf16 field, printed), a
# detached gradient ~1.  The kernels' own roundings are held elementwise in
# phase 1b.
# An f32 TiNeuVox field is not f32 throughout: its hat kernels round the
# cotangent g to bf16 (the TPU kernels' contract), so last-bit differences
# upstream (G3 and G5 against their plain versions) flip a few of those
# roundings and move the
# deformation leaves, whose only signal is G10's: the plain step against
# itself reads up to 3.8e-5, the kernel step up to 1.3e-4 on an H100
# (PERF.md §6), hence F32_HAT_STEP_FRO.  With the composite on its plain
# versions and fixed-order scatter-adds the hat kernels see the plain
# step's cotangents bit for bit, and that step read 1.6e-7 (G9's summation
# order and G10's rank sums): HAT_ALONE_STEP_FRO.
STEP_REPEATS = 8
# Phases 14b and 18b: the TiNeuVox and proposal paths trained from each of
# QUALITY_SEEDS through their kernels (phases 12 and 16 are the first seed's
# run) and through the plain versions of their kernels; the kernel route's
# mean trained PSNR may fall at most PSNR_MARGIN below the plain route's.
# One run is no measure: by seed and by last-bit differences the TiNeuVox
# run ends anywhere in 17.7-21.9 dB (most near 18.3 or 21.3), and before
# G4 summed in a fixed order the proposal path's PSNR moved ~1.4 dB a seed
# from call to call.  Each route repeats from call to call (phase 31; on the
# TiNeuVox path the plain route runs PyTorch's scatter-adds in a fixed
# order, :func:`quality_run`), but a kernel and its plain version still
# round differently, and one seed's run amplifies that.  Across three seeds
# each route's PSNR spread over 0.8-1.9 dB on an H100 (PERF.md §6); 1.5 dB
# between the means of three is ~2 standard errors of their difference,
# and a kernel that cost every seed ~3 dB would fail it.  The default run
# takes the first SMOKE_QUALITY_SEEDS of them, all three; ``--quality``
# takes every seed it is given.
QUALITY_SEEDS = (42, 7, 1234)  # the first is the trainers' default
SMOKE_QUALITY_SEEDS = 3
PSNR_MARGIN = 1.5
F32_STEP_FRO = 1e-4
F32_HAT_STEP_FRO = 5e-4
HAT_ALONE_STEP_FRO = 1e-5
BF16_STEP_FRO = 5e-3
# the eval renderer's rounds and early stop at the trainer's defaults:
# max_samples_per_ray // 32 rounds, a ray retired past 1 - max(eps, 1e-4)
EVAL_MAX_ROUNDS = NGPOccTrainer.max_samples_per_ray // 32
EVAL_EARLY_STOP_EPS = max(NGPOccTrainer.early_stop_eps, 1e-4)
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
# Phase 21: the proposal example's 360 cascade, [256, 96] -> 48 samples
PROP360_COUNTS = (256, 96, 48)
# Phases 1 and 22: the occupancy example's unbounded branch; 22b: steps of
# each occupancy-update mode past warmup
OCC360_ARGS = ["--scene", "procedural360", "--field", "cp"]
OCC_MODE_STEPS = 64
# the kernels the TiNeuVox path launches
PATH_KERNELS_TINEUVOX = ("march", "composite_fwd", "composite_bwd", "hat_fwd",
                         "hat_bwd_line", "hat_bwd_x")
# Phases 23-24: the dynamic example (nerfacc_tpu_torch.examples.train_mlp_tnerf)
# per field, at its full widths on the moving-blob scene, and the vanilla
# example (train_mlp_nerf); --example tnerf|kplanes|tineuvox|mlp-nerf runs
# them alone.  Each loop ends at the first multiple of its 8-step calls past
# --max_steps, so --max_steps is one call short of the steps wanted.
MLP_CALL = 8
MLP_STEPS = {"tnerf": 504, "kplanes": 504, "tineuvox": 504}
# field -> the example's flags and the kernels its path launches; --example
# adds MLP_EXAMPLE_FLAGS (TiNeuVox at the lr of the TPU v5e's quality rows,
# docs/benchmarks.md:100-101)
MLP_PATHS = {
    "tnerf": ([], ("march", "composite_fwd", "composite_bwd")),
    "kplanes": (["--field", "kplanes"], ("march", "composite_fwd", "composite_bwd")),
    "tineuvox": (["--field", "tineuvox"], PATH_KERNELS_TINEUVOX),
    "mlp-nerf": ([], ("march", "composite_fwd", "composite_bwd")),
}
MLP_EXAMPLE_FLAGS = {"tineuvox": ["--lr", "5e-3"]}
VANILLA_STEPS, VANILLA_LOG = 600, 300  # phase 24: a checkpoint at each log
# Phase 25 and --example tensorf|voxel|cp-planes: the occupancy example's
# other fields (its flags; the kernels their training launches).  Each run
# ends at the first multiple of its 8-step calls past --max_steps, one call
# short of FIELD_STEPS, which is no multiple of the refresh interval: the
# step checked against the plain versions does not refresh.
CP_PATH_KERNELS = ("cp_level_fwd", "cp_level_bwd", "march", "composite_fwd", "composite_bwd")
OCC_FIELD_PATHS = {
    "tensorf": (["--field", "tensorf"], CP_PATH_KERNELS),
    "voxel": (["--field", "voxel"], ("march", "composite_fwd", "composite_bwd")),
    "cp-planes": (["--field", "cp", "--plane_res", "64", "--plane_rank", "16",
                   "--field_reg_weight", "1e-3"], CP_PATH_KERNELS),
}
FIELD_STEPS = 408
# Phase 26 and --example barf: the BARF example (examples.train_barf) at
# its 320x320 procedural scene from poses perturbed by 0.05 rad / 0.05;
# BARF_STEPS is a multiple of its 8-step calls and no multiple of the
# refresh interval, past the poses' unfreezing at BARF_STEPS // 4.
BARF_STEPS = 312
BARF_KERNELS = ("march", "composite_fwd", "composite_bwd")


# Phase 28: the distributed layer.  Every rank's budget holds the whole
# train batch's samples (the bench's 2048 rays march ~0.9M), so no rank cuts.
DIST_BUDGET = 2**20
DIST_STEPS = 20
DIST_TRAIN_STEPS = 200
DIST_TIMEOUT = 600
DIST_KERNELS = ("cp_level_fwd", "cp_level_bwd", "march", "composite_fwd", "composite_bwd")
DIST_PROP_KERNELS = ("cp_level_fwd", "cp_level_bwd", "composite_fwd", "composite_bwd",
                     "importance_sampling")
# The least time the card could take for a kernel's work: the bytes the
# function must move over the H100's memory rate, or
# its f32 operations over the f32 peak outside the tensor cores, whichever
# is larger.  Operations are counted from the kernel's arithmetic per item
# (a fused multiply-add counts two), a lower count of the work.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# field kind -> the module and class of its full-width field
FIELDS = {
    "cp": ("models.cp_field", "CPRadianceField"),
    "ngp": ("models.ngp", "NGPRadianceField"),
    "tineuvox": ("models.tineuvox", "TiNeuVoxRadianceField"),
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
    # a profile that recorded fewer device events than calls lost some of
    # them (seen on the card): take it again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if len(kernels) >= reps:
            break
    us = sum(e.time_range.end - e.time_range.start for e in kernels)
    return us / reps / 1e3


def host_us(fn, reps=20):
    """Host microseconds per call of ``fn``: its launch path, timed by
    ``time.perf_counter`` over ``reps`` calls with no sync among them."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / reps


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


def cp_taps(u, lines):
    """The library's stages of a CP level on (N, 3) coordinates in [0, 1]:
    the two taps and lerp weights of each point on each axis, as rows of
    the three axes' stacked (3R, rank) table: (3N, 2) rows, (3N, 2)
    weights, the table."""
    R = lines.shape[1]
    x = u.t().reshape(-1) * (R - 1)
    i0 = torch.floor(x).clamp(0, R - 2)
    f = x - i0
    axis = torch.arange(3, device=u.device).repeat_interleave(u.shape[0])
    rows = (i0.long() + axis * R)[:, None] + torch.tensor([0, 1], device=u.device)
    return rows, torch.stack([1.0 - f, f], dim=1), lines.reshape(3 * R, -1)


def cp_library_ms(u, lines, cot):
    """One PyTorch call a stage of G1 and of G4 on these inputs (CUDA
    events): ``F.embedding_bag`` over the precomputed taps (G1's gather
    stage, the three axes' lerps) and ``index_add_`` of the precomputed
    per-tap updates into the (3R, rank) table gradient (G4's scatter
    stage)."""
    rows, w, table = cp_taps(u, lines)
    gather = cuda_ms(lambda: F.embedding_bag(rows, table, mode="sum",
                                             per_sample_weights=w))
    upd = (w[:, :, None] * cot.repeat(3, 1)[:, None, :]).reshape(-1, cot.shape[1])
    acc = torch.zeros_like(table)
    flat = rows.reshape(-1)
    scatter = cuda_ms(lambda: acc.index_add_(0, flat, upd))
    return gather, scatter


def port_module(name):
    """``nerfacc_tpu_torch.<name>`` of the tree imported now: this
    checkout's, or the one ``--quality --root`` names.  The trainers, fields
    and loaders are looked up through it at call time."""
    return importlib.import_module(f"nerfacc_tpu_torch.{name}")


def make_trainer(dev, kind="cp", dtype=torch.bfloat16, timestamps=None, **kw):
    """The field of ``kind`` in a trainer with its settings; a dynamic
    field's refresh draws from the training frames' ``timestamps``."""
    module, name = FIELDS[kind]
    return port_module("trainers.ngp_occ").NGPOccTrainer(
        field=getattr(port_module(module), name)(AABB, compute_dtype=dtype), aabb=AABB,
        device=dev, timestamps=timestamps, **TRAIN[kind][0], **kw,
    )


def make_prop_trainer(dev, dtype=torch.bfloat16, **kw):
    """``bench.py``'s proposal configuration: the full-width CP radiance
    field and one CPDensityField (16/64 x rank 16, hidden 64) in a compute
    dtype, 128 proposal and 64 final samples, near 2, far 6, uniform."""
    fields = port_module("models.cp_field")
    return port_module("trainers.ngp_prop").NGPPropTrainer(
        field=fields.CPRadianceField(AABB, compute_dtype=dtype),
        prop_fields=[fields.CPDensityField(AABB, compute_dtype=dtype)],
        prop_samples=[PROP_SAMPLES], num_samples=PROP_FINAL, near_plane=2.0,
        far_plane=6.0, device=dev, **kw,
    )


def train_loader(dev, kind, seed=QUALITY_SEEDS[0]):
    """The train split of ``kind`` ("prop": the proposal path's) scene, its
    batches drawn from ``seed``."""
    procedural = port_module("data.procedural")
    if kind == "tineuvox":
        return procedural.ProceduralDynamicSceneLoader(
            split="train", num_rays=TRAIN[kind][1], seed=seed, device=dev
        )
    rays = PROP_RAYS if kind == "prop" else TRAIN[kind][1]
    return procedural.ProceduralSceneLoader(
        split="train", n_train=6, width=256, height=256, num_rays=rays, seed=seed,
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

    # G2 with a window, as the eval renderer runs it: rounds of EVAL_WINDOW
    # candidates over the eval chunk from near 0, each round from the last
    # one's termination planes with the rays not yet terminated, each
    # bitwise against march_plain; timed on the round with the most samples.
    # Each round's samples are composited by G3 behind the opacity of the
    # rounds before (prefix_trans = 1 - opacity), with seeded densities and
    # colours, as the eval renderer composites them
    alive = torch.ones(G2_RAYS, dtype=torch.bool, device=dev)
    opacity = torch.zeros(G2_RAYS, device=dev)
    near_w, rounds = near, []
    while len(rounds) < EVAL_MAX_ROUNDS and bool(alive.any()):
        wargs = (o, d, occ.binaries, occ.aabbs, near_w, far, trainer.render_step_size,
                 0.0, alive)
        wout = march(*wargs, max_samples=EVAL_WINDOW)
        wref = march_plain(*wargs, max_samples=EVAL_WINDOW)
        require(all(torch.equal(a, b) for a, b in zip(wout, wref)),
                f"G2 windowed, round {len(rounds)}: differs from march_plain")
        ws = compact_samples(wout)
        pargs = (ws.t_starts, ws.t_ends,
                 10.0 ** (torch.rand(ws.num_valid, generator=g, device=dev) * 4 - 1),
                 torch.rand((ws.num_valid, 3), generator=g, device=dev), ws.ray_indices,
                 G2_RAYS, ws.seg_starts, ws.seg_ends, (1.0 - opacity).contiguous())
        rounds.append((wout.ray_indices.shape[0], wargs, wout, pargs))
        if ws.num_valid:
            opacity = opacity + composite_sorted(*pargs)[1][:, 0]
        alive = alive & ~wout.terminated
        near_w = wout.termination_planes
    n_w, wargs, wout, pargs = max(rounds, key=lambda r: r[0])
    window = measured(
        0.0, cuda_ms(lambda: march(*wargs, max_samples=EVAL_WINDOW)),
        cuda_ms(lambda: march_plain(*wargs, max_samples=EVAL_WINDOW)),
        nbytes(*wargs, *wout), 15 * n_w,
    )
    print(f"G2 march windowed: {len(rounds)} rounds of {EVAL_WINDOW} candidates over the "
          f"{G2_RAYS}-ray eval chunk (near 0), samples per round "
          f"{[r[0] for r in rounds]}, every round bitwise equal to march_plain; the "
          f"busiest round: kernel {window['ms']:.4f} ms, alone "
          f"{device_ms(lambda: march(*wargs, max_samples=EVAL_WINDOW)):.4f} ms, bound "
          f"{window['bound_ms']:.4f} ms ({window['bound_by']}), plain "
          f"{window['plain_ms']:.4f} ms")
    # G3 on the busiest round's samples, behind the earlier rounds' opacity
    pc, pa, pdep, _ = composite_sorted(*pargs)
    rc, ra, rdep, _ = composite_sorted_plain(*pargs)
    p_err = max(float((pc - rc).abs().max()), float((pa - ra).abs().max()))
    p_dep_err = float((pdep - rdep).abs().max())
    prefix = pargs[-1]
    print(f"G3 composite, the busiest windowed round ({n_w} samples) behind the earlier "
          f"rounds' opacity (prefix_trans in [{float(prefix.min()):.4g}, "
          f"{float(prefix.max()):.4g}], {int((prefix < 1).sum())} of {G2_RAYS} rays below "
          f"1): rgb/opacity max_abs_err={p_err:.3g}, depth {p_dep_err:.3g}, kernel "
          f"{cuda_ms(lambda: composite_sorted(*pargs)):.4f} ms, plain "
          f"{cuda_ms(lambda: composite_sorted_plain(*pargs)):.4f} ms")
    require(p_err <= 1e-5, f"G3 with prefix_trans: rgb/opacity differ by {p_err}")
    require(p_dep_err <= 1e-4, f"G3 with prefix_trans: depth differs by {p_dep_err}")

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
    # it sums in fixed point: two calls and the plain version bit for bit
    worst, g4_ms, g4_plain_ms = 0.0, None, None
    cot = torch.randn((G1_N, 32), generator=g, device=dev)
    for line in trainer.field.encoder.lines:
        R = line.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            out, ref = held_bitwise(f"G4 R={R} {dtype}",
                                    lambda: cp_level_backward(u, cot, line, dtype),
                                    lambda: cp_level_backward_plain(u, cot, line, dtype))
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            ms = cuda_ms(lambda: cp_level_backward(u, cot, line, dtype))
            plain = cuda_ms(lambda: cp_level_backward_plain(u, cot, line, dtype))
            print(f"G4 cp_level_bwd R={R} {str(dtype)[6:]}: max_abs_err={err:.3g} "
                  f"(scale {scale:.3g}), two calls and the plain version bitwise equal, "
                  f"kernel {ms:.4f} ms, alone "
                  f"{device_ms(lambda: cp_level_backward(u, cot, line, dtype)):.4f} ms, twin "
                  f"{plain:.4f} ms")
            worst = max(worst, err)
            if R == 512 and dtype == torch.bfloat16:
                g4_ms, g4_plain_ms, g4_bytes = ms, plain, nbytes(u, cot, line, out)
    # per point three cell weights; per point, rank and axis the product of
    # the other two axes' lerps and two weighted taps
    g1_lib, g4_lib = cp_library_ms(u, trainer.field.encoder.lines[-1], cot)
    report["cp_level_bwd"] = measured(
        worst, g4_ms, g4_plain_ms, g4_bytes, G1_N * (9 + 32 * 3 * 4), g4_lib
    )
    report["cp_level_fwd"]["library_ms"] = g1_lib
    print(f"G1 / G4 at R=512, rank 32, N={G1_N}: F.embedding_bag on the precomputed "
          f"taps (the gather stage) {g1_lib:.4f} ms, index_add_ of the precomputed "
          f"per-tap updates (the scatter stage) {g4_lib:.4f} ms")

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
        held_bitwise(f"G4 ray order (16, 16) {dtype}",
                     lambda: cp_level_backward(u_prop, cot_prop, lines_prop, dtype),
                     lambda: cp_level_backward_plain(u_prop, cot_prop, lines_prop, dtype))
        print(f"G4 cp_level_bwd, proposal field's coordinates in ray order, N = "
              f"{u_prop.shape[0]}, (R, rank) = (16, 16), {str(dtype)[6:]}: two calls and "
              f"the plain version bitwise equal, kernel "
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
    # and the 360 cascade's first proposal level (phase 21): PROP_RAYS rays
    # x 256 samples, contracted and clamped as CPDensityField maps them
    u_360 = proposal_points(dev, g, "360").clamp(0.0, 1.0).contiguous()
    levels += [("360 cascade's first proposal level", u_360,
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


def g7_operations(x, resolutions, table_size):
    """G7's operations on ``x`` by its replay, as one phrase."""
    ops = port_module("ops.hash_encode").hash_bwd_operations(x, resolutions, table_size)
    return (f"{ops['bulk_32'] + ops['bulk_16'] + ops['atomics']} global operations by replay "
            f"({ops['bulk_32']} 32-byte and {ops['bulk_16']} 16-byte bulk reductions, "
            f"{ops['atomics']} 64-bit atomics; {ops['shared']} adds in shared memory)")


def exact_table_grad(x, cot, table_shape, resolutions):
    """G7's function summed exactly enough (f64) from the f32 products
    ``w_c * cot`` it adds."""
    L, T, F = table_shape
    idx, w = hash_corners_plain(x, resolutions, T)
    rows = (idx + T * torch.arange(L, device=x.device)[None, :, None]).reshape(-1)
    upd = (w[..., None] * cot.reshape(-1, L, 1, F)).reshape(-1, F)
    exact = torch.zeros((L * T, F), dtype=torch.float64, device=x.device)
    return exact.index_add_(0, rows, upd.double()).reshape(L, T, F)


def proposal_points(dev, g, config):
    """The encoder coordinates (unclamped) of a proposal path's first-level
    points, in ray order, as its density field maps them:
    "bounded", ``PROP_RAYS`` train rays of the bounded scene x
    ``PROP_SAMPLES`` stratified samples uniform over [2, 6], scaled to the
    box +-1.5 (N = 2^19); "360", ``PROP_RAYS`` rays of the unbounded scene
    x ``PROP360_COUNTS[0]`` stratified samples uniform in disparity over its
    near and far planes, contracted over the box +-1 (N = 2^20)."""
    procedural = port_module("data.procedural")
    if config == "bounded":
        ds = procedural.ProceduralSceneLoader(split="train", n_train=6, width=256, height=256,
                                              num_rays=PROP_RAYS, device=dev)
        n, aabb, unbounded = PROP_SAMPLES, AABB, False
    else:
        ds = procedural.ProceduralUnboundedSceneLoader(split="train", n_train=2, width=64,
                                                       height=64, num_rays=PROP_RAYS, device=dev)
        n, aabb, unbounded = PROP360_COUNTS[0], [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], True
    rays = ds[0]
    s = (torch.arange(n, device=dev) + torch.rand((PROP_RAYS, n), generator=g, device=dev)) / n
    if unbounded:
        t = 1.0 / (s / ds.FAR + (1.0 - s) / ds.NEAR)
    else:
        t = ds.NEAR + s * (ds.FAR - ds.NEAR)
    pts = (rays["rays_o"][:, None] + t[..., None] * rays["rays_d"][:, None]).reshape(-1, 3)
    return normalize_points(pts, torch.tensor(aabb, device=dev), unbounded)[0].contiguous()


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

    # G6: the plain version rounds each fused multiply-add once, as the
    # kernel does, so the two are bitwise equal
    out = hash_encode_forward(x, table, res)
    ref = hash_encode_plain(x, table, res)
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    unequal = int((out != ref).sum())
    require(unequal == 0, f"G6: {unequal} entries unequal, err {err} scale {scale}")
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
          f"{r['ms']:.4f} ms, alone "
          f"{device_ms(lambda: hash_encode_forward(x, table, res)):.4f} ms, "
          f"twin {r['plain_ms']:.4f} ms; {touched} table rows "
          f"touched, bound {r['bound_ms']:.4f} ms; embedding_bag on the "
          f"precomputed rows (gather stage only) {r['library_ms']:.4f} ms, "
          f"max_abs_err {bag_err:.3g}")

    # G7: it sums in fixed point: two calls and the plain version bit for
    # bit, within 1e-6 of the largest entry of the exact (f64) sum
    out, ref = held_bitwise("G7", lambda: hash_encode_backward(x, cot, (L, T, 2), res),
                            lambda: hash_encode_backward_plain(x, cot, (L, T, 2), res))
    exact = exact_table_grad(x, cot, (L, T, 2), res)
    err, scale = float((out - exact).abs().max()), float(exact.abs().max())
    require(err <= 1e-6 * scale, f"G7: err {err} from the exact sum, scale {scale}")
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
    print(f"G7 hash_bwd N={HASH_N} L={L} T={T}: two calls and the plain version bitwise "
          f"equal, max_abs_err={err:.3g} from the exact sum (scale {scale:.3g}), kernel "
          f"{r['ms']:.4f} ms, alone "
          f"{device_ms(lambda: hash_encode_backward(x, cot, (L, T, 2), res)):.4f} ms, "
          f"twin {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms; index_add_ on "
          f"the precomputed rows and updates (scatter stage only) "
          f"{r['library_ms']:.4f} ms, alone "
          f"{device_ms(lambda: acc.index_add_(0, rows.reshape(-1), upd)):.4f} ms; "
          f"{g7_operations(x, res, T)}")

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
    # G6 on those positions and on the dense refresh's points, one jittered
    # point per cell of the 128^3 grid in the refresh's cell order
    ids = torch.arange(128**3, device=dev)
    cells = torch.stack([ids // 128**2, (ids // 128) % 128, ids % 128], -1).float()
    x_refresh = (cells + torch.rand((128**3, 3), generator=g, device=dev)) / 128
    for what, xs in (("NGP train step's positions in ray order", x_ray),
                     ("dense refresh's points in cell order", x_refresh)):
        out = hash_encode_forward(xs, table, res)
        unequal = int((out != hash_encode_plain(xs, table, res)).sum())
        require(unequal == 0, f"G6 on the {what}: {unequal} entries unequal")
        print(f"G6 hash_fwd, {what}, N={xs.shape[0]}: {unequal} of {out.numel()} entries "
              f"unequal, kernel {cuda_ms(lambda: hash_encode_forward(xs, table, res)):.4f} "
              f"ms, alone {device_ms(lambda: hash_encode_forward(xs, table, res)):.4f} ms, "
              f"bound {bound_ms(nbytes(xs, out), 0):.4f} ms (x and the output alone)")
    del x_refresh, out
    out, _ = held_bitwise(
        "G7 ray order", lambda: hash_encode_backward(x_ray, cot_ray, (L, T, 2), res),
        lambda: hash_encode_backward_plain(x_ray, cot_ray, (L, T, 2), res))
    exact = exact_table_grad(x_ray, cot_ray, (L, T, 2), res)
    err, scale = float((out - exact).abs().max()), float(exact.abs().max())
    require(err <= 1e-6 * scale, f"G7 ray order: err {err} from the exact sum, scale {scale}")
    level0 = hash_corners_plain(x_ray, res[:1], T)[0][:, 0, 0]
    same = float((level0[1:] == level0[:-1]).float().mean())
    print(f"G7 hash_bwd, NGP train step's positions in ray order, N={x_ray.shape[0]} "
          f"({same:.3f} of samples on the previous sample's level-0 row): two calls and "
          f"the plain version bitwise equal, {err / scale:.3g} of the largest entry from "
          f"the exact sum, kernel "
          f"{cuda_ms(lambda: hash_encode_backward(x_ray, cot_ray, (L, T, 2), res)):.4f} ms, "
          f"alone "
          f"{device_ms(lambda: hash_encode_backward(x_ray, cot_ray, (L, T, 2), res)):.4f} ms, "
          f"bound {bound_ms(nbytes(x_ray, cot_ray, out), 0):.4f} ms; "
          f"{g7_operations(x_ray, res, T)}")

    # G6 and G7 at the proposal field's shape (NGPDensityField: 5 levels,
    # one more than a multiple of G6's group of 4, T = 2^17; phase 20) on
    # the bounded path's first proposal level (N = 2^19) and the 360
    # cascade's (N = 2^20) in ray order, an O(1) table: G6 bitwise; G7
    # bitwise its plain version and within 1e-6 of the largest entry of the
    # exact sum, where the contracted far samples pile thousands of terms
    # onto a row
    enc = NGPDensityField(AABB).encoder
    L, T, res = enc.n_levels, enc.table_size, enc.resolutions
    table = torch.rand((L, T, 2), generator=g, device=dev) * 2.0 - 1.0
    for config in ("bounded", "360"):
        xs = proposal_points(dev, g, config)
        cot = torch.randn((xs.shape[0], 2 * L), generator=g, device=dev)
        out = hash_encode_forward(xs, table, res)
        unequal = int((out.view(torch.int32) != hash_encode_plain(xs, table, res).view(
            torch.int32)).sum())
        require(unequal == 0, f"G6 proposal field {config}: {unequal} entries unequal")
        grad, _ = held_bitwise(
            f"G7 proposal field {config}", lambda: hash_encode_backward(xs, cot, (L, T, 2), res),
            lambda: hash_encode_backward_plain(xs, cot, (L, T, 2), res))
        exact = exact_table_grad(xs, cot, (L, T, 2), res)
        err, scale = float((grad - exact).abs().max()), float(exact.abs().max())
        require(err <= 1e-6 * scale, f"G7 proposal field {config}: err {err} from the exact "
                                     f"sum, scale {scale}")
        idx = hash_corners_plain(xs, res, T)[0]
        touched = int(torch.unique(idx + T * torch.arange(L, device=dev)[None, :, None]).numel())
        fwd = measured(0.0, cuda_ms(lambda: hash_encode_forward(xs, table, res)),
                       cuda_ms(lambda: hash_encode_plain(xs, table, res)),
                       nbytes(xs, out) + touched * 2 * 4, xs.shape[0] * L * (9 + 19 + 32))
        bwd = measured(err, cuda_ms(lambda: hash_encode_backward(xs, cot, (L, T, 2), res)),
                       cuda_ms(lambda: hash_encode_backward_plain(xs, cot, (L, T, 2), res)),
                       nbytes(xs, cot, grad), xs.shape[0] * L * (9 + 19 + 16))
        print(f"G6 hash_fwd, proposal field ({config} path's first level in ray order), "
              f"N={xs.shape[0]} L={L} T={T}: {unequal} of {out.numel()} entries unequal, "
              f"kernel {fwd['ms']:.4f} ms, alone "
              f"{device_ms(lambda: hash_encode_forward(xs, table, res)):.4f} ms, plain "
              f"{fwd['plain_ms']:.4f} ms, bound {fwd['bound_ms']:.4f} ms ({touched} rows "
              f"touched); G7 hash_bwd bitwise its plain version over two calls, "
              f"{err / scale:.3g} of the largest entry from the exact sum, kernel "
              f"{bwd['ms']:.4f} ms, alone "
              f"{device_ms(lambda: hash_encode_backward(xs, cot, (L, T, 2), res)):.4f} ms, "
              f"plain {bwd['plain_ms']:.4f} ms, bound {bwd['bound_ms']:.4f} ms; "
              f"{g7_operations(xs, res, T)}")
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

    # G8's launch for one CP level, at each level: three axes' coordinates
    # drawn as above, the product bitwise against the per-axis plain
    # composition, the axes it keeps for the backward bitwise against the
    # one-axis launches, timed against the per-axis sequence the encoder ran
    # before (three column copies, three one-axis launches, two products)
    for R, rank in HAT_LEVELS:
        x3 = torch.stack([hat_inputs(g, R, rank)[0] for _ in range(3)], dim=1)
        lines3 = 1.0 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev)
        ref, ref_axes = hat_level_plain(x3, lines3)
        prod, axes = hat_level_fwd(x3, lines3, True)
        unequal = int((prod != ref).sum()) + int((axes != ref_axes).sum())
        unequal += int((hat_level_fwd(x3, lines3, False)[0] != ref).sum())
        for i in range(3):
            unequal += int((hat_fwd(x3[:, i], lines3[i]) != axes[i]).sum())
        require(unequal == 0, f"G8 level R={R}: {unequal} entries differ")

        def per_axis():
            prod = hat_fwd(x3[:, 0], lines3[0])
            for i in (1, 2):
                prod = prod * hat_fwd(x3[:, i], lines3[i])
            return prod

        level_ms = device_ms(lambda: hat_level_fwd(x3, lines3, False))
        print(f"G8 one CP level R={R} rank={rank} N={HAT_N}: 0 of {4 * prod.numel()} "
              f"entries unequal (product and axes; the one-axis launches agree); one "
              f"launch alone {level_ms:.4f} ms, with the axes kept "
              f"{device_ms(lambda: hat_level_fwd(x3, lines3, True)):.4f} ms; the per-axis "
              f"sequence alone {device_ms(per_axis):.4f} ms; by events "
              f"{cuda_ms(lambda: hat_level_fwd(x3, lines3, False)):.4f} ms against "
              f"{cuda_ms(per_axis):.4f} ms; bound {bound_ms(nbytes(x3, lines3, prod), 0):.4f} ms")

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


def unequal_bits(a, b):
    """The entries of ``a`` whose bits differ from ``b``'s (NaNs with one
    payload equal)."""
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.view(view) != b.view(view)).sum())


def held_bitwise(what, kernel, plain):
    """``kernel()`` twice and ``plain()`` once: a kernel that sums in fixed
    point gives the same bits on both calls and equals its plain version.
    Returns the first call's output and the plain version's."""
    out, again, ref = kernel(), kernel(), plain()
    repeat, unequal = unequal_bits(out, again), unequal_bits(out, ref)
    require(repeat == 0 and unequal == 0,
            f"{what}: {repeat} entries differ between two calls, {unequal} from the plain "
            "version")
    return out, ref


def same_bits(a, b):
    """Bitwise equality of two tensors of any dtype, NaNs included."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.reshape(-1).contiguous().view(torch.uint8),
                       b.reshape(-1).contiguous().view(torch.uint8))


def repeat_digest(leaves, losses):
    """SHA-256 of a phase-31 run: each leaf's name, dtype, shape and bytes
    in ``leaves``' order (parameters, Adam moments, occupancy grid), then
    the losses' bytes."""
    h = hashlib.sha256()
    for name, v in list(leaves.items()) + [("losses", losses)]:
        v = v.detach().contiguous().cpu()
        h.update(f"{name} {v.dtype} {tuple(v.shape)}".encode())
        h.update(v.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


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
        idx = torch.randint(0, T, (LANE_BLOCKS * T, 128), **i32)
        cases.append((f"P2 lane_gather T={T}", lane_gather, lane_gather_plain, (src, idx)))
        cases.append((f"P2 lane_gather T={T} bf16", lane_gather, lane_gather_plain,
                      (src.to(torch.bfloat16), idx)))
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
        route = ""
        if key == "lane_gather":
            b = lane_gather_route(T, src.dtype)
            route = (f"route: {b}-byte table rows in shared memory; " if b
                     else "route: one thread an element, table through L2; ")
        lib_out = library(*lib_args)
        lib_equal = torch.equal(lib_out, out) if key != "coarse_occ" else None
        del checked, lib_out
        # each output is one indexed load: ~2 integer operations per element
        rec = measured(
            0.0, cuda_ms(lambda: fn(*args)), cuda_ms(lambda: plain(*args)),
            nbytes(*args, out), 2 * out.numel(), cuda_ms(lambda: library(*lib_args)),
        )
        kernel_dev, library_dev = device_ms(lambda: fn(*args)), device_ms(lambda: library(*lib_args))
        kernel_host, library_host = host_us(lambda: fn(*args)), host_us(lambda: library(*lib_args))
        print(f"{name}: {route}{out.numel()} outputs, 0 unequal to the plain version "
              f"(also with {100 * GATHER_OUTSIDE:g}% of the indices out of range); "
              f"kernel {rec['ms']:.4f} ms ({1e6 * rec['ms'] / out.numel():.4f} ns per "
              f"output), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
              f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it; plain {rec['plain_ms']:.4f} "
              f"ms; {what} {rec['library_ms']:.4f} ms"
              + ("" if lib_equal is None else f", equal to the kernel: {lib_equal}")
              + f"; device time alone: kernel {kernel_dev:.4f} ms, {what} {library_dev:.4f} ms"
              + f"; host per call: wrapper {kernel_host:.2f} us, {what} {library_host:.2f} us")
        # the kernels line times K5, P1 at 128 lanes and P2 at T = 2^14
        if name in ("K5 coarse_occ", f"P1 row_gather ({ROW_TABLE}, 128)",
                    f"P2 lane_gather T={2**14}"):
            report[key] = rec
        del lib_args
    del outs, cases
    torch.cuda.empty_cache()
    return report, probe_launches


def prop_level_inputs(g, n_rays, counts=(PROP_SAMPLES, PROP_FINAL)):
    """Importance sampling's inputs at each resampling of a proposal cascade
    that draws ``counts`` samples in turn: the first's ([0, 1] edges and
    CDF, E = 2), then each later one's (the previous resampling's edges in s
    and the CDF ``propnet_sampling`` forms from seeded densities, a third of
    them zero, so the CDF has plateaus).  Returns ``[(vals, cdfs, n), ...]``
    and the stratified bias."""
    dev = g.device
    unit = torch.tensor([[0.0, 1.0]], device=dev).expand(n_rays, 2).contiguous()
    bias = torch.rand(n_rays, generator=g, device=dev)
    levels = [(unit, unit, counts[0])]
    for n in counts[1:]:
        vals, cdfs, m = levels[-1]
        _, edges = pdf._importance_sampling(vals, cdfs, bias, m)
        sigma = torch.rand((n_rays, m), generator=g, device=dev) * 40.0
        sigma = torch.where(torch.rand(sigma.shape, generator=g, device=dev) < 1 / 3, 0.0, sigma)
        trans, _ = render_transmittance_from_density(edges[:, :-1], edges[:, 1:], sigma)
        levels.append((edges, 1.0 - torch.cat([trans, torch.zeros_like(trans[:, :1])], dim=-1), n))
    return levels, bias


def g14_ops(vals, n):
    """G14's operations on ``vals``' rows: per sample its position (3), the
    E - 1 compares with their selects (~3 each) and the lerp (~6); per
    edge ~3."""
    return vals.shape[0] * (n * (3 * (vals.shape[1] - 1) + 9) + 3 * (n + 1))


def vote_share(vals, cdfs):
    """The share of rows that pass G14's vote (nondecreasing edges and CDF,
    so no NaN, and no -0.0), which take its search; the others its walk."""
    rows = torch.cat([vals, cdfs], dim=1)
    ok = ((vals.diff(dim=1) >= 0).all(1) & (cdfs.diff(dim=1) >= 0).all(1)
          & ~(rows.view(torch.int32) == -2**31).any(1))
    return float(ok.float().mean())


def mixed_rows(vals, cdfs):
    """A copy of the rows in which each eighth row from the third on fails
    G14's vote: its edges or CDF out of order, a NaN in either, or a -0.0
    in either (the CDF's beside a +0.0), in turn."""
    vals, cdfs = vals.clone(), cdfs.clone()
    j = vals.shape[1] // 2
    for k, r in enumerate(range(2, vals.shape[0], 8)):
        case = k % 6
        if case == 0:
            vals[r, [0, j]] = vals[r, [j, 0]]
        elif case == 1:
            cdfs[r] = cdfs[r].flip(0)
        elif case == 2:
            cdfs[r, j] = float("nan")
        elif case == 3:
            vals[r, j] = float("nan")
        elif case == 4:
            cdfs[r, :2] = torch.tensor([-0.0, 0.0])
        else:
            vals[r, 0] = -0.0
    return vals, cdfs


@torch.inference_mode()
def phase_pdf_kernel(dev):
    """1f. G14 against its plain version, bitwise: at ``PROP_RAYS`` rays on
    both levels (E = 2 -> 128 samples, then E = 129 -> 64), stratified, at
    the eval chunk's ``PROP_EVAL_RAYS`` rays (E = 129 -> 64, bias 0.5), and
    on the final level's rows with some that fail its monotone-row vote
    (:func:`mixed_rows`), in one launch;
    timed on the final level at ``PROP_RAYS`` (and, device time alone, on
    the first).  No PyTorch call computes it
    (``torch.searchsorted`` is the search alone)."""
    g = torch.Generator(device=dev).manual_seed(14)
    (first, final), bias = prop_level_inputs(g, PROP_RAYS)
    eval_final = prop_level_inputs(g, PROP_EVAL_RAYS)[0][1]
    half = torch.full((PROP_EVAL_RAYS,), 0.5, device=dev)
    mixed = (*mixed_rows(*final[:2]), final[2])
    for what, (vals, cdfs, n), b in (
        (f"{PROP_RAYS} rays, E = 2 -> {PROP_SAMPLES}", first, bias),
        (f"{PROP_RAYS} rays, E = {PROP_SAMPLES + 1} -> {PROP_FINAL}", final, bias),
        (f"{PROP_EVAL_RAYS} rays, E = {PROP_SAMPLES + 1} -> {PROP_FINAL}, eval", eval_final, half),
        (f"{PROP_RAYS} rays, E = {PROP_SAMPLES + 1} -> {PROP_FINAL}, mixed", mixed, bias),
    ):
        out = pdf._importance_sampling(vals, cdfs, b, n)
        ref = pdf.importance_sampling_plain(vals, cdfs, b, n)
        require(same_bits(out[0], ref[0]) and same_bits(out[1], ref[1]),
                f"G14 {what}: differs from its plain version")
        print(f"G14 importance_sampling {what}: samples and edges bitwise equal "
              f"to the plain version; {vote_share(vals, cdfs):.4f} of the rows take the "
              f"search")
    vals, cdfs, n = final
    out = pdf._importance_sampling(vals, cdfs, bias, n)
    rec = measured(
        0.0, cuda_ms(lambda: pdf._importance_sampling(vals, cdfs, bias, n)),
        cuda_ms(lambda: pdf.importance_sampling_plain(vals, cdfs, bias, n)),
        nbytes(vals, cdfs, bias, *out), g14_ops(vals, n),
    )
    first_dev = device_ms(lambda: pdf._importance_sampling(*first[:2], bias, first[2]))
    print(f"G14 importance_sampling {PROP_RAYS} rays, E = {vals.shape[1]} -> {n}: kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); device time alone: kernel "
          f"{device_ms(lambda: pdf._importance_sampling(vals, cdfs, bias, n)):.4f} ms, and "
          f"{first_dev:.4f} ms on the first level (E = 2 -> {first[2]})")
    # the 360 cascade's three resamplings (phase 21), stratified, each
    # bitwise and timed; n = 256 takes several of the kernel's chunks
    levels, bias = prop_level_inputs(g, PROP_RAYS, PROP360_COUNTS)
    for vals, cdfs, n in levels:
        out = pdf._importance_sampling(vals, cdfs, bias, n)
        ref = pdf.importance_sampling_plain(vals, cdfs, bias, n)
        what = f"{PROP_RAYS} rays, E = {vals.shape[1]} -> {n}, 360 cascade"
        require(same_bits(out[0], ref[0]) and same_bits(out[1], ref[1]),
                f"G14 {what}: differs from its plain version")
        r = measured(
            0.0, cuda_ms(lambda: pdf._importance_sampling(vals, cdfs, bias, n)),
            cuda_ms(lambda: pdf.importance_sampling_plain(vals, cdfs, bias, n)),
            nbytes(vals, cdfs, bias, *out), g14_ops(vals, n),
        )
        print(f"G14 importance_sampling {what}: samples and edges bitwise equal to the "
              f"plain version; {vote_share(vals, cdfs):.4f} of the rows take the search; "
              f"kernel {r['ms']:.4f} ms, alone "
              f"{device_ms(lambda: pdf._importance_sampling(vals, cdfs, bias, n)):.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
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
          f"{metrics['ssim']:.4f}, launches {launches}; G2 launches per frame "
          f"{launches['march'] / len(metrics['views']):.2f}")
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
    of G3 and G5, so that a kernel train step and the plain step hand the hat
    kernels and their plain versions the same cotangents, bit for bit.  The
    deterministic flag is for those plain versions, which run on the card
    here: they are written for the CPU, and a PyTorch op they call may add
    atomically on the card unless the flag is set.  The kernels and the
    port's own scatters sum in a fixed order without it (phase 31)."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with plain_kernels(("composite_fwd", "composite_bwd")):
            yield
    finally:
        torch.use_deterministic_algorithms(False)


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


def phase_train_twins(trainer, state, batch, kind="cp", f32=None, name=None):
    """One train step through the kernels against the same step through the
    plain twins: the same state, batch and near-plane jitter, for the
    trained bf16 field and for the same parameters in an f32 field (``f32``,
    by default ``kind``'s bench trainer; printed as ``name``).  Each
    kernel step runs ``STEP_REPEATS`` times, as it did when atomics reordered its sums
    from run to run.  For the hat route's f32 field also the plain step
    against itself, and the kernel step under :func:`hat_kernels_alone`
    against the plain step there (held to ``HAT_ALONE_STEP_FRO``)."""
    require(state.step % trainer.update_interval != 0, "phase 5 step refreshes")
    gen = torch.Generator(device=trainer.device).manual_seed(5)
    near = torch.rand(batch["rays_o"].shape[0], generator=gen, device=trainer.device)
    if f32 is None:
        f32 = make_trainer(
            trainer.device, kind, torch.float32, timestamps=trainer.timestamps,
            max_steps=TRAIN_STEPS, sample_budget=trainer.sample_budget,
        )
    name = name or kind
    hat = "hat_fwd" in ENCODER_KERNELS[kind]
    plain, checks = {}, []
    for mode, tr, limit in (("f32", f32, F32_HAT_STEP_FRO if hat else F32_STEP_FRO),
                            ("bf16", trainer, BF16_STEP_FRO)):
        def plain_step():
            return train_loss_plain(tr, state.params, state.occ_state, batch, near)

        def kernel_step():
            return kernel_step_grads(tr, state, batch, near)

        what = f"train step {name} {mode}"
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
    print(f"train step {name}, twins f32 field vs bf16 field (what lost bf16 "
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
    return metrics["psnr"]


def timed(fn):
    """``fn()`` and its wall seconds, ended by a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rounds_render(field_fn, occ, data, step, eps):
    """``data``'s rays through :func:`render_rays_occgrid_test` at the
    trainer's window and round cap, 8192-ray chunks: colours and each ray's
    sample count."""
    parts = [render_rays_occgrid_test(
        field_fn, occ, data["rays_o"][i : i + 8192], data["rays_d"][i : i + 8192],
        render_bkgd=data["color_bkgd"], render_step_size=step, early_stop_eps=eps,
        window=EVAL_WINDOW, max_iters=EVAL_MAX_ROUNDS, return_stats=True,
    ) for i in range(0, data["rays_o"].shape[0], 8192)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[3]["counts"] for p in parts])


def same_sample_sets(occ, data, step):
    """Per ray, whether the eval renderer's rounds without the early stop
    (windows of ``EVAL_WINDOW`` candidates, at most ``EVAL_MAX_ROUNDS``,
    each resumed from the last one's termination plane) emit the samples of
    the ray's whole orbit from near 0 (the exact renderer's march): the same
    count and every bound within 1e-2 of a step (a candidate that moved
    across a voxel face shifts the set by a step or more; rounding moves a
    bound by ulps).  Also each ray's count on the whole orbit.  The rounds'
    samples do not depend on the field: without the early stop a ray stays
    alive until its orbit ends."""
    o, d = data["rays_o"], data["rays_d"]
    n = o.shape[0]
    near = torch.zeros(n, device=o.device)
    far = torch.full_like(near, 1e10)
    whole = march(o, d, occ.binaries, occ.aabbs, near, far, step)
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    ids, t0, t1 = [], [], []
    for _ in range(EVAL_MAX_ROUNDS):
        res = march(o, d, occ.binaries, occ.aabbs, near, far, step, rays_mask=alive,
                    max_samples=EVAL_WINDOW)
        ids.append(res.ray_indices.long())
        t0.append(res.t_starts)
        t1.append(res.t_ends)
        alive = alive & ~res.terminated
        near = res.termination_planes
        if not bool(alive.any()):
            break
    ids, t0, t1 = torch.cat(ids), torch.cat(t0), torch.cat(t1)
    order = torch.argsort(t0, stable=True)
    order = order[torch.argsort(ids[order], stable=True)]
    ids, t0, t1 = ids[order], t0[order], t1[order]
    counts = torch.bincount(ids, minlength=n)
    same = counts == whole.counts
    start = torch.cumsum(counts, 0) - counts
    wid = whole.ray_indices.long()
    wstart = torch.cumsum(whole.counts.long(), 0) - whole.counts.long()
    sel = same[wid]
    pos = start[wid[sel]] + torch.arange(wid.shape[0], device=o.device)[sel] - wstart[wid[sel]]
    moved = torch.maximum((t0[pos] - whole.t_starts[sel]).abs(),
                          (t1[pos] - whole.t_ends[sel]).abs())
    worst = torch.zeros(n, device=o.device).scatter_reduce(0, wid[sel], moved, "amax")
    return same & (worst <= 1e-2 * step), whole.counts


def compare_renderers(label, views, field_fn, occ, step, early, exact):
    """6b / 6c: each view through the early-stop renderer (``early(data)
    -> (colors, n_samples)``) and the exact one (``exact``, likewise), timed
    after one warm-up view: samples a ray and seconds a frame of both.
    Checked against the same rounds without the early stop
    (:func:`rounds_render` at eps -inf, with ``field_fn(data)``'s field on
    ``occ``): the early stop alone moves a colour by at most
    ``RENDERER_COLOUR_ERR``; so does the early-stop renderer against the
    exact one on every ray whose rounds emit the samples of its whole orbit
    (:func:`same_sample_sets`: the same set, not only as many); the rays
    where a resumed orbit emits another candidate than the whole orbit (one
    that moved across a voxel face by rounding) are counted, held to
    ``FLIP_ALLOWANCE`` of the rays, and every ray's colour to
    ``RENDERER_FLIP_COLOUR_ERR``; and the early stop renders fewer samples.
    The worst ray of each class is printed, with its view, index and
    count; a ray of the same set past ``RENDERER_COLOUR_ERR`` is printed
    with its samples."""
    early(views[0])
    exact(views[0])
    totals = {"early stop": [0, 0.0], "exact": [0, 0.0]}
    worst = {"early stop alone": 0.0, "same samples": 0.0, "all rays": 0.0}
    worst_ray = {"same set": None, "another set": None}
    flipped = equal_count_moved = 0
    for i, data in enumerate(views):
        n_rays = data["rays_o"].shape[0]
        (c_early, n_early), s_early = timed(lambda: early(data))
        (c_exact, n_exact), s_exact = timed(lambda: exact(data))
        with torch.no_grad():  # no ray retires for its opacity, even past 1 by rounding
            c_rounds, counts = rounds_render(field_fn(data), occ, data, step, -math.inf)
        same, whole_counts = same_sample_sets(occ, data, step)
        equal_count_moved += int(((counts == whole_counts) & ~same).sum())
        err = (c_early - c_exact).abs().amax(dim=-1)
        for cls, mask in (("same set", same), ("another set", ~same)):
            if bool(mask.any()):
                e, r = err.masked_fill(~mask, -1.0).max(0)
                if worst_ray[cls] is None or float(e) > worst_ray[cls][0]:
                    worst_ray[cls] = (float(e), i, int(r), int(whole_counts[r]), int(counts[r]))
        if bool(same.any()) and float(err[same].max()) > RENDERER_COLOUR_ERR:
            r = int(err.masked_fill(~same, -1.0).argmax())
            o, d = data["rays_o"][r : r + 1], data["rays_d"][r : r + 1]
            z = torch.zeros(1, device=o.device)
            ray = march(o, d, occ.binaries, occ.aabbs, z, z + 1e10, step)
            print(f"{label} view {i} ray {r}: same sample set, colour difference "
                  f"{float(err[r]):.6g}; origin {o.tolist()}, direction {d.tolist()}, "
                  f"samples t_starts {ray.t_starts.tolist()}")
        readings = {
            "early stop alone": float((c_early - c_rounds).abs().max()),
            "same samples": float(err[same].max()) if bool(same.any()) else 0.0,
            "all rays": float(err.max()),
        }
        for k, v in readings.items():
            worst[k] = max(worst[k], v)
        flipped += int((~same).sum())
        for name, n, sec in (("early stop", n_early, s_early), ("exact", n_exact, s_exact)):
            totals[name][0] += n
            totals[name][1] += sec
        print(f"{label} view {i}: early stop {n_early / n_rays:.2f} samples/ray, "
              f"{s_early:.4f} s; exact {n_exact / n_rays:.2f} samples/ray, {s_exact:.4f} s; "
              f"max colour difference {readings['all rays']:.3g} ({int((~same).sum())} "
              f"rays with another sample set), early stop alone "
              f"{readings['early stop alone']:.3g}")
    for cls, w in worst_ray.items():
        if w is not None:
            print(f"{label}: worst ray with {cls}: colour difference {w[0]:.6g}, view {w[1]} "
                  f"ray {w[2]}, {w[3]} samples on its whole orbit, {w[4]} in its rounds")
    print(f"{label}: {equal_count_moved} rays with as many samples as their whole orbit "
          f"but another set")
    n_rays = sum(v["rays_o"].shape[0] for v in views)
    print(f"{label}: " + "; ".join(
        f"{name} {n / n_rays:.2f} samples/ray, {sec / len(views):.4f} s/frame"
        for name, (n, sec) in totals.items()
    ) + "; max colour difference " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
      + f" (limits {RENDERER_COLOUR_ERR}, all rays {RENDERER_FLIP_COLOUR_ERR}); "
        f"{flipped} of {n_rays} rays with another sample set (limit "
        f"{FLIP_ALLOWANCE} of the rays)")
    for what in ("early stop alone", "same samples"):
        require(worst[what] <= RENDERER_COLOUR_ERR,
                f"{label}: early-stop colours differ by {worst[what]} ({what})")
    require(worst["all rays"] <= RENDERER_FLIP_COLOUR_ERR,
            f"{label}: early-stop colours differ by {worst['all rays']} (all rays)")
    require(flipped <= FLIP_ALLOWANCE * n_rays, f"{label}: {flipped} rays flipped")
    require(totals["early stop"][0] < totals["exact"][0],
            f"{label}: the early stop rendered no fewer samples")


def phase_trained_frames(trainer, state, ds):
    """6b: the trained CP field's test views through the trainer's eval
    renderer (``render_view``) and its exact renderer (``render_rays``)."""
    compare_renderers(
        "trained cp frames", [ds[i] for i in range(len(ds))],
        lambda data: trainer._field_fn(state, data), state.occ_state,
        trainer.render_step_size,
        lambda data: trainer.render_view(state, data)[::3],
        lambda data: trainer.render_rays(state, data)[::3],
    )


@torch.no_grad()
def phase_opaque_frames(dev):
    """6c: the hard-surface scene served through its own analytic density
    and colour, on a 128^3 grid refreshed N_REFRESH times from that density
    as the trainer refreshes (density x step, EMA 0.95, threshold 0.01):
    the early-stop renderer at the trainer's settings against the exact
    one, 8192-ray chunks."""
    ds, seconds = timed(lambda: ProceduralOpaqueSceneLoader(split="test", device=dev))
    step = 5e-3
    centers = ds.blob_centers

    def field_fn(x, dirs):
        return ds.query_rgb(x, centers), ds.query_density(x, centers)[:, 0]

    occ = init_occ_grid(AABB, 128, 1, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for _ in range(N_REFRESH):
        jitter = torch.rand((occ.levels, occ.cells_per_lvl, 3), generator=g, device=dev)
        occ = update_occ_grid(
            occ, lambda x: ds.query_density(x, centers)[:, 0] * step, jitter,
            occ_thre=1e-2, ema_decay=0.95,
        )
    print(f"opaque scene: {len(ds)} test views {ds.WIDTH}x{ds.HEIGHT}, ground truth "
          f"rendered in {seconds:.2f} s; occupied share "
          f"{float(occ.binaries.float().mean()):.4f}")

    def early(data):
        colors, counts = rounds_render(field_fn, occ, data, step, EVAL_EARLY_STOP_EPS)
        return colors, int(counts.sum())

    def exact(data):
        colors, _, _, n = render_image_with_occgrid(
            field_fn, occ, data["rays_o"], data["rays_d"], data["color_bkgd"],
            render_step_size=step, max_samples=None, sample_budget=None,
        )
        return colors, n

    compare_renderers("opaque frames", [ds[i] for i in range(len(ds))],
                      lambda data: field_fn, occ, step, early, exact)


class _Stop(Exception):
    """Ends the example's first run right after its checkpoint."""


def phase_example(dev, untrained_psnr):
    """6d: ``python -m nerfacc_tpu_torch.examples.train_ngp_nerf_occ --field
    cp --device_sampler 1`` for EXAMPLE_STEPS steps, EXAMPLE_CALL a call,
    through its ``build`` and ``train_loop``: stopped right after its
    checkpoint at EXAMPLE_CKPT (which must load back bitwise), then run again
    with the same arguments, which resumes from it.  The controller must
    grow the batch past its initial 1024 rays, the loss halve, the resumed
    run end finite and 3 dB above the untrained PSNR; launches counted over
    both runs.  Returns the launches."""
    ex = port_module("examples.train_ngp_nerf_occ")
    ckpt = os.path.join("build", "chip_smoke", "example.ckpt")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    args = ex.parser().parse_args([
        "--field", "cp", "--device_sampler", "1", "--steps_per_call", str(EXAMPLE_CALL),
        "--max_steps", str(EXAMPLE_STEPS - EXAMPLE_CALL), "--ckpt_every",
        str(EXAMPLE_CKPT), "--model_path", ckpt, "--log_every", "500",
    ])
    save = ex.save_checkpoint
    stopped = []

    def save_then_stop(path, state):
        save(path, state)
        loaded = load_checkpoint(path, like=state, device=dev)
        same = all(torch.equal(loaded.params[k], v) for k, v in state.params.items())
        adam, adam_loaded = state.opt_state.optimizer, loaded.opt_state.optimizer
        for k, p in state.params.items():
            mine, theirs = adam.state[p], adam_loaded.state[loaded.params[k]]
            same &= all(torch.equal(mine[m], theirs[m]) for m in mine)
        for k in ("occs", "binaries", "aabbs"):
            same &= torch.equal(getattr(loaded.occ_state, k), getattr(state.occ_state, k))
        same &= (loaded.step, loaded.opt_state.count) == (state.step, state.opt_state.count)
        stopped.append((state.step, same))
        if state.step == EXAMPLE_CKPT:
            raise _Stop

    cuda.reset_launches()
    t0 = time.perf_counter()
    ex.save_checkpoint = save_then_stop
    log = []  # the first run's records, then the resumed run's
    try:
        trainer, train_ds, test_ds = ex.build(args)
        try:
            ex.train_loop(trainer, train_ds, test_ds, args, log)
        except _Stop:
            pass
        first_seconds = time.perf_counter() - t0
        trainer, train_ds, test_ds = ex.build(args)
        run = ex.train_loop(trainer, train_ds, test_ds, args, log)
    finally:
        ex.save_checkpoint = save
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    print(f"example: first run stopped after its checkpoint at step {stopped[0][0]} "
          f"({first_seconds:.1f} s, set-up included), checkpoint loaded back bitwise: "
          f"{stopped[0][1]}; resumed run to step {run.state.step} in "
          f"{run.train_seconds:.1f} s")
    rays = [r["num_rays"] for r in log]
    losses = [r["loss"] for r in log]
    grown = [r["step"] for r in log if r["num_rays"] > 1024]
    print(f"example: ray counts {sorted(set(rays))}, first above 1024 in the call "
          f"ending at step {grown[0] if grown else None}, the last call's "
          f"{rays[-1]}; demand of the first and last calls "
          f"{log[0]['n_total_samples'] / log[0]['num_rays']:.1f} and "
          f"{log[-1]['n_total_samples'] / log[-1]['num_rays']:.1f} samples/ray; mean "
          f"loss of the first and last five calls "
          f"{statistics.mean(losses[:5]):.6f} -> {statistics.mean(losses[-5:]):.6f}; "
          f"eval psnr {run.metrics['psnr']:.3f}, ssim {run.metrics['ssim']:.4f} "
          f"(untrained {untrained_psnr:.3f}); launches {launches}")
    require(len(stopped) >= 2 and all(same for _, same in stopped),
            f"example: a checkpoint did not load back bitwise: {stopped}")
    require(stopped[0][0] == EXAMPLE_CKPT, f"example: first checkpoint at {stopped[0][0]}")
    require(run.state.step == EXAMPLE_STEPS, f"example: ended at step {run.state.step}")
    require(max(rays) > 1024, f"example: the controller kept {sorted(set(rays))} rays")
    require(all(math.isfinite(v) for v in losses), "example: non-finite loss")
    require(statistics.mean(losses[-5:]) < 0.5 * statistics.mean(losses[:5]),
            "example: the loss did not halve")
    require(run.metrics["psnr"] >= untrained_psnr + 3.0,
            f"example: psnr {run.metrics['psnr']} not 3 dB above {untrained_psnr}")
    for name in ("cp_level_fwd", "cp_level_bwd", "march", "composite_fwd", "composite_bwd"):
        require(launches[name] > 0, f"example: kernel {name} never launched")
    return launches


def phase_prop_serve(dev, ds, trainer=None, state=None, untrained_psnr=None, name="prop",
                     kernels=("cp_level_fwd", "composite_fwd", "importance_sampling")):
    """15 (untrained, seed-42 weights) and 18 (``trainer`` and ``state``
    from phase 16, against ``untrained_psnr``): ``NGPPropTrainer``'s
    evaluation on the test views, launches counted; phases 20 and 21 the
    same for the path ``name``, whose serving launches ``kernels``."""
    label = name if untrained_psnr is None else f"trained {name}"
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
    for kernel in kernels:
        require(launches.get(kernel, 0) > 0, f"kernel {kernel} never launched in {label} serving")
    if untrained_psnr is not None:
        require(metrics["psnr"] >= untrained_psnr + 3.0,
                f"{label} psnr {metrics['psnr']} not 3 dB above {untrained_psnr}")
    return metrics["psnr"]


def phase_prop_train(dev):
    """16. The proposal path trained at bench.py's configuration through
    ``train_steps_sampled`` and the proposal-gradient schedule, launches
    counted; batches drawn on the card from the step's generator."""
    t0 = time.perf_counter()
    ds = train_loader(dev, "prop")
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


# kernel -> the entry points its plain version takes the place of: (module,
# attribute, module of the plain version, its attribute), modules under
# nerfacc_tpu_torch.  The callers look each attribute up at call time (the
# autograd Functions, the samplers), so a swap reaches every path.  Older
# trees have no hat_level_fwd; each kernel must swap at least one.
PLAIN_SWAPS = {
    "cp_level_fwd": [("ops.cp_level", "_encode_forward", "ops.cp_level", "cp_level_encode_plain")],
    "cp_level_bwd": [("ops.cp_level", "cp_level_backward", "ops.cp_level",
                      "cp_level_backward_plain")],
    "march": [("estimators.occ_grid", "march", "grid", "march_plain"),
              ("estimators.sparse_grid", "march", "grid", "march_plain"),
              ("utils.rendering", "march", "grid", "march_plain")],
    "composite_fwd": [("ops.sorted_segments", "_composite_forward", "ops.sorted_segments",
                       "composite_sorted_plain")],
    "composite_bwd": [("ops.sorted_segments", "composite_sorted_backward",
                       "ops.sorted_segments", "composite_sorted_backward_plain")],
    "hat_fwd": [("ops.hat_matmul", "hat_fwd", "ops.hat_matmul", "hat_interp_matmul_plain"),
                ("ops.hat_matmul", "hat_level_fwd", "ops.hat_matmul", "hat_level_plain")],
    "hat_bwd_line": [("ops.hat_matmul", "hat_bwd_line", "ops.hat_matmul", "hat_bwd_line_plain")],
    "hat_bwd_x": [("ops.hat_matmul", "hat_bwd_x", "ops.hat_matmul", "hat_bwd_x_plain")],
    "importance_sampling": [("pdf", "_importance_sampling", "pdf", "importance_sampling_plain")],
    "hash_fwd": [("ops.hash_encode", "hash_encode_forward", "ops.hash_encode",
                  "hash_encode_plain")],
    "hash_bwd": [("ops.hash_encode", "hash_encode_backward", "ops.hash_encode",
                  "hash_encode_backward_plain")],
}
# path -> the kernels its training and serving launch
PATH_KERNELS = {
    "tineuvox": PATH_KERNELS_TINEUVOX,
    "prop": ("cp_level_fwd", "cp_level_bwd", "composite_fwd", "composite_bwd",
             "importance_sampling"),
}


@contextlib.contextmanager
def plain_kernels(names=tuple(PLAIN_SWAPS)):
    """Inside: each kernel of ``names`` (by default every kernel of the
    TiNeuVox and proposal paths: G1-G10 and G14) runs its plain version,
    through the same wrappers' callers and autograd Functions."""
    saved = []
    try:
        for name in names:
            swapped = 0
            for mod, attr, plain_mod, plain_attr in PLAIN_SWAPS[name]:
                module = port_module(mod)
                if hasattr(module, attr):
                    saved.append((module, attr, getattr(module, attr)))
                    setattr(module, attr, getattr(port_module(plain_mod), plain_attr))
                    swapped += 1
            require(swapped > 0, f"no entry point of {name} to swap for its plain version")
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


def train_path(dev, path, seed):
    """:func:`quality_run`'s training: the trainer, its state after
    ``TRAIN_STEPS`` steps, the test views and the (reconstruction) losses."""
    procedural = port_module("data.procedural")
    ds = train_loader(dev, path, seed)
    if path == "tineuvox":
        test = procedural.ProceduralDynamicSceneLoader(split="test", device=dev)
        trainer = make_trainer(dev, path, timestamps=ds.timestamps, max_steps=TRAIN_STEPS,
                               sample_budget=TRAIN[path][2], seed=seed)
        state = trainer.init_state()
        batches = [ds[0] for _ in range(TRAIN_STEPS)]
        losses = []
        for batch in batches:
            state, aux = trainer.train_step(state, batch)
            losses.append(aux["loss"])
        return trainer, state, test, torch.stack(losses)
    test = procedural.ProceduralSceneLoader(split="test", device=dev)
    sampler = port_module("data.device_sampler").DeviceRaySampler.from_loader(ds)
    trainer = make_prop_trainer(dev, max_steps=TRAIN_STEPS, seed=seed)
    state = trainer.init_state()
    rg_fn = port_module("estimators.prop_net").get_proposal_requires_grad_fn()
    rgs = [rg_fn(step) for step in range(TRAIN_STEPS)]
    losses = []
    for start in range(0, TRAIN_STEPS, 100):
        state, aux = trainer.train_steps_sampled(state, sampler, rgs[start : start + 100])
        losses.append(aux["loss"] - aux["prop_loss"])
    return trainer, state, test, torch.cat(losses)


def quality_run(dev, path, seed, plain=()):
    """``path`` trained from ``seed`` for ``TRAIN_STEPS`` steps and served on
    its test views, with the kernels of ``plain`` on their plain versions in
    both (:func:`plain_kernels`): "tineuvox" at phase 12's configuration
    (``train_step`` on one batch of the train loader a step), "prop" at
    phase 16's (``train_steps_sampled`` in calls of 100 steps).  With seed 42
    the run is phase 12's or 16's.  It reaches the port only through entry
    points that every tree of the port with that path has, looked up at
    call time, so it also runs on an older tree (``--quality --root``).
    Returns the trained PSNR and SSIM, the (reconstruction) loss's mean
    over the first and last 50 steps, the seconds, and the launches of the
    path's kernels."""
    cuda_mod = port_module("cuda")
    t0 = time.perf_counter()
    cuda_mod.reset_launches()
    # the kernels sum in a fixed order by themselves (phase 31); on the
    # TiNeuVox path the plain versions, which run on the card here, need
    # PyTorch's deterministic algorithms for it (G9's plain version adds in
    # f64 with index_add_, atomic on the card without the flag), so that
    # both routes repeat from call to call.  The proposal path's plain
    # versions need no flag: G4's sums in int64, whose order does not matter
    torch.use_deterministic_algorithms(bool(plain) and path == "tineuvox", warn_only=True)
    try:
        with plain_kernels(plain):
            trainer, state, test, losses = train_path(dev, path, seed)
            metrics = trainer.eval_metrics(state, test)
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.synchronize()
    launches = {k: cuda_mod.LAUNCHES[k] for k in PATH_KERNELS[path]}
    for name, n in launches.items():
        if name in plain:
            require(n == 0, f"{path}: {name} launched on its plain route")
        else:
            require(n > 0, f"{path}: kernel {name} never launched")
    losses = losses.cpu()
    require(bool(torch.isfinite(losses).all()), f"{path}: non-finite loss")
    require(all(v["finite"] for v in metrics["views"]), f"{path}: non-finite view")
    return {
        "path": path, "seed": seed, "psnr": metrics["psnr"], "ssim": metrics["ssim"],
        "loss_first50": float(losses[:50].mean()), "loss_last50": float(losses[-50:].mean()),
        "seconds": time.perf_counter() - t0, "launches": launches,
    }


def _quality_job(device, path, seed, plain):
    return quality_run(torch.device(device), path, seed, plain)


def quality_runs(dev, jobs):
    """:func:`quality_run` for each ``(path, seed, plain)`` of ``jobs``, all
    at once, each in a process of its own on the card, with one CPU thread
    (the processes share the host's cores): the train loops are host-bound,
    so the processes overlap on the host and share the card.  A run's
    result does not depend on the others (its seed fixes its draws), but
    its seconds include theirs.  Returns the results in job order; every
    process has ended when it returns."""
    with multiprocessing.get_context("spawn").Pool(
            len(jobs), initializer=torch.set_num_threads, initargs=(1,)) as pool:
        return pool.starmap(_quality_job, [(str(dev), *job) for job in jobs])


def phase_plain_quality(dev, path, kernel_psnr):
    """14b / 18b. ``path`` trained from the other seeds of the first
    ``SMOKE_QUALITY_SEEDS`` of ``QUALITY_SEEDS`` through its kernels
    (``kernel_psnr``: phase 14's / 18's, from the first) and from all of
    them through the plain versions of its kernels
    (:func:`quality_run`, the runs side by side, :func:`quality_runs`),
    each served as it was trained: the kernel route's mean trained PSNR
    must be no more than ``PSNR_MARGIN`` below the plain route's."""
    psnr = {"kernels": [kernel_psnr], "plain": []}
    seeds = QUALITY_SEEDS[:SMOKE_QUALITY_SEEDS]
    jobs = [(route, seed, plain) for seed in seeds
            for route, plain in (("kernels", ()), ("plain", PATH_KERNELS[path]))
            if route == "plain" or seed != QUALITY_SEEDS[0]]
    t0 = time.perf_counter()
    runs = quality_runs(dev, [(path, seed, plain) for _, seed, plain in jobs])
    for (route, seed, _), run in zip(jobs, runs):
        psnr[route].append(run["psnr"])
        print(f"trained {path}, seed {seed}, through the {route}: psnr {run['psnr']:.3f}, "
              f"ssim {run['ssim']:.4f}, mean loss {run['loss_first50']:.6f} -> "
              f"{run['loss_last50']:.6f} (first and last 50 steps), {TRAIN_STEPS} steps "
              f"and the test views in {run['seconds']:.1f} s beside the other runs")
    print(f"trained {path}: {len(jobs)} runs side by side in {time.perf_counter() - t0:.1f} s "
          f"({card()})")
    mean = {k: statistics.mean(v) for k, v in psnr.items()}
    print(f"trained {path} psnr over seeds {seeds}: through the kernels "
          f"{[round(v, 3) for v in psnr['kernels']]}, mean {mean['kernels']:.3f}; through "
          f"the plain versions {[round(v, 3) for v in psnr['plain']]}, mean "
          f"{mean['plain']:.3f}; margin {PSNR_MARGIN} dB")
    require(mean["kernels"] >= mean["plain"] - PSNR_MARGIN,
            f"trained {path}: mean psnr {mean['kernels']} through the kernels is more than "
            f"{PSNR_MARGIN} dB below {mean['plain']} through the plain versions")


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


def f32_twin(trainer):
    """``trainer`` with its fields rebuilt in f32 (the same classes, box and
    contraction, their default widths)."""
    def f32(field):
        return type(field)(field.aabb.tolist(), unbounded=field.unbounded,
                           compute_dtype=torch.float32)

    return dataclasses.replace(trainer, field=f32(trainer.field),
                               prop_fields=[f32(p) for p in trainer.prop_fields])


def phase_prop_train_twins(trainer, state, batch, f32=None, name="prop"):
    """17. One proposal train step with ``requires_grad`` through the
    kernels against the same step through the plain versions, from phase
    16's state with the same batch and jitter, for the trained bf16 fields
    and for the same parameters in f32 fields (``f32``, by default phase
    16's configuration; phase 5's bounds).  Phases 20 and 21 the same for
    the path ``name``."""
    gen = torch.Generator(device=trainer.device).manual_seed(17)
    n_rays = batch["rays_o"].shape[0]
    biases = [torch.rand(n_rays, generator=gen, device=trainer.device)
              for _ in range(len(trainer.prop_samples) + 1)]
    if f32 is None:
        f32 = make_prop_trainer(trainer.device, torch.float32, max_steps=TRAIN_STEPS)
    checks = []
    for mode, tr, limit in (("f32", f32, F32_STEP_FRO), ("bf16", trainer, BF16_STEP_FRO)):
        ref = prop_step_grads(tr, state, batch, biases, plain=True)
        checks.append(step_readings(
            f"train step {name} {mode}, kernels vs plain versions",
            lambda: prop_step_grads(tr, state, batch, biases), ref, limit,
        ))
    for what, reading, limit, loss_rel in checks:
        require(reading <= limit, f"{what}: a gradient leaf off by {reading} > {limit}")
        require(loss_rel <= 1e-5, f"{what}: losses differ by {loss_rel}")


# Phase 19: the library API's quick start on the card, a user's own loop.
QS_STEPS, QS_WARMUP, QS_RES, QS_STEP = 200, 64, 128, 5e-3
QS_DISTORTION = 1e-3
# the loop's mean loss over its last 20 steps must be below this share of
# its first 20's (PERF.md §6 holds the prediction this bound comes from)
QS_LOSS_RATIO = 0.5
QS_TIMED_STEPS = 20  # steps of the loop and of train_step timed side by side
QS_VIEW_MAX_SAMPLES = 2048  # view 0's orbits hold ~1040 candidates, over 1024
QS_KERNELS = ("cp_level_fwd", "cp_level_bwd", "march", "composite_fwd", "composite_bwd")
QS_PROP_STEPS = 50
QS_PROP_KERNELS = ("cp_level_fwd", "cp_level_bwd", "composite_fwd", "composite_bwd",
                   "importance_sampling")


def qs_loss(field, estimator, batch, near_jitter=None):
    """The quick start's sampling and rendering on ``batch`` and the loop's
    loss: smooth L1 plus ``QS_DISTORTION`` x the mean distortion.  Returns
    the loss and the number of samples."""
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    n_rays = rays_o.shape[0]

    def sigma_fn(t0, t1, rid):
        return field.query_density(rays_o[rid] + (0.5 * (t0 + t1))[:, None] * rays_d[rid])[..., 0]

    ray_indices, t_starts, t_ends = estimator.sampling(
        rays_o, rays_d, sigma_fn=sigma_fn, render_step_size=QS_STEP, stratified=True,
        near_jitter=near_jitter)

    def rgb_sigma_fn(t0, t1, rid):
        d = rays_d[rid]
        rgb, density = field(rays_o[rid] + (0.5 * (t0 + t1))[:, None] * d, d)
        return rgb, density[..., 0]

    colors, _, _, extras = nerfacc_tpu_torch.rendering(
        t_starts, t_ends, ray_indices, n_rays=n_rays, rgb_sigma_fn=rgb_sigma_fn,
        render_bkgd=batch["color_bkgd"])
    dist = nerfacc_tpu_torch.distortion(extras["weights"], t_starts, t_ends, ray_indices, n_rays)
    loss = F.smooth_l1_loss(colors, batch["rgb"]) + QS_DISTORTION * dist.mean()
    return loss, ray_indices.shape[0]


def qs_step_grads(field, estimator, batch, near, plain=False, kernels=QS_KERNELS):
    """One loop step's loss and gradients (no grid update, no Adam) through
    the kernels or (``plain``) their plain versions, each gradient checked
    finite and nonzero."""
    field.zero_grad(set_to_none=True)
    before = dict(cuda.LAUNCHES)
    with plain_kernels(kernels) if plain else contextlib.nullcontext():
        loss, _ = qs_loss(field, estimator, batch, near)
        loss.backward()
    if plain:
        require(cuda.LAUNCHES == before, "the plain quick-start step launched a kernel")
    grads = {k: p.grad.clone() for k, p in field.named_parameters()}
    for name, g in grads.items():
        require(torch.isfinite(g).all() and float(g.abs().max()) > 0,
                f"quick start: gradient of {name} is zero or not finite")
    return float(loss.detach()), grads


def qs_frame(field, estimator, data, chunk=8192):
    """A view through the quick start's calls, 8192 rays a call, every
    occupied candidate kept (no visibility filter): the colours."""
    rays_o, rays_d = data["rays_o"].reshape(-1, 3), data["rays_d"].reshape(-1, 3)
    colors = []
    for s in range(0, rays_o.shape[0], chunk):
        o, d = rays_o[s : s + chunk], rays_d[s : s + chunk]
        ray_indices, t_starts, t_ends = estimator.sampling(
            o, d, render_step_size=QS_STEP, early_stop_eps=0.0, alpha_thre=0.0)

        def rgb_sigma_fn(t0, t1, rid, o=o, d=d):
            rgb, density = field(o[rid] + (0.5 * (t0 + t1))[:, None] * d[rid], d[rid])
            return rgb, density[..., 0]

        colors.append(nerfacc_tpu_torch.rendering(
            t_starts, t_ends, ray_indices, n_rays=o.shape[0], rgb_sigma_fn=rgb_sigma_fn,
            render_bkgd=data["color_bkgd"])[0])
    return torch.cat(colors)


@torch.no_grad()
def qs_frame_timed(field, estimator, data):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    colors = qs_frame(field, estimator, data)
    torch.cuda.synchronize()
    return colors, time.perf_counter() - t0


@torch.no_grad()
def qs_scan_times(field, estimator, batch, near):
    """The quick start's flat-layout scans, PyTorch ops on one step's sample
    buffer (the visibility's and the extras' transmittance, the distortion's
    two exclusive sums), against G5, whose warps scan the same segments, on
    the same buffer: CUDA events around a call and device time alone."""
    rays_o, rays_d = batch["rays_o"], batch["rays_d"]
    n_rays = rays_o.shape[0]
    ray_indices, t0, t1 = estimator.sampling(rays_o, rays_d, render_step_size=QS_STEP,
                                             stratified=True, near_jitter=near)
    rid = ray_indices
    rgbs, density = field(rays_o[rid] + (0.5 * (t0 + t1))[:, None] * rays_d[rid], rays_d[rid])
    sigmas = density[..., 0].float().contiguous()
    rgbs = rgbs.float().contiguous()
    counts = torch.bincount(rid, minlength=n_rays)
    ends = torch.cumsum(counts, 0)
    ss, se = (ends - counts).to(torch.int32), (ends - 1).to(torch.int32)
    g = torch.Generator(device=rid.device).manual_seed(23)
    cot = [torch.rand((n_rays, c), generator=g, device=rid.device) for c in (3, 1, 1)]
    weights = nerfacc_tpu_torch.render_weight_from_density(
        t0, t1, sigmas, ray_indices=rid, n_rays=n_rays)[0]
    calls = {
        "transmittance (exclusive_sum, indices)": lambda: nerfacc_tpu_torch.render_transmittance_from_density(
            t0, t1, sigmas, ray_indices=rid, n_rays=n_rays),
        "distortion's two exclusive sums": lambda: (
            nerfacc_tpu_torch.exclusive_sum(weights, indices=rid),
            nerfacc_tpu_torch.exclusive_sum(weights * t0, indices=rid)),
        "G5 composite_bwd": lambda: composite_sorted_backward(
            t0, t1, sigmas, rgbs, rid.to(torch.int32), n_rays, ss, se, *cot),
    }
    for what, fn in calls.items():
        print(f"quick start scans: {what} on {rid.shape[0]} samples of {n_rays} rays: "
              f"{cuda_ms(fn):.4f} ms by events, {device_ms(fn):.4f} ms device alone "
              f"({card()})")


def qs_step_checks(dev, field, estimator, batch, name):
    """One loop step (no grid update, no Adam) through the kernels against
    the same step through their plain versions (phase 5's bounds), for the
    bf16 ``field`` and for its parameters in an f32 field; returns the
    near-plane jitter it used."""
    near = torch.rand(batch["rays_o"].shape[0], device=dev,
                      generator=torch.Generator(device=dev).manual_seed(19))
    f32 = port_module("models.cp_field").CPRadianceField(AABB, compute_dtype=torch.float32)
    f32 = f32.to(dev)
    f32.load_state_dict(field.state_dict())
    checks = []
    for mode, fld, limit in (("f32", f32, F32_STEP_FRO), ("bf16", field, BF16_STEP_FRO)):
        ref = qs_step_grads(fld, estimator, batch, near, plain=True)
        checks.append(step_readings(
            f"{name} step {mode}, kernels vs plain versions",
            lambda fld=fld: qs_step_grads(fld, estimator, batch, near), ref, limit))
    for what, reading, limit, loss_rel in checks:
        require(reading <= limit, f"{what}: a gradient leaf off by {reading} > {limit}")
        require(loss_rel <= 1e-5, f"{what}: losses differ by {loss_rel}")
    return near


def qs_train(dev, estimator_cls, name, train=None, occ_eval_fn=None):
    """The quick start's loop: the full-width bf16 CP field from seed 42
    behind ``estimator_cls(roi_aabb=AABB, resolution=QS_RES)``,
    ``QS_STEPS`` steps on ``train`` (default: phase 4's train split) of the
    estimator's update (from ``occ_eval_fn``, default the field's density
    times the step),
    ``qs_loss`` and Adam, launches counted; every 50 steps the loss, the
    samples, the launches a step so far and the grid's occupied share.  The
    loss must fall below ``QS_LOSS_RATIO`` of its start and G1-G5 must
    launch.  Returns the field, the estimator, the ``QS_STEPS + 1``
    batches, the launches and each step's seconds."""
    train = train_loader(dev, "cp") if train is None else train
    batches = [train[0] for _ in range(QS_STEPS + 1)]
    field = port_module("models.cp_field").CPRadianceField(AABB).to(dev)
    field.init(torch.Generator().manual_seed(QUALITY_SEEDS[0]))
    estimator = estimator_cls(roi_aabb=AABB, resolution=QS_RES, device=dev)
    optimizer = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)

    if occ_eval_fn is None:
        def occ_eval_fn(x):
            return field.query_density(x)[..., 0] * QS_STEP

    torch.cuda.synchronize()
    cuda.reset_launches()
    losses, samples, step_s = [], [], []
    for step in range(QS_STEPS):
        t0 = time.perf_counter()
        estimator.update_every_n_steps(step, occ_eval_fn, warmup_steps=QS_WARMUP)
        loss, n = qs_loss(field, estimator, batches[step])
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
        samples.append(n)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if step % 50 == 0 or step == QS_STEPS - 1:
            print(f"{name} step {step}: loss {float(loss.detach()):.6f}, {n} samples, "
                  f"launches a step " + ", ".join(
                      f"{k} {cuda.LAUNCHES[k] / (step + 1):.3f}" for k in QS_KERNELS)
                  + f", occupied share {float(estimator.binaries.float().mean()):.4f}")
    launches = dict(cuda.LAUNCHES)
    losses = torch.stack(losses).cpu()
    require(bool(torch.isfinite(losses).all()), f"{name}: non-finite loss")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    print(f"{name}: {QS_STEPS} steps in {sum(step_s):.3f} s, mean loss of the first "
          f"20 steps {first:.6f}, of the last 20 {last:.6f} (ratio {last / first:.4f}, "
          f"limit {QS_LOSS_RATIO}); {statistics.mean(samples):.1f} samples a step; "
          f"launches {launches}, per step "
          + ", ".join(f"{k} {v / QS_STEPS:.3f}" for k, v in launches.items() if v))
    require(last < QS_LOSS_RATIO * first,
            f"{name}: loss {first} -> {last} not below {QS_LOSS_RATIO}x")
    for kernel in QS_KERNELS:
        require(launches[kernel] > 0, f"kernel {kernel} never launched in the {name} loop")
    return field, estimator, batches, launches, step_s


def phase_quickstart(dev, ds):
    """19. The README's quick start as a user writes it against the port:
    ``OccGridEstimator`` (128^3 over +-1.5), ``sampling`` with a density
    callback, ``rendering``, a smooth-L1 loss plus ``distortion``, and
    ``torch.optim.Adam``, on the full-width bf16 CP field from seed 42, for
    ``QS_STEPS`` steps on phase 4's train split; launches counted.  Then one
    step through the kernels against their plain versions (phase 5's
    bounds), view 0 against ``trainer.render_rays`` on the same field and
    grid, and the timings."""
    print(f"quick start: {card()}")
    field, estimator, batches, launches, step_s = qs_train(
        dev, nerfacc_tpu_torch.OccGridEstimator, "quick start")
    near = qs_step_checks(dev, field, estimator, batches[QS_STEPS], "quick start")

    # view 0 through the quick start against the trainer's exact renderer
    trainer = make_trainer(dev)
    state = TrainState({k: v.detach() for k, v in field.state_dict().items()}, None,
                       estimator.state, 0)
    estimator.max_samples = QS_VIEW_MAX_SAMPLES
    data = ds[0]
    colors, qs_seconds = qs_frame_timed(field, estimator, data)
    qs_frames = [qs_frame_timed(field, estimator, data)[1] for _ in range(2)]
    torch.cuda.synchronize()
    exact, exact_seconds = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        exact = trainer.render_rays(state, data)[0]
        torch.cuda.synchronize()
        exact_seconds.append(time.perf_counter() - t0)
    estimator.max_samples = 1024
    diff = float((colors - exact).abs().max())
    print(f"quick start view 0: sampling + rendering vs trainer.render_rays, max colour "
          f"difference {diff:.3g} (limit 2e-3); {min([qs_seconds] + qs_frames):.4f} s/frame "
          f"against {min(exact_seconds):.4f} s/frame for render_rays ({card()})")
    require(diff <= 2e-3, f"quick start view 0: differs from render_rays by {diff}")

    # the flat-layout scans in PyTorch ops at the loop's shapes, beside G5
    qs_scan_times(field, estimator, batches[QS_STEPS], near)

    # a step of the loop against NGPOccTrainer.train_step, same field and rays
    loop_ms = 1e3 * statistics.median(step_s[-QS_TIMED_STEPS:])
    tstate = TrainState(
        {k: v.detach().clone().requires_grad_(True) for k, v in field.state_dict().items()},
        None, estimator.state, 1)
    tstate = tstate._replace(opt_state=trainer.init_optimizer(tstate.params))
    trainer_s = []
    for i in range(QS_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tstate, _ = trainer.train_step(tstate, batches[i])
        torch.cuda.synchronize()
        trainer_s.append(time.perf_counter() - t0)
    print(f"quick start: a loop step {loop_ms:.3f} ms (median of its last "
          f"{QS_TIMED_STEPS}) against {1e3 * statistics.median(trainer_s):.3f} ms for "
          f"NGPOccTrainer.train_step on the same field and rays (median of "
          f"{QS_TIMED_STEPS}, its budget {trainer.sample_budget}) ({card()})")
    return launches, loop_ms


def phase_quickstart_prop(dev):
    """19b. The proposal leg: ``PropNetEstimator`` with one CPDensityField
    (16/64 x rank 16) and its own Adam, the full-width CP radiance field,
    ``rendering`` on the batched rows, ``PROP_RAYS`` rays and 128 + 64
    samples, for ``QS_PROP_STEPS`` steps; launches counted.  The proposal
    loss must fall, and one step through the kernels must stay within phase
    17's bounds of the same step on their plain versions."""
    fields = port_module("models.cp_field")
    gen = torch.Generator().manual_seed(QUALITY_SEEDS[0])
    field = fields.CPRadianceField(AABB).to(dev)
    field.init(gen)
    prop = fields.CPDensityField(AABB).to(dev)
    prop.init(gen)
    estimator = nerfacc_tpu_torch.PropNetEstimator(
        torch.optim.Adam(prop.parameters(), lr=1e-2, eps=1e-15))
    optimizer = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)
    sampler = DeviceRaySampler.from_loader(train_loader(dev, "prop"))
    rg_fn = get_proposal_requires_grad_fn()
    g = torch.Generator(device=dev).manual_seed(191)

    def leg_loss(batch, rg, biases=None, generator=None):
        o, d = batch["rays_o"], batch["rays_d"]

        def prop_sigma_fn(t0, t1):
            pos = o[:, None] + (0.5 * (t0 + t1))[..., None] * d[:, None]
            return prop(pos.reshape(-1, 3)).reshape(t0.shape)

        t_starts, t_ends = estimator.sampling(
            [prop_sigma_fn], [PROP_SAMPLES], PROP_FINAL, o.shape[0], 2.0, 6.0, "uniform",
            stratified=True, requires_grad=rg, generator=generator, biases=biases, device=dev)

        def rgb_sigma_fn(t0, t1, _):
            pos = o[:, None] + (0.5 * (t0 + t1))[..., None] * d[:, None]
            rgb, density = field(pos.reshape(-1, 3), d[:, None].expand_as(pos).reshape(-1, 3))
            return rgb.reshape(t0.shape + (3,)), density.reshape(t0.shape)

        colors, _, _, extras = nerfacc_tpu_torch.rendering(
            t_starts, t_ends, rgb_sigma_fn=rgb_sigma_fn, render_bkgd=batch["color_bkgd"])
        return F.smooth_l1_loss(colors, batch["rgb"]), extras["trans"]

    torch.cuda.synchronize()
    cuda.reset_launches()
    losses, prop_losses = [], []
    t0 = time.perf_counter()
    for step in range(QS_PROP_STEPS):
        rg = rg_fn(step)
        loss, trans = leg_loss(sampler.sample(g), rg, generator=g)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        prop_losses.append(estimator.update_every_n_steps(trans, rg, loss_scaler=1024.0))
        losses.append(loss.detach())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    losses = torch.stack(losses).cpu()
    rg_losses = [v for v in prop_losses if v]
    first, last = statistics.mean(rg_losses[:10]), statistics.mean(rg_losses[-10:])
    print(f"quick start prop: {QS_PROP_STEPS} steps in {seconds:.3f} s "
          f"({1e3 * seconds / QS_PROP_STEPS:.3f} ms/step, {card()}), loss "
          f"{float(losses[:10].mean()):.6f} -> {float(losses[-10:].mean()):.6f}, proposal "
          f"loss {first:.6f} -> {last:.6f} over {len(rg_losses)} proposal steps; "
          f"launches {launches}")
    require(bool(torch.isfinite(losses).all()), "quick start prop: non-finite loss")
    require(last < first, f"quick start prop: proposal loss {first} -> {last} did not fall")
    for name in ("importance_sampling", "composite_fwd", "composite_bwd"):
        require(launches[name] > 0, f"kernel {name} never launched in the proposal leg")

    batch = sampler.sample(g)
    biases = [torch.rand(PROP_RAYS, generator=g, device=dev) for _ in range(2)]

    def step(plain=False):
        for p in (*field.parameters(), *prop.parameters()):
            p.grad = None
        before = dict(cuda.LAUNCHES)
        with plain_kernels(QS_PROP_KERNELS) if plain else contextlib.nullcontext():
            loss, trans = leg_loss(batch, True, biases=biases)
            loss = loss + estimator.compute_loss(trans, 1024.0)
            loss.backward()
        if plain:
            require(cuda.LAUNCHES == before, "the plain proposal leg launched a kernel")
        grads = {f"field.{k}": p.grad.clone() for k, p in field.named_parameters()}
        grads.update({f"prop.{k}": p.grad.clone() for k, p in prop.named_parameters()})
        for name, gr in grads.items():
            require(torch.isfinite(gr).all() and float(gr.abs().max()) > 0,
                    f"quick start prop: gradient of {name} is zero or not finite")
        return float(loss.detach()), grads

    what, reading, limit, loss_rel = step_readings(
        "quick start prop step bf16, kernels vs plain versions", step, step(plain=True),
        BF16_STEP_FRO)
    require(reading <= limit, f"{what}: a gradient leaf off by {reading} > {limit}")
    require(loss_rel <= 1e-5, f"{what}: losses differ by {loss_rel}")
    return launches


# Phases 20 and 21, and --example prop-*: the proposal example's paths,
# each built by the example's own build() from the flags a user passes (its
# defaults otherwise): path -> (flags, the kernels its training launches)
PROP_PATHS = {
    "prop-cp": (["--field", "cp"], PATH_KERNELS["prop"]),
    "prop-ngp": (["--field", "ngp"],
                 ("hash_fwd", "hash_bwd", "composite_fwd", "composite_bwd",
                  "importance_sampling")),
    "prop360": (["--scene", "procedural360", "--field", "cp"], PATH_KERNELS["prop"]),
}


# Phase 27: the quick start's loop through the sparse estimator.  JAX's
# windowed rounds end after 64, and a round moves a live ray on by at least
# its 40 windows of 8 candidates (nerfacc_tpu/grid.py:1202-1320).
VDB_ROUND_REACH = 64 * 40 * 8


def same_samples(a, b):
    """True if two ``(ray_indices, t_starts, t_ends)`` are equal bit for bit."""
    return all(same_bits(x, y) for x, y in zip(a, b))


def vdb_traversals(dev, estimator, data, label):
    """On ``estimator``'s trained grid, through ``sparse_grid_from_dense``, a
    ``VDBEstimator`` and an ``N3TreeEstimator`` sample ``data``'s rays:
    ``traversal="windowed"`` must equal ``OccGridEstimator``'s samples with
    ``QS_VIEW_MAX_SAMPLES`` candidates, ``"padded"`` its samples with 1024,
    bit for bit; no orbit may reach ``VDB_ROUND_REACH``.  Returns that
    ``OccGridEstimator`` (its cap 1024)."""
    dense = estimator.binaries[0]
    grid = nerfacc_tpu_torch.sparse_grid_from_dense(dense, AABB, device=dev)
    occ = nerfacc_tpu_torch.OccGridEstimator(roi_aabb=AABB, resolution=QS_RES,
                                             max_samples=QS_VIEW_MAX_SAMPLES, device=dev)
    occ.binaries = dense[None].clone()
    occ.occs = estimator.occs.clone()
    rays_o, rays_d = data["rays_o"].reshape(-1, 3), data["rays_d"].reshape(-1, 3)
    n_rays = rays_o.shape[0]
    kw = dict(render_step_size=QS_STEP, early_stop_eps=0.0, alpha_thre=0.0)
    exact = occ.sampling(rays_o, rays_d, **kw)
    occ.max_samples = 1024  # from here on phase 19's cap
    capped = occ.sampling(rays_o, rays_d, **kw)
    for cls in (nerfacc_tpu_torch.VDBEstimator, nerfacc_tpu_torch.N3TreeEstimator):
        est = cls(init_grid=grid, device=dev)
        require(torch.equal(est.binaries, occ.binaries), f"{cls.__name__}: grid differs")
        windowed = est.sampling(rays_o, rays_d, traversal="windowed", **kw)
        padded = est.sampling(rays_o, rays_d, traversal="padded", **kw)
        ok_w, ok_p = same_samples(windowed, exact), same_samples(padded, capped)
        print(f"{label}, {cls.__name__}, view 0 ({n_rays} rays): windowed "
              f"{windowed[0].shape[0]} samples, bitwise OccGridEstimator's at "
              f"{QS_VIEW_MAX_SAMPLES} candidates: {ok_w}; padded {padded[0].shape[0]}, "
              f"bitwise its at 1024: {ok_p}")
        require(ok_w and ok_p, f"{label}: {cls.__name__}'s samples differ from "
                "OccGridEstimator's")
    per_ray = [torch.bincount(s[0], minlength=n_rays) for s in (exact, capped)]
    _, t_far, hits = nerfacc_tpu_torch.ray_aabb_intersect(rays_o, rays_d, occ.aabbs)
    longest = float(t_far[hits].max()) / QS_STEP
    print(f"{label}: the 1024-candidate cap cut {int((per_ray[1] < per_ray[0]).sum())} "
          f"of {n_rays} rays ({int(per_ray[0].sum() - per_ray[1].sum())} samples); the "
          f"longest orbit to the box's far side holds {longest:.1f} candidates, JAX's "
          f"windowed rounds reach at least {VDB_ROUND_REACH}")
    require(longest < VDB_ROUND_REACH, f"{label}: an orbit outreaches JAX's windowed rounds")
    return occ


def phase_quickstart_vdb(dev, ds, qs_loop_ms):
    """27. Phase 19's loop with ``VDBEstimator`` (128^3 over +-1.5, the VDB
    update: only the touched voxels change) in place of
    ``OccGridEstimator``; launches counted, G1-G5 must launch and the loss
    must fall below ``QS_LOSS_RATIO``.  One step through the kernels
    against their plain versions (phase 5's bounds).  On the trained grid
    :func:`vdb_traversals` for view 0's rays.  View 0 through ``qs_frame``
    against ``trainer.render_rays`` within 2e-3.  A loop step timed by
    ``utils.profiler.benchmark`` against the same step with
    ``OccGridEstimator`` on the same grid, field and rays, and beside
    phase 19's (``qs_loop_ms``).  Then the loop on the hard-surface scene's
    train split (6 views at 256x256), its VDB update driven by the scene's
    own density times the step (the learned field raises its density in
    every cell there): the update must leave fewer than all voxels
    occupied, and :func:`vdb_traversals` holds that grid's samples of the
    scene's view 0.  Returns both loops' launches."""
    from nerfacc_tpu_torch.utils import profiler

    print(f"vdb quick start: {card()}")
    t_phase = time.perf_counter()
    field, estimator, batches, launches, step_s = qs_train(
        dev, nerfacc_tpu_torch.VDBEstimator, "vdb quick start")
    qs_step_checks(dev, field, estimator, batches[QS_STEPS], "vdb quick start")

    occ = vdb_traversals(dev, estimator, ds[0], "vdb traversals")
    data = ds[0]

    # view 0 through the quick start's calls against the exact renderer
    trainer = make_trainer(dev)
    state = TrainState({k: v.detach() for k, v in field.state_dict().items()}, None,
                       occ.state, 0)
    colors, vdb_seconds = qs_frame_timed(field, estimator, data)
    vdb_seconds = min([vdb_seconds] + [qs_frame_timed(field, estimator, data)[1]
                                       for _ in range(2)])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exact_colors = trainer.render_rays(state, data)[0]
    torch.cuda.synchronize()
    exact_seconds = time.perf_counter() - t0
    diff = float((colors - exact_colors).abs().max())
    print(f"vdb quick start view 0: sampling + rendering vs trainer.render_rays, max colour "
          f"difference {diff:.3g} (limit 2e-3); {vdb_seconds:.4f} s/frame against "
          f"{exact_seconds:.4f} s/frame for render_rays ({card()})")
    require(diff <= 2e-3, f"vdb quick start view 0: differs from render_rays by {diff}")

    # a loop step off the update interval, VDBEstimator against
    # OccGridEstimator on the same grid, field and rays: occ, vdb, vdb, occ
    optimizer = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)

    def loop_step(est, batch):
        loss, _ = qs_loss(field, est, batch)
        optimizer.zero_grad()
        loss.backward()
        optimizer.step()
        return loss

    times = {"OccGridEstimator": [], "VDBEstimator": []}
    for name, est in (("OccGridEstimator", occ), ("VDBEstimator", estimator)) * 2:
        times[name].append(profiler.benchmark(
            loop_step, est, batches[QS_STEPS], iters=QS_TIMED_STEPS, warmup=2)["mean_ms"])
    print(f"vdb quick start: a loop step {times['VDBEstimator'][0]:.3f} / "
          f"{times['VDBEstimator'][1]:.3f} ms against {times['OccGridEstimator'][0]:.3f} / "
          f"{times['OccGridEstimator'][1]:.3f} ms with OccGridEstimator on the same grid "
          f"(profiler.benchmark, mean of {QS_TIMED_STEPS}); phase 19's loop step "
          f"{qs_loop_ms:.3f} ms (median of its last {QS_TIMED_STEPS}); the VDB loop's "
          f"median {1e3 * statistics.median(step_s[-QS_TIMED_STEPS:]):.3f} ms ({card()})")

    # the hard-surface scene, whose empty space the VDB update must disable;
    # the update reads the scene's own density (a learned CP field raises
    # its density in every cell of this scene, PERF.md §6)
    opaque = ProceduralOpaqueSceneLoader(split="train", n_train=6, width=256, height=256,
                                         num_rays=TRAIN["cp"][1], seed=QUALITY_SEEDS[0],
                                         device=dev)
    _, estimator, _, opaque_launches, _ = qs_train(
        dev, nerfacc_tpu_torch.VDBEstimator, "vdb opaque", train=opaque,
        occ_eval_fn=lambda x: opaque.query_density(x, opaque.blob_centers)[:, 0] * QS_STEP)
    share = float(estimator.binaries.float().mean())
    print(f"vdb opaque: after {QS_STEPS} steps the VDB update, from the scene's density, "
          f"left {share:.4f} of the {QS_RES}^3 voxels occupied")
    require(share < 1.0, "vdb opaque: the VDB update disabled no voxel")
    vdb_traversals(dev, estimator, ProceduralOpaqueSceneLoader(split="test", device=dev)[0],
                   "vdb opaque traversals")
    print(f"vdb quick start: phase 27 took {time.perf_counter() - t_phase:.1f} s ({card()})")
    return {k: v + opaque_launches.get(k, 0) for k, v in launches.items()}


def dist_occ_spec(steps, **kw):
    """A phase 28 occupancy case: the bench CP field (bf16) and trainer with
    a per-rank budget of ``DIST_BUDGET`` (nothing truncates), a global batch
    of ``TRAIN["cp"][1]`` rays drawn each step from phase 4's scene."""
    return dict(field=dict(aabb=AABB, compute_dtype=torch.bfloat16),
                trainer=dict(sample_budget=DIST_BUDGET),
                scene=dict(split="train", n_train=6, width=256, height=256,
                           num_rays=TRAIN["cp"][1]),
                steps=steps, **kw)


def per_rank_step(launches, steps, kernels=DIST_KERNELS):
    """A rank's launches a step, of ``kernels``."""
    return ", ".join(f"{k} {launches.get(k, 0) / steps:.3f}" for k in kernels)


def leaf_fro(got, want):
    """The largest relative Frobenius distance of ``got``'s leaves from
    ``want``'s (dicts of numpy arrays)."""
    return max(float(np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30))
               for k, w in want.items())


def require_adam_close(got, want, got_grads, want_grads, rtol, atol, what, weight_decay=0.0):
    """Every leaf of ``got`` (parameters after Adam steps) within ``atol +
    rtol |want|`` of ``want``'s, except the entries whose update may
    rightly differ: Adam's first steps move an entry by about lr times the
    sign of its gradient (plus the decay), so an entry whose gradient at
    some step (``*_grads``: one dict a step) lay within the two runs'
    difference of zero may step the other way, by up to 2 lr.  Both runs'
    gradients must agree within ``BF16_STEP_FRO`` per leaf.  Returns the
    count of such entries and the worst excess elsewhere."""
    exempt, worst = 0, -np.inf
    for k, w in want.items():
        ambiguous = np.zeros(w.shape, bool)
        for g, h in zip(got_grads, want_grads):
            fro = np.linalg.norm(g[k] - h[k]) / max(np.linalg.norm(h[k]), 1e-30)
            require(fro <= BF16_STEP_FRO, f"{what}: gradient of {k} {fro:.3g} from the other's")
            ambiguous |= np.abs(h[k] + weight_decay * w) <= np.abs(g[k] - h[k])
        excess = np.abs(got[k] - w) - (atol + rtol * np.abs(w))
        exempt += int((ambiguous & (excess > 0)).sum())
        if (~ambiguous).any():
            worst = max(worst, float(excess[~ambiguous].max()))
    require(worst <= 0, f"{what}: past rtol {rtol} / atol {atol} by {worst:.3g}")
    return exempt, worst


def phase_distributed(dev):
    """28. The distributed layer on the card (``nerfacc_tpu_torch.parallel``,
    ranks started by ``spawn``, the rank bodies of ``parallel.dryrun``):
    a) NCCL, one rank: ``make_dp_train_step`` over ``DIST_STEPS`` steps of
    the bench CP trainer against ``train_step`` from the same state, through
    every kernel, bit for bit (parameters, gradients, grid, aux): every sum
    of the step runs in a fixed order; NCCL with two ranks on one card must
    raise.
    b) gloo, two ranks on ``cuda:0``: one stratified DP step against the
    single-process step on the global batch (tests/test_parallel.py's DP
    bounds, binaries equal, the ranks bitwise equal), then
    ``DIST_TRAIN_STEPS`` DP steps (the loss must halve; ms/step and the
    collectives' share of a step), then one DP step through the kernels
    against one through the plain versions (phase 5's bf16 bound).
    c) gloo, four ranks on a (2, 2) mesh: two DP+TP steps against the
    single-process steps (tests/test_parallel.py's TP bounds, W1 in
    shard-major order), rank 16 a shard, the checkpoint round trip.
    d) the proposal DP step on b's two ranks, ``bench_prop``'s fields,
    against the single-process step.  e) the dry run of
    ``dryrun_multichip(4)`` (its rank body, ``case_dryrun``) on c's four
    ranks.
    Every rank launches the path's kernels (G1-G5; G14 in d).  Returns the
    launches summed over ranks and steps."""
    from nerfacc_tpu_torch import parallel
    from nerfacc_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"distributed: {card()}")
    total = {}

    def add(launches, what, kernels=DIST_KERNELS):
        """Count a rank's launches; each of ``kernels`` must be among them."""
        for k in kernels:
            require(launches.get(k, 0) > 0, f"{what}: kernel {k} never launched on a rank")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    # a) NCCL at world size 1: every collective real, no bit may move
    try:
        parallel.make_mesh(2, 0, "tcp://127.0.0.1:1", backend="nccl", device=dev)
        require(False, "NCCL with two ranks on one card did not raise")
    except ValueError as e:
        print(f"distributed a: NCCL with two ranks on one card raises: {e}")
    t0 = time.perf_counter()
    a = parallel.spawn(1, dryrun.run_cases, None, [
        ("kernels", "occ", dist_occ_spec(DIST_STEPS, single=True)),
    ], backend="nccl", timeout=DIST_TIMEOUT)[0]
    print(f"distributed a: one rank ran in {time.perf_counter() - t0:.1f} s ({card()})")
    dp, single = a["kernels"]["dp"], a["kernels"]["single"]
    same = [all(np.array_equal(dp[part][k], single[part][k]) for k in single[part])
            for part in ("params", "grads")]
    same += [np.array_equal(dp[k], single[k]) for k in ("occs", "binaries")]
    same.append(all(np.array_equal(np.asarray(x[k]), np.asarray(y[k]))
                    for x, y in zip(dp["aux"], single["aux"]) for k in y))
    print(f"distributed a: NCCL, 1 rank, {DIST_STEPS} DP steps vs train_step through every "
          f"kernel: parameters, gradients, occs, binaries, aux bit for bit {same}; "
          f"launches a step {per_rank_step(a['kernels']['launches'], DIST_STEPS)}")
    require(all(same), "a: the DP step at world size 1 moved a bit")
    add(a["kernels"]["launches"], "a")

    # b) gloo, two ranks sharing the card; they run d) too
    t0 = time.perf_counter()
    prop_spec = dict(field=dict(aabb=AABB, compute_dtype=torch.bfloat16),
                     prop=dict(aabb=AABB, compute_dtype=torch.bfloat16),
                     trainer=dict(prop_samples=[PROP_SAMPLES], num_samples=PROP_FINAL,
                                  near_plane=2.0, far_plane=6.0),
                     scene=dict(split="train", n_train=6, width=256, height=256,
                                num_rays=PROP_RAYS), single=True)
    b = parallel.spawn(2, dryrun.run_cases, None, [
        ("one", "occ", dist_occ_spec(1, single=True, record_grads=True)),
        ("train", "occ", dist_occ_spec(DIST_TRAIN_STEPS, timed=True, single=True,
                                       plain_swaps={k: PLAIN_SWAPS[k] for k in DIST_KERNELS})),
        ("prop", "prop", prop_spec),
    ], backend="gloo", device=str(dev), timeout=DIST_TIMEOUT)
    print(f"distributed b, d: two ranks ran in {time.perf_counter() - t0:.1f} s ({card()})")
    single = b[0]["one"]["single"]
    for r, rank in enumerate(b):
        dp = rank["one"]["dp"]
        loss, want = float(dp["aux"][0]["loss"]), float(single["aux"][0]["loss"])
        exempt, worst = require_adam_close(dp["params"], single["params"], dp["step_grads"],
                                           single["step_grads"], 2e-4, 2e-6,
                                           "b: DP parameters", weight_decay=1e-6)
        print(f"distributed b: gloo, rank {r} of 2, one stratified DP step vs the "
              f"single-process step on {TRAIN['cp'][1]} rays: loss {loss:.7g} / {want:.7g}, "
              f"samples {int(dp['aux'][0]['n_rendering_samples'])} of "
              f"{int(single['aux'][0]['n_rendering_samples'])}, gradients "
              f"{leaf_fro(dp['grads'], single['grads']):.3g} and parameters "
              f"{leaf_fro(dp['params'], single['params']):.3g} relative Frobenius at most; "
              f"parameters within rtol 2e-4 / atol 2e-6 (worst excess {worst:.3g}) but "
              f"{exempt} entries of gradient within the runs' difference of zero")
        require(abs(loss - want) <= 1e-5 * abs(want), "b: DP loss")
        require(np.array_equal(dp["binaries"], single["binaries"]), "b: binaries")
        add(rank["one"]["launches"], "b")
    require(all(np.array_equal(b[0][c]["dp"]["params"][k], b[1][c]["dp"]["params"][k])
                for c in ("one", "train") for k in single["params"]),
            "b: the ranks' parameters differ")
    for r, rank in enumerate(b):
        run = rank["train"]
        losses = [float(x["loss"]) for x in run["dp"]["aux"]]
        first, last = statistics.mean(losses[:20]), statistics.mean(losses[-20:])
        print(f"distributed b: gloo, rank {r} of 2, {DIST_TRAIN_STEPS} DP steps: loss "
              f"{first:.5f} -> {last:.5f} (means of the first and last 20), "
              f"{run['ms_step']:.3f} ms/step (one process on the global batch, rank 1 "
              f"waiting: {b[0]['train']['single_ms_step']:.3f}), one step's collectives alone "
              f"{run['collectives_ms']:.3f} ms ({run['collectives_ms'] / run['ms_step']:.1%} of "
              f"a step); launches a step {per_rank_step(run['launches'], DIST_TRAIN_STEPS)} "
              f"({card()})")
        require(last <= 0.5 * first, "b: the DP loss did not halve")
        plain = run["plain"]
        worst = max(plain["fro"].values())
        print(f"distributed b: rank {r}, a DP step through the kernels vs the plain "
              f"versions: loss {plain['loss']:.7g} / {plain['plain_loss']:.7g}, gradients "
              f"{worst:.3g} relative Frobenius at most (limit {BF16_STEP_FRO})")
        require(abs(plain["loss"] - plain["plain_loss"]) <= 1e-5 * abs(plain["plain_loss"])
                and worst <= BF16_STEP_FRO, "b: kernels vs plain versions")
        add(run["launches"], "b")

    # c) gloo, four ranks on a (2, 2) data x model mesh; they run e) too
    t0 = time.perf_counter()
    c = parallel.spawn(4, dryrun.run_cases, (2, 2), [
        ("tp", "tp", dist_occ_spec(2, single=True, record_grads=True)),
        ("dryrun", "dryrun", 4),
    ], backend="gloo", device=str(dev), timeout=DIST_TIMEOUT)
    print(f"distributed c, e: four ranks ran in {time.perf_counter() - t0:.1f} s ({card()})")
    single, gathered = c[0]["tp"]["single"], c[0]["tp"]["gathered"]
    perm = c[0]["tp"]["perm"]
    want = dict(single["params"], **{"mlp_base.0": single["params"]["mlp_base.0"][perm]})
    for r, rank in enumerate(c):
        res = rank["tp"]
        lines = [v[0] for k, v in res["shapes"].items() if k.startswith("encoder.lines.")]
        losses = [float(x["loss"]) for x in res["aux"]]
        print(f"distributed c: gloo, rank {r} of a (2, 2) mesh: line tables {lines} (and "
              f"their moments {res['shapes']['encoder.lines.0'][1:]}), W1 "
              f"{res['shapes']['mlp_base.0'][0]}; losses {losses} vs "
              f"{[float(x['loss']) for x in single['aux']]}; checkpoint round trip "
              f"{res['roundtrip']}; init is its part of the whole draw {res['init_equal']}; "
              f"launches a step {per_rank_step(res['launches'], 2)}")
        require(all(s[-1] == 16 for s in lines), "c: line tables not rank 16 a shard")
        require(all(abs(x - float(y["loss"])) <= 1e-4 * abs(float(y["loss"]))
                    for x, y in zip(losses, single["aux"])), "c: TP losses")
        require(abs(res["roundtrip"][0] - res["roundtrip"][1]) < 1e-6, "c: round trip")
        require(res["init_equal"], "c: the sharded field's draw")
        add(res["launches"], "c")
    permuted = [dict(g, **{"mlp_base.0": g["mlp_base.0"][perm]}) for g in single["step_grads"]]
    exempt, worst = require_adam_close(gathered["params"], want, gathered["step_grads"],
                                       permuted, 2e-4, 2e-5, "c: TP parameters",
                                       weight_decay=1e-6)
    print(f"distributed c: gathered parameters after 2 TP steps vs the single-process "
          f"steps: {leaf_fro(gathered['params'], want):.3g} relative Frobenius at most, "
          f"within rtol 2e-4 / atol 2e-5 (worst excess {worst:.3g}) but {exempt} entries "
          f"of gradient within the runs' difference of zero; last step's gradients "
          f"{leaf_fro(gathered['step_grads'][-1], permuted[-1]):.3g}")

    # d) the proposal path, on b's two ranks
    single = b[0]["prop"]["single"]
    for r, rank in enumerate(b):
        dp = rank["prop"]["dp"]
        leaves = [dict(enumerate(run[part])) for run in (dp, single)
                  for part in ("params", "grads")]
        exempt, worst = require_adam_close(leaves[0], leaves[2], [leaves[1]], [leaves[3]],
                                           2e-4, 2e-6, "d: proposal DP parameters")
        print(f"distributed d: gloo, rank {r} of 2, a proposal DP step vs the single-process "
              f"step on {PROP_RAYS} rays: loss {float(dp['aux']['loss']):.7g} / "
              f"{float(single['aux']['loss']):.7g}, prop loss "
              f"{float(dp['aux']['prop_loss']):.7g} / {float(single['aux']['prop_loss']):.7g}; "
              f"gradients {leaf_fro(leaves[1], leaves[3]):.3g} relative Frobenius at most, "
              f"parameters within rtol 2e-4 / atol 2e-6 (worst excess {worst:.3g}) but "
              f"{exempt} entries of gradient within the runs' difference of zero; launches a "
              f"step {per_rank_step(rank['prop']['launches'], 1, DIST_PROP_KERNELS)}")
        for key in ("loss", "mse", "prop_loss"):
            want = float(single["aux"][key])
            require(abs(float(dp["aux"][key]) - want) <= 1e-5 * abs(want), f"d: {key}")
        add(rank["prop"]["launches"], "d", DIST_PROP_KERNELS)

    # e) the dry run's rank body (dryrun_multichip's) on c's four ranks
    e = [rank["dryrun"] for rank in c]
    print(f"distributed e: {e[0]['line']}; launches a step, by rank: "
          + "; ".join(per_rank_step(rank["launches"], 2) for rank in e))
    for rank in e:
        add(rank["launches"], "e")
    print(f"distributed: phase 28 took {time.perf_counter() - t_phase:.1f} s ({card()})")
    return total


# Phase 29: the windowed sweep and pool sized so that no ray is cut (an
# orbit of the bench grid holds ~1040 candidates from near 0, 130 windows)
POOLED_SWEEP = 160
POOLED_WINDOW_BUDGET = 2**18
POOLED_SAMPLE_BUDGET = 2**22


def flat_samples(valid, t_starts, t_ends, ray_of_row):
    """(int64 ray ids, starts, ends) of the valid candidates of a padded
    layout, in row-major order."""
    rays = ray_of_row.long()[:, None].expand_as(valid)
    return rays[valid], t_starts[valid], t_ends[valid]


def phase_pooled_entry_points(dev, trainer, state, batch):
    """29. The occupancy estimator's windowed and pooled entry points on
    phase 4's trained bench CP field, its 128^3 grid and one of its train
    batches (2048 rays, near planes jittered by a seeded draw), against
    ``sampling`` (the march, G2): ``sampling_padded`` over the whole orbit's
    lattice and windowed (``POOLED_SWEEP`` windows, so that no ray is
    cut), ``sampling_pooled`` (``POOLED_WINDOW_BUDGET`` windows) and its
    ``compact_samples_from_windows`` must emit its samples bit for bit.
    Without jitter, ``render_rays_occgrid_pooled`` with no early stop in one
    round must give ``render_rays_with_occgrid``'s image on ``sampling``'s
    samples bit for bit, and with its defaults (early stop at 1 - 1e-4),
    like ``make_cursor_eval_chunk``, within ``RENDERER_COLOUR_ERR``.  Each
    call timed (host clock after a sync, the best of three); every entry
    point must launch G2, and the renderers G1 and G3.  Returns the
    phase's launches."""
    from nerfacc_tpu_torch.estimators.occ_grid import sampling, sampling_padded, sampling_pooled
    from nerfacc_tpu_torch.utils import rendering

    print(f"pooled entry points: {card()}")
    t_phase = time.perf_counter()
    occ, step = state.occ_state, trainer.render_step_size
    o, d = batch["rays_o"], batch["rays_d"]
    n_rays = o.shape[0]
    bkgd = batch["color_bkgd"]
    field_fn = trainer._field_fn(state, batch)
    jitter = torch.rand(n_rays, device=dev, generator=torch.Generator(device=dev).manual_seed(29))
    total = {}

    def call(what, fn, kernels):
        """``fn()`` three times: its result, best seconds and launches of one
        call; each of ``kernels`` must launch."""
        best = math.inf
        for _ in range(3):
            before = dict(cuda.LAUNCHES)
            out, seconds = timed(fn)
            best = min(best, seconds)
        launched = {k: cuda.LAUNCHES[k] - before[k] for k in cuda.LAUNCHES}
        for k in kernels:
            require(launched[k] > 0, f"29: {what} launched no {k}")
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
        return out, best, launched

    with torch.no_grad():
        ref, ref_s, _ = call("sampling", lambda: sampling(
            occ, o, d, render_step_size=step, near_jitter=jitter), ["march"])
        want = (ref.ray_indices.long(), ref.t_starts, ref.t_ends)
        rows = torch.arange(n_rays, device=dev)
        kw = dict(render_step_size=step, stratified=True, near_jitter=jitter)
        def padded(**extra):
            res = sampling_padded(occ, o, d, **kw, **extra)
            return flat_samples(res.valid, res.t_starts, res.t_ends, rows)

        outs = {
            "sampling_padded (lattice)": lambda: padded(max_samples=None),
            f"sampling_padded (windowed, {POOLED_SWEEP} windows)": lambda: padded(
                windowed=True, n_windows=POOLED_SWEEP, max_coarse=POOLED_SWEEP),
            "sampling_pooled + compact_samples_from_windows": lambda: (lambda c: (
                c.ray_indices.long(), c.t_starts, c.t_ends))(
                rendering.compact_samples_from_windows(sampling_pooled(
                    occ, o, d, window_budget=POOLED_WINDOW_BUDGET, max_coarse=POOLED_SWEEP,
                    **kw), POOLED_SAMPLE_BUDGET, n_rays)),
        }
        for what, fn in outs.items():
            got, seconds, launched = call(what, fn, ["march"])
            same = same_samples(got, want)
            print(f"pooled entry points: {what}: {got[0].shape[0]} samples of {n_rays} rays, "
                  f"bitwise sampling's {want[0].shape[0]}: {same}; {seconds:.4f} s against "
                  f"{ref_s:.4f} s for sampling; launches {launched['march']} march ({card()})")
            require(same, f"29: {what}'s samples differ from sampling's")

        exact_samples = compact_samples(sampling(occ, o, d, render_step_size=step))
        (exact, exact_s, _) = call("the exact renderer", lambda: rendering.render_rays_with_occgrid(
            lambda p, dirs, _ids: field_fn(p, dirs), o, d, exact_samples, bkgd)[:3],
            ["cp_level_fwd", "composite_fwd"])
        pooled, pooled_s, _ = call("render_rays_occgrid_pooled", lambda: (
            rendering.render_rays_occgrid_pooled(
                field_fn, occ, o, d, render_bkgd=bkgd, render_step_size=step,
                early_stop_eps=0.0, budget=POOLED_SAMPLE_BUDGET,
                window_budget=POOLED_WINDOW_BUDGET, max_coarse=POOLED_SWEEP, max_rounds=1)),
            ["march", "cp_level_fwd", "composite_fwd"])
        same = all(torch.equal(a, b) for a, b in zip(pooled, exact))
        print(f"pooled entry points: render_rays_occgrid_pooled, no early stop, one round: "
              f"colours, opacities and depths bitwise the exact renderer's on "
              f"{exact_samples.num_valid} samples: {same}; {pooled_s:.4f} s against "
              f"{exact_s:.4f} s for render_rays_with_occgrid ({card()})")
        require(same, "29: the pooled renderer without early stop is not the exact one")
        early, early_s, launched = call("render_rays_occgrid_pooled (defaults)", lambda: (
            rendering.render_rays_occgrid_pooled(field_fn, occ, o, d, render_bkgd=bkgd,
                                                 render_step_size=step)),
            ["march", "cp_level_fwd", "composite_fwd"])
        chunk_fn = rendering.make_cursor_eval_chunk(field_fn, occ, render_step_size=step)
        cursor, cursor_s, cursor_launched = call("make_cursor_eval_chunk", lambda: chunk_fn(o, d),
                                                 ["march", "cp_level_fwd", "composite_fwd"])
        cursor_colors = cursor[0] + bkgd * (1.0 - cursor[1])
        for what, colors, seconds, n in (
                ("render_rays_occgrid_pooled (defaults)", early[0], early_s, launched),
                ("make_cursor_eval_chunk (defaults)", cursor_colors, cursor_s,
                 cursor_launched)):
            diff = float((colors - exact[0]).abs().max())
            print(f"pooled entry points: {what}: max colour difference from the exact "
                  f"renderer {diff:.3g} (limit {RENDERER_COLOUR_ERR}); {seconds:.4f} s, "
                  f"launches march {n['march']}, composite_fwd {n['composite_fwd']} "
                  f"({card()})")
            require(diff <= RENDERER_COLOUR_ERR, f"29: {what} differs by {diff}")
    print(f"pooled entry points: phase 29 took {time.perf_counter() - t_phase:.1f} s "
          f"({card()})")
    return total


# Phase 30: the public options the port takes as the JAX package does
OPTIONS_FIRST_ROUND = 700  # (b): the first round's orbit candidates a ray
OPTIONS_STEPS = 50  # (c): steps of the bench CP field at other widths
OPTIONS_TNV_STEPS = 12  # (e): TiNeuVox steps with a tri-plane level
OPTIONS_PADDED = 256  # (f): the padded step's max_samples_per_ray
OPTIONS_NEAR = 2.0  # (f): its near plane, the scene's, so 256 candidates reach the box
OPTIONS_ERR = 2e-3  # (a): kernels vs plain versions, phase 2's exact renderer's bound
OPTIONS_SUM_ERR = 1e-5  # (b): two rounds vs one, of the largest output
OPTIONS_GRAD_ERR = 1e-4  # (b): the second round's gradients vs one round's, of the largest
OPTIONS_KERNELS = ("cp_level_fwd", "cp_level_bwd", "march", "composite_fwd", "composite_bwd",
                   "hash_fwd", "hash_bwd", "hat_fwd", "hat_bwd_line", "hat_bwd_x")


def _leaf_rounds(field_fn, o, d, rounds):
    """(b)'s renders: ``render_rays_with_occgrid`` on each ``(name, samples,
    prefix_fn)`` of ``rounds`` in turn, the field's colours and densities
    made leaves that ask for a gradient (``prefix_fn(outputs, leaves so
    far)`` gives the carried transmittance or None); unnormalised depths.  Returns the
    outputs and the leaves by name."""
    from nerfacc_tpu_torch.utils import rendering

    outs, leaves = {}, {}
    for name, samples, prefix_fn in rounds:
        def fn(positions, dirs, _ids, name=name):
            with torch.no_grad():
                rgb, sigma = field_fn(positions, dirs)
            leaves[name] = (rgb.requires_grad_(True), sigma.requires_grad_(True))
            return leaves[name]

        outs[name] = rendering.render_rays_with_occgrid(
            fn, o, d, samples, expected_depths=False, prefix_trans=prefix_fn(outs, leaves))[:3]
    return outs, leaves


def split_rounds(whole, counts):
    """A march's samples split into two rounds: each ray's first ``counts``
    (n_rays,) samples, then the rest, as two ``MarchResult`` tuples, and the
    mask of the first round's samples in ``whole``.  Both rounds keep the
    whole march's bounds, so that the field sees the same points."""
    n = whole.counts.long()
    ray_of = whole.ray_indices.long()
    slot = torch.arange(ray_of.shape[0], device=ray_of.device) - (torch.cumsum(n, 0) - n)[ray_of]
    in_first = slot < counts.long()[ray_of]

    def part(mask, c):
        return whole._replace(ray_indices=whole.ray_indices[mask], t_starts=whole.t_starts[mask],
                              t_ends=whole.t_ends[mask], counts=c.to(whole.counts.dtype))

    return part(in_first, counts), part(~in_first, n - counts.long()), in_first


def carried_transmittance(samples, sigmas, n_rays):
    """(n_rays, 1) ``exp(-sum min(sigma delta, 40))`` over each ray's
    ``samples`` (a round's transmittance as kernel G3 forms it, in place of
    ``1 - opacity``, whose sum of ``1 - exp(-x)`` terms loses digits where
    many samples are nearly empty)."""
    sd = (sigmas.detach() * (samples.t_ends - samples.t_starts)).clamp(max=40.0)
    total = torch.zeros(n_rays, dtype=sd.dtype, device=sd.device)
    total.index_add_(0, samples.ray_indices.long(), sd)
    return torch.exp(-total)[:, None]


def _backward_sums(outs, names, cot):
    """Backward of ``sum(cot . (colour, opacity, depth))`` of the rounds
    ``names`` summed; returns the summed outputs."""
    total = [sum(outs[n][i] for n in names) for i in range(3)]
    sum((x * cot[:, i : i + w]).sum() for x, i, w in zip(total, (0, 3, 4), (3, 1, 1))).backward()
    return [t.detach() for t in total]


def phase_options(dev, trainer, state, batch, ds):
    """30. The options the port takes as the JAX package does, at full
    width, each path driven with the launch counts zeroed before it and read
    after it (the comparisons with the plain versions are not counted): a)
    ``render_image_with_occgrid`` at JAX's defaults (1024 orbit candidates a
    ray, a 2^18 budget a chunk) on phase 4's trained bench CP field and its
    grid, test view 0, through the kernels against the plain versions
    (within ``OPTIONS_ERR``), the share of rays the candidate window cuts
    and the difference from the whole orbit's image printed; b) on phase 4's
    train batch, ``render_rays_with_occgrid`` over each ray's first
    ``OPTIONS_FIRST_ROUND`` candidates, then over the rest of the whole
    orbit's samples (:func:`split_rounds`) carrying
    the first round's transmittance (:func:`carried_transmittance`) as
    ``prefix_trans``, against one round over the whole orbit: the sums
    within ``OPTIONS_SUM_ERR`` of the largest, and through G3/G5
    (and again on their plain versions) the gradients of the second round's
    colours and densities within ``OPTIONS_GRAD_ERR`` of the one round's
    largest, the first round's colours' within 1e-6; c) the bench CP field
    (lines 32/128/512 x rank 32, bf16) at hidden 128, 31 geometry features
    and no view directions, trained ``OPTIONS_STEPS`` steps on 2048 rays
    with a 2^18 budget (the loss must fall), then one step through the
    kernels against the plain versions (phase 5's bf16 bound); d) the
    full-width NGP field at hidden 128, one step, then a step through G6/G7
    against the plain versions; e) TiNeuVox (f32) with a 64^2 x 16
    tri-plane level, ``OPTIONS_TNV_STEPS`` steps with G8-G10 launching, then
    a step within ``F32_HAT_STEP_FRO`` of the plain versions; f) the bench
    trainer with ``traversal="padded"`` and
    ``max_samples_per_ray=OPTIONS_PADDED`` from phase 4's state, near plane
    ``OPTIONS_NEAR``: no ray's march holds more than that many samples,
    some rays are cut, and the step matches the plain versions.  G1-G10
    must launch.  Returns the phase's launches."""
    from nerfacc_tpu_torch.estimators.occ_grid import sampling

    occ_grid = port_module("trainers.ngp_occ")
    fields = port_module("models.cp_field")
    print(f"options: {card()}")
    t_phase = time.perf_counter()
    total = {}

    def driven(what, fn, kernels):
        """``fn()`` with the launch counts zeroed before and read after; each
        of ``kernels`` must launch."""
        cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launched = dict(cuda.LAUNCHES)
        for k in kernels:
            require(launched[k] > 0, f"30 {what}: no launch of {k}")
        for k, v in launched.items():
            total[k] = total.get(k, 0) + v
        return out, launched

    # a) the chunked image renderer at JAX's defaults
    occ, step = state.occ_state, trainer.render_step_size
    data = ds[0]
    field_fn = trainer._field_fn(state, data)
    serving = ("cp_level_fwd", "march", "composite_fwd")

    def render():
        with torch.no_grad():
            return render_image_with_occgrid(field_fn, occ, data["rays_o"], data["rays_d"],
                                             data["color_bkgd"], render_step_size=step)

    (colors, _, _, n), launched = driven("a", render, serving)
    with plain_kernels(serving):
        plain = render()[0]
    diff = float((colors - plain).abs().max())
    whole = trainer.render_rays(state, data)
    with torch.no_grad():
        window = sampling(occ, data["rays_o"], data["rays_d"], render_step_size=step,
                          max_samples=1024)
    cut = float((~window.terminated).float().mean())
    off = (colors - whole[0]).abs().amax(dim=-1)
    print(f"options a: render_image_with_occgrid at JAX's defaults, view 0: {n} samples "
          f"(the whole orbit {whole[3]}), {cut:.4f} of {colors.shape[0]} rays cut by "
          f"max_samples=1024; kernels vs plain versions max colour difference {diff:.3g} "
          f"(limit {OPTIONS_ERR}); from the whole orbit's image {float(off.max()):.3g} at "
          f"most, {float((off > 1e-3).float().mean()):.4f} of the pixels by more than 1e-3; "
          f"launches {launched['march']} march, {launched['composite_fwd']} composite_fwd "
          f"({card()})")
    require(diff <= OPTIONS_ERR, f"30 a: kernels and plain versions differ by {diff}")
    require(0.0 < cut < 1.0, f"30 a: max_samples cut {cut} of the rays")

    # b) two rounds carrying the transmittance against one round
    o, d = batch["rays_o"], batch["rays_d"]
    field_fn = trainer._field_fn(state, batch)
    with torch.no_grad():
        first = sampling(occ, o, d, render_step_size=step, max_samples=OPTIONS_FIRST_ROUND)
        whole = sampling(occ, o, d, render_step_size=step)
    first, rest, in_a = split_rounds(whole, first.counts)
    first_samples = compact_samples(first)
    rounds = [("one", compact_samples(whole), lambda outs, leaves: None),
              ("a", first_samples, lambda outs, leaves: None),
              ("b", compact_samples(rest), lambda outs, leaves: carried_transmittance(
                  first_samples, leaves["a"][1], o.shape[0]))]
    cot = torch.rand(o.shape[0], 5, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(30))

    def two_rounds():
        outs, leaves = _leaf_rounds(field_fn, o, d, rounds)
        return (_backward_sums(outs, ["one"], cot), _backward_sums(outs, ["a", "b"], cot),
                {k: (v[0].grad, v[1].grad) for k, v in leaves.items()})

    (one, two, grads), launched = driven("b", two_rounds, ("composite_fwd", "composite_bwd"))
    with plain_kernels(("march", "composite_fwd", "composite_bwd")):
        _, two_plain, grads_plain = two_rounds()
    sums = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(two, one))
    plain_sums = max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(two_plain, one))
    readings = {}
    for k, name in ((0, "rgb"), (1, "sigma")):
        g_one = grads["one"][k]
        scale = float(g_one.abs().max())
        readings[f"second round {name}"] = float(
            (grads["b"][k] - g_one[~in_a]).abs().max()) / scale
        readings[f"second round {name}, plain"] = float(
            (grads_plain["b"][k] - g_one[~in_a]).abs().max()) / scale
    first_rgb = float((grads["a"][0] - grads["one"][0][in_a]).abs().max()) / float(
        grads["one"][0].abs().max())
    print(f"options b: {first.ray_indices.shape[0]} + {rest.ray_indices.shape[0]} samples in "
          f"two rounds against {whole.ray_indices.shape[0]} in one, {o.shape[0]} rays: sums "
          f"within {sums:.3g} of the largest output (plain versions {plain_sums:.3g}, limit "
          f"{OPTIONS_SUM_ERR}); gradients, of the largest: first round rgb {first_rgb:.3g} "
          f"(limit 1e-6), " + ", ".join(f"{k} {v:.3g}" for k, v in readings.items())
          + f" (limit {OPTIONS_GRAD_ERR}); launches {launched['composite_fwd']} composite_fwd, "
          f"{launched['composite_bwd']} composite_bwd ({card()})")
    require(max(sums, plain_sums) <= OPTIONS_SUM_ERR, f"30 b: rounds' sums off by {sums}")
    require(first_rgb <= 1e-6, f"30 b: first round's colour gradients off by {first_rgb}")
    require(max(readings.values()) <= OPTIONS_GRAD_ERR, f"30 b: gradients {readings}")

    # c) the bench CP field at other widths, without view directions
    train = train_loader(dev, "cp")
    wide = occ_grid.NGPOccTrainer(
        field=fields.CPRadianceField(AABB, hidden_dim=128, geo_feat_dim=31, use_viewdirs=False),
        aabb=AABB, device=dev, max_steps=TRAIN_STEPS,
    )
    batches = [train[0] for _ in range(OPTIONS_STEPS + 1)]

    def steps(tr, st, bs):
        losses = []
        for b in bs:
            st, aux = tr.train_step(st, b)
            losses.append(aux["loss"])
        return st, torch.stack(losses).cpu()

    (st, losses), launched = driven("c", lambda: steps(wide, wide.init_state(), batches[:-1]),
                                    CP_PATH_KERNELS)
    first_loss, last_loss = float(losses[:10].mean()), float(losses[-10:].mean())
    print(f"options c: CP field hidden 128, geo 31, no view directions (head "
          f"{wide.field.head_dims}): {OPTIONS_STEPS} steps, mean loss of the first 10 "
          f"{first_loss:.6f}, of the last 10 {last_loss:.6f}; launches per step "
          + ", ".join(f"{k} {launched[k] / OPTIONS_STEPS:.3f}" for k in CP_PATH_KERNELS)
          + f" ({card()})")
    require(bool(torch.isfinite(losses).all()) and last_loss < first_loss,
            f"30 c: loss {first_loss} -> {last_loss} did not fall")
    phase_step_vs_plain(wide, st, batches[-1], "30 c cp hidden 128 geo 31 no viewdirs",
                        CP_PATH_KERNELS)
    del wide, st

    # d) NGP at hidden 128
    ngp_kernels = ("hash_fwd", "hash_bwd", "march", "composite_fwd", "composite_bwd")
    ngp = occ_grid.NGPOccTrainer(
        field=port_module("models.ngp").NGPRadianceField(AABB, hidden_dim=128), aabb=AABB,
        device=dev, max_steps=TRAIN_STEPS,
    )
    (st, _), launched = driven("d", lambda: ngp.train_step(ngp.init_state(), batches[0]),
                               ngp_kernels)
    print("options d: NGP field hidden 128 (16 levels, T = 2^19), one step: launches "
          + ", ".join(f"{k} {launched[k]}" for k in ngp_kernels) + f" ({card()})")
    phase_step_vs_plain(ngp, st, batches[1], "30 d ngp hidden 128", ngp_kernels)
    del ngp, st

    # e) TiNeuVox with a tri-plane level, f32
    dyn = port_module("data.procedural").ProceduralDynamicSceneLoader(
        split="train", n_train=6, width=128, height=128, num_rays=TRAIN["tineuvox"][1],
        device=dev)
    tnv = occ_grid.NGPOccTrainer(
        field=port_module("models.tineuvox").TiNeuVoxRadianceField(
            AABB, compute_dtype=torch.float32, plane_resolutions=(64,), plane_ranks=(16,),
            device=dev),
        aabb=AABB, device=dev, timestamps=dyn.timestamps, max_steps=TRAIN_STEPS,
        sample_budget=TRAIN["tineuvox"][2], **TRAIN["tineuvox"][0],
    )
    dyn_batches = [dyn[0] for _ in range(OPTIONS_TNV_STEPS + 1)]
    (st, losses), launched = driven(
        "e", lambda: steps(tnv, tnv.init_state(), dyn_batches[:-1]), PATH_KERNELS_TINEUVOX)
    print(f"options e: TiNeuVox f32 with a 64^2 x 16 tri-plane level: {OPTIONS_TNV_STEPS} "
          f"steps, losses {float(losses[0]):.6f} -> {float(losses[-1]):.6f}; launches "
          + ", ".join(f"{k} {launched[k]}" for k in PATH_KERNELS_TINEUVOX) + f" ({card()})")
    require(bool(torch.isfinite(losses).all()), "30 e: non-finite loss")
    phase_step_vs_plain(tnv, st, dyn_batches[-1], "30 e tineuvox plane (64, 16)",
                        PATH_KERNELS_TINEUVOX, limit=F32_HAT_STEP_FRO)
    del tnv, st

    # f) the padded traversal from phase 4's state
    padded = make_trainer(dev, near_plane=OPTIONS_NEAR, traversal="padded",
                          max_samples_per_ray=OPTIONS_PADDED, max_steps=TRAIN_STEPS)
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.params.items()}
    pstate = TrainState(params, padded.init_optimizer(params), state.occ_state, state.step)
    marched, sampler = [], occ_grid.sampling

    def recording(*args, **kwargs):
        res = sampler(*args, **kwargs)
        marched.append(res.counts)
        return res

    occ_grid.sampling = recording
    try:
        (_, aux), launched = driven("f", lambda: padded.train_step(pstate, batch),
                                    CP_PATH_KERNELS)
    finally:
        occ_grid.sampling = sampler
    worst = int(marched[0].max())
    print(f"options f: padded step, max_samples_per_ray {OPTIONS_PADDED} from near "
          f"{OPTIONS_NEAR}: at most {worst} samples a ray, {int(aux['n_rays_truncated'])} "
          f"of {batch['rays_o'].shape[0]} rays cut, {int(aux['n_rays_ok'])} in the loss, "
          f"{aux['n_rendering_samples']} samples ({card()})")
    require(0 < worst <= OPTIONS_PADDED, f"30 f: a ray holds {worst} samples")
    require(int(aux["n_rays_truncated"]) > 0, "30 f: the candidate window cut no ray")
    phase_step_vs_plain(padded, pstate, batch, "30 f padded cp", CP_PATH_KERNELS)
    for k in OPTIONS_KERNELS:
        require(total.get(k, 0) > 0, f"30: no launch of {k}")
    print(f"options: phase 30 took {time.perf_counter() - t_phase:.1f} s, launches {total} "
          f"({card()})")
    return total


def prop_example(path, steps, seed=QUALITY_SEEDS[0], extra=()):
    """The proposal example's module and its arguments for ``path``."""
    ex = port_module("examples.train_ngp_nerf_prop")
    args = ex.parser().parse_args([*PROP_PATHS[path][0], "--max_steps", str(steps),
                                   "--seed", str(seed), *extra])
    return ex, args


def phase_prop_path(dev, path):
    """20 (``prop-ngp``) and 21 (``prop360``): the proposal example's
    trainer and loaders from its ``build`` (full width, 24 train views at
    320x320, ``--batch_size`` 4096), served untrained, trained for
    ``TRAIN_STEPS`` steps through ``train_steps_sampled`` and the
    proposal-gradient schedule (calls of 100 steps), one ``requires_grad``
    step through the kernels against the plain versions (phase 17), and
    served trained, 3 dB above untrained.  The reconstruction loss must
    fall and the path's kernels launch over the training.  Returns the
    training's launches."""
    ex, args = prop_example(path, TRAIN_STEPS)
    (trainer, train_ds, test_ds), setup = timed(lambda: ex.build(args))
    kernels = PROP_PATHS[path][1]
    prop = trainer.prop_fields[0]
    per_ray = trainer.num_samples + sum(trainer.prop_samples)
    print(f"{path}: {type(trainer.field).__name__} behind {len(trainer.prop_fields)} x "
          f"{type(prop).__name__} (unbounded {prop.unbounded}), {list(trainer.prop_samples)} "
          f"-> {trainer.num_samples} samples, {trainer.sampling_type}, opaque last sample "
          f"{trainer.opaque_bkgd}, near {trainer.near_plane} far {trainer.far_plane}; "
          f"{len(train_ds)} train and {len(test_ds)} test views {test_ds.WIDTH}x"
          f"{test_ds.HEIGHT} ({type(train_ds).__name__}), built in {setup:.2f} s")
    serving = tuple(k for k in kernels if not k.endswith("bwd"))
    untrained = phase_prop_serve(dev, test_ds, trainer, trainer.init_state(), name=path,
                                 kernels=serving)

    state = trainer.init_state()
    sampler = DeviceRaySampler.from_loader(train_ds, num_rays=args.batch_size)
    rg_fn = get_proposal_requires_grad_fn()
    rgs = [rg_fn(step) for step in range(TRAIN_STEPS)]
    cuda.reset_launches()
    losses, prop_losses = [], []
    t0 = time.perf_counter()
    for start in range(0, TRAIN_STEPS, 100):
        state, aux = trainer.train_steps_sampled(state, sampler, rgs[start : start + 100])
        losses.append(aux["loss"])
        prop_losses.append(aux["prop_loss"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    losses, prop_losses = torch.cat(losses).cpu(), torch.cat(prop_losses).cpu()
    require(bool(torch.isfinite(losses).all()), f"train {path}: non-finite loss")
    recon = losses - prop_losses
    first, last = float(recon[:50].mean()), float(recon[-50:].mean())
    samples = TRAIN_STEPS * args.batch_size * per_ray
    print(f"train {path}: {TRAIN_STEPS} steps in {seconds:.3f} s, "
          f"{1e3 * seconds / TRAIN_STEPS:.3f} ms/step, {samples / seconds:.6g} train samples/s "
          f"({args.batch_size} x ({' + '.join(str(n) for n in trainer.prop_samples)} + "
          f"{trainer.num_samples}) per step), {sum(rgs)} steps train the proposal fields; "
          f"mean reconstruction loss {first:.6f} -> {last:.6f} (first and last 50 steps), "
          f"prop loss {float(prop_losses[:50][torch.tensor(rgs[:50])].mean()):.6f} -> "
          f"{float(prop_losses[-200:][torch.tensor(rgs[-200:])].mean()):.6f}; per step "
          + ", ".join(f"{k} {v / TRAIN_STEPS:.3f}" for k, v in launches.items() if v))
    require(last < first, f"train {path}: reconstruction loss {first} -> {last} did not fall")
    for kernel in kernels:
        require(launches[kernel] > 0, f"kernel {kernel} never launched in {path} training")
    batch = sampler.sample(trainer._generator(TRAIN_STEPS, 2))
    phase_prop_train_twins(trainer, state, batch, f32_twin(trainer), path)
    phase_prop_serve(dev, test_ds, trainer, state, untrained, name=path, kernels=serving)
    return launches


def occ360_example(dev):
    """The occupancy example's unbounded branch from its own ``build``
    (``OCC360_ARGS``, ``TRAIN_STEPS`` steps): (module, arguments, trainer,
    train loader, test loader).  Its loop ends at the first multiple of its
    8-step calls past ``--max_steps``, so ``--max_steps`` is one call short
    of ``TRAIN_STEPS``."""
    ex = port_module("examples.train_ngp_nerf_occ")
    args = ex.parser().parse_args([*OCC360_ARGS, "--max_steps", str(TRAIN_STEPS - 8),
                                   "--log_every", str(TRAIN_STEPS // 4)])
    (trainer, train_ds, test_ds), setup = timed(lambda: ex.build(args))
    print(f"occ360: {type(trainer.field).__name__} (unbounded {trainer.field.unbounded}), "
          f"{trainer.grid_nlvl} x {trainer.grid_resolution}^3 grid over "
          f"{trainer.field.aabb.tolist()}, step {trainer.render_step_size}, cone "
          f"{trainer.cone_angle}, alpha_thre {trainer.alpha_thre}, near "
          f"{trainer.near_plane}, budget {trainer.sample_budget}, weight decay "
          f"{trainer.weight_decay}; {len(train_ds)} train views ({train_ds.color_bkgd_aug} "
          f"backgrounds) and {len(test_ds)} test views {test_ds.WIDTH}x{test_ds.HEIGHT} "
          f"({type(train_ds).__name__}), built in {setup:.2f} s")
    return ex, args, trainer, train_ds, test_ds


@torch.inference_mode()
def phase_unbounded_march(dev, trainer, train_ds):
    """Phase 1's G2 check on the unbounded configuration: the grid refreshed
    ``N_REFRESH`` times by the untrained field, a train batch of
    ``G2_TRAIN_RAYS`` rays at the trainer's stratified near planes, G2
    against its plain version bit for bit (samples, counts, termination
    planes), timed.  Returns the refreshed state."""
    g = torch.Generator(device=dev).manual_seed(22)
    state = refreshed_state(trainer)
    occ = state.occ_state
    batch = DeviceRaySampler.from_loader(train_ds, num_rays=G2_TRAIN_RAYS).sample(g)
    near = trainer.near_plane + torch.rand(G2_TRAIN_RAYS, generator=g, device=dev) \
        * trainer.render_step_size
    args = (batch["rays_o"], batch["rays_d"], occ.binaries, occ.aabbs, near,
            torch.full_like(near, trainer.far_plane), trainer.render_step_size,
            trainer.cone_angle)
    out, ref = march(*args), march_plain(*args)
    n_differ = int((out.counts != ref.counts).sum())
    same = [torch.equal(a, b) for a, b in zip(out, ref)]
    require(all(same), f"G2 unbounded train batch: {n_differ} rays differ in count, "
                       f"fields equal {same}")
    r = measured(0.0, cuda_ms(lambda: march(*args)), cuda_ms(lambda: march_plain(*args)),
                 nbytes(*args[:6], *out), 15 * out.ray_indices.shape[0])
    print(f"G2 march {G2_TRAIN_RAYS} rays (unbounded train batch: {occ.levels} levels, "
          f"{float(occ.binaries.float().mean()):.3f} occupied, step "
          f"{trainer.render_step_size}, cone {trainer.cone_angle}, near "
          f"{trainer.near_plane} + jitter * step): {out.ray_indices.shape[0]} samples, "
          f"{float(out.counts.float().mean()):.1f} a ray, 0 rays differ, bitwise; kernel "
          f"{r['ms']:.4f} ms, alone {device_ms(lambda: march(*args)):.4f} ms, bound "
          f"{r['bound_ms']:.4f} ms, twin {r['plain_ms']:.4f} ms")
    return state


def serve_views(what, trainer, state, ds):
    """``eval_metrics`` on every view of ``ds``, a line a view: the mean
    PSNR."""
    metrics = trainer.eval_metrics(state, ds)
    for i, v in enumerate(metrics["views"]):
        print(f"{what} view {i}: {v['seconds']:.4f} s, "
              f"{v['n_samples'] / v['n_rays']:.2f} samples/ray, psnr {v['psnr']:.3f}, "
              f"ssim {v['ssim']:.4f}")
        require(v["finite"], f"{what} view {i}: non-finite output")
    return metrics


def phase_occ360(dev, ex, args, trainer, train_ds, test_ds, untrained_state):
    """22: the occupancy example's unbounded branch: served untrained (the
    refreshed grid of phase 1), trained through the example's
    ``train_loop`` (``train_steps_sampled``, the controller), one step
    through the kernels against the plain versions, served trained (the
    loop's evaluation), 3 dB above untrained.  Returns the training's
    launches."""
    untrained = serve_views("occ360 untrained", trainer, untrained_state, test_ds)["psnr"]
    cuda.reset_launches()
    run = ex.train_loop(trainer, train_ds, test_ds, args)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    steps = int(run.state.step)
    samples = sum(r["samples"] for r in run.log)
    losses = [r["loss"] for r in run.log]
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    rays = sorted({r["num_rays"] for r in run.log})
    print(f"train occ360: {steps} steps in {run.train_seconds:.3f} s, "
          f"{1e3 * run.train_seconds / steps:.3f} ms/step, "
          f"{samples / run.train_seconds:.6g} train samples/s ({samples / steps:.1f} "
          f"rendered a step), ray counts {rays}; mean loss of the first and last five "
          f"calls {first:.6f} -> {last:.6f}; truncated rays {run.log[-1]['n_rays_truncated']}"
          f"; per step " + ", ".join(f"{k} {v / steps:.3f}" for k, v in launches.items() if v))
    require(all(math.isfinite(v) for v in losses), "train occ360: non-finite loss")
    require(last < first, f"train occ360: loss {first} -> {last} did not fall")
    for name in ENCODER_KERNELS["cp"] + ("march", "composite_fwd", "composite_bwd"):
        require(launches.get(name, 0) > 0, f"kernel {name} never launched in occ360 training")
    state = run.state
    batch = DeviceRaySampler.from_loader(train_ds, num_rays=train_ds.num_rays).sample(
        trainer._generator(steps, 3))
    f32 = dataclasses.replace(trainer, field=type(trainer.field)(
        trainer.field.aabb.tolist(), unbounded=True, compute_dtype=torch.float32))
    phase_train_twins(trainer, state, batch, "cp", f32=f32, name="occ360")
    for i, v in enumerate(run.metrics["views"]):
        print(f"trained occ360 view {i}: {v['seconds']:.4f} s, "
              f"{v['n_samples'] / v['n_rays']:.2f} samples/ray, psnr {v['psnr']:.3f}, "
              f"ssim {v['ssim']:.4f}")
        require(v["finite"], f"trained occ360 view {i}: non-finite output")
    print(f"trained occ360: psnr {run.metrics['psnr']:.3f} (untrained {untrained:.3f}), "
          f"ssim {run.metrics['ssim']:.4f}, occupied share "
          f"{float(state.occ_state.binaries.float().mean()):.4f}")
    require(run.metrics["psnr"] >= untrained + 3.0,
            f"trained occ360 psnr {run.metrics['psnr']} not 3 dB above {untrained}")
    return launches


def phase_occ_modes(dev):
    """22b: the bench CP trainer through its warmup (dense refreshes), then
    ``OCC_MODE_STEPS`` steps from that state with the sampled update and
    again with four stripes; every update made through G1 and through its
    plain version, with the same draws (the step's generator), whose
    binaries must be equal; each update timed."""
    est = port_module("estimators.occ_grid")
    ds = train_loader(dev, "cp")
    sampler = DeviceRaySampler.from_loader(ds, num_rays=TRAIN["cp"][1])
    base = make_trainer(dev, max_steps=TRAIN_STEPS)
    state, _ = base.train_steps_sampled(base.init_state(), sampler, base.warmup_steps)
    torch.cuda.synchronize()
    for mode_name, options in (("sampled", dict(dense_occ_update=False)),
                               ("striped", dict(occ_refresh_stripes=4))):
        trainer = dataclasses.replace(base, **options)
        st = copy.deepcopy(state)
        update_ms, occ_err, modes, losses = [], 0.0, set(), []
        t0 = time.perf_counter()
        for step in range(st.step, st.step + OCC_MODE_STEPS):
            if step % trainer.update_interval == 0:
                modes.add(est.update_mode(step, trainer.warmup_steps, trainer.dense_occ_update,
                                          trainer.occ_refresh_stripes))
                before = dict(cuda.LAUNCHES)
                with plain_kernels(("cp_level_fwd",)):
                    plain = trainer.refresh_occ_grid(st, step).occ_state
                require(cuda.LAUNCHES == before, "22b: the plain update launched a kernel")
                update_ms.append(cuda_ms(lambda: trainer.refresh_occ_grid(st, step), reps=3))
                kern = trainer.refresh_occ_grid(st, step).occ_state
                require(torch.equal(kern.binaries, plain.binaries),
                        f"22b {mode_name} step {step}: binaries differ from the plain update's")
                occ_err = max(occ_err, float((kern.occs - plain.occs).abs().max()))
            st, aux = trainer.train_step(st, sampler.sample(trainer._generator(step, 3)))
            losses.append(aux["loss"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        losses = torch.stack(losses).cpu()
        require(bool(torch.isfinite(losses).all()), f"22b {mode_name}: non-finite loss")
        require(modes == {mode_name}, f"22b {mode_name}: updates took {modes}")
        cells = est.cells_evaluated(mode_name, st.occ_state.cells_per_lvl,
                                    trainer.occ_refresh_stripes)
        print(f"occupancy update {mode_name} past warmup (steps {state.step}-{st.step}): "
              f"{len(update_ms)} updates of {cells} cells, {statistics.mean(update_ms):.3f} ms "
              f"an update, kernel and plain binaries equal at every update (occupancy "
              f"max_abs_err {occ_err:.3g}); {OCC_MODE_STEPS} steps in {seconds:.3f} s, loss "
              f"{float(losses[:8].mean()):.6f} -> {float(losses[-8:].mean()):.6f}, occupied "
              f"share {float(st.occ_state.binaries.float().mean()):.4f}")
    dense_ms = cuda_ms(lambda: base.refresh_occ_grid(state, state.step + 16), reps=3)
    print(f"occupancy update dense past warmup ({base.grid_resolution}^3, every cell): "
          f"{dense_ms:.3f} ms an update")


def mlp_example(path, steps, seed=QUALITY_SEEDS[0], extra=()):
    """The MLP example of ``path`` (``mlp-nerf``: train_mlp_nerf; a field:
    train_mlp_tnerf on the moving-blob scene) and its arguments for
    ``steps`` steps."""
    if path == "mlp-nerf":
        ex = port_module("examples.train_mlp_nerf")
        flags = []
    else:
        ex = port_module("examples.train_mlp_tnerf")
        flags = [*MLP_PATHS[path][0], "--scene", "proceduraldynamic"]
    args = ex.parser().parse_args([*flags, "--max_steps", str(steps - MLP_CALL),
                                   "--steps_per_call", str(MLP_CALL), "--seed", str(seed),
                                   "--log_every", str(max(steps // 4, MLP_CALL)), *extra])
    return ex, args


def mlp_run_record(run, steps_done, seconds):
    """The numbers of one MLP example run: ms/step, train samples/s (the
    rendered samples), the final and largest ray counts, the masked share
    of the last quarter of calls and the losses."""
    log = run.log
    samples = sum(r["samples"] for r in log)
    tail = log[-max(len(log) // 4, 1):]
    return {
        "steps": steps_done, "train_seconds": seconds,
        "ms_per_step": 1e3 * seconds / max(steps_done, 1),
        "samples_per_s": samples / seconds,
        "final_num_rays": log[-1]["num_rays"], "max_num_rays": max(r["num_rays"] for r in log),
        "loss_first5": statistics.mean(r["loss"] for r in log[:5]),
        "loss_last5": statistics.mean(r["loss"] for r in log[-5:]),
        "masked_share_last_quarter": statistics.mean(r["masked"] for r in tail),
        "masked_share_first_call": log[0]["masked"],
    }


def phase_mlp_example(dev, path):
    """23 (``tnerf``), 23b (``kplanes``), 23c (``tineuvox``): the dynamic
    example built by its own ``build`` (full widths, 24 train views of the
    moving-blob scene at 320x320, a 2^16 budget, the controller from 1024
    rays), served untrained on its four test views (the grid refreshed
    ``N_REFRESH`` times), trained ``MLP_STEPS`` steps through its
    ``train_loop`` (the loss must fall, the path's kernels launch), one
    step through the kernels against the plain versions (phase 5's bounds;
    T-NeRF and K-Planes; the plain step against itself printed beside it),
    served trained 3 dB above untrained; K-Planes' occupancy refresh timed
    (32 chunks of its ``max_eval_chunk``).  Returns the training's
    launches."""
    steps = MLP_STEPS[path]
    ex, args = mlp_example(path, steps)
    (trainer, train_ds, test_ds), setup = timed(lambda: ex.build(args))
    kernels = MLP_PATHS[path][1]
    n_params = sum(p.numel() for p in trainer.field.parameters())
    print(f"{path}: {type(trainer.field).__name__} ({n_params} parameters, "
          f"{str(trainer.field.compute_dtype).split('.')[-1]} operands), lr {trainer.lr}, "
          f"Adam eps {trainer.adam_eps}, warmup {trainer.warmup_lr_steps}, prior weight "
          f"{trainer.field_reg_weight}, weight decay {trainer.weight_decay}, budget "
          f"{trainer.sample_budget}; {len(train_ds)} train and {len(test_ds)} test views "
          f"{test_ds.WIDTH}x{test_ds.HEIGHT} ({type(train_ds).__name__}), built in "
          f"{setup:.2f} s")
    untrained = serve_views(f"{path} untrained", trainer, refreshed_state(trainer),
                            test_ds)["psnr"]
    cuda.reset_launches()
    run = ex.train_loop(trainer, train_ds, test_ds, args)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    steps_done = int(run.state.step)
    rec = mlp_run_record(run, steps_done, run.train_seconds)
    rays = sorted({r["num_rays"] for r in run.log})
    print(f"train {path}: {steps_done} steps in {run.train_seconds:.3f} s, "
          f"{rec['ms_per_step']:.3f} ms/step, {rec['samples_per_s']:.6g} train samples/s "
          f"(rendered), ray counts {rays} (final {rec['final_num_rays']}), masked share "
          f"{rec['masked_share_first_call']:.3f} in the first call, "
          f"{rec['masked_share_last_quarter']:.3f} over the last quarter of calls; mean loss "
          f"of the first and last five calls {rec['loss_first5']:.6f} -> "
          f"{rec['loss_last5']:.6f}; per step "
          + ", ".join(f"{k} {v / steps_done:.3f}" for k, v in launches.items() if v))
    require(steps_done == steps, f"train {path}: ended at step {steps_done}")
    require(all(math.isfinite(r["loss"]) for r in run.log), f"train {path}: non-finite loss")
    require(rec["loss_last5"] < rec["loss_first5"],
            f"train {path}: loss {rec['loss_first5']} -> {rec['loss_last5']} did not fall")
    for name in kernels:
        require(launches.get(name, 0) > 0, f"kernel {name} never launched in {path} training")
    state = run.state
    if path in ("tnerf", "kplanes"):
        phase_step_vs_plain(trainer, state, train_ds[0], path, kernels)
    if path == "kplanes":
        step = steps_done + trainer.update_interval - steps_done % trainer.update_interval
        ms = cuda_ms(lambda: trainer.refresh_occ_grid(state, step), reps=3)
        cells = state.occ_state.occs.numel()
        print(f"kplanes refresh past warmup: {cells} cells in "
              f"{-(-cells // trainer.field.max_eval_chunk)} chunks of "
              f"{trainer.field.max_eval_chunk}, {ms:.3f} ms an update")
    for i, v in enumerate(run.metrics["views"]):
        print(f"trained {path} view {i}: {v['seconds']:.4f} s, "
              f"{v['n_samples'] / v['n_rays']:.2f} samples/ray, psnr {v['psnr']:.3f}, "
              f"ssim {v['ssim']:.4f}")
        require(v["finite"], f"trained {path} view {i}: non-finite output")
    print(f"trained {path}: psnr {run.metrics['psnr']:.3f} (untrained {untrained:.3f}), "
          f"ssim {run.metrics['ssim']:.4f}, occupied share "
          f"{float(state.occ_state.binaries.float().mean()):.4f}; summary "
          f"{json.dumps(run.summary)}")
    require(run.metrics["psnr"] >= untrained + 3.0,
            f"trained {path} psnr {run.metrics['psnr']} not 3 dB above {untrained}")
    return launches


def phase_step_vs_plain(trainer, state, batch, name, kernels, limit=None):
    """One train step through the kernels against the same step with
    ``kernels`` on their plain versions (:func:`plain_kernels`), from
    ``state``, with the same batch and near-plane jitter, ``STEP_REPEATS``
    times (as when atomics reordered the sums), held to ``limit`` (None: phase 5's
    bound for the field's compute dtype); the plain step against itself is
    printed beside it."""
    require(state.step % trainer.update_interval != 0, f"{name}: the step refreshes")
    gen = torch.Generator(device=trainer.device).manual_seed(5)
    near = torch.rand(batch["rays_o"].shape[0], generator=gen, device=trainer.device)
    bf16 = trainer.field.compute_dtype == torch.bfloat16
    if limit is None:
        limit = BF16_STEP_FRO if bf16 else F32_STEP_FRO

    def kernel_step():
        return kernel_step_grads(trainer, state, batch, near)

    def plain_step():
        with plain_kernels(kernels):
            return kernel_step_grads(trainer, state, batch, near)

    what = f"train step {name} {'bf16' if bf16 else 'f32'}"
    before = dict(cuda.LAUNCHES)
    ref = plain_step()
    require(all(cuda.LAUNCHES[k] == before[k] for k in kernels),
            f"{what}: the plain step launched a kernel")
    step_readings(f"{what}, plain vs plain", plain_step, ref)
    _, reading, _, loss_rel = step_readings(f"{what}, kernels vs plain versions", kernel_step,
                                            ref, limit)
    require(reading <= limit, f"{what}: a gradient leaf off by {reading} > {limit}")
    require(loss_rel <= 1e-5, f"{what}: losses differ by {loss_rel}")


def phase_vanilla_example(dev):
    """24: ``python -m nerfacc_tpu_torch.examples.train_mlp_nerf
    --model_path P`` (the full-width vanilla NeRF, 24 views of the
    translucent scene at 320x320, a 2^16 budget, the controller from 1024
    rays) for ``VANILLA_STEPS`` steps, a checkpoint at each log
    (``VANILLA_LOG`` steps): stopped right after the first checkpoint, then
    run again with the same arguments in a second ``train_loop``, which
    resumes at its step.  The step count carries over, the loss keeps
    falling, the trained PSNR ends 3 dB above the untrained.  Returns the
    launches of both runs."""
    ex, _ = mlp_example("mlp-nerf", VANILLA_STEPS)
    ckpt = os.path.join("build", "chip_smoke", "vanilla.ckpt")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    args = ex.parser().parse_args([
        "--max_steps", str(VANILLA_STEPS - MLP_CALL), "--log_every", str(VANILLA_LOG),
        "--steps_per_call", str(MLP_CALL), "--model_path", ckpt,
    ])
    (trainer, train_ds, test_ds), setup = timed(lambda: ex.build(args))
    n_params = sum(p.numel() for p in trainer.field.parameters())
    print(f"mlp-nerf: {type(trainer.field).__name__} ({n_params} parameters), lr "
          f"{trainer.lr}, Adam eps {trainer.adam_eps}, warmup {trainer.warmup_lr_steps}; "
          f"{len(train_ds)} train and {len(test_ds)} test views {test_ds.WIDTH}x"
          f"{test_ds.HEIGHT}, built in {setup:.2f} s")
    untrained = serve_views("mlp-nerf untrained", trainer, refreshed_state(trainer),
                            test_ds)["psnr"]
    save, stops = ex.save_checkpoint, []

    def save_then_stop(path, state):
        save(path, state)
        stops.append(int(state.step))
        if len(stops) == 1:
            raise _Stop

    cuda.reset_launches()
    first = []
    ex.save_checkpoint = save_then_stop
    try:
        try:
            ex.train_loop(trainer, train_ds, test_ds, args, first)
        except _Stop:
            pass
        trainer, train_ds, test_ds = ex.build(args)
        run = ex.train_loop(trainer, train_ds, test_ds, args)
    finally:
        ex.save_checkpoint = save
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    second = run.log
    steps = int(run.state.step)
    rec = mlp_run_record(run, steps - stops[0], run.train_seconds)
    losses = [r["loss"] for r in first + second]
    print(f"mlp-nerf: first run stopped after its checkpoint at step {stops[0]}, resumed "
          f"from it to step {steps} ({second[0]['step'] - MLP_CALL} -> {second[-1]['step']}); "
          f"the resumed run {rec['ms_per_step']:.3f} ms/step, {rec['samples_per_s']:.6g} "
          f"train samples/s, ray counts {sorted({r['num_rays'] for r in first + second})}; "
          f"mean loss of the first run's first five calls "
          f"{statistics.mean(losses[:5]):.6f}, its last five "
          f"{statistics.mean(r['loss'] for r in first[-5:]):.6f}, the resumed run's first "
          f"five {statistics.mean(r['loss'] for r in second[:5]):.6f} and last five "
          f"{statistics.mean(r['loss'] for r in second[-5:]):.6f}; launches per step "
          + ", ".join(f"{k} {v / steps:.3f}" for k, v in launches.items() if v))
    for i, v in enumerate(run.metrics["views"]):
        print(f"trained mlp-nerf view {i}: {v['seconds']:.4f} s, "
              f"{v['n_samples'] / v['n_rays']:.2f} samples/ray, psnr {v['psnr']:.3f}, "
              f"ssim {v['ssim']:.4f}")
        require(v["finite"], f"trained mlp-nerf view {i}: non-finite output")
    print(f"trained mlp-nerf: psnr {run.metrics['psnr']:.3f} (untrained {untrained:.3f}), "
          f"ssim {run.metrics['ssim']:.4f}")
    require(stops[0] % VANILLA_LOG < MLP_CALL and VANILLA_LOG <= stops[0] < 2 * VANILLA_LOG,
            f"mlp-nerf: first checkpoint at step {stops[0]}")
    require(second[0]["step"] == stops[0] + MLP_CALL and steps == VANILLA_STEPS,
            f"mlp-nerf: resumed at {second[0]['step'] - MLP_CALL}, ended at {steps}")
    require(all(math.isfinite(v) for v in losses), "mlp-nerf: non-finite loss")
    require(statistics.mean(r["loss"] for r in second[-5:])
            < statistics.mean(r["loss"] for r in second[:5])
            < statistics.mean(losses[:5]), "mlp-nerf: the loss did not keep falling")
    require(run.metrics["psnr"] >= untrained + 3.0,
            f"mlp-nerf: psnr {run.metrics['psnr']} not 3 dB above {untrained}")
    for name in MLP_PATHS["mlp-nerf"][1]:
        require(launches.get(name, 0) > 0, f"mlp-nerf: kernel {name} never launched")
    return launches


def occ_field_example(path, steps, seed=QUALITY_SEEDS[0], extra=()):
    """The occupancy example with ``path``'s field flags and its arguments
    for ``steps`` steps (``--max_steps`` one call short)."""
    ex = port_module("examples.train_ngp_nerf_occ")
    args = ex.parser().parse_args([
        *OCC_FIELD_PATHS[path][0], "--max_steps", str(steps - EXAMPLE_CALL),
        "--steps_per_call", str(EXAMPLE_CALL), "--seed", str(seed), *extra])
    return ex, args


def occ_run_record(run, steps):
    """The numbers of one occupancy example run: ms/step, train samples/s
    (the rendered samples), the ray counts and the losses."""
    log = run.log
    return {
        "steps": steps, "train_seconds": run.train_seconds,
        "ms_per_step": 1e3 * run.train_seconds / steps,
        "samples_per_s": sum(r["samples"] for r in log) / run.train_seconds,
        "final_num_rays": log[-1]["num_rays"], "max_num_rays": max(r["num_rays"] for r in log),
        "loss_first5": statistics.mean(r["loss"] for r in log[:5]),
        "loss_last5": statistics.mean(r["loss"] for r in log[-5:]),
    }


def phase_occ_field(dev, path):
    """25: the occupancy example with ``--field tensorf``, ``--field voxel``
    or ``--field cp --plane_res 64 --plane_rank 16 --field_reg_weight 1e-3``
    (``path``), built by its own ``build`` at full width (the bench budget
    2^18, the controller from 1024 rays, 24 views of the translucent scene at
    320x320): served untrained (the grid refreshed ``N_REFRESH`` times),
    trained ``FIELD_STEPS`` steps through its ``train_loop`` (the loss must
    fall, the path's kernels launch), one step through the kernels against
    the plain versions (phase 5's bounds), served trained 3 dB above
    untrained, and one dense refresh timed.  Returns the training's
    launches."""
    ex, args = occ_field_example(path, FIELD_STEPS, extra=["--log_every", "200"])
    (trainer, train_ds, test_ds), setup = timed(lambda: ex.build(args))
    field, kernels = trainer.field, OCC_FIELD_PATHS[path][1]
    enc = field.encoder
    levels = (f"voxel grids {enc.resolutions} x channels {enc.channels}"
              if path == "voxel" else
              f"lines {enc.resolutions} x {enc.ranks}, planes {enc.plane_resolutions} x "
              f"{enc.plane_ranks} ({enc.plane_mode})")
    print(f"{path}: {type(field).__name__} ({sum(p.numel() for p in field.parameters())} "
          f"parameters, {str(field.compute_dtype).split('.')[-1]} operands), {levels}, "
          f"{enc.output_dim} features, refresh chunk {field.max_eval_chunk}, prior weight "
          f"{trainer.field_reg_weight}, budget {trainer.sample_budget}; built in {setup:.2f} s")
    untrained = serve_views(f"{path} untrained", trainer, refreshed_state(trainer),
                            test_ds)["psnr"]
    cuda.reset_launches()
    run = ex.train_loop(trainer, train_ds, test_ds, args)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    steps = int(run.state.step)
    rec = occ_run_record(run, steps)
    print(f"train {path}: {steps} steps in {run.train_seconds:.3f} s, "
          f"{rec['ms_per_step']:.3f} ms/step, {rec['samples_per_s']:.6g} train samples/s, "
          f"ray counts {sorted({r['num_rays'] for r in run.log})}; mean loss of the first "
          f"and last five calls {rec['loss_first5']:.6f} -> {rec['loss_last5']:.6f}; per "
          "step " + ", ".join(f"{k} {v / steps:.3f}" for k, v in launches.items() if v))
    require(steps == FIELD_STEPS, f"train {path}: ended at step {steps}")
    require(all(math.isfinite(r["loss"]) for r in run.log), f"train {path}: non-finite loss")
    require(rec["loss_last5"] < rec["loss_first5"], f"train {path}: the loss did not fall")
    for name in kernels:
        require(launches.get(name, 0) > 0, f"kernel {name} never launched in {path} training")
    state = run.state
    phase_step_vs_plain(trainer, state, train_ds[0], path, kernels)
    step = steps + trainer.update_interval - steps % trainer.update_interval
    ms = cuda_ms(lambda: trainer.refresh_occ_grid(state, step), reps=3)
    cells = state.occ_state.occs.numel()
    print(f"{path} dense refresh past warmup: {cells} cells in "
          f"{-(-cells // min(2**21, field.max_eval_chunk))} chunks, {ms:.3f} ms an update")
    for i, v in enumerate(run.metrics["views"]):
        print(f"trained {path} view {i}: {v['seconds']:.4f} s, "
              f"{v['n_samples'] / v['n_rays']:.2f} samples/ray, psnr {v['psnr']:.3f}, "
              f"ssim {v['ssim']:.4f}")
        require(v["finite"], f"trained {path} view {i}: non-finite output")
    print(f"trained {path}: psnr {run.metrics['psnr']:.3f} (untrained {untrained:.3f}), "
          f"ssim {run.metrics['ssim']:.4f}, occupied share "
          f"{float(state.occ_state.binaries.float().mean()):.4f}")
    require(run.metrics["psnr"] >= untrained + 3.0,
            f"trained {path} psnr {run.metrics['psnr']} not 3 dB above {untrained}")
    return launches


def barf_example(steps, seed=QUALITY_SEEDS[0], extra=()):
    """The BARF example and its arguments for ``steps`` steps."""
    ex = port_module("examples.train_barf")
    return ex, ex.parser().parse_args(["--max_steps", str(steps), "--seed", str(seed), *extra])


def barf_step_grads(trainer, state, batch, near):
    """One BARF ``train_step`` from a copy of ``state``: its loss and the
    field's and the pose deltas' gradients, each checked finite and
    nonzero."""
    params = {"field": {k: v.detach().clone().requires_grad_(True)
                        for k, v in state.params["field"].items()},
              "pose_deltas": state.params["pose_deltas"].detach().clone().requires_grad_(True)}
    st = type(state)(params, trainer.init_optimizer(params), state.occ_state, state.step)
    _, aux = trainer.train_step(st, batch, near_jitter=near)
    grads = {f"field.{k}": p.grad for k, p in params["field"].items()}
    grads["pose_deltas"] = params["pose_deltas"].grad
    for name, g in grads.items():
        require(torch.isfinite(g).all() and float(g.abs().max()) > 0,
                f"barf step: gradient of {name} is zero or not finite")
    return float(aux["loss"]), grads


def pose_floor_on_card(dev):
    """tests/test_pose.py:113 on the card with TF32 allowed for matmuls:
    1e-4 rad of noise on 24 poses must read back within 3x its magnitude
    plus 0.02 deg (bf16-rounded pose math read ~1.2 deg)."""
    pose = port_module("models.pose")
    g = torch.Generator(device=dev).manual_seed(11)
    w = torch.randn(24, 3, generator=g, device=dev)
    c2w = pose.se3_exp(torch.cat([w, 4.0 * torch.randn(24, 3, generator=g, device=dev)], -1))
    c2w = torch.cat([c2w[:, :, :3], 4.0 * torch.randn(24, 3, 1, generator=g, device=dev)], -1)
    xi = 1e-4 * torch.randn(24, 6, generator=g, device=dev)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        noisy, _ = pose.perturb_poses(c2w, xi=xi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    err = pose.pose_registration_errors(noisy, c2w)
    applied = float(torch.rad2deg(xi[:, :3].norm(dim=-1)).mean())
    print(f"barf pose precision floor on the card (TF32 allowed): 1e-4 rad of noise reads "
          f"{err['rot_deg']:.6f} deg against {applied:.6f} applied (limit "
          f"{3.0 * applied + 0.02:.6f})")
    require(err["rot_deg"] < 3.0 * applied + 0.02, f"barf pose floor: {err}")


def phase_barf(dev):
    """26: ``python -m nerfacc_tpu_torch.examples.train_barf`` (the 8x256
    vanilla NeRF with per-image SE(3) deltas, 320x320 procedural views, poses
    perturbed by 0.05 rad / 0.05) for ``BARF_STEPS`` steps through its
    ``build`` and ``train_loop``: the initial and final pose errors printed,
    the loss must fall and G2, G3, G5 launch; one step through the kernels
    against the plain versions (phase 5's f32 bound), the pose-delta
    gradient included; the pose math's precision floor on the card.
    Returns the training's launches."""
    ex, args = barf_example(BARF_STEPS, extra=["--log_every", str(BARF_STEPS // 2),
                                                "--eval_images", "4"])
    (trainer, train_ds, test_ds), setup = timed(lambda: ex.build(args))
    print(f"barf: {type(trainer.field).__name__} "
          f"({sum(p.numel() for p in trainer.field.parameters())} parameters), "
          f"{trainer.n_images} poses, {len(test_ds)} test views {test_ds.WIDTH}x"
          f"{test_ds.HEIGHT}, {args.num_rays} rays a step, {trainer.max_samples_per_ray} "
          f"candidates a ray at most, poses frozen before step {trainer.pose_start_step}, "
          f"window {trainer.pe_c2f}; built in {setup:.2f} s")
    untrained = trainer.eval_metrics(trainer.refresh_occ_grid(trainer.init_state(), 0),
                                     test_ds, 4)["psnr"]
    cuda.reset_launches()
    run = ex.train_loop(trainer, train_ds, test_ds, args)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)
    steps = int(run.state.step)
    log = run.log
    first5 = statistics.mean(r["loss"] for r in log[:5])
    last5 = statistics.mean(r["loss"] for r in log[-5:])
    e0, e1 = run.pose_errors["initial"], run.pose_errors["final"]
    print(f"train barf: {steps} steps in {run.train_seconds:.3f} s, "
          f"{1e3 * run.train_seconds / steps:.3f} ms/step, "
          f"{sum(r['samples'] for r in log) / run.train_seconds:.6g} train samples/s; mean "
          f"loss of the first and last five calls {first5:.6f} -> {last5:.6f}; pose error "
          f"R {e0['rot_deg']:.4f} -> {e1['rot_deg']:.4f} deg, T {e0['trans']:.5f} -> "
          f"{e1['trans']:.5f}; per step "
          + ", ".join(f"{k} {v / steps:.3f}" for k, v in launches.items() if v))
    for i, v in enumerate(run.metrics["views"]):
        print(f"trained barf view {i}: {v['seconds']:.4f} s, "
              f"{v['n_samples'] / v['n_rays']:.2f} samples/ray, psnr {v['psnr']:.3f}, "
              f"ssim {v['ssim']:.4f}")
        require(v["finite"], f"trained barf view {i}: non-finite output")
    print(f"trained barf: psnr {run.metrics['psnr']:.3f} (untrained {untrained:.3f}), ssim "
          f"{run.metrics['ssim']:.4f}; summary {json.dumps(run.summary)}")
    require(steps == BARF_STEPS, f"barf: ended at step {steps}")
    require(all(math.isfinite(r["loss"]) for r in log), "barf: non-finite loss")
    require(last5 < first5, f"barf: loss {first5} -> {last5} did not fall")
    for name in BARF_KERNELS:
        require(launches.get(name, 0) > 0, f"barf: kernel {name} never launched")
    state = run.state
    require(state.step % trainer.update_interval != 0 and state.step >= trainer.pose_start_step,
            "barf: the step checked refreshes or has frozen poses")
    batch = train_ds.pixel_batch(0)
    near = torch.rand(batch["rgb"].shape[0], generator=torch.Generator(device=dev).manual_seed(5),
                      device=dev)
    what = "train step barf f32"
    before = dict(cuda.LAUNCHES)
    with plain_kernels(BARF_KERNELS):
        ref = barf_step_grads(trainer, state, batch, near)
    require(all(cuda.LAUNCHES[k] == before[k] for k in BARF_KERNELS),
            f"{what}: the plain step launched a kernel")

    def plain_step():
        with plain_kernels(BARF_KERNELS):
            return barf_step_grads(trainer, state, batch, near)

    step_readings(f"{what}, plain vs plain", plain_step, ref)
    _, reading, _, loss_rel = step_readings(
        f"{what}, kernels vs plain versions",
        lambda: barf_step_grads(trainer, state, batch, near), ref, F32_STEP_FRO)
    require(reading <= F32_STEP_FRO, f"{what}: a gradient leaf off by {reading}")
    require(loss_rel <= 1e-5, f"{what}: losses differ by {loss_rel}")
    pose_floor_on_card(dev)
    return launches


# Phase 31: each train path trained twice from one seed.  REPEAT_STEPS
# holds three occupancy refreshes (every 16 steps from step 0) and, on the
# proposal path, steps that train the proposal field.
REPEAT_STEPS = 40


def state_leaves(obj, prefix="state"):
    """A train state's tensors by name: the parameters, the occupancy grid
    and an optimizer's moments (``torch.optim`` state per parameter),
    walking NamedTuples, dicts, lists and tuples; other values are left
    out."""
    if torch.is_tensor(obj):
        yield prefix, obj
    elif isinstance(obj, torch.optim.Optimizer):
        for i, group in enumerate(obj.param_groups):
            for j, p in enumerate(group["params"]):
                for k, v in sorted(obj.state.get(p, {}).items()):
                    if torch.is_tensor(v):
                        yield f"{prefix}.adam[{i}][{j}].{k}", v
    elif hasattr(obj, "_fields"):
        for k in obj._fields:
            yield from state_leaves(getattr(obj, k), f"{prefix}.{k}")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from state_leaves(v, f"{prefix}.{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from state_leaves(v, f"{prefix}[{i}]")


def occ_repeat(trainer, batches):
    """``run()`` for phase 31: ``trainer.train_step`` from ``init_state`` on
    ``batches``; the state and the (steps,) losses."""
    def run():
        state, losses = trainer.init_state(), []
        for batch in batches:
            state, aux = trainer.train_step(state, batch)
            losses.append(aux["loss"])
        return state, torch.stack(losses)
    return run


def repeat_paths(dev):
    """Phase 31's paths, built one at a time: (name, ``run()``, kernels),
    each ``run()`` training from the trainer's seed on the same batches."""
    for kind in ("cp", "ngp", "tineuvox"):  # phases 4, 8, 12
        ds = train_loader(dev, kind)
        trainer = make_trainer(dev, kind, timestamps=getattr(ds, "timestamps", None),
                               max_steps=TRAIN_STEPS, sample_budget=TRAIN[kind][2])
        kernels = (*ENCODER_KERNELS[kind], "march", "composite_fwd", "composite_bwd")
        yield kind, occ_repeat(trainer, [ds[0] for _ in range(REPEAT_STEPS)]), kernels

    # phase 16: bench_prop, batches drawn on the card from each step's generator
    trainer = make_prop_trainer(dev, max_steps=TRAIN_STEPS)
    sampler = DeviceRaySampler.from_loader(train_loader(dev, "prop"))
    rg_fn = port_module("estimators.prop_net").get_proposal_requires_grad_fn()
    rgs = [rg_fn(step) for step in range(REPEAT_STEPS)]
    require(0 < sum(rgs) < REPEAT_STEPS, f"repeat bench_prop: {sum(rgs)} proposal steps")

    def prop_run():
        state, aux = trainer.train_steps_sampled(trainer.init_state(), sampler, rgs)
        return state, torch.stack([aux["loss"], aux["prop_loss"]], -1)
    yield "bench_prop", prop_run, PATH_KERNELS["prop"]

    for path in ("tensorf", "voxel"):  # phase 25
        ex, args = occ_field_example(path, REPEAT_STEPS)
        trainer, train_ds, _ = ex.build(args)
        yield (path, occ_repeat(trainer, [train_ds[0] for _ in range(REPEAT_STEPS)]),
               OCC_FIELD_PATHS[path][1])
    ex, args = mlp_example("kplanes", REPEAT_STEPS)  # phase 23b
    trainer, train_ds, _ = ex.build(args)
    yield ("kplanes", occ_repeat(trainer, [train_ds[0] for _ in range(REPEAT_STEPS)]),
           MLP_PATHS["kplanes"][1])
    ex, args = barf_example(REPEAT_STEPS)  # phase 26
    trainer, train_ds, _ = ex.build(args)
    batches = [train_ds.pixel_batch(0) for _ in range(REPEAT_STEPS)]
    yield "barf", occ_repeat(trainer, batches), BARF_KERNELS

    # phase 19: the quick start's loop, its draws from PyTorch's default
    # generators, seeded before each run
    train = train_loader(dev, "cp")
    batches = [train[0] for _ in range(REPEAT_STEPS)]

    def qs_run():
        torch.manual_seed(QUALITY_SEEDS[0])
        field = port_module("models.cp_field").CPRadianceField(AABB).to(dev)
        field.init(torch.Generator().manual_seed(QUALITY_SEEDS[0]))
        estimator = nerfacc_tpu_torch.OccGridEstimator(roi_aabb=AABB, resolution=QS_RES,
                                                       device=dev)
        optimizer = torch.optim.Adam(field.parameters(), lr=1e-2, eps=1e-15)

        def occ_eval_fn(x):
            return field.query_density(x)[..., 0] * QS_STEP
        losses = []
        for step, batch in enumerate(batches):
            estimator.update_every_n_steps(step, occ_eval_fn, warmup_steps=QS_WARMUP)
            loss, _ = qs_loss(field, estimator, batch)
            optimizer.zero_grad()
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        state = {"field": dict(field.named_parameters()), "adam": optimizer,
                 "grid": {"occs": estimator.occs, "binaries": estimator.binaries}}
        return state, torch.stack(losses)
    yield "quick start", qs_run, QS_KERNELS


def phase_repeat(dev):
    """31. Each train path of ``repeat_paths`` trained twice from one seed
    for ``REPEAT_STEPS`` steps through every kernel, PyTorch's deterministic
    algorithms off: every parameter, the Adam moments, the occupancy grid
    and every step's loss must be equal bit for bit, else the first leaf and
    step that differ are named.  Returns the launches of the first runs."""
    t_phase = time.perf_counter()
    require(not torch.are_deterministic_algorithms_enabled(),
            "repeat: PyTorch's deterministic algorithms are on")
    total = {}
    for name, run, kernels in repeat_paths(dev):
        t0 = time.perf_counter()
        runs = []
        for i in range(2):
            cuda.reset_launches()
            state, losses = run()
            runs.append(({k: v.detach().clone() for k, v in state_leaves(state)},
                         losses.detach().clone()))
            if i == 0:
                launches = dict(cuda.LAUNCHES)
            del state
        (leaves, losses), (leaves2, losses2) = runs
        require(list(leaves) == list(leaves2), f"repeat {name}: the states' leaves differ")
        leaf = next((k for k in leaves if not same_bits(leaves[k], leaves2[k])), None)
        step = next((i for i in range(losses.shape[0])
                     if not same_bits(losses[i], losses2[i])), None)
        entries = sum(v.numel() for v in leaves.values())
        print(f"repeat {name} sha256 {repeat_digest(leaves, losses)} (second run "
              f"{repeat_digest(leaves2, losses2)})")
        print(f"repeat {name}: {REPEAT_STEPS} steps twice in {time.perf_counter() - t0:.1f} s; "
              f"{len(leaves)} leaves ({entries} entries: parameters, Adam moments, grid) and "
              f"{losses.shape[0]} steps' losses bit for bit: {leaf is None and step is None} "
              f"(first leaf that differs: {leaf}; first step: {step}); launches a run "
              + ", ".join(f"{k} {launches[k]}" for k in kernels))
        require(leaf is None and step is None,
                f"repeat {name}: two runs from one seed differ, first at leaf {leaf}, "
                f"step {step}")
        for k in kernels:
            require(launches.get(k, 0) > 0, f"repeat {name}: kernel {k} never launched")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    print(f"repeat: every path bit for bit over two runs, {time.perf_counter() - t_phase:.1f} s")
    return total


def _plain_for(route, kernels):
    """The kernels that ``route`` puts on their plain versions: none for
    "kernels", all of ``kernels`` for "plain", the named ones for
    "plain:<kernel>,<kernel>" (by their launch-count names)."""
    if route == "kernels":
        return ()
    if route == "plain":
        return tuple(kernels)
    return tuple(route.removeprefix("plain:").split(","))


def _example_study(args, kernels, make_example, record):
    """An example script as a user runs it, from each seed through each
    route of ``--routes``: ``make_example(seed)`` gives the script's module
    and its parsed flags, its own ``build`` and ``train_loop`` run, each
    kernel of ``kernels`` must launch unless the route puts it on its plain
    version, and ``record(trainer, run, eargs)`` gives the run's figures;
    one JSON line a run, printed and appended to
    ``<out>/example_<label>.jsonl``."""
    head = {"label": args.label, "card": card(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    print(json.dumps(head), flush=True)
    os.makedirs(args.out, exist_ok=True)
    cuda_mod = port_module("cuda")
    for route in args.routes:
        plain = _plain_for(route, kernels)
        for seed in args.seeds:
            ex, eargs = make_example(seed)
            with plain_kernels(plain):
                (trainer, train_ds, test_ds), setup = timed(lambda: ex.build(eargs))
                cuda_mod.reset_launches()
                run = ex.train_loop(trainer, train_ds, test_ds, eargs)
            launches = {k: v for k, v in cuda_mod.LAUNCHES.items() if v}
            for kernel in kernels:
                n = launches.get(kernel, 0)
                require((n > 0) != (kernel in plain),
                        f"{args.example} {route}: kernel {kernel} launched {n} times")
            rec = {"label": args.label, "example": args.example, "route": route, "seed": seed,
                   **record(trainer, run, eargs), "setup_seconds": setup,
                   "launches": launches}
            print(json.dumps(rec), flush=True)
            with open(os.path.join(args.out, f"example_{args.label}.jsonl"), "a") as f:
                f.write(json.dumps({**head, **rec}) + "\n")


def mlp_example_study(args):
    """``--example tnerf|kplanes|tineuvox|mlp-nerf``: the MLP example
    (``python -m nerfacc_tpu_torch.examples.train_mlp_tnerf --field <field>
    --scene proceduraldynamic --max_steps <steps> --seed <seed>``, TiNeuVox
    at ``--lr 5e-3``; or ``train_mlp_nerf``) through
    :func:`_example_study`: eval PSNR and SSIM (four test views), the steps
    trained and their wall seconds, ms/step, train samples/s (rendered), the
    final and largest ray counts, the masked share, the losses, eval
    seconds a frame and samples a ray."""
    def record(trainer, run, eargs):
        views = run.metrics["views"]
        return {
            "lr": trainer.lr, "psnr": run.metrics["psnr"], "ssim": run.metrics["ssim"],
            "view_psnr": [v["psnr"] for v in views],
            "all_finite": all(v["finite"] for v in views),
            **mlp_run_record(run, int(run.state.step), run.train_seconds),
            "eval_s_per_frame": sum(v["seconds"] for v in views) / len(views),
            "eval_samples_per_ray": (sum(v["n_samples"] for v in views)
                                     / sum(v["n_rays"] for v in views)),
            "summary": getattr(run, "summary", None),
        }

    _example_study(args, MLP_PATHS[args.example][1],
                   lambda seed: mlp_example(args.example, args.steps, seed,
                                            MLP_EXAMPLE_FLAGS.get(args.example, [])),
                   record)


def occ_field_example_study(args):
    """``--example tensorf|voxel|cp-planes``: the occupancy example with the
    field's flags (``--field tensorf``, ``--field voxel``, ``--field cp
    --plane_res 64 --plane_rank 16 --field_reg_weight 1e-3``; ``--max_steps
    <steps>``) through :func:`_example_study`: eval PSNR and SSIM over the
    test views, the steps, ms/step, train samples/s, ray counts, the losses,
    and the eval renderer's seconds a frame and samples a ray."""
    def record(trainer, run, eargs):
        views = run.metrics["views"]
        return {
            "psnr": run.metrics["psnr"], "ssim": run.metrics["ssim"],
            "view_psnr": [v["psnr"] for v in views],
            "all_finite": all(v["finite"] for v in views),
            **occ_run_record(run, int(run.state.step)),
            "eval_s_per_frame": sum(v["seconds"] for v in views) / len(views),
            "eval_samples_per_ray": (sum(v["n_samples"] for v in views)
                                     / sum(v["n_rays"] for v in views)),
        }

    _example_study(args, OCC_FIELD_PATHS[args.example][1],
                   lambda seed: occ_field_example(
                       args.example, args.steps, seed,
                       ["--log_every", str(max(args.steps // 10, EXAMPLE_CALL))]),
                   record)


def barf_example_study(args):
    """``--example barf``: ``python -m nerfacc_tpu_torch.examples.train_barf
    --max_steps <steps> --seed <seed>`` through :func:`_example_study`: eval
    PSNR and SSIM (its three eval views), the initial and final pose
    errors, the steps, ms/step, train samples/s (the rendered samples), the
    losses, and seconds a frame and samples a ray."""
    def record(trainer, run, eargs):
        views, log = run.metrics["views"], run.log
        steps = int(run.state.step)
        e0, e1 = run.pose_errors["initial"], run.pose_errors["final"]
        return {
            "steps": steps, "psnr": run.metrics["psnr"], "ssim": run.metrics["ssim"],
            "view_psnr": [v["psnr"] for v in views],
            "all_finite": all(v["finite"] for v in views),
            "rot_deg": e1["rot_deg"], "trans": e1["trans"],
            "rot_deg_init": e0["rot_deg"], "trans_init": e0["trans"],
            "train_seconds": run.train_seconds,
            "ms_per_step": 1e3 * run.train_seconds / steps,
            "samples_per_s": sum(r["samples"] for r in log) / run.train_seconds,
            "loss_first5": statistics.mean(r["loss"] for r in log[:5]),
            "loss_last5": statistics.mean(r["loss"] for r in log[-5:]),
            "eval_s_per_frame": sum(v["seconds"] for v in views) / len(views),
            "eval_samples_per_ray": (sum(v["n_samples"] for v in views)
                                     / sum(v["n_rays"] for v in views)),
            "summary": run.summary,
        }

    _example_study(args, BARF_KERNELS,
                   lambda seed: barf_example(args.steps, seed,
                                             ["--log_every", str(max(args.steps // 10, 8))]),
                   record)


def card():
    """The card's name and power limit, from ``nvidia-smi``."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def quality_study(args):
    """``--quality``: :func:`quality_run` for each path, seed and route, on
    this checkout or on the tree ``--root`` names (an older commit unpacked
    by ``git archive`` into a git-ignored directory); one JSON line a run,
    printed and appended to ``<out>/quality_<label>.jsonl``.  A route is
    "kernels", "plain" (every kernel of the path on its plain version) or
    "plain:<kernel>,<kernel>" (those kernels alone, by their launch-count
    names)."""
    if args.root:
        for name in [m for m in sys.modules if m.split(".")[0] == "nerfacc_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, os.path.abspath(args.root))
    package = os.path.dirname(port_module("cuda").__file__)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    head = {"label": args.label, "package": os.path.dirname(package), "card": card(),
            "torch": torch.__version__, "cuda": torch.version.cuda}
    print(json.dumps(head), flush=True)
    os.makedirs(args.out, exist_ok=True)
    for path in args.quality:
        for route in args.routes:
            plain = _plain_for(route, PATH_KERNELS[path])
            for seed in args.seeds:
                run = {"label": args.label, "route": route,
                       **quality_run(dev, path, seed, plain)}
                print(json.dumps(run), flush=True)
                with open(os.path.join(args.out, f"quality_{args.label}.jsonl"), "a") as f:
                    f.write(json.dumps({**head, **run}) + "\n")


def prop_example_study(args):
    """``--example prop-cp|prop-ngp|prop360``: the proposal example
    (``python -m nerfacc_tpu_torch.examples.train_ngp_nerf_prop <the path's
    flags> --max_steps <steps> --seed <seed>``, its defaults otherwise)
    through :func:`_example_study`: eval PSNR and SSIM (all test views),
    steps, wall seconds of the loop and train samples/s by the script's
    count, the reconstruction and proposal losses, and seconds a frame."""
    def record(trainer, run, eargs):
        log, views = run.log, run.metrics["views"]
        recon = log["loss"] - log["prop_loss"]
        per_ray = trainer.num_samples + sum(trainer.prop_samples)
        steps = int(run.state.step)
        return {
            "steps": steps, "psnr": run.metrics["psnr"], "ssim": run.metrics["ssim"],
            "view_psnr": [v["psnr"] for v in views], "n_views": len(views),
            "all_finite": all(v["finite"] for v in views),
            "train_seconds": run.train_seconds,
            "samples_per_s": steps * eargs.batch_size * per_ray / run.train_seconds,
            "ms_per_step": 1e3 * run.train_seconds / steps,
            "recon_loss_first100": float(recon[:100].mean()),
            "recon_loss_last100": float(recon[-100:].mean()),
            "prop_loss_last": float(log["prop_loss"][log["requires_grad"]][-50:].mean()),
            "eval_s_per_frame": sum(v["seconds"] for v in views) / len(views),
        }

    _example_study(args, PROP_PATHS[args.example][1],
                   lambda seed: prop_example(args.example, args.steps, seed,
                                             ["--log_every", str(max(args.steps // 10, 32))]),
                   record)


def example_study(args):
    """``--example cp|ngp|occ360``: the occupancy example as a user runs it
    (``python -m nerfacc_tpu_torch.examples.train_ngp_nerf_occ --field
    <field> --max_steps <steps> --seed <seed>``, or for occ360 ``--scene
    procedural360 --field cp``, its defaults otherwise) from each seed,
    then its test views through the exact renderer too; one JSON line a
    run, printed and appended to ``<out>/example_<label>.jsonl``: eval PSNR
    and SSIM, the steps trained and their wall seconds (the final
    evaluation excluded), train samples/s, the last call's ray count, mean
    rendered samples a step, and seconds a frame and samples a ray of both
    renderers."""
    ex = port_module("examples.train_ngp_nerf_occ")
    head = {"label": args.label, "card": card(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    print(json.dumps(head), flush=True)
    os.makedirs(args.out, exist_ok=True)
    for seed in args.seeds:
        flags = OCC360_ARGS if args.example == "occ360" else ["--field", args.example]
        eargs = ex.parser().parse_args([
            *flags, "--max_steps", str(args.steps), "--seed", str(seed),
            "--log_every", str(max(args.steps // 10, 8)),
        ])
        (trainer, train_ds, test_ds), setup = timed(lambda: ex.build(eargs))
        cuda.reset_launches()
        run = ex.train_loop(trainer, train_ds, test_ds, eargs)
        launches = {k: v for k, v in cuda.LAUNCHES.items() if v}
        views = run.metrics["views"]
        n_rays = sum(v["n_rays"] for v in views)
        exact_seconds, exact_samples, exact_psnr = 0.0, 0, []
        for i in range(len(test_ds)):
            data = test_ds[i]
            (colors, _, _, n), seconds = timed(lambda: trainer.render_rays(run.state, data))
            exact_seconds += seconds
            exact_samples += n
            exact_psnr.append(float(-10.0 * torch.log10(((colors - data["rgb"]) ** 2).mean())))
        rec = {
            "label": args.label, "field": args.example, "seed": seed,
            "scene": eargs.scene, "steps": run.state.step, "psnr": run.metrics["psnr"],
            "ssim": run.metrics["ssim"], "view_psnr": [v["psnr"] for v in views],
            "train_seconds": run.train_seconds, "setup_seconds": setup,
            "samples_per_s": sum(r["samples"] for r in run.log) / run.train_seconds,
            "ms_per_step": 1e3 * run.train_seconds / run.state.step,
            "final_num_rays": run.log[-1]["num_rays"],
            "max_num_rays": max(r["num_rays"] for r in run.log),
            "mean_samples_per_step": sum(r["samples"] for r in run.log) / run.state.step,
            "loss_first5": statistics.mean(r["loss"] for r in run.log[:5]),
            "loss_last5": statistics.mean(r["loss"] for r in run.log[-5:]),
            "eval_s_per_frame": sum(v["seconds"] for v in views) / len(views),
            "eval_samples_per_ray": sum(v["n_samples"] for v in views) / n_rays,
            "exact_s_per_frame": exact_seconds / len(views),
            "exact_samples_per_ray": exact_samples / n_rays,
            "exact_psnr": statistics.mean(exact_psnr),
            "launches": launches,
        }
        print(json.dumps(rec), flush=True)
        with open(os.path.join(args.out, f"example_{args.label}.jsonl"), "a") as f:
            f.write(json.dumps({**head, **rec}) + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quality", nargs="+", choices=list(PATH_KERNELS),
                    help="train and serve these paths alone (quality_study)")
    ap.add_argument("--example", choices=["cp", "ngp", "occ360", *OCC_FIELD_PATHS, "barf",
                                          *PROP_PATHS, *MLP_PATHS],
                    help="run the occupancy example (cp, ngp, occ360: example_study; "
                         "tensorf, voxel, cp-planes: occ_field_example_study), the BARF "
                         "example (barf: barf_example_study), the proposal example "
                         "(prop-*: prop_example_study) or the MLP examples (tnerf, "
                         "kplanes, tineuvox, mlp-nerf: mlp_example_study) alone")
    ap.add_argument("--steps", type=int, default=10000, help="--example's --max_steps")
    ap.add_argument("--seeds", nargs="+", type=int, default=list(QUALITY_SEEDS))
    ap.add_argument("--routes", nargs="+", default=None,
                    help="--quality's (default: kernels plain) and --example prop-*'s "
                         "and the MLP examples' (default: kernels)")
    ap.add_argument("--root", help="the tree whose nerfacc_tpu_torch --quality imports")
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default="build/quality")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    if args.quality:
        args.routes = args.routes or ["kernels", "plain"]
        quality_study(args)
        return
    if args.example in PROP_PATHS:
        args.routes = args.routes or ["kernels"]
        prop_example_study(args)
        return
    if args.example in MLP_PATHS:
        args.routes = args.routes or ["kernels"]
        mlp_example_study(args)
        return
    if args.example in OCC_FIELD_PATHS:
        args.routes = args.routes or ["kernels"]
        occ_field_example_study(args)
        return
    if args.example == "barf":
        args.routes = args.routes or ["kernels"]
        barf_example_study(args)
        return
    if args.example:
        example_study(args)
        return
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card()}")
    t_start = time.perf_counter()

    def mark(phases):
        print(f"chip_smoke: phases {phases} done, {time.perf_counter() - t_start:.1f} s in")
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
    mark("1-1f")
    occ360 = occ360_example(dev)
    occ360_untrained = phase_unbounded_march(dev, *occ360[2:4])
    trainer, state, untrained_psnr = phase_slice(dev, ds)

    main_colors = trainer.render_rays(state, ds[0])[0]
    plain_colors = render_view_plain(trainer, state, ds[0])
    diff = float((main_colors - plain_colors).abs().max())
    print(f"view 0 through the exact renderer, kernels vs twins: max colour difference "
          f"{diff:.3g}")
    require(diff <= 2e-3, f"view 0: kernel and twin paths differ by {diff}")
    # and through the eval renderer (render_view: windowed G2, G3 behind
    # prefix_trans), its kernels against their plain versions
    eval_colors = trainer.render_view(state, ds[0])[0]
    before = dict(cuda.LAUNCHES)
    with plain_kernels(("cp_level_fwd", "march", "composite_fwd")):
        eval_plain = trainer.render_view(state, ds[0])[0]
    require(cuda.LAUNCHES == before, "the plain eval renderer launched a kernel")
    diff = float((eval_colors - eval_plain).abs().max())
    print(f"view 0 through the eval renderer, kernels vs plain versions: max colour "
          f"difference {diff:.3g}")
    require(diff <= 2e-3, f"view 0: eval renderer's kernel and plain routes differ by {diff}")

    trainer, state, batch, launches = phase_train(dev)
    phase_train_twins(trainer, state, batch)
    phase_serve_trained(trainer, state, ds, untrained_psnr)
    phase_trained_frames(trainer, state, ds)
    cp_trained = (trainer, state, batch)  # phase 29's
    del trainer, state
    phase_opaque_frames(dev)
    example_launches = phase_example(dev, untrained_psnr)
    mark("2-6d")

    # 7-10: the hash-grid NGP field through the same entry points
    _, _, untrained_psnr = phase_slice(dev, ds, "ngp")
    trainer, state, batch, ngp_launches = phase_train(dev, "ngp")
    phase_train_twins(trainer, state, batch, "ngp")
    phase_serve_trained(trainer, state, ds, untrained_psnr, "ngp")
    del trainer, state
    mark("7-10")

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
    psnr = phase_serve_trained(trainer, state, dyn_test, untrained_psnr, "tineuvox")
    del trainer, state
    phase_plain_quality(dev, "tineuvox", psnr)
    mark("11-14b")

    # 15-18: the proposal-network path
    untrained_psnr = phase_prop_serve(dev, ds)
    trainer, state, batch, prop_launches = phase_prop_train(dev)
    phase_prop_train_twins(trainer, state, batch)
    psnr = phase_prop_serve(dev, ds, trainer, state, untrained_psnr)
    del trainer, state
    phase_plain_quality(dev, "prop", psnr)
    mark("15-18b")

    # 19: the library API's quick start, and its proposal leg
    qs_launches, qs_loop_ms = phase_quickstart(dev, ds)
    qs_prop_launches = phase_quickstart_prop(dev)
    # 20-21: the proposal example's hash-grid path and its 360 cascade
    prop_ngp_launches = phase_prop_path(dev, "prop-ngp")
    prop360_launches = phase_prop_path(dev, "prop360")
    mark("19-21")
    # 22: the occupancy example's unbounded branch; 22b: the update modes
    occ360_launches = phase_occ360(dev, *occ360, occ360_untrained)
    del occ360, occ360_untrained
    phase_occ_modes(dev)
    mark("22-22b")
    # 23-23c: the dynamic example per field; 24: the vanilla example
    mlp_launches = [phase_mlp_example(dev, path) for path in ("tnerf", "kplanes", "tineuvox")]
    mlp_launches.append(phase_vanilla_example(dev))
    mark("23-24")
    # 25: the occupancy example's other fields; 26: the BARF example
    mlp_launches += [phase_occ_field(dev, path) for path in OCC_FIELD_PATHS]
    mlp_launches.append(phase_barf(dev))
    mark("25-26")
    # 27: the quick start's loop through the sparse estimator
    mlp_launches.append(phase_quickstart_vdb(dev, ds, qs_loop_ms))
    mark("27")
    # 28: the distributed layer, its ranks' launches summed
    mlp_launches.append(phase_distributed(dev))
    mark("28")
    # 29: the windowed and pooled entry points on phase 4's trained field
    mlp_launches.append(phase_pooled_entry_points(dev, *cp_trained))
    mark("29")
    # 30: the public options taken as the JAX package takes them
    mlp_launches.append(phase_options(dev, *cp_trained, ds))
    del cp_trained
    mark("30")
    # 31: each train path twice from one seed, bit for bit
    mlp_launches.append(phase_repeat(dev))
    mark("31")
    # each kernel's launches over the training runs (phases 4, 8, 12, 16,
    # 20, 21, 22, 23-23c, 24, 25, 26, 28, 31), the occupancy example's (6d), the
    # quick start's loops (19, 27), the entry points of phase 29 and the
    # options' paths of phase 30, and the gather kernels' over the gather
    # probe's run
    launches = {k: v + ngp_launches[k] + tnv_launches[k] + prop_launches[k]
                + example_launches[k] + qs_launches[k] + qs_prop_launches[k]
                + prop_ngp_launches[k] + prop360_launches[k] + occ360_launches.get(k, 0)
                + sum(m.get(k, 0) for m in mlp_launches)
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
