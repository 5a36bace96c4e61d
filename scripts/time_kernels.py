#!/usr/bin/env python3
"""Time kernels of one tree of the PyTorch port on one GPU, at the shapes the
paths give them.

Run from the root of a checkout:

    python3 scripts/time_kernels.py [G1 G2 G3 G4 G5 G6 G7 G8 G9 G10 G11 G12 G14] [--root DIR] [--label NAME] [--out build/time_kernels]

The positional arguments pick the kernels (all of these by default).
``--root`` names the tree whose ``nerfacc_tpu_torch`` is imported and built
(default: this checkout), so that two designs are compared on one card in
one call, in turns, e.g. with an older commit unpacked by ``git archive``
into a git-ignored directory:

    python3 scripts/time_kernels.py G6 G8 --root build/parent --label parent
    python3 scripts/time_kernels.py G6 G8 --label change
    python3 scripts/time_kernels.py G6 G8 --label change
    python3 scripts/time_kernels.py G6 G8 --root build/parent --label parent

The shapes:

- G1 (CP-level forward), both compute dtypes: N = 2^18 uniform in [0, 1]^3
  at (R, rank) = (512, 32); the CP train buffer's sample midpoints in ray
  order (below) at (32, 32), (128, 32), (512, 32); the proposal field's
  points (below) at (16, 16) and (64, 16); the dense refresh's 2^21 points,
  one jittered point per cell of the 128^3 grid in the refresh's cell
  order, at (512, 32).  Error: the count of entries unequal to the plain
  version; beside it ``embedding_bag`` on the precomputed taps of the three
  axes (the gather stage alone).
- G2 (march): the full-width CP trainer's grid after four dense refreshes
  (parameters from seed 42, as ``chip_smoke.py``'s phase 1): the middle
  8192 rays of test view 0 with near plane 0, and a 2048-ray train batch (6
  views at 256x256) at the trainer's near planes ``0 + jitter * step``;
  the sample count, the rays whose count differs from the plain version
  (on that grid and on it with half its cells cleared); and, in a tree
  whose march takes ``max_samples``, the eval renderer's rounds over that
  8192-ray chunk (windows of 128 candidates from near 0, each round from
  the last one's termination planes with the rays not yet terminated),
  timed on the round with the most samples, every round checked bitwise.
- G3 and G5 (composite forward and backward), on sample buffers marched
  on that grid, with seeded densities 10^U(-1, 3), colours and cotangents:
  the eval chunk (its 8192 rays, every sample kept); the CP train buffer
  (2048 train rays cut at the 2^18 budget by ``compact_samples``); the
  TiNeuVox buffer's shape (the first 1024 of those rays, cut at 2^16); the
  proposal layout (4096 rays x 64 samples over [2, 6], one segment per row
  of the flat view).  G3 asks for the weights on the three occupancy-grid
  buffers, as ``utils/rendering.py`` does, not on the proposal layout, as
  ``volrend.rendering`` does not.
- G4 (CP-level backward), bf16 with seeded tables and cotangents: N = 2^18
  uniform at (512, 32); the CP train buffer's midpoints (normalised to the
  AABB and clamped, as ``CPGridEncoder`` does) at (32, 32), (128, 32),
  (512, 32); the proposal field's points (4096 train rays x 128 stratified
  samples over [2, 6], N = 2^19) at (16, 16) and (64, 16); beside it
  ``index_add_`` of the precomputed per-tap updates into the (3R, rank)
  table gradient (the scatter stage alone).
- G6 (hash encode forward) at the NGP field's width (16 levels, T = 2^19),
  a seeded table in [-1, 1]: N = 2^18 uniform in [0, 1]^3 with 1% of the
  points pushed up to 0.1 outside (``chip_smoke.py``'s phase 1c); the NGP
  train step's positions in ray order (as G7's below); the dense refresh's
  2^21 points, one jittered point per cell of the 128^3 grid in the
  refresh's cell order (as G1's); the NGP eval chunk: the middle 8192 rays
  of test view 0 marched with near plane 0 on the full-width NGP trainer's
  grid after four dense refreshes, every sample kept, the sample midpoints
  mapped to [0, 1]^3 over the AABB (unclamped).  Error: the count of
  entries unequal to the plain version; beside it ``embedding_bag`` on the
  precomputed corner rows and weights (the gather stage alone) and the
  bound over x, the output and the table rows the call touches.
- G8 (hat forward): the one-axis kernel at N = 2^18, (R, rank) = (512, 32),
  and at TiNeuVox's levels (32, 16), (128, 16), (512, 32) at N = 2^16 (the
  train step's budget) and 2^21 (the refresh, about an eval chunk), uniform
  coordinates, beside ``embedding_bag`` on the precomputed taps (the gather
  stage alone); and one CP level of ``CPGridEncoder(use_pallas=True)`` at
  those levels and sizes, with grad off and on (points and tables requiring
  one; forward alone, and forward and backward): ``hat_cp_level`` where the
  tree has it, else the per-axis sequence its encoder ran (column copies,
  three one-axis launches, two products).  Error: entries unequal to the
  per-axis plain composition.
- G7 (hash table gradient) at the NGP field's width (16 levels, T = 2^19):
  N = 2^18 uniform in [0, 1]^3 with 1% of the points pushed up to 0.1
  outside (``chip_smoke.py``'s phase 1c); and the NGP train step's
  positions in ray order: 2048 train rays marched on the full-width NGP
  trainer's grid after four dense refreshes, cut at the 2^18 budget, the
  sample midpoints mapped to [0, 1]^3 as ``models/ngp.py::normalize_points``
  maps them; with each, the share of samples whose level-0 corner row
  equals the previous sample's, and ``index_add_`` on the precomputed rows
  and updates (the scatter stage alone).
- G9 (hat table gradient): TiNeuVox's levels (R, rank) = (32, 16), (128,
  16), (512, 32) at N = 2^16 and 2^18, uniform coordinates and a seeded
  cotangent; whether two calls give the same bits, and ``index_add_`` on
  the precomputed taps and updates.
- G10 (hat coordinate gradient): N = 2^18 at (512, 32) and N = 2^16 at
  TiNeuVox's three levels, uniform coordinates.
- G11 (coarse-occupancy lookup) at ``chip_smoke.py``'s phase 1e shape: N =
  2^18 uniform lookups into a (256, 1024) f32 summary; beside it
  ``summary[row, lane]`` on int64 indices.  Error: entries unequal to the
  plain version on those lookups with 1% of the rows and 1% of the lanes
  redrawn from [-8, rows + 8) and [-8, lanes + 8).
- G12 (per-lane gather) at phase 1e's shapes: 64 blocks of T rows at T =
  512, 2^14 and 2^16, f32 and bf16, and the NGP-shaped lookup (f32, T =
  2^16, 2^18 rows, lane l in [0, min(2^(10 + l % 16), T))); in a tree with
  routes also about the route boundaries (T = 8192, 9557, 14336, 28672) and
  with every route of the kernel timed alone on the checked indices; the
  tree takes (the bytes of each table row a block keeps in shared memory, 0
  for one thread an element, "parent" in a tree without routes); beside it
  ``torch.gather``
  on int64 indices.  Error: entries unequal to the plain version with 1% of
  the indices redrawn from [-T - 8, T + 8).
  Both also give the wrapper's host microseconds per call
  (``time.perf_counter`` over 200 calls, no sync inside) and the PyTorch
  call's; G11 also each piece of its wrapper's (the shared helpers
  ``cuda.on_card``, ``cuda.stream_ptr``, ``cuda.ptr``, the output's
  allocation, the ctypes launch).
- G14 (importance sampling) at ``chip_smoke.py``'s phase 1f shapes: 4096
  rays, E = 2 -> 128 (the first proposal level, stratified); 4096 rays, E =
  129 -> 64 (the final resampling, a CDF with plateaus, stratified); 8192
  rays, E = 129 -> 64 with bias 0.5 (the eval chunk); the 4096-ray
  rows with the CDF phase 1f formed before, a third of its rows out of
  order by rounding, so that they take the kernel's walk; and the 360
  cascade's three resamplings at 4096 rays (E = 2 -> 256, 257 -> 96,
  97 -> 48).  Error: the entries of samples and edges unequal to the plain
  version.

The proposal example's shapes (in a tree with the unbounded scene; the
bounded ones in every tree): G1 at ``CPDensityField``'s levels (16, 16)
and (64, 16) on the 360 cascade's first level (4096 rays x 256 samples
uniform in disparity, contracted, N = 2^20); G6 and G7 at
``NGPDensityField``'s shape (5 levels, T = 2^17) on the bounded path's
first level (N = 2^19, unclamped) and the 360 cascade's (N = 2^20).

Each row holds the error against the plain version, the CUDA-event time of
one call (host path included), the device time of its kernels alone from
``torch.profiler``, the plain version's time, and the bytes bound (each
input read once, each output written once, at 3.35 TB/s).  Each result is
one JSON line; all go to ``<out>/time_kernels_<label>.json``.
"""
import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
HBM_BYTES_PER_S = 3.35e12
HAT_LEVELS = ((32, 16), (128, 16), (512, 32))
HAT_X_SHAPES = ((2**18, 512, 32), (2**16, 32, 16), (2**16, 128, 16), (2**16, 512, 32))
G8_SIZES = (2**16, 2**21)  # the TiNeuVox train step's budget; the refresh
G8_AXIS_N = 2**18  # PERF.md's earlier G8 row


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


def host_us(fn, reps=200):
    """Host microseconds per call of ``fn``: the launch path, with no sync
    inside the timed calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / reps


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def bytes_bound_ms(*tensors):
    return 1e3 * nbytes(*tensors) / HBM_BYTES_PER_S


def err_of_max(out, ref):
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(out, ref))


def unequal(a, b):
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def unequal_words(a, b):
    """Entries of ``a`` and ``b`` whose bits differ, 2- or 4-byte words."""
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return int((a.view(view) != b.view(view)).sum())


def with_outside(g, idx, low, high, share=0.01):
    """``idx`` with ``share`` of its entries redrawn from [low, high)."""
    out = idx.clone().reshape(-1)
    k = int(share * out.numel())
    out[:k] = torch.randint(low, high, (k,), generator=g, device=idx.device, dtype=idx.dtype)
    return out.reshape(idx.shape)


def refreshed_grid(dev, kind="cp"):
    """The full-width CP (or NGP) trainer after four dense refreshes, its
    occupancy state and its render step."""
    from nerfacc_tpu_torch.models.cp_field import CPRadianceField
    from nerfacc_tpu_torch.models.ngp import NGPRadianceField
    from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer

    field = {"cp": CPRadianceField, "ngp": NGPRadianceField}[kind]
    trainer = NGPOccTrainer(field=field(AABB, compute_dtype=torch.bfloat16), aabb=AABB,
                            device=dev)
    state = trainer.init_state()
    for step in range(4):
        state = trainer.refresh_occ_grid(state, step)
    return state.occ_state, trainer.render_step_size


def train_rays(dev, n):
    """``n`` train rays of the six 256x256 views, and the loader's batch."""
    from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader

    return ProceduralSceneLoader(split="train", n_train=6, width=256, height=256,
                                 num_rays=n, device=dev)[0]


def train_midpoints(dev, kind, g):
    """The sample midpoints of a 2048-ray train batch marched on the
    ``kind`` trainer's refreshed grid and cut at the 2^18 budget, in ray
    order, mapped to [0, 1]^3 over the AABB (unclamped); and the march."""
    from nerfacc_tpu_torch.grid import march
    from nerfacc_tpu_torch.utils.rendering import compact_samples

    occ, step = refreshed_grid(dev, kind)
    train = train_rays(dev, 4096)
    o, d = train["rays_o"][:2048].contiguous(), train["rays_d"][:2048].contiguous()
    near = (0.0 + torch.rand(2048, generator=g, device=dev) * step).contiguous()
    far = torch.full_like(near, 1e10)
    s = compact_samples(march(o, d, occ.binaries, occ.aabbs, near, far, step), 2**18)
    ids = s.ray_indices.long()
    mids = o[ids] + (0.5 * (s.t_starts + s.t_ends))[:, None] * d[ids]
    return to_unit(mids), (occ, step, o, d, near, far, s, train)


def to_unit(pts):
    """World points mapped to [0, 1]^3 over the AABB (unclamped)."""
    lo = torch.tensor(AABB[:3], device=pts.device)
    hi = torch.tensor(AABB[3:], device=pts.device)
    return ((pts - lo) / (hi - lo)).contiguous()


def refresh_points(dev, g):
    """The dense refresh's points: one jittered point per cell of the 128^3
    grid, cells in the refresh's row-major order."""
    ids = torch.arange(128**3, device=dev)
    coords = torch.stack([ids // 128**2, (ids // 128) % 128, ids % 128], -1).float()
    return ((coords + torch.rand((128**3, 3), generator=g, device=dev)) / 128).contiguous()


def eval_chunk_points(dev, kind):
    """The sample midpoints of the middle 8192 rays of test view 0, marched
    with near plane 0 on the ``kind`` trainer's refreshed grid, every sample
    kept, mapped to [0, 1]^3 (unclamped)."""
    from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
    from nerfacc_tpu_torch.grid import march
    from nerfacc_tpu_torch.utils.rendering import compact_samples

    occ, step = refreshed_grid(dev, kind)
    test = ProceduralSceneLoader(split="test", device=dev)[0]
    n = test["rays_o"].shape[0]
    mid = slice(n // 2 - 4096, n // 2 + 4096)
    o, d = test["rays_o"][mid].contiguous(), test["rays_d"][mid].contiguous()
    s = compact_samples(march(o, d, occ.binaries, occ.aabbs, torch.zeros(8192, device=dev),
                              torch.full((8192,), 1e10, device=dev), step))
    ids = s.ray_indices.long()
    return to_unit(o[ids] + (0.5 * (s.t_starts + s.t_ends))[:, None] * d[ids])


def g6_points(dev, g):
    """G6's four point sets: name -> (N, 3) points."""
    x = torch.rand((2**18, 3), generator=g, device=dev)
    n_out = 2**18 // 100
    below = torch.rand(n_out, generator=g, device=dev) < 0.5
    push = 0.1 * torch.rand(n_out, generator=g, device=dev)
    x[:n_out, 0] = torch.where(below, -push, 1.0 + push)
    return {
        "uniform, 1% outside": x,
        "NGP train step, ray order": train_midpoints(dev, "ngp", g)[0],
        "dense refresh, 128^3 cells": refresh_points(dev, g),
        "NGP eval chunk, 8192 rays": eval_chunk_points(dev, "ngp"),
    }


def proposal_points(dev, train, g):
    """The proposal field's points: 128 stratified samples per ray of 4096
    train rays over [2, 6], normalised to the AABB (not clamped:
    ``NGPDensityField`` takes them so, ``CPDensityField`` clamps them)."""
    po, pd = train["rays_o"], train["rays_d"]
    tp = 2.0 + (torch.arange(128, device=dev) + torch.rand((4096, 128), generator=g,
                                                           device=dev)) * (4.0 / 128)
    pts = po[:, None] + tp[..., None] * pd[:, None]
    lo = torch.tensor(AABB[:3], device=dev)
    hi = torch.tensor(AABB[3:], device=dev)
    return ((pts.reshape(-1, 3) - lo) / (hi - lo)).contiguous()


def cascade_points(dev):
    """The 360 cascade's first proposal level (the proposal example's
    ``--scene procedural360``): 256 samples per ray of 4096 train rays of
    the unbounded scene, stratified uniform in disparity over its near and
    far planes, contracted over the box +-1 as its density fields map them
    (N = 2^20, in [0, 1]^3); None in a tree without that scene."""
    from nerfacc_tpu_torch.data import procedural
    from nerfacc_tpu_torch.models.ngp import contract_to_unisphere

    loader = getattr(procedural, "ProceduralUnboundedSceneLoader", None)
    if loader is None:
        return None
    g = torch.Generator(device=dev).manual_seed(360)
    rays = loader(split="train", n_train=2, width=64, height=64, num_rays=4096, device=dev)[0]
    s = (torch.arange(256, device=dev) + torch.rand((4096, 256), generator=g, device=dev)) / 256
    t = 1.0 / (s / loader.FAR + (1.0 - s) / loader.NEAR)
    pts = rays["rays_o"][:, None] + t[..., None] * rays["rays_d"][:, None]
    aabb = torch.tensor([-1.0, -1.0, -1.0, 1.0, 1.0, 1.0], device=dev)
    return contract_to_unisphere(pts.reshape(-1, 3), aabb).contiguous()


class Inputs:
    """The buffers the rows share, made once per run on first use."""

    def __init__(self, dev):
        self.dev = dev
        self._cp = None
        self._cascade = False

    def cp(self):
        if self._cp is None:
            g = torch.Generator(device=self.dev).manual_seed(0)
            u_mid, (occ, step, o, d, near, far, train_s, train) = train_midpoints(
                self.dev, "cp", g)
            u_prop = proposal_points(self.dev, train, g)
            self._cp = dict(
                u_train=u_mid.clamp(0.0, 1.0).contiguous(), occ=occ, step=step,
                o=o, d=d, near=near, far=far, train_s=train_s,
                u_prop=u_prop.clamp(0.0, 1.0).contiguous(), u_prop_raw=u_prop, g=g,
            )
        return self._cp

    def cascade(self):
        if self._cascade is False:
            self._cascade = cascade_points(self.dev)
        return self._cascade

    def sample_buffers(self):
        """The G3/G5 buffers: name -> (t_starts, t_ends, ray ids, rays,
        segment starts, segment ends)."""
        from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
        from nerfacc_tpu_torch.grid import march
        from nerfacc_tpu_torch.utils.rendering import compact_samples

        c, dev = self.cp(), self.dev
        occ, step, o, d, near, far = (c[k] for k in ("occ", "step", "o", "d", "near", "far"))
        test = ProceduralSceneLoader(split="test", device=dev)[0]
        n = test["rays_o"].shape[0]
        mid = slice(n // 2 - 4096, n // 2 + 4096)
        eval_s = compact_samples(march(
            test["rays_o"][mid].contiguous(), test["rays_d"][mid].contiguous(),
            occ.binaries, occ.aabbs, torch.zeros(8192, device=dev),
            torch.full((8192,), 1e10, device=dev), step))
        tnv_s = compact_samples(
            march(o[:1024].contiguous(), d[:1024].contiguous(), occ.binaries, occ.aabbs,
                  near[:1024].contiguous(), far[:1024].contiguous(), step), 2**16)
        t = torch.linspace(2.0, 6.0, 65, device=dev)
        rows = torch.arange(4096, dtype=torch.int32, device=dev)

        def sorted_case(s, n_rays):
            return (s.t_starts, s.t_ends, s.ray_indices, n_rays, s.seg_starts, s.seg_ends)

        return {
            "eval chunk, 8192 rays": sorted_case(eval_s, 8192),
            "CP train buffer, 2048 rays, budget 2^18": sorted_case(c["train_s"], 2048),
            "TiNeuVox buffer shape, 1024 rays, budget 2^16": sorted_case(tnv_s, 1024),
            "proposal layout, 4096 rays x 64": (
                t[:-1].repeat(4096), t[1:].repeat(4096), rows.repeat_interleave(64), 4096,
                rows * 64, rows * 64 + 63),
        }


def cp_taps(u, lines):
    """A CP level's library stages' inputs: each point's two taps on each
    axis as rows of the stacked (3R, rank) table, their lerp weights, the
    table."""
    R = lines.shape[1]
    x = u.t().reshape(-1) * (R - 1)
    i0 = torch.floor(x).clamp(0, R - 2)
    f = x - i0
    axis = torch.arange(3, device=u.device).repeat_interleave(u.shape[0])
    rows = (i0.long() + axis * R)[:, None] + torch.tensor([0, 1], device=u.device)
    return rows, torch.stack([1.0 - f, f], dim=1), lines.reshape(3 * R, -1)


def g1_rows(inp):
    from nerfacc_tpu_torch.ops.cp_level import cp_level_encode, cp_level_encode_plain

    dev, c = inp.dev, inp.cp()
    g = torch.Generator(device=dev).manual_seed(1)
    u_refresh = refresh_points(dev, g)
    shapes = [("uniform", torch.rand((2**18, 3), generator=g, device=dev), 512, 32)]
    shapes += [("CP train buffer, ray order", c["u_train"], R, 32) for R in (32, 128, 512)]
    shapes += [("proposal field, ray order", c["u_prop"], R, 16) for R in (16, 64)]
    shapes += [("dense refresh, 128^3 cells", u_refresh, 512, 32)]
    if inp.cascade() is not None:
        shapes += [("360 cascade's first proposal level, ray order", inp.cascade(), R, 16)
                   for R in (16, 64)]
    for name, u, R, rank in shapes:
        lines = 1 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev)
        runs = float((torch.floor(u[1:] * (R - 1)) == torch.floor(u[:-1] * (R - 1)))
                     .all(-1).float().mean())
        rows, w, table = cp_taps(u, lines)

        def gather():
            return F.embedding_bag(rows, table, mode="sum", per_sample_weights=w)

        for dt in (torch.float32, torch.bfloat16):
            out = cp_level_encode(u, lines, dt)
            ref = cp_level_encode_plain(u, lines, dt)
            yield {
                "kernel": "G1 cp_level_fwd", "case": name, "N": u.shape[0], "R": R,
                "rank": rank, "dtype": str(dt)[6:], "share_same_cell_as_previous": runs,
                "unequal_to_plain": unequal(out, ref), "entries": out.numel(),
                "ms": cuda_ms(lambda: cp_level_encode(u, lines, dt)),
                "device_ms": device_ms(lambda: cp_level_encode(u, lines, dt)),
                "plain_ms": cuda_ms(lambda: cp_level_encode_plain(u, lines, dt), reps=5),
                "embedding_bag_ms": cuda_ms(gather),
                "embedding_bag_device_ms": device_ms(gather),
                "bound_ms": bytes_bound_ms(u, lines, out),
            }


def g2_rows(inp):
    from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
    from nerfacc_tpu_torch.grid import march, march_plain

    dev, c = inp.dev, inp.cp()
    occ, step = c["occ"], c["step"]
    g = torch.Generator(device=dev).manual_seed(0)
    cleared = occ.binaries & (torch.rand(occ.binaries.shape, generator=g, device=dev) < 0.5)
    test = ProceduralSceneLoader(split="test", device=dev)[0]
    n = test["rays_o"].shape[0]
    mid = slice(n // 2 - 4096, n // 2 + 4096)
    train = train_rays(dev, 2048)
    jitter = torch.rand(2048, generator=g, device=dev)
    cases = {
        "8192-ray eval chunk, near 0": (
            test["rays_o"][mid].contiguous(), test["rays_d"][mid].contiguous(),
            torch.zeros(8192, device=dev)),
        "2048-ray train batch, near 0 + jitter * step": (
            train["rays_o"].contiguous(), train["rays_d"].contiguous(),
            (0.0 + jitter * step).contiguous()),
    }
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
        yield {
            "kernel": "G2 march", "case": name, "rays": o.shape[0], "samples": samples,
            "rays_differ_from_plain": differ, "bitwise_equal_to_plain": same,
            "ms": cuda_ms(lambda: march(*args)),
            "device_ms": device_ms(lambda: march(*args)),
        }
    if "max_samples" not in inspect.signature(march).parameters:
        return
    o, d, near = cases["8192-ray eval chunk, near 0"]
    far = torch.full_like(near, 1e10)
    alive = torch.ones_like(near, dtype=torch.bool)
    rounds, same = [], True
    while len(rounds) < 1024 // 32 and bool(alive.any()):
        args = (o, d, occ.binaries, occ.aabbs, near, far, step, 0.0, alive)
        out = march(*args, max_samples=128)
        same &= all(torch.equal(a, b) for a, b in zip(out, march_plain(*args, max_samples=128)))
        rounds.append((out.ray_indices.shape[0], args, out))
        alive = alive & ~out.terminated
        near = out.termination_planes
    samples, args, out = max(rounds, key=lambda r: r[0])
    yield {
        "kernel": "G2 march", "case": "8192-ray eval chunk, busiest round of 128 candidates",
        "rays": o.shape[0], "rounds": len(rounds), "samples": samples,
        "samples_per_round": [r[0] for r in rounds], "bitwise_equal_to_plain": same,
        "ms": cuda_ms(lambda: march(*args, max_samples=128)),
        "device_ms": device_ms(lambda: march(*args, max_samples=128)),
        "bytes_bound_ms": bytes_bound_ms(*args, *out),
    }


def g3_rows(inp):
    from nerfacc_tpu_torch.ops.sorted_segments import composite_sorted, composite_sorted_plain

    dev = inp.dev
    g = torch.Generator(device=dev).manual_seed(3)
    for name, (t0, t1, ids, n_rays, ss, se) in inp.sample_buffers().items():
        n = t0.shape[0]
        sigmas = 10.0 ** (torch.rand(n, generator=g, device=dev) * 4 - 1)
        rgbs = torch.rand((n, 3), generator=g, device=dev)
        weights = not name.startswith("proposal")
        args = (t0, t1, sigmas, rgbs, ids, n_rays, ss, se, None, weights)
        out = composite_sorted(*args)
        ref = composite_sorted_plain(*args)
        yield {
            "kernel": "G3 composite_fwd", "case": name, "rays": n_rays, "samples": n,
            "weights": weights, "longest_ray": int((se - ss + 1).clamp(min=0).max()),
            "rgb_opacity_max_abs_err": max(float((a - b).abs().max())
                                           for a, b in zip(out[:2], ref[:2])),
            "depth_max_abs_err": float((out[2] - ref[2]).abs().max()),
            "weights_max_abs_err": (float((out[3] - ref[3]).abs().max())
                                    if weights else None),
            "ms": cuda_ms(lambda: composite_sorted(*args)),
            "device_ms": device_ms(lambda: composite_sorted(*args)),
            "plain_ms": cuda_ms(lambda: composite_sorted_plain(*args), reps=5),
            # inputs read once (ray ids unread), the sums and weights written once
            "bound_ms": 1e3 * (nbytes(*args) - nbytes(ids) + nbytes(*out)) / HBM_BYTES_PER_S,
        }


def g4_rows(inp):
    from nerfacc_tpu_torch.ops.cp_level import cp_level_backward, cp_level_backward_plain

    dev, c = inp.dev, inp.cp()
    g = torch.Generator(device=dev).manual_seed(4)
    shapes = [("uniform", torch.rand((2**18, 3), generator=g, device=dev), 512, 32)]
    shapes += [("CP train buffer, ray order", c["u_train"][:2**18], R, 32) for R in (32, 128, 512)]
    shapes += [("proposal field, ray order", c["u_prop"], R, 16) for R in (16, 64)]
    for name, u, R, rank in shapes:
        n = u.shape[0]
        lines = 1 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev)
        cot = torch.randn((n, rank), generator=g, device=dev)
        dt = torch.bfloat16
        out = cp_level_backward(u, cot, lines, dt)
        ref = cp_level_backward_plain(u, cot, lines, dt)
        runs = float((torch.floor(u[1:] * (R - 1)) == torch.floor(u[:-1] * (R - 1))).float().mean())
        taps, w, table = cp_taps(u, lines)
        upd = (w[:, :, None] * cot.repeat(3, 1)[:, None, :]).reshape(-1, rank)
        acc, flat = torch.zeros_like(table), taps.reshape(-1)

        def scatter():
            return acc.index_add_(0, flat, upd)

        yield {
            "kernel": "G4 cp_level_bwd", "case": name, "N": n, "R": R, "rank": rank,
            "index_add_ms": cuda_ms(scatter), "index_add_device_ms": device_ms(scatter),
            "share_same_row_as_previous": runs,
            "err_of_max": err_of_max([out], [ref]),
            "unequal_to_plain": unequal(out, ref),
            "unequal_between_two_calls": unequal(out, cp_level_backward(u, cot, lines, dt)),
            "ms": cuda_ms(lambda: cp_level_backward(u, cot, lines, dt)),
            "device_ms": device_ms(lambda: cp_level_backward(u, cot, lines, dt)),
            "plain_ms": cuda_ms(lambda: cp_level_backward_plain(u, cot, lines, dt), reps=5),
            "bound_ms": bytes_bound_ms(u, cot, lines, out),
        }


def g5_rows(inp):
    from nerfacc_tpu_torch.ops.sorted_segments import (
        composite_sorted_backward,
        composite_sorted_backward_plain,
    )

    dev = inp.dev
    g = torch.Generator(device=dev).manual_seed(5)
    for name, (t0, t1, ids, n_rays, ss, se) in inp.sample_buffers().items():
        n = t0.shape[0]
        sigmas = 10.0 ** (torch.rand(n, generator=g, device=dev) * 4 - 1)
        rgbs = torch.rand((n, 3), generator=g, device=dev)
        cots = [torch.randn((n_rays, c), generator=g, device=dev) for c in (3, 1, 1)]
        args = (t0, t1, sigmas, rgbs, ids, n_rays, ss, se, *cots)
        out = composite_sorted_backward(*args)
        ref = composite_sorted_backward_plain(*args)
        counts = (se - ss + 1).clamp(min=0)
        yield {
            "kernel": "G5 composite_bwd", "case": name, "rays": n_rays, "samples": n,
            "longest_ray": int(counts.max()),
            "err_of_max": err_of_max(out, ref),
            "ms": cuda_ms(lambda: composite_sorted_backward(*args)),
            "device_ms": device_ms(lambda: composite_sorted_backward(*args)),
            "plain_ms": cuda_ms(lambda: composite_sorted_backward_plain(*args), reps=5),
            # inputs read once (ray ids unread), the two gradients written once
            "bound_ms": 1e3 * (nbytes(*args) - nbytes(ids) + nbytes(*out)) / HBM_BYTES_PER_S,
        }


def g6_rows(inp):
    import torch.nn.functional as F

    from nerfacc_tpu_torch.models.encoders import HashGridEncoder
    from nerfacc_tpu_torch.ops.hash_encode import (
        hash_corners_plain,
        hash_encode_forward,
        hash_encode_plain,
    )

    dev = inp.dev
    g = torch.Generator(device=dev).manual_seed(6)
    enc = HashGridEncoder()
    L, T, res = enc.n_levels, enc.table_size, enc.resolutions
    table = torch.rand((L, T, 2), generator=g, device=dev) * 2.0 - 1.0
    flat = table.reshape(-1, 2)
    for name, x in g6_points(dev, g).items():
        n = x.shape[0]
        out = hash_encode_forward(x, table, res)
        ref = hash_encode_plain(x, table, res)
        idx, w = hash_corners_plain(x, res, T)
        rows = (idx + T * torch.arange(L, device=dev)[None, :, None]).reshape(-1, 8)
        w = w.reshape(-1, 8).contiguous()
        del idx
        touched = int(torch.unique(rows).numel())
        row = {
            "kernel": "G6 hash_fwd", "case": name, "N": n, "L": L, "T": T,
            "outside_unit_cube": int(((x < 0) | (x > 1)).any(1).sum()),
            "unequal_to_plain": unequal(out, ref), "entries": out.numel(),
            "rows_touched": touched,
            "ms": cuda_ms(lambda: hash_encode_forward(x, table, res)),
            "device_ms": device_ms(lambda: hash_encode_forward(x, table, res)),
            "plain_ms": cuda_ms(lambda: hash_encode_plain(x, table, res), reps=3),
            "embedding_bag_ms": cuda_ms(lambda: F.embedding_bag(
                rows, flat, mode="sum", per_sample_weights=w)),
            "embedding_bag_device_ms": device_ms(lambda: F.embedding_bag(
                rows, flat, mode="sum", per_sample_weights=w)),
            # x read, the output written, each touched table row read once
            "bound_ms": 1e3 * (nbytes(x, out) + touched * 8) / HBM_BYTES_PER_S,
        }
        del ref, rows, w
        yield row
    # the proposal field's shape (NGPDensityField: 5 levels, T = 2^17)
    enc = HashGridEncoder(n_levels=5, log2_hashmap_size=17, max_resolution=128)
    L, T, res = enc.n_levels, enc.table_size, enc.resolutions
    g = torch.Generator(device=dev).manual_seed(66)
    table = torch.rand((L, T, 2), generator=g, device=dev) * 2.0 - 1.0
    for name, x in prop_hash_points(inp).items():
        out = hash_encode_forward(x, table, res)
        idx = hash_corners_plain(x, res, T)[0]
        touched = int(torch.unique(idx + T * torch.arange(L, device=dev)[None, :, None]).numel())
        del idx
        yield {
            "kernel": "G6 hash_fwd", "case": name, "N": x.shape[0], "L": L, "T": T,
            "outside_unit_cube": int(((x < 0) | (x > 1)).any(1).sum()),
            "unequal_to_plain": unequal(out, hash_encode_plain(x, table, res)),
            "entries": out.numel(), "rows_touched": touched,
            "ms": cuda_ms(lambda: hash_encode_forward(x, table, res)),
            "device_ms": device_ms(lambda: hash_encode_forward(x, table, res)),
            "plain_ms": cuda_ms(lambda: hash_encode_plain(x, table, res), reps=3),
            "bound_ms": 1e3 * (nbytes(x, out) + touched * 8) / HBM_BYTES_PER_S,
        }


def prop_hash_points(inp):
    """The proposal field's points for G6 and G7 at ``NGPDensityField``'s
    shape: the bounded path's first level (N = 2^19, unclamped) and, in a
    tree with the unbounded scene, the 360 cascade's (N = 2^20)."""
    points = {"NGPDensityField, bounded path's first level, ray order": inp.cp()["u_prop_raw"]}
    if inp.cascade() is not None:
        points["NGPDensityField, 360 cascade's first level, ray order"] = inp.cascade()
    return points


def g8_axis_rows(g):
    import torch.nn.functional as F

    from nerfacc_tpu_torch.ops.hat_matmul import hat_fwd, hat_interp_matmul_plain, hat_taps

    dev = g.device
    shapes = [(G8_AXIS_N, 512, 32)] + [(n, R, rank) for n in G8_SIZES for R, rank in HAT_LEVELS]
    for n, R, rank in shapes:
        x = torch.rand(n, generator=g, device=dev)
        line = 1 + 0.1 * torch.randn((R, rank), generator=g, device=dev)
        out = hat_fwd(x, line)
        ref = hat_interp_matmul_plain(x, line)
        i0, i1, w0, w1, _, _ = hat_taps(x, R)
        taps = torch.stack([i0, i1], dim=1)
        w = torch.stack([w0, w1], dim=1)
        line_b = line.to(torch.bfloat16).to(torch.float32)
        yield {
            "kernel": "G8 hat_fwd, one axis", "N": n, "R": R, "rank": rank,
            "unequal_to_plain": unequal(out, ref), "entries": out.numel(),
            "ms": cuda_ms(lambda: hat_fwd(x, line)),
            "device_ms": device_ms(lambda: hat_fwd(x, line)),
            "plain_ms": cuda_ms(lambda: hat_interp_matmul_plain(x, line), reps=5),
            "embedding_bag_ms": cuda_ms(lambda: F.embedding_bag(
                taps, line_b, mode="sum", per_sample_weights=w)),
            "embedding_bag_device_ms": device_ms(lambda: F.embedding_bag(
                taps, line_b, mode="sum", per_sample_weights=w)),
            "bound_ms": bytes_bound_ms(x, line, out),
        }


def g8_level_rows(g):
    from nerfacc_tpu_torch.ops import hat_matmul

    dev = g.device
    fused = getattr(hat_matmul, "hat_cp_level", None)

    def level(x, lines):
        if fused is not None:
            return fused(x, lines)
        # the parent's CPGridEncoder(use_pallas=True) level
        prod = hat_matmul.hat_interp_matmul(x[:, 0], lines[0])
        for axis in (1, 2):
            prod = prod * hat_matmul.hat_interp_matmul(x[:, axis], lines[axis])
        return prod

    for n in G8_SIZES:
        for R, rank in HAT_LEVELS:
            x0 = torch.rand((n, 3), generator=g, device=dev)
            lines0 = 1 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev)
            cot = torch.randn((n, rank), generator=g, device=dev)
            a = [hat_matmul.hat_interp_matmul_plain(x0[:, i], lines0[i]) for i in range(3)]
            ref = (a[0] * a[1]) * a[2]
            for grad in (False, True):
                x = x0.clone().requires_grad_(grad)
                lines = lines0.clone().requires_grad_(grad)

                def fwd():
                    with torch.set_grad_enabled(grad):
                        return level(x, lines)

                def fwd_bwd():
                    level(x, lines).backward(cot)

                out = fwd()
                row = {
                    "kernel": "G8 hat_fwd, one CP level",
                    "route": "hat_cp_level" if fused is not None else "per-axis",
                    "N": n, "R": R, "rank": rank, "grad": grad,
                    "unequal_to_plain": unequal(out.detach(), ref), "entries": out.numel(),
                    "ms": cuda_ms(fwd), "device_ms": device_ms(fwd),
                    # x and the tables read, the product (and with grad the
                    # three axes' interpolants) written
                    "bound_ms": 1e3 * (nbytes(x0, lines0) + (4 if grad else 1) * nbytes(ref))
                    / HBM_BYTES_PER_S,
                }
                if grad:
                    row["fwd_bwd_ms"] = cuda_ms(fwd_bwd)
                    row["fwd_bwd_device_ms"] = device_ms(fwd_bwd)
                yield row


def g8_rows(inp):
    g = torch.Generator(device=inp.dev).manual_seed(8)
    yield from g8_axis_rows(g)
    yield from g8_level_rows(g)


def g7_rows(inp):
    from nerfacc_tpu_torch.models.encoders import HashGridEncoder
    from nerfacc_tpu_torch.ops.hash_encode import (
        hash_corners_plain,
        hash_encode_backward,
        hash_encode_backward_plain,
    )

    dev = inp.dev
    g = torch.Generator(device=dev).manual_seed(7)
    enc = HashGridEncoder()
    L, T, res = enc.n_levels, enc.table_size, enc.resolutions
    x = torch.rand((2**18, 3), generator=g, device=dev)
    n_out = 2**18 // 100
    below = torch.rand(n_out, generator=g, device=dev) < 0.5
    push = 0.1 * torch.rand(n_out, generator=g, device=dev)
    x[:n_out, 0] = torch.where(below, -push, 1.0 + push)
    x_ray, _ = train_midpoints(dev, "ngp", g)
    cases = [(name, x, L, T, res)
             for name, x in (("uniform, 1% outside", x), ("NGP train step, ray order", x_ray))]
    # the proposal field's shape (NGPDensityField: 5 levels, T = 2^17)
    prop = HashGridEncoder(n_levels=5, log2_hashmap_size=17, max_resolution=128)
    cases += [(name, x, prop.n_levels, prop.table_size, prop.resolutions)
              for name, x in prop_hash_points(inp).items()]
    for name, x, L, T, res in cases:
        n = x.shape[0]
        cot = torch.randn((n, 2 * L), generator=g, device=dev)
        out = hash_encode_backward(x, cot, (L, T, 2), res)
        ref = hash_encode_backward_plain(x, cot, (L, T, 2), res)
        idx, w = hash_corners_plain(x, res, T)
        rows = (idx + T * torch.arange(L, device=dev)[None, :, None]).reshape(-1)
        upd = (w[..., None] * cot.reshape(n, L, 1, 2)).reshape(-1, 2)
        acc = torch.zeros((L * T, 2), device=dev)
        yield {
            "kernel": "G7 hash_bwd", "case": name, "N": n, "L": L, "T": T,
            "share_level0_row_as_previous": float((idx[1:, 0, 0] == idx[:-1, 0, 0]).float().mean()),
            "err_of_max": err_of_max([out], [ref]),
            "unequal_to_plain": unequal(out, ref),
            "unequal_between_two_calls": unequal(
                out, hash_encode_backward(x, cot, (L, T, 2), res)),
            "atomics": g7_atomics(x, L, T, res),
            "ms": cuda_ms(lambda: hash_encode_backward(x, cot, (L, T, 2), res)),
            "device_ms": device_ms(lambda: hash_encode_backward(x, cot, (L, T, 2), res)),
            "plain_ms": cuda_ms(lambda: hash_encode_backward_plain(x, cot, (L, T, 2), res),
                                reps=5),
            "index_add_ms": cuda_ms(lambda: acc.index_add_(0, rows, upd)),
            "index_add_device_ms": device_ms(lambda: acc.index_add_(0, rows, upd)),
            # x and the cotangent read once, the table gradient written once
            "bound_ms": bytes_bound_ms(x, cot, out),
        }


def g7_atomics(x, L, T, res, block=4096):
    """The atomics G7 issues on ``x``, counted by replaying its blocks and
    warps in PyTorch: ``fixed_point`` (this design: per corner, one 64-bit
    atomic a feature for each run of equal rows on neighbouring lanes, the
    cube of a level whose int64 pairs fit 80 KiB summed in shared memory)
    and ``float_pairs`` (its parent: per pair of corners dx = 0, 1, one
    float4 atomic for each run of equal row pairs, and one more for each
    run where the two corners lie on different pairs; the cube of a level
    whose float2s fit 48 KiB in shared memory, one float2 atomic a nonzero
    cell).  Each counts global (the L2's) and shared atomics; a zero term
    is counted as if it were not."""
    from nerfacc_tpu_torch.ops.hash_encode import hash_corners_plain

    n, dev = x.shape[0], x.device
    idx, _ = hash_corners_plain(x, res, T)  # (n, L, 8)
    lane = torch.arange(n, device=dev) % 32
    blk = torch.arange(n, device=dev) // block
    counts = {"fixed_point": {"global": 0, "shared": 0},
              "float_pairs": {"global": 0, "shared": 0}}

    def heads(key, valid=None):
        """Lanes that start a run of equal keys (among ``valid`` lanes)."""
        prev = torch.cat([key[:1], key[:-1]])
        h = (lane == 0) | (key != prev)
        if valid is not None:
            pv = torch.cat([valid[:1], valid[:-1]])
            h = valid & (h | ~pv)
        return h

    for level in range(L):
        r = float(res[level])
        i0 = torch.floor(x * r).long()
        dim = int(r) + 1
        rows = idx[:, level, :] + level * T
        for design, cube_bytes, entry in (("fixed_point", 80 * 1024, 16),
                                          ("float_pairs", 48 * 1024, 8)):
            c = counts[design]
            staged = dim**3 * entry <= cube_bytes
            if staged:
                cells = []
                for k in range(8):
                    off = torch.tensor([(k >> 2) & 1, (k >> 1) & 1, k & 1], device=dev)
                    cell = i0 + off
                    inside = ((cell >= 0) & (cell < dim)).all(-1)
                    h = heads(rows[:, k])
                    per = 2 if design == "fixed_point" else 1  # atomics a global add
                    c["shared"] += 2 * int((h & inside).sum())
                    c["global"] += per * int((h & ~inside).sum())
                    flat = (cell[:, 0] * dim + cell[:, 1]) * dim + cell[:, 2]
                    cells.append((blk * dim**3 + flat)[h & inside])
                nonzero = int(torch.unique(torch.cat(cells)).numel())
                c["global"] += (2 if design == "fixed_point" else 1) * nonzero
            elif design == "fixed_point":
                c["global"] += 2 * sum(int(heads(rows[:, k]).sum()) for k in range(8))
            else:
                for k in range(4):
                    p0, p1 = rows[:, k] >> 1, rows[:, k + 4] >> 1
                    c["global"] += int(heads(p0).sum())
                    c["global"] += int(heads(p1, p1 != p0).sum())
    return counts


def g9_rows(inp):
    from nerfacc_tpu_torch.ops.hat_matmul import hat_bwd_line, hat_bwd_line_plain, hat_taps

    dev = inp.dev
    g = torch.Generator(device=dev).manual_seed(9)
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
            yield {
                "kernel": "G9 hat_bwd_line", "N": n, "R": R, "rank": rank,
                "err_of_max": float((out - ref).abs().max() / ref.abs().max()),
                "same_bits_twice": bool(torch.equal(
                    out.view(torch.int32), hat_bwd_line(x, cot, R).view(torch.int32))),
                "ms": cuda_ms(lambda: hat_bwd_line(x, cot, R)),
                "device_ms": device_ms(lambda: hat_bwd_line(x, cot, R)),
                "index_add_ms": cuda_ms(lambda: acc.index_add_(0, taps, upd)),
                "index_add_device_ms": device_ms(lambda: acc.index_add_(0, taps, upd)),
                # x and g read once, the table written once
                "bound_ms": 1e3 * (4 * n * (1 + rank) + 4 * R * rank) / HBM_BYTES_PER_S,
            }


def g10_rows(inp):
    from nerfacc_tpu_torch.ops.hat_matmul import hat_bwd_x, hat_bwd_x_plain

    dev = inp.dev
    g = torch.Generator(device=dev).manual_seed(10)
    for n, R, rank in HAT_X_SHAPES:
        x = torch.rand(n, generator=g, device=dev)
        line = 1 + 0.1 * torch.randn((R, rank), generator=g, device=dev)
        cot = torch.randn((n, rank), generator=g, device=dev)
        out = hat_bwd_x(x, cot, line)
        ref = hat_bwd_x_plain(x, cot, line)
        yield {
            "kernel": "G10 hat_bwd_x", "N": n, "R": R, "rank": rank,
            "err_of_max": float((out - ref).abs().max() / ref.abs().max()),
            "ms": cuda_ms(lambda: hat_bwd_x(x, cot, line)),
            "device_ms": device_ms(lambda: hat_bwd_x(x, cot, line)),
            "plain_ms": cuda_ms(lambda: hat_bwd_x_plain(x, cot, line), reps=5),
            "bound_ms": bytes_bound_ms(x, cot, line, out),
        }


def g14_inputs(dev, g, n_rays):
    """``chip_smoke.py``'s phase 1f inputs: the first level's unit rows (E =
    2) with a stratified bias, and the final resampling's rows (E = 129):
    the first level's 129 edges and the CDF ``propnet_sampling`` forms from
    seeded densities, a third of them zero, so the CDF has plateaus; and
    that CDF as phase 1f formed it before (the exclusive sum as the
    inclusive one less the sample's own term, which rounds a third of the
    rows out of order)."""
    from nerfacc_tpu_torch.pdf import importance_sampling_plain
    from nerfacc_tpu_torch.volrend import render_transmittance_from_density

    unit = torch.tensor([[0.0, 1.0]], device=dev).expand(n_rays, 2).contiguous()
    bias = torch.rand(n_rays, generator=g, device=dev)
    _, edges = importance_sampling_plain(unit, unit, bias, 128)
    sigma = torch.rand((n_rays, 128), generator=g, device=dev) * 40.0
    sigma = torch.where(torch.rand(sigma.shape, generator=g, device=dev) < 1 / 3, 0.0, sigma)
    trans, _ = render_transmittance_from_density(edges[:, :-1], edges[:, 1:], sigma)
    sdt = sigma * (edges[:, 1:] - edges[:, :-1])
    former = torch.exp(-torch.cumsum(sdt, dim=-1) + sdt)
    cdfs, former = (1.0 - torch.cat([t, torch.zeros_like(t[:, :1])], dim=-1)
                    for t in (trans, former))
    return unit, bias, edges.contiguous(), cdfs.contiguous(), former.contiguous()


def cascade_rows(dev):
    """The 360 cascade's three resamplings at 4096 rays, stratified (the
    proposal example's [256, 96] -> 48): E = 2 -> 256, then each level's
    edges with the CDF formed from seeded densities (a third zero) -> 96,
    and -> 48, as ``chip_smoke.py``'s phase 1f forms them."""
    from nerfacc_tpu_torch.pdf import importance_sampling_plain
    from nerfacc_tpu_torch.volrend import render_transmittance_from_density

    g = torch.Generator(device=dev).manual_seed(360)
    unit = torch.tensor([[0.0, 1.0]], device=dev).expand(4096, 2).contiguous()
    bias = torch.rand(4096, generator=g, device=dev)
    rows = [(unit, unit, 256)]
    for n in (96, 48):
        vals, cdfs, m = rows[-1]
        _, edges = importance_sampling_plain(vals, cdfs, bias, m)
        sigma = torch.rand((4096, m), generator=g, device=dev) * 40.0
        sigma = torch.where(torch.rand(sigma.shape, generator=g, device=dev) < 1 / 3, 0.0, sigma)
        trans, _ = render_transmittance_from_density(edges[:, :-1], edges[:, 1:], sigma)
        rows.append((edges.contiguous(),
                     (1.0 - torch.cat([trans, torch.zeros_like(trans[:, :1])], -1)).contiguous(),
                     n))
    return [(f"4096 rays, E = {v.shape[1]} -> {n}, 360 cascade, stratified", v, c, bias, n)
            for v, c, n in rows]


def g14_rows(inp):
    from nerfacc_tpu_torch import pdf

    dev = inp.dev
    g = torch.Generator(device=dev).manual_seed(14)
    unit, bias, edges, cdfs, former = g14_inputs(dev, g, 4096)
    _, _, eval_edges, eval_cdfs, _ = g14_inputs(dev, g, 8192)
    half = torch.full((8192,), 0.5, device=dev)
    for what, vals, c, b, n in (
        ("4096 rays, E = 2 -> 128, stratified", unit, unit, bias, 128),
        ("4096 rays, E = 129 -> 64, plateaued CDF, stratified", edges, cdfs, bias, 64),
        ("8192 rays, E = 129 -> 64, plateaued CDF, bias 0.5", eval_edges, eval_cdfs, half, 64),
        ("4096 rays, E = 129 -> 64, the former phase 1f CDF, stratified", edges, former, bias,
         64),
        *cascade_rows(dev),
    ):
        out = pdf._importance_sampling(vals, c, b, n)
        ref = pdf.importance_sampling_plain(vals, c, b, n)
        yield {
            "kernel": "G14 importance_sampling", "shape": what,
            "unequal": unequal(out[0], ref[0]) + unequal(out[1], ref[1]),
            "rows_out_of_order": int((~(c.diff(dim=1) >= 0).all(1)).sum()),
            "ms": cuda_ms(lambda: pdf._importance_sampling(vals, c, b, n)),
            "device_ms": device_ms(lambda: pdf._importance_sampling(vals, c, b, n)),
            "plain_ms": cuda_ms(lambda: pdf.importance_sampling_plain(vals, c, b, n), reps=5),
            # each input read once, each output written once
            "bound_ms": bytes_bound_ms(vals, c, b, *out),
        }


def host_pieces_us(row, lane, S):
    """Host microseconds a call of each piece of G11's wrapper (the shared
    helpers of ``nerfacc_tpu_torch.cuda`` among them) and of the ctypes call
    that launches the kernel."""
    from nerfacc_tpu_torch import cuda

    out = torch.empty_like(row, dtype=torch.float32)
    lib, stream = cuda.load(), cuda.stream_ptr(row)
    launch = lib.coarse_occ_lookup
    return {
        "cuda.on_card": host_us(lambda: cuda.on_card(row, lane, S)),
        "cuda.stream_ptr": host_us(lambda: cuda.stream_ptr(row)),
        "cuda.ptr x4": host_us(lambda: [cuda.ptr(t) for t in (row, lane, S, out)]),
        "torch.empty_like": host_us(lambda: torch.empty_like(row, dtype=torch.float32)),
        "contiguous x3": host_us(lambda: (row.contiguous(), lane.contiguous(), S.contiguous())),
        "ctypes launch": host_us(lambda: launch(row.data_ptr(), lane.data_ptr(), S.data_ptr(),
                                                out.data_ptr(), row.shape[0], *S.shape, stream)),
    }


def g11_rows(inp):
    from nerfacc_tpu_torch.ops.coarse_occ import coarse_occ_lookup, coarse_occ_lookup_plain

    dev = inp.dev
    g = torch.Generator(device=dev).manual_seed(11)
    rows, lanes, n = 256, 1024, 2**18
    S = torch.rand((rows, lanes), generator=g, device=dev)
    row = torch.randint(0, rows, (n,), generator=g, device=dev, dtype=torch.int32)
    lane = torch.randint(0, lanes, (n,), generator=g, device=dev, dtype=torch.int32)
    row_o, lane_o = with_outside(g, row, -8, rows + 8), with_outside(g, lane, -8, lanes + 8)
    out = coarse_occ_lookup(row, lane, S)
    r64, l64 = row.long(), lane.long()
    yield {
        "kernel": "G11 coarse_occ_lookup", "N": n, "summary": [rows, lanes],
        "unequal_to_plain": unequal(coarse_occ_lookup(row_o, lane_o, S),
                                    coarse_occ_lookup_plain(row_o, lane_o, S)),
        "ms": cuda_ms(lambda: coarse_occ_lookup(row, lane, S)),
        "device_ms": device_ms(lambda: coarse_occ_lookup(row, lane, S)),
        "host_us": host_us(lambda: coarse_occ_lookup(row, lane, S)),
        "plain_ms": cuda_ms(lambda: coarse_occ_lookup_plain(row, lane, S), reps=5),
        "library_ms": cuda_ms(lambda: S[r64, l64]),
        "library_device_ms": device_ms(lambda: S[r64, l64]),
        "library_host_us": host_us(lambda: S[r64, l64]),
        "host_pieces_us": host_pieces_us(row, lane, S),
        "bound_ms": bytes_bound_ms(row, lane, S, out),
    }


def g12_route_ms(src, idx, routes):
    """Device time alone of each of the tree's G12 routes on these inputs
    (the route argument of its C entry point), and whether each equals the
    plain version bit for bit."""
    from nerfacc_tpu_torch import cuda
    from nerfacc_tpu_torch.ops import lane_gather as lg

    lib, T = cuda.load(), src.shape[0]
    out = torch.empty(idx.shape, dtype=src.dtype, device=src.device)
    ref = lg.lane_gather_plain(src, idx)
    times = {}
    for route in routes:
        def call(route=route):
            cuda.check(lib.lane_gather(src.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                       idx.shape[0], T, src.element_size(), route,
                                       lg.SHARED_TABLE_BYTES, cuda.stream_ptr(src)),
                       "lane_gather")
        call()
        times[str(route)] = {"device_ms": device_ms(call, reps=5),
                             "unequal_to_plain": unequal_words(out, ref)}
    return times


def g12_rows(inp):
    from nerfacc_tpu_torch.ops import lane_gather as lg

    dev = inp.dev
    g = torch.Generator(device=dev).manual_seed(12)
    route_of = getattr(lg, "lane_gather_route", None)
    # phase 1e's tables, then (trees with routes) the route boundaries
    heights = [512, 2**14, 2**16] + ([8192, 9557, 14336, 28672] if route_of else [])
    cases = [(f"T={T}", T, dt, None) for T in heights for dt in (torch.float32, torch.bfloat16)]
    sizes = torch.clamp(2 ** (10 + torch.arange(128, device=dev) % 16), max=2**16)
    cases.append(("NGP-shaped", 2**16, torch.float32, sizes))
    for name, T, dt, sizes in cases:
        src = torch.randn((T, 128), generator=g, device=dev).to(dt)
        if sizes is None:
            idx = torch.randint(0, T, (64 * T, 128), generator=g, device=dev, dtype=torch.int32)
        else:
            idx = (torch.randint(0, 2**30, (2**18, 128), generator=g, device=dev,
                                 dtype=torch.int32) % sizes).to(torch.int32)
        checked = with_outside(g, idx, -T - 8, T + 8)
        bad = unequal_words(lg.lane_gather(src, checked), lg.lane_gather_plain(src, checked))
        routes = {}
        if route_of:  # every route the kernel has for this dtype
            routes = g12_route_ms(src, checked, (0, 32, 16) if dt == torch.bfloat16 else (0, 32))
        del checked
        out = lg.lane_gather(src, idx)
        i64 = idx.long()
        yield {
            "kernel": "G12 lane_gather", "case": name, "T": T, "rows": idx.shape[0],
            "dtype": str(dt)[6:], "route": route_of(T, dt) if route_of else "parent",
            "unequal_to_plain": bad, "routes": routes,
            "ms": cuda_ms(lambda: lg.lane_gather(src, idx)),
            "device_ms": device_ms(lambda: lg.lane_gather(src, idx)),
            "host_us": host_us(lambda: lg.lane_gather(src, idx), reps=20),
            "plain_ms": cuda_ms(lambda: lg.lane_gather_plain(src, idx), reps=3),
            "library_ms": cuda_ms(lambda: torch.gather(src, 0, i64), reps=5),
            "library_device_ms": device_ms(lambda: torch.gather(src, 0, i64), reps=5),
            "bound_ms": bytes_bound_ms(src, idx, out),
        }
        del src, idx, out, i64
        torch.cuda.empty_cache()


ROWS = {"G1": g1_rows, "G2": g2_rows, "G3": g3_rows, "G4": g4_rows, "G5": g5_rows,
        "G6": g6_rows, "G7": g7_rows, "G8": g8_rows, "G9": g9_rows, "G10": g10_rows,
        "G11": g11_rows, "G12": g12_rows, "G14": g14_rows}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernels", nargs="*", choices=list(ROWS), metavar="KERNEL",
                    help=f"kernels to time, of {' '.join(ROWS)} (default: all)")
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default="change")
    ap.add_argument("--out", default="build/time_kernels")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import nerfacc_tpu_torch

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    head = {"label": args.label, "package": os.path.dirname(nerfacc_tpu_torch.__file__),
            "card": smi}
    print(json.dumps(head))
    inp = Inputs(dev)
    rows = []
    for kernel in args.kernels or ROWS:
        for row in ROWS[kernel](inp):
            print(json.dumps({"label": args.label, **row}), flush=True)
            rows.append(row)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"time_kernels_{args.label}.json"), "a") as f:
        f.write(json.dumps({**head, "rows": rows}) + "\n")


if __name__ == "__main__":
    main()
