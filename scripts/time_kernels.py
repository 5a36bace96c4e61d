#!/usr/bin/env python3
"""Time kernels of one tree of the PyTorch port on one GPU, at the shapes the
paths give them.

Run from the root of a checkout:

    python3 scripts/time_kernels.py [G1 G2 G3 G4 G5 G7 G9 G10] [--root DIR] [--label NAME] [--out build/time_kernels]

The positional arguments pick the kernels (all of these by default).
``--root`` names the tree whose ``nerfacc_tpu_torch`` is imported and built
(default: this checkout), so that two designs are compared on one card in
one call, in turns, e.g. with an older commit unpacked by ``git archive``
into a git-ignored directory:

    python3 scripts/time_kernels.py G1 G7 --root build/parent --label parent
    python3 scripts/time_kernels.py G1 G7 --label change
    python3 scripts/time_kernels.py G1 G7 --label change
    python3 scripts/time_kernels.py G1 G7 --root build/parent --label parent

The shapes:

- G1 (CP-level forward), both compute dtypes: N = 2^18 uniform in [0, 1]^3
  at (R, rank) = (512, 32); the CP train buffer's sample midpoints in ray
  order (below) at (32, 32), (128, 32), (512, 32); the proposal field's
  points (below) at (16, 16) and (64, 16); the dense refresh's 2^21 points,
  one jittered point per cell of the 128^3 grid in the refresh's cell
  order, at (512, 32).  Error: the count of entries unequal to the plain
  version.
- G2 (march): the full-width CP trainer's grid after four dense refreshes
  (parameters from seed 42, as ``chip_smoke.py``'s phase 1): the middle
  8192 rays of test view 0 with near plane 0, and a 2048-ray train batch (6
  views at 256x256) at the trainer's near planes ``0 + jitter * step``;
  the sample count, the rays whose count differs from the plain version
  (on that grid and on it with half its cells cleared).
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
  samples over [2, 6], N = 2^19) at (16, 16) and (64, 16).
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

Each row holds the error against the plain version, the CUDA-event time of
one call (host path included), the device time of its kernels alone from
``torch.profiler``, the plain version's time, and the bytes bound (each
input read once, each output written once, at 3.35 TB/s).  Each result is
one JSON line; all go to ``<out>/time_kernels_<label>.json``.
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
HBM_BYTES_PER_S = 3.35e12
HAT_LEVELS = ((32, 16), (128, 16), (512, 32))
HAT_X_SHAPES = ((2**18, 512, 32), (2**16, 32, 16), (2**16, 128, 16), (2**16, 512, 32))


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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def bytes_bound_ms(*tensors):
    return 1e3 * nbytes(*tensors) / HBM_BYTES_PER_S


def err_of_max(out, ref):
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(out, ref))


def unequal(a, b):
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


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
    lo = torch.tensor(AABB[:3], device=dev)
    hi = torch.tensor(AABB[3:], device=dev)
    return ((mids - lo) / (hi - lo)).contiguous(), (occ, step, o, d, near, far, s, train)


def proposal_points(dev, train, g):
    """The proposal field's points: 128 stratified samples per ray of 4096
    train rays over [2, 6], normalised to the AABB and clamped."""
    po, pd = train["rays_o"], train["rays_d"]
    tp = 2.0 + (torch.arange(128, device=dev) + torch.rand((4096, 128), generator=g,
                                                           device=dev)) * (4.0 / 128)
    pts = po[:, None] + tp[..., None] * pd[:, None]
    lo = torch.tensor(AABB[:3], device=dev)
    hi = torch.tensor(AABB[3:], device=dev)
    return ((pts.reshape(-1, 3) - lo) / (hi - lo)).clamp(0.0, 1.0).contiguous()


class Inputs:
    """The buffers the rows share, made once per run on first use."""

    def __init__(self, dev):
        self.dev = dev
        self._cp = None

    def cp(self):
        if self._cp is None:
            g = torch.Generator(device=self.dev).manual_seed(0)
            u_mid, (occ, step, o, d, near, far, train_s, train) = train_midpoints(
                self.dev, "cp", g)
            self._cp = dict(
                u_train=u_mid.clamp(0.0, 1.0).contiguous(), occ=occ, step=step,
                o=o, d=d, near=near, far=far, train_s=train_s,
                u_prop=proposal_points(self.dev, train, g), g=g,
            )
        return self._cp

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


def g1_rows(inp):
    from nerfacc_tpu_torch.ops.cp_level import cp_level_encode, cp_level_encode_plain

    dev, c = inp.dev, inp.cp()
    g = torch.Generator(device=dev).manual_seed(1)
    # the dense refresh: one jittered point per cell of the 128^3 grid, cells
    # in the refresh's row-major order
    ids = torch.arange(128**3, device=dev)
    coords = torch.stack([ids // 128**2, (ids // 128) % 128, ids % 128], -1).float()
    u_refresh = ((coords + torch.rand((128**3, 3), generator=g, device=dev)) / 128).contiguous()
    shapes = [("uniform", torch.rand((2**18, 3), generator=g, device=dev), 512, 32)]
    shapes += [("CP train buffer, ray order", c["u_train"], R, 32) for R in (32, 128, 512)]
    shapes += [("proposal field, ray order", c["u_prop"], R, 16) for R in (16, 64)]
    shapes += [("dense refresh, 128^3 cells", u_refresh, 512, 32)]
    for name, u, R, rank in shapes:
        lines = 1 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev)
        runs = float((torch.floor(u[1:] * (R - 1)) == torch.floor(u[:-1] * (R - 1)))
                     .all(-1).float().mean())
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
        yield {
            "kernel": "G4 cp_level_bwd", "case": name, "N": n, "R": R, "rank": rank,
            "share_same_row_as_previous": runs,
            "err_of_max": err_of_max([out], [ref]),
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
    for name, x in (("uniform, 1% outside", x), ("NGP train step, ray order", x_ray)):
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
            "ms": cuda_ms(lambda: hash_encode_backward(x, cot, (L, T, 2), res)),
            "device_ms": device_ms(lambda: hash_encode_backward(x, cot, (L, T, 2), res)),
            "plain_ms": cuda_ms(lambda: hash_encode_backward_plain(x, cot, (L, T, 2), res),
                                reps=5),
            "index_add_ms": cuda_ms(lambda: acc.index_add_(0, rows, upd)),
            "index_add_device_ms": device_ms(lambda: acc.index_add_(0, rows, upd)),
            # x and the cotangent read once, the table gradient written once
            "bound_ms": bytes_bound_ms(x, cot, out),
        }


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


ROWS = {"G1": g1_rows, "G2": g2_rows, "G3": g3_rows, "G4": g4_rows, "G5": g5_rows,
        "G7": g7_rows, "G9": g9_rows, "G10": g10_rows}


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
