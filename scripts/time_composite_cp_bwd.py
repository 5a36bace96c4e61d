#!/usr/bin/env python3
"""Time kernels G5 (composite backward) and G4 (CP-level backward) of one
tree of the PyTorch port on one GPU, at the shapes the train steps give them.

Run from the root of a checkout:

    python3 scripts/time_composite_cp_bwd.py [--root DIR] [--label NAME] [--out build/time_composite_cp_bwd]

``--root`` names the tree whose ``nerfacc_tpu_torch`` is imported and built
(default: this checkout), so that two designs are compared on one card in
one call, e.g. with an older commit unpacked by ``git archive`` into a
git-ignored directory:

    python3 scripts/time_composite_cp_bwd.py --root build/parent --label parent
    python3 scripts/time_composite_cp_bwd.py --label change

G5 runs on sample buffers marched on the full-width ``CPRadianceField``
trainer's grid after four dense refreshes (parameters from seed 42, as
``chip_smoke.py``'s phase 1), with seeded densities 10^U(-1, 3), colours and
cotangents:

- the eval chunk: the middle 8192 rays of test view 0, near plane 0, every
  sample kept;
- the CP train buffer: 2048 train rays (6 views at 256x256) at the trainer's
  near planes ``0 + jitter * step``, cut at the 2^18 budget by
  ``compact_samples``;
- the TiNeuVox buffer's shape: the first 1024 of those rays, cut at 2^16;
- the proposal layout: 4096 rays x 64 samples over [2, 6], one segment per
  row of the flat view, as ``volrend.rendering`` hands it over.

G4 runs at N = 2^18, R = 512, rank 32 on coordinates uniform in [0, 1]
(``chip_smoke.py``'s shape), on ray-ordered coordinates (the CP train
buffer's sample midpoints, normalised to the AABB and clamped as
``CPGridEncoder`` does) at (R, rank) = (32, 32), (128, 32), (512, 32), and
on the proposal field's coordinates (4096 train rays x 128 stratified
samples over [2, 6], N = 2^19) at (16, 16) and (64, 16); bf16, the fields'
compute dtype, with seeded tables and cotangents.

Each row holds the error against the plain version (relative to its largest
entry), the CUDA-event time of one call (host path included), the device
time of its kernels alone from ``torch.profiler``, and the bytes bound (each
input read once, each output written once, at 3.35 TB/s).  Each result is
one JSON line; all go to ``<out>/time_composite_cp_bwd_<label>.json``.
"""
import torch

from time_march_hat import AABB, cuda_ms, device_ms, refreshed_cp_grid, timing_main

HBM_BYTES_PER_S = 3.35e12


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def err_of_max(out, ref):
    return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(out, ref))


def buffers(dev):
    """The G5 buffers, and the CP train buffer's sample midpoints."""
    from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
    from nerfacc_tpu_torch.grid import march
    from nerfacc_tpu_torch.utils.rendering import compact_samples

    occ, step = refreshed_cp_grid(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    test = ProceduralSceneLoader(split="test", device=dev)[0]
    n = test["rays_o"].shape[0]
    mid = slice(n // 2 - 4096, n // 2 + 4096)
    train = ProceduralSceneLoader(split="train", n_train=6, width=256, height=256,
                                  num_rays=4096, device=dev)[0]
    o, d = train["rays_o"][:2048].contiguous(), train["rays_d"][:2048].contiguous()
    near = (0.0 + torch.rand(2048, generator=g, device=dev) * step).contiguous()
    far = torch.full_like(near, 1e10)

    def sorted_case(s, n_rays):
        return (s.t_starts, s.t_ends, s.ray_indices, n_rays, s.seg_starts, s.seg_ends)

    eval_s = compact_samples(march(
        test["rays_o"][mid].contiguous(), test["rays_d"][mid].contiguous(),
        occ.binaries, occ.aabbs, torch.zeros(8192, device=dev),
        torch.full((8192,), 1e10, device=dev), step))
    train_m = march(o, d, occ.binaries, occ.aabbs, near, far, step)
    train_s = compact_samples(train_m, 2**18)
    tnv_s = compact_samples(
        march(o[:1024].contiguous(), d[:1024].contiguous(), occ.binaries, occ.aabbs,
              near[:1024].contiguous(), far[:1024].contiguous(), step), 2**16)
    t = torch.linspace(2.0, 6.0, 65, device=dev)
    t0 = t[:-1].repeat(4096)
    t1 = t[1:].repeat(4096)
    rows = torch.arange(4096, dtype=torch.int32, device=dev)
    prop = (t0, t1, rows.repeat_interleave(64), 4096, rows * 64, rows * 64 + 63)
    cases = {
        "eval chunk, 8192 rays": sorted_case(eval_s, 8192),
        "CP train buffer, 2048 rays, budget 2^18": sorted_case(train_s, 2048),
        "TiNeuVox buffer shape, 1024 rays, budget 2^16": sorted_case(tnv_s, 1024),
        "proposal layout, 4096 rays x 64": prop,
    }
    ids = train_s.ray_indices.long()
    mids = o[ids] + (0.5 * (train_s.t_starts + train_s.t_ends))[:, None] * d[ids]
    lo = torch.tensor(AABB[:3], device=dev)
    hi = torch.tensor(AABB[3:], device=dev)
    u_train = ((mids - lo) / (hi - lo)).clamp(0.0, 1.0).contiguous()
    # the proposal field's points: 128 stratified samples per ray over [2, 6]
    po, pd = train["rays_o"], train["rays_d"]
    tp = 2.0 + (torch.arange(128, device=dev) + torch.rand((4096, 128), generator=g,
                                                           device=dev)) * (4.0 / 128)
    pts = po[:, None] + tp[..., None] * pd[:, None]
    u_prop = ((pts.reshape(-1, 3) - lo) / (hi - lo)).clamp(0.0, 1.0).contiguous()
    return cases, u_train, u_prop


def g5_rows(dev, cases):
    from nerfacc_tpu_torch.ops.sorted_segments import (
        composite_sorted_backward,
        composite_sorted_backward_plain,
    )

    g = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for name, (t0, t1, ids, n_rays, ss, se) in cases.items():
        n = t0.shape[0]
        sigmas = 10.0 ** (torch.rand(n, generator=g, device=dev) * 4 - 1)
        rgbs = torch.rand((n, 3), generator=g, device=dev)
        cots = [torch.randn((n_rays, c), generator=g, device=dev) for c in (3, 1, 1)]
        args = (t0, t1, sigmas, rgbs, ids, n_rays, ss, se, *cots)
        out = composite_sorted_backward(*args)
        ref = composite_sorted_backward_plain(*args)
        counts = (se - ss + 1).clamp(min=0)
        rows.append({
            "kernel": "G5 composite_bwd", "case": name, "rays": n_rays, "samples": n,
            "longest_ray": int(counts.max()),
            "err_of_max": err_of_max(out, ref),
            "ms": cuda_ms(lambda: composite_sorted_backward(*args)),
            "device_ms": device_ms(lambda: composite_sorted_backward(*args)),
            "plain_ms": cuda_ms(lambda: composite_sorted_backward_plain(*args), reps=5),
            # inputs read once (ray ids unread), the two gradients written once
            "bound_ms": 1e3 * (nbytes(*args) - nbytes(ids) + nbytes(*out)) / HBM_BYTES_PER_S,
        })
    return rows


def g4_rows(dev, u_train, u_prop):
    from nerfacc_tpu_torch.ops.cp_level import cp_level_backward, cp_level_backward_plain

    g = torch.Generator(device=dev).manual_seed(4)
    shapes = [("uniform", torch.rand((2**18, 3), generator=g, device=dev), 512, 32)]
    shapes += [("CP train buffer, ray order", u_train[:2**18], R, 32) for R in (32, 128, 512)]
    shapes += [("proposal field, ray order", u_prop, R, 16) for R in (16, 64)]
    rows = []
    for name, u, R, rank in shapes:
        n = u.shape[0]
        lines = 1 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev)
        cot = torch.randn((n, rank), generator=g, device=dev)
        dt = torch.bfloat16
        out = cp_level_backward(u, cot, lines, dt)
        ref = cp_level_backward_plain(u, cot, lines, dt)
        runs = float((torch.floor(u[1:] * (R - 1)) == torch.floor(u[:-1] * (R - 1))).float().mean())
        rows.append({
            "kernel": "G4 cp_level_bwd", "case": name, "N": n, "R": R, "rank": rank,
            "share_same_row_as_previous": runs,
            "err_of_max": err_of_max([out], [ref]),
            "ms": cuda_ms(lambda: cp_level_backward(u, cot, lines, dt)),
            "device_ms": device_ms(lambda: cp_level_backward(u, cot, lines, dt)),
            "plain_ms": cuda_ms(lambda: cp_level_backward_plain(u, cot, lines, dt), reps=5),
            "bound_ms": 1e3 * nbytes(u, cot, lines, out) / HBM_BYTES_PER_S,
        })
    return rows


def rows(dev):
    cases, u_train, u_prop = buffers(dev)
    yield from g5_rows(dev, cases)
    yield from g4_rows(dev, u_train, u_prop)


if __name__ == "__main__":
    timing_main("time_composite_cp_bwd", __doc__, rows)
