#!/usr/bin/env python3
"""Time kernels G3 (composite forward) and G10 (hat coordinate gradient) of
one tree of the PyTorch port on one GPU, at the shapes the paths give them.

Run from the root of a checkout:

    python3 scripts/time_composite_fwd_hat_x.py [--root DIR] [--label NAME] [--out build/time_composite_fwd_hat_x]

``--root`` names the tree whose ``nerfacc_tpu_torch`` is imported and built
(default: this checkout), so that two designs are compared on one card in
one call, e.g. with an older commit unpacked by ``git archive`` into a
git-ignored directory:

    python3 scripts/time_composite_fwd_hat_x.py --root build/parent --label parent
    python3 scripts/time_composite_fwd_hat_x.py --label change

G3 runs on the four sample buffers of ``time_composite_cp_bwd.py`` (the
8192-ray eval chunk, the CP train buffer of 2048 rays cut at 2^18, the
TiNeuVox buffer's shape of 1024 rays cut at 2^16, and the proposal layout
of 4096 rays x 64), with seeded densities 10^U(-1, 3) and colours; the
occupancy-grid buffers ask for the weights, as ``utils/rendering.py`` does,
the proposal layout does not, as ``volrend.rendering`` does not.  G10 runs
at N = 2^18, (R, rank) = (512, 32), and at the TiNeuVox train step's budget
N = 2^16 at its three levels (32, 16), (128, 16) and (512, 32), on
coordinates uniform in [0, 1] with a seeded table and cotangent.

Each row holds the error against the plain version (G3: absolute, colour
and opacity, and depth; G10: relative to its largest entry), the CUDA-event
time of one call (host path included), the device time of its kernel alone
from ``torch.profiler``, and the bytes bound (each input read once, each
output written once, at 3.35 TB/s).  Each result is one JSON line; all go
to ``<out>/time_composite_fwd_hat_x_<label>.json``.
"""
import torch

from time_composite_cp_bwd import HBM_BYTES_PER_S, buffers, nbytes
from time_march_hat import cuda_ms, device_ms, timing_main

HAT_X_SHAPES = ((2**18, 512, 32), (2**16, 32, 16), (2**16, 128, 16), (2**16, 512, 32))


def g3_rows(dev, cases):
    from nerfacc_tpu_torch.ops.sorted_segments import composite_sorted, composite_sorted_plain

    g = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for name, (t0, t1, ids, n_rays, ss, se) in cases.items():
        n = t0.shape[0]
        sigmas = 10.0 ** (torch.rand(n, generator=g, device=dev) * 4 - 1)
        rgbs = torch.rand((n, 3), generator=g, device=dev)
        weights = not name.startswith("proposal")
        args = (t0, t1, sigmas, rgbs, ids, n_rays, ss, se, None, weights)
        out = composite_sorted(*args)
        ref = composite_sorted_plain(*args)
        rows.append({
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
        })
    return rows


def g10_rows(dev):
    from nerfacc_tpu_torch.ops.hat_matmul import hat_bwd_x, hat_bwd_x_plain

    g = torch.Generator(device=dev).manual_seed(10)
    rows = []
    for n, R, rank in HAT_X_SHAPES:
        x = torch.rand(n, generator=g, device=dev)
        line = 1 + 0.1 * torch.randn((R, rank), generator=g, device=dev)
        cot = torch.randn((n, rank), generator=g, device=dev)
        out = hat_bwd_x(x, cot, line)
        ref = hat_bwd_x_plain(x, cot, line)
        rows.append({
            "kernel": "G10 hat_bwd_x", "N": n, "R": R, "rank": rank,
            "err_of_max": float((out - ref).abs().max() / ref.abs().max()),
            "ms": cuda_ms(lambda: hat_bwd_x(x, cot, line)),
            "device_ms": device_ms(lambda: hat_bwd_x(x, cot, line)),
            "plain_ms": cuda_ms(lambda: hat_bwd_x_plain(x, cot, line), reps=5),
            "bound_ms": 1e3 * nbytes(x, cot, line, out) / HBM_BYTES_PER_S,
        })
    return rows


def rows(dev):
    cases, _, _ = buffers(dev)
    yield from g3_rows(dev, cases)
    yield from g10_rows(dev)


if __name__ == "__main__":
    timing_main("time_composite_fwd_hat_x", __doc__, rows)
