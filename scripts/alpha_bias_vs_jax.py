#!/usr/bin/env python3
"""Measure how far ``alpha = 1 - exp(-x)`` in f32 sits from the exact value
at the tiny optical depths of an untrained field, through each exp that
forms it: XLA's on the CPU (the JAX package's, with ``--xla``), PyTorch's
on the CPU (the port's plain versions), PyTorch's on the card (``expf``, as
kernels G3 and G5 call it) where one is present, and ``-expm1(-x)``.

Run from the root of a checkout:

    JAX_PLATFORMS=cpu python3 scripts/alpha_bias_vs_jax.py --xla [--n 1000000]
    python3 scripts/alpha_bias_vs_jax.py          # on a machine with a card

Both packages form alpha as ``1 - exp(-sigma * dt)`` in f32
(nerfacc_tpu/volrend.py:101; the port's ``volrend.py``,
``ops/sorted_segments.py`` and ``csrc/composite.cu``).  Near x = 0 the
result keeps only what the rounding of ``exp(-x)`` to f32 (steps of 2^-24
just below 1) leaves: each alpha is off by up to ~1% at x ~ 5e-6, and if
the exp rounds one way more often than the other, every alpha of a ray
(and every weight) is off the same way.  For each range of x the script
prints one JSON line a route: the mean relative error of alpha (its bias),
its root mean square, and the mean error of ``exp(-x)`` in units of 2^-24.
"""
import argparse
import json

import numpy as np
import torch

RANGES = ((1e-6, 1e-5), (3e-6, 8e-6), (1e-5, 1e-4), (1e-4, 1e-3))


def routes(xla):
    """name -> (x: f32 numpy -> (alpha, exp(-x)) as numpy)."""
    out = {}
    if xla:
        import jax
        import jax.numpy as jnp

        cpu = jax.devices("cpu")[0]
        exp = jax.jit(lambda x: jnp.exp(-x), device=cpu)
        alpha = jax.jit(lambda x: 1.0 - jnp.exp(-x), device=cpu)
        out["xla cpu (jax.jit)"] = lambda x: (np.asarray(alpha(x)), np.asarray(exp(x)))

    def torch_route(device):
        def run(x):
            t = torch.tensor(x, device=device)
            e = torch.exp(-t)
            return (1.0 - e).cpu().numpy(), e.cpu().numpy()
        return run

    out["torch cpu"] = torch_route("cpu")
    if torch.cuda.is_available():
        out["torch cuda (expf)"] = torch_route("cuda")
    out["torch cpu -expm1"] = lambda x: (
        (-torch.expm1(-torch.tensor(x))).numpy(), torch.exp(-torch.tensor(x)).numpy())
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--xla", action="store_true", help="add XLA's exp on the CPU (needs JAX)")
    args = ap.parse_args()
    rng = np.random.default_rng(args.seed)
    for lo, hi in RANGES:
        x = rng.uniform(lo, hi, args.n).astype(np.float32)
        x64 = x.astype(np.float64)
        exact = -np.expm1(-x64)
        for name, fn in routes(args.xla).items():
            alpha, e = fn(x)
            rel = alpha.astype(np.float64) / exact - 1.0
            ulps = (e.astype(np.float64) - np.exp(-x64)) / 2.0**-24
            print(json.dumps({
                "x": [lo, hi], "route": name, "alpha_mean_rel_err": float(rel.mean()),
                "alpha_rms_rel_err": float(np.sqrt((rel * rel).mean())),
                "exp_mean_err_ulps_2^-24": float(ulps.mean()),
            }), flush=True)


if __name__ == "__main__":
    main()
