"""Is a field's output a function of the point alone, or also of the batch
it is evaluated in?  On the card:

    python3 scripts/diag_field_batch.py [--min-rows 0 65536]

trains the bench CP field as ``chip_smoke.py``'s phase 4 does, evaluates it
once on 2^20 random points in the box with random directions, then again on
the first M of them for M from 1 to 2^19, and prints, for each M, how many
rows differ from the big batch's (density or colour, bit for bit) and the
largest relative density difference.  It does so for each value of
``models/ngp.py::_GEMM_MIN_ROWS`` given (0 pads nothing), and prints one
JSON line a value.  With ``--frames N`` it also renders the four test
views through the eval renderer (``render_view``) N times with each value,
in turns, and prints the seconds a frame.
"""
import argparse
import json
import os
import statistics
import sys
import time

import torch

sys.argv, argv = ["chip_smoke.py"], sys.argv[1:]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from nerfacc_tpu_torch.models import ngp  # noqa: E402

SIZES = (1, 2, 3, 7, 17, 100, 256, 1000, 4096, 8192, 10000, 16384, 40000, 65536, 100000,
         300000, 1 << 19)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--min-rows", nargs="+", type=int, default=[0, ngp._GEMM_MIN_ROWS])
    ap.add_argument("--frames", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("diag_field_batch: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card()}, torch {torch.__version__}", flush=True)
    trainer, state, _, _ = cs.phase_train(dev)
    ds = cs.ProceduralSceneLoader(split="test", device=dev)
    field_fn = trainer._field_fn(state, ds[0])
    g = torch.Generator(device=dev).manual_seed(0)
    n = 1 << 20
    x = torch.rand((n, 3), generator=g, device=dev) * 2.4 - 1.2
    d = torch.nn.functional.normalize(torch.randn((n, 3), generator=g, device=dev), dim=-1)
    default = ngp._GEMM_MIN_ROWS
    with torch.inference_mode():
        for min_rows in args.min_rows:
            ngp._GEMM_MIN_ROWS = min_rows
            rgb_ref, sig_ref = field_fn(x, d)
            rows = {}
            for m in SIZES:
                rgb, sig = field_fn(x[:m].clone(), d[:m].clone())
                unequal = (sig != sig_ref[:m]) | (rgb != rgb_ref[:m]).any(-1)
                rel = ((sig - sig_ref[:m]).abs() / sig_ref[:m].abs().clamp_min(1e-6)).max()
                rows[m] = (int(unequal.sum()), float(rel))
                print(f"min rows {min_rows}: M = {m}: {rows[m][0]} of {m} rows unequal to "
                      f"the 2^20-row batch's, largest relative density difference "
                      f"{rows[m][1]:.3g}", flush=True)
            print(json.dumps({"min_rows": min_rows, "card": cs.card(),
                              "unequal_rows": {str(m): r[0] for m, r in rows.items()},
                              "max_rel_density": {str(m): r[1] for m, r in rows.items()}}))
        seconds = {m: [] for m in args.min_rows}
        for _ in range(args.frames):
            for min_rows in args.min_rows:
                ngp._GEMM_MIN_ROWS = min_rows
                for i in range(len(ds)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    trainer.render_view(state, ds[i])
                    torch.cuda.synchronize()
                    seconds[min_rows].append(time.perf_counter() - t0)
        for min_rows, s in seconds.items():
            if s:
                print(f"min rows {min_rows}: render_view {statistics.median(s):.4f} s/frame "
                      f"(median of {len(s)}, {min(s):.4f}-{max(s):.4f}; {cs.card()})")
    ngp._GEMM_MIN_ROWS = default


if __name__ == "__main__":
    main()
