"""Runs some of chip_smoke.py's phases alone on the card:

    python3 scripts/run_chip_phases.py [25] [26] [6b] [27] [28] [29] [30] [31]

25: the occupancy example's tensorf, voxel and cp-planes fields; 26: the
BARF example; 6b: five times, the CP field trained as phase 4 trains it,
then its test views through the early-stop and the exact renderers (the
sample-set classification and its worst rays); 27: the quick start's loop
(phase 19), then the same loop through ``VDBEstimator``, on the
translucent and the hard-surface scene; 28: the distributed layer (its five
sub-phases); 29: the CP field trained as phase 4 trains it, then the
windowed and pooled entry points on it; 30: the CP field trained as phase
4 trains it, then the public options on it (phase 30's six paths); 31:
each train path trained twice from one seed, bit for bit.  Each
phase is caught and reported, so that the others still run, and the exit
code is 1 if one failed.  No argument runs 25, 26 and 6b.
"""
import os
import sys
import time
import traceback

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def run(name, fn, failed):
    t = time.perf_counter()
    try:
        fn()
        print(f"PHASE {name} ok in {time.perf_counter() - t:.1f} s", flush=True)
    except Exception:
        traceback.print_exc()
        failed.append(name)
        print(f"PHASE {name} FAILED after {time.perf_counter() - t:.1f} s", flush=True)


def main():
    which = sys.argv[1:] or ["25", "26", "6b"]
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("card:", cs.card(), flush=True)
    t0 = time.perf_counter()
    cs.cuda.load()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    failed = []

    def twenty_eight():
        total = cs.phase_distributed(dev)
        print("launches over phase 28's ranks:", total, flush=True)

    if "28" in which:
        run("28", twenty_eight, failed)
    for path in cs.OCC_FIELD_PATHS if "25" in which else ():
        run(f"25 {path}", lambda: cs.phase_occ_field(dev, path), failed)
    if "26" in which:
        run("26", lambda: cs.phase_barf(dev), failed)
    ds = cs.ProceduralSceneLoader(split="test", device=dev)
    if "27" in which:
        def twenty_seven():
            _, loop_ms = cs.phase_quickstart(dev, ds)
            cs.phase_quickstart_vdb(dev, ds, loop_ms)
        run("19 + 27", twenty_seven, failed)
    if "29" in which:
        def twenty_nine():
            trainer, state, batch, _ = cs.phase_train(dev)
            print("launches of phase 29:", cs.phase_pooled_entry_points(dev, trainer, state, batch),
                  flush=True)
        run("29", twenty_nine, failed)
    if "30" in which:
        def thirty():
            trainer, state, batch, _ = cs.phase_train(dev)
            print("launches of phase 30:", cs.phase_options(dev, trainer, state, batch, ds),
                  flush=True)
        run("30", thirty, failed)
    if "31" in which:
        run("31", lambda: print("launches of phase 31:", cs.phase_repeat(dev), flush=True),
            failed)
    for i in range(5 if "6b" in which else 0):
        def six_b():
            trainer, state, _, _ = cs.phase_train(dev)
            cs.phase_trained_frames(trainer, state, ds)
        run(f"6b run {i}", six_b, failed)
    print(f"total {time.perf_counter() - t0:.1f} s")
    sys.exit(1 if failed else 0)


# the ranks of phase 28 import this file again (the spawn start method)
if __name__ == "__main__":
    main()
