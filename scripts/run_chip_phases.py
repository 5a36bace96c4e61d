"""Runs some of chip_smoke.py's phases alone on the card:

    python3 scripts/run_chip_phases.py [25] [26] [6b] [27]

25: the occupancy example's tensorf, voxel and cp-planes fields; 26: the
BARF example; 6b: five times, the CP field trained as phase 4 trains it,
then its test views through the early-stop and the exact renderers (the
sample-set classification and its worst rays); 27: the quick start's loop
(phase 19), then the same loop through ``VDBEstimator``.  Each phase is
caught and reported, so that the others still run.  No argument runs
25, 26 and 6b.
"""
import os
import sys
import time
import traceback

import torch

which = sys.argv[1:] or ["25", "26", "6b"]
sys.argv = ["chip_smoke.py"]
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

dev = torch.device("cuda", 0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print("card:", cs.card(), flush=True)
t0 = time.perf_counter()
cs.cuda.load()
print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)


def run(name, fn):
    t = time.perf_counter()
    try:
        fn()
        print(f"PHASE {name} ok in {time.perf_counter() - t:.1f} s", flush=True)
    except Exception:
        traceback.print_exc()
        print(f"PHASE {name} FAILED after {time.perf_counter() - t:.1f} s", flush=True)


for path in cs.OCC_FIELD_PATHS if "25" in which else ():
    run(f"25 {path}", lambda: cs.phase_occ_field(dev, path))
if "26" in which:
    run("26", lambda: cs.phase_barf(dev))
ds = cs.ProceduralSceneLoader(split="test", device=dev)
if "27" in which:
    def twenty_seven():
        _, loop_ms = cs.phase_quickstart(dev, ds)
        cs.phase_quickstart_vdb(dev, ds, loop_ms)
    run("19 + 27", twenty_seven)
for i in range(5 if "6b" in which else 0):
    def six_b():
        trainer, state, _, _ = cs.phase_train(dev)
        cs.phase_trained_frames(trainer, state, ds)
    run(f"6b run {i}", six_b)
print(f"total {time.perf_counter() - t0:.1f} s")
