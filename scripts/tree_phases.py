#!/usr/bin/env python3
"""Two of chip_smoke.py's phases against one tree of the PyTorch port, on
one GPU, so that two trees are compared in one call.

    python3 scripts/tree_phases.py [--root DIR] digest [PATH ...]
    python3 scripts/tree_phases.py [--root DIR] train [KIND]

``digest``: each named path of phase 31 (``ngp`` by default; ``cp``,
``tineuvox``, ``bench_prop``, ``tensorf``, ``voxel``, ``kplanes``,
``barf``, ``quick start``) is trained once from its seed, and the SHA-256
of its final parameters, Adam moments, occupancy grid and losses is printed
as phase 31 prints it, one JSON line a path.  ``train``: phase 8's training
run (phase 4's with ``cp``, 12's with ``tineuvox``; ``ngp`` by default),
with its ``train <kind>: ... ms/step`` line.

The code of the phases is this checkout's ``chip_smoke.py``; the tree whose
``nerfacc_tpu_torch`` it drives is ``--root`` (default: this checkout).
Compare a parent unpacked by ``git archive`` into a git-ignored directory
with this tree in one call, in turns:

    python3 scripts/tree_phases.py --root build/parent digest ngp
    python3 scripts/tree_phases.py digest ngp
"""
import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke(root):
    """This checkout's chip_smoke.py, bound to ``root``'s package."""
    sys.path.insert(0, root)
    import nerfacc_tpu_torch  # the tree's, before chip_smoke puts this checkout first

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)
    package = os.path.dirname(nerfacc_tpu_torch.__file__)
    if not package.startswith(root):
        raise SystemExit(f"tree_phases: imported {package}, not the tree {root}")
    return cs, package


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("what", choices=["digest", "train"])
    ap.add_argument("names", nargs="*")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tree_phases: torch.cuda.is_available() is false")
    cs, package = load_chip_smoke(os.path.abspath(args.root))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(json.dumps({"package": package, "card": cs.card()}), flush=True)
    if args.what == "train":
        cs.phase_train(dev, *(args.names or ["ngp"])[:1])
        return
    left = set(args.names or ["ngp"])
    for name, run, _ in cs.repeat_paths(dev):
        if name not in left:
            continue
        state, losses = run()
        leaves = {k: v.detach().clone() for k, v in cs.state_leaves(state)}
        print(json.dumps({"package": package, "path": name, "steps": int(losses.shape[0]),
                          "sha256": cs.repeat_digest(leaves, losses)}), flush=True)
        left.discard(name)
        if not left:
            break
    if left:
        raise SystemExit(f"tree_phases: no phase-31 path named {sorted(left)}")


if __name__ == "__main__":
    main()
