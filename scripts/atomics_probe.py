#!/usr/bin/env python3
"""Build and run scripts/probes/atomics_probe.cu on one GPU: the rates of
the reductions G7 (csrc/hash_encode.cu) can build on.

    python3 scripts/atomics_probe.py [--out build/atomics_probe]

Prints the card's name and power limit, then one line a probe (G int64 adds
or G operations a second): a block's own shared memory (a 64-bit
atomicAdd, two 32-bit adds with the carry), another block's across a
cluster of 2-16 (distributed shared memory), and global memory at 8, 32 and
128 MiB tables (64-bit reds, float4 atomics, 32-byte TMA bulk reductions),
the bulk reduction's record size at one block of 8 warps an SM, and a bulk
reduction mixed with four 64-bit reds.  The binary goes to ``--out``.
"""
import argparse
import os
import subprocess

from torch.utils.cpp_extension import CUDA_HOME

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="build/atomics_probe")
    args = ap.parse_args()
    if CUDA_HOME is None:
        raise SystemExit("atomics_probe: no CUDA toolkit found")
    os.makedirs(args.out, exist_ok=True)
    exe = os.path.join(args.out, "atomics_probe")
    subprocess.run([os.path.join(CUDA_HOME, "bin", "nvcc"), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-o", exe,
                    os.path.join(HERE, "probes", "atomics_probe.cu")], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    subprocess.run([exe], check=True, timeout=600)


if __name__ == "__main__":
    main()
