"""Build and load the hand-written CUDA kernels.

Every ``nerfacc_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, which is
loaded with :mod:`ctypes`.  The build runs at the first kernel launch of the
process, never at import, and lands in ``build/nerfacc_tpu_torch/`` at the
root of the checkout, keyed by a hash of the sources and flags so that an
edited source is rebuilt.  Each C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; :func:`check` turns a nonzero code
into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "nerfacc_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # (u, lines, out, n, R, rank, bf16, stream)
    "cp_level_fwd": [_P, _P, _P, ctypes.c_int64, _I, _I, _I, _P],
    # (u, g, lines, dlines, n, R, rank, bf16, stream)
    "cp_level_bwd": [_P] * 4 + [ctypes.c_int64, _I, _I, _I, _P],
    # (rays_o, rays_d, near, far, mask, binaries, aabbs, n_rays, m, rx, ry,
    #  rz, step, cone, tau, base, counts, term, stream)
    "march_count": [_P] * 7 + [_I] * 5 + [_F] * 4 + [_P, _P, _P],
    # (... as march_count ..., offsets, ray_ids, t_starts, t_ends, stream)
    "march_fill": [_P] * 7 + [_I] * 5 + [_F] * 4 + [_P] * 5,
    # (t_starts, t_ends, sigmas, rgbs, seg_starts, seg_ends, prefix_trans,
    #  n_rays, colors, opacities, depths, weights, stream)
    "composite_fwd": [_P] * 7 + [_I] + [_P] * 5,
    # (t_starts, t_ends, sigmas, rgbs, seg_starts, seg_ends, prefix_trans,
    #  n_rays, g_colors, g_opacities, g_depths, d_sigmas, d_rgbs, scratch,
    #  stream)
    "composite_bwd": [_P] * 7 + [_I] + [_P] * 7,
}

_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None  # wall time of this process's build
build_log: str = ""  # nvcc's output (register and shared-memory use)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SRC_DIR.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libnerfacc_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the current sources have no library yet."""
    global build_seconds, build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    srcs = [str(p) for p in sorted(SRC_DIR.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{build_log}"
        )
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.nerfacc_error_string.argtypes = [ctypes.c_int]
        lib.nerfacc_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = load().nerfacc_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
