"""Build and load the hand-written CUDA kernels.

Every ``nerfacc_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` per source, all started together, and the objects
are linked into one shared library with a plain C interface, which is
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
DEFAULT_BUILD_DIR = _PKG.parent / "build" / "nerfacc_tpu_torch"
BUILD_DIR = DEFAULT_BUILD_DIR  # utils.setup_compilation_cache moves it
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # (u, lines, out, n, R, rank, bf16, stream)
    "cp_level_fwd": [_P, _P, _P, ctypes.c_int64, _I, _I, _I, _P],
    # (u, g, lines, dlines, work, n, R, rank, bf16, stream)
    "cp_level_bwd": [_P] * 5 + [ctypes.c_int64, _I, _I, _I, _P],
    # (rays_o, rays_d, near, far, mask, binaries, aabbs, n_rays, m, rx, ry,
    #  rz, step, cone, tau, base, max_samples, counts, term, terminated,
    #  stream)
    "march_count": [_P] * 7 + [_I] * 5 + [_F] * 4 + [_I] + [_P] * 4,
    # (... as march_count up to max_samples ..., offsets, ray_ids, t_starts,
    #  t_ends, stream)
    "march_fill": [_P] * 7 + [_I] * 5 + [_F] * 4 + [_I] + [_P] * 5,
    # (t_starts, t_ends, sigmas, rgbs, seg_starts, seg_ends, prefix_trans,
    #  n_rays, colors, opacities, depths, weights, stream)
    "composite_fwd": [_P] * 7 + [_I] + [_P] * 5,
    # (t_starts, t_ends, sigmas, rgbs, seg_starts, seg_ends, prefix_trans,
    #  n_rays, g_colors, g_opacities, g_depths, d_sigmas, d_rgbs, scratch,
    #  stream)
    "composite_bwd": [_P] * 7 + [_I] + [_P] * 7,
    # (x, table, res, out, n, L, log2T, stream)
    "hash_fwd": [_P] * 4 + [ctypes.c_int64, _I, _I, _P],
    # (x, cot, res, g_table, work, work_words, n, L, log2T, item_samples, stream)
    "hash_bwd": [_P] * 5 + [ctypes.c_int64, ctypes.c_int64, _I, _I, _I, _P],
    # (x, line, out, n, R, rank, stream)
    "hat_fwd": [_P] * 3 + [ctypes.c_int64, _I, _I, _P],
    # (x, lines, prod, axes, n, R, rank, stream)
    "hat_level_fwd": [_P] * 4 + [ctypes.c_int64, _I, _I, _P],
    # (x, g, partials, dline, n, R, rank, max_blocks, stream)
    "hat_bwd_line": [_P] * 4 + [ctypes.c_int64, _I, _I, _I, _P],
    # (x, g, line, dx, n, R, rank, stream)
    "hat_bwd_x": [_P] * 4 + [ctypes.c_int64, _I, _I, _P],
    # (row, lane, summary, out, n, rows, lanes, stream)
    "coarse_occ_lookup": [_P] * 4 + [ctypes.c_int64, _I, _I, _P],
    # (src, idx, out, n_rows, T, elem_bytes, route, table_bytes, stream)
    "lane_gather": [_P] * 3 + [ctypes.c_int64, _I, _I, _I, _I, _P],
    # (tab, idx, out, n, T, F, vec, stream)
    "row_gather": [_P] * 3 + [ctypes.c_int64, _I, _I, _I, _P],
    # (vals, cdfs, bias, samples, edges, n_rays, E, n, stream)
    "importance_sampling": [_P] * 5 + [_I, _I, _I, _P],
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
    tag = f"{out.stem}.tmp{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((cmd, obj, proc))
    logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, _, proc in jobs]
    objs = [str(obj) for _, obj, _ in jobs]
    tmp = BUILD_DIR / f"{tag}.so"
    link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *objs]
    if all(rc == 0 for _, _, rc in logs):
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append((link, proc.stdout + proc.stderr, proc.returncode))
    build_seconds = time.perf_counter() - t0
    build_log = "".join(text for _, text, _ in logs)
    for path in objs:
        Path(path).unlink(missing_ok=True)
    for cmd, text, rc in logs:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{text}")
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
