"""Profiling helpers.

PyTorch counterpart of nerfacc_tpu/utils/profiler.py (reference:
scripts/run_profiler.py wraps ``torch.profiler``): a ``torch.profiler``
trace context that writes a Chrome trace, and a timing harness that waits
on the card only at the measurement's two ends, so that the launches in
between queue as they do in a training loop.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[str]:
    """Profile a code block with ``torch.profiler`` (CPU activity, and CUDA
    activity where a card is present) and write a Chrome trace
    (``trace_<ns>.json``) into ``log_dir`` (default: ``nerfacc_tpu_torch_trace``
    in the temporary directory); view it in ``chrome://tracing`` or
    Perfetto.  Yields ``log_dir``."""
    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "nerfacc_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{time.time_ns()}.json"))


def _on_card(out: Any) -> bool:
    """True if any tensor in ``out`` (nested in tuples, lists or dicts)
    lies on a CUDA device."""
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_card(v) for v in out.values())
    if isinstance(out, (tuple, list)):
        return any(_on_card(v) for v in out)
    return False


def _wait(out: Any) -> None:
    if _on_card(out):
        torch.cuda.synchronize()


def benchmark(
    fn: Callable,
    *args,
    iters: int = 10,
    warmup: int = 2,
    **kwargs,
) -> Dict[str, float]:
    """Wall-clock ``fn(*args, **kwargs)``: ``warmup`` calls, then ``iters``
    timed calls.  Where the output lies on the card, ``torch.cuda.
    synchronize()`` runs after the warmup and after the last timed call,
    and nowhere between.

    Returns:
        ``{"mean_ms": ..., "total_s": ...}`` over the timed calls.
    """
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _wait(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kwargs)
    _wait(out)
    total = time.perf_counter() - t0
    return {"mean_ms": total / iters * 1000.0, "total_s": total}
