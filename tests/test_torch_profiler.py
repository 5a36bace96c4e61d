"""The port's profiling helpers on the CPU: ``benchmark`` times a callable
and returns the JAX package's two keys; ``trace`` writes a Chrome trace of
the block it wraps."""
import json

import pytest
import torch

from nerfacc_tpu_torch.utils import profiler
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)


@pytest.mark.parametrize("out", ["tensor", "nested", "none"])
def test_benchmark_returns_its_two_keys(out):
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        y = x * scale
        return {"tensor": y, "nested": ({"y": [y]},), "none": None}[out]

    got = profiler.benchmark(fn, torch.ones(8), iters=5, warmup=3, scale=2.0)
    assert set(got) == {"mean_ms", "total_s"} and len(calls) == 8
    assert got["total_s"] > 0 and got["mean_ms"] == pytest.approx(got["total_s"] / 5 * 1e3)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiler.trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert log_dir == str(tmp_path / "trace") and len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
