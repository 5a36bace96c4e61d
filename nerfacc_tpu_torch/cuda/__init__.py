"""Hand-written CUDA kernels: lazy build, launch helpers and launch counts.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched it on the
card (the plain PyTorch twins never count).  A run shows that its path went
through the kernels by zeroing the counts with :func:`reset_launches` before
it and reading them after it.
"""
from __future__ import annotations

import torch

from ._build import check, load

LAUNCHES = {
    "cp_level_fwd": 0, "cp_level_bwd": 0, "march": 0, "composite_fwd": 0,
    "composite_bwd": 0, "hash_fwd": 0, "hash_bwd": 0, "hat_fwd": 0,
    "hat_bwd_line": 0, "hat_bwd_x": 0, "coarse_occ": 0, "lane_gather": 0,
    "row_gather": 0, "importance_sampling": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_card(*tensors: torch.Tensor) -> bool:
    """True if the tensors lie on a CUDA device, False if on the CPU.

    A wrapper runs its kernel for the first and its plain twin for the
    second; any other device, or a mix, raises.
    """
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        devices = {t.device for t in tensors}
        if len(devices) != 1:
            raise ValueError(f"tensors on several cards: {sorted(map(str, devices))}")
        return True
    raise ValueError(f"no kernel or twin for devices {sorted(kinds)}")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s card, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int:
    """Device pointer of a contiguous tensor, or 0 (null) for ``None``."""
    if t is None:
        return 0
    if not t.is_contiguous():
        raise ValueError("kernel arguments must be contiguous")
    return t.data_ptr()


__all__ = [
    "LAUNCHES", "check", "load", "on_card", "ptr", "reset_launches", "stream_ptr",
]
