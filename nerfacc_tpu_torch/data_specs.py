"""Ray interval and sample specs, batched layout only.

PyTorch counterpart of the batched half of nerfacc_tpu/data_specs.py: the
proposal path keeps every ray's edges in one row of an ``(n_rays, n_edges)``
tensor.  The flattened ``packed_info`` layout and the validity masks of the
varying-count sampler are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class RayIntervals(NamedTuple):
    """Interval edges per ray, ``vals`` (n_rays, n_edges), nondecreasing."""

    vals: torch.Tensor


class RaySamples(NamedTuple):
    """Sample positions per ray, ``vals`` (n_rays, n_samples)."""

    vals: torch.Tensor
