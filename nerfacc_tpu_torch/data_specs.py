"""Ray interval and sample specs, in the flattened and the batched layout.

PyTorch counterpart of nerfacc_tpu/data_specs.py:
* **flattened**: ``vals`` is (all_samples,), with ``packed_info`` (n_rays, 2)
  ``[chunk_start, chunk_cnt]`` and/or ``ray_indices`` (all_samples,);
* **batched**: ``vals`` is (n_rays, n_samples) and the other fields are None.
``is_valid`` marks the samples of a varying-count sampler, ``is_left`` /
``is_right`` the edges that open / close an interval.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RaySamples(NamedTuple):
    """Samples along rays.

    Attributes:
        vals: (all_samples,) or (n_rays, n_samples).
        packed_info: optional (n_rays, 2) int32 [start, cnt] per ray chunk.
        ray_indices: optional (all_samples,) ray id per sample.
        is_valid: optional bool mask, the shape of ``vals``.
    """

    vals: torch.Tensor
    packed_info: Optional[torch.Tensor] = None
    ray_indices: Optional[torch.Tensor] = None
    is_valid: Optional[torch.Tensor] = None


class RayIntervals(NamedTuple):
    """Interval edges along rays, nondecreasing within a ray.

    Attributes:
        vals: (all_edges,) or (n_rays, n_edges).
        packed_info: optional (n_rays, 2) int32 [start, cnt] per ray chunk.
        ray_indices: optional (all_edges,) ray id per edge.
        is_left: optional bool mask: the edge opens an interval.
        is_right: optional bool mask: the edge closes an interval.
    """

    vals: torch.Tensor
    packed_info: Optional[torch.Tensor] = None
    ray_indices: Optional[torch.Tensor] = None
    is_left: Optional[torch.Tensor] = None
    is_right: Optional[torch.Tensor] = None
