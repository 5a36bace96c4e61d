"""Estimator base class.

PyTorch counterpart of nerfacc_tpu/estimators/base.py, as the reference's
``nn.Module``: ``train()``, ``eval()``, ``state_dict()`` and
``load_state_dict()`` are PyTorch's own, and an estimator's grids ride along
as buffers.
"""
from __future__ import annotations

from typing import Any

import torch.nn as nn


class AbstractEstimator(nn.Module):
    """Base class of the transmittance estimators: ``sampling()`` and
    ``update_every_n_steps()``."""

    def sampling(self, *args, **kwargs) -> Any:
        raise NotImplementedError

    def update_every_n_steps(self, *args, **kwargs) -> Any:
        raise NotImplementedError
