"""Rendering loops, metrics and the parameter bridge to the JAX package."""
from __future__ import annotations

import os
from pathlib import Path
from typing import Union


def setup_compilation_cache(path: Union[None, str, os.PathLike] = None) -> None:
    """Set the directory the hand-written kernels build into (JAX's
    persistent compilation cache, here the library that ``nvcc`` writes,
    keyed by a hash of the sources: a later process with the same sources
    loads it without building).  None: ``build/nerfacc_tpu_torch`` at the
    root of the checkout.  It moves the directory and does nothing more: a
    process that has loaded the kernels keeps them."""
    from ..cuda import _build

    _build.BUILD_DIR = _build.DEFAULT_BUILD_DIR if path is None else Path(path)


__all__ = ["setup_compilation_cache"]
