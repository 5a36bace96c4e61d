"""The estimators: occupancy grid, proposal network and sparse grid."""
from .base import AbstractEstimator
from .occ_grid import OccGridEstimator, OccGridState
from .prop_net import PropNetEstimator, get_proposal_requires_grad_fn
from .sparse_grid import (
    N3TreeEstimator,
    SparseGrid,
    SparseGridEstimator,
    VDBEstimator,
    sparse_grid_from_dense,
    sparse_grid_from_ijk,
    traverse_vdbs,
)

__all__ = [
    "AbstractEstimator",
    "N3TreeEstimator",
    "OccGridEstimator",
    "OccGridState",
    "PropNetEstimator",
    "SparseGrid",
    "SparseGridEstimator",
    "VDBEstimator",
    "get_proposal_requires_grad_fn",
    "sparse_grid_from_dense",
    "sparse_grid_from_ijk",
    "traverse_vdbs",
]
