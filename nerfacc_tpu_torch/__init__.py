"""nerfacc_tpu_torch: the occupancy-grid render and train paths of
nerfacc_tpu, with its CP, hash-grid (Instant-NGP) and TiNeuVox (dynamic)
radiance fields, ported to PyTorch and hand-written CUDA kernels for NVIDIA
Hopper.

Importing the package builds nothing and needs no GPU: the kernels compile
at their first launch (see :mod:`nerfacc_tpu_torch.cuda`).  Every kernel
wrapper runs its kernel for CUDA tensors and its plain PyTorch twin for CPU
tensors.  Entry points put their state on the card unless given
``device="cpu"``.
"""
from . import cuda
from .estimators.occ_grid import OccGridState, init_occ_grid, sampling, update_occ_grid
from .grid import march, march_plain, ray_aabb_intersect, traverse_grids_padded
from .models.cp_field import CPGridEncoder, CPRadianceField
from .models.encoders import HashGridEncoder, SinusoidalEncoder
from .models.ngp import NGPRadianceField
from .models.tineuvox import TiNeuVoxRadianceField
from .trainers.ngp_occ import NGPOccTrainer, TrainState
from .utils.rendering import (
    CompactSamples,
    compact_samples,
    render_image_with_occgrid,
    render_rays_with_occgrid,
)

__all__ = [
    "CPGridEncoder", "CPRadianceField", "CompactSamples", "HashGridEncoder",
    "NGPOccTrainer", "NGPRadianceField", "SinusoidalEncoder",
    "TiNeuVoxRadianceField", "OccGridState", "TrainState", "compact_samples", "cuda", "init_occ_grid",
    "march", "march_plain", "ray_aabb_intersect", "render_image_with_occgrid",
    "render_rays_with_occgrid", "sampling", "traverse_grids_padded",
    "update_occ_grid",
]
