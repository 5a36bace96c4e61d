"""nerfacc_tpu_torch: the occupancy-grid and proposal-network render and
train paths of nerfacc_tpu, with its CP, hash-grid (Instant-NGP) and
TiNeuVox (dynamic) radiance fields and the CP proposal field, ported to
PyTorch and hand-written CUDA kernels for NVIDIA Hopper.

Importing the package builds nothing and needs no GPU: the kernels compile
at their first launch (see :mod:`nerfacc_tpu_torch.cuda`).  Every kernel
wrapper runs its kernel for CUDA tensors and its plain PyTorch twin for CPU
tensors.  Entry points put their state on the card unless given
``device="cpu"``.
"""
from . import cuda
from .data.device_sampler import DeviceRaySampler
from .data_specs import RayIntervals, RaySamples
from .estimators.occ_grid import OccGridState, init_occ_grid, sampling, update_occ_grid
from .estimators.prop_net import (
    get_proposal_requires_grad_fn,
    propnet_loss,
    propnet_sampling,
)
from .grid import march, march_plain, ray_aabb_intersect, traverse_grids_padded
from .models.cp_field import CPDensityField, CPGridEncoder, CPRadianceField
from .models.encoders import HashGridEncoder, SinusoidalEncoder
from .models.ngp import NGPRadianceField
from .models.tineuvox import TiNeuVoxRadianceField
from .pdf import importance_sampling, searchsorted
from .trainers.ngp_occ import NGPOccTrainer, TrainState
from .trainers.ngp_prop import NGPPropTrainer, PropTrainState
from .utils.checkpoint import load_checkpoint, save_checkpoint
from .utils.rendering import (
    CompactSamples,
    compact_samples,
    render_image_with_occgrid,
    render_rays_occgrid_test,
    render_rays_with_occgrid,
)

__all__ = [
    "CPDensityField", "CPGridEncoder", "CPRadianceField", "CompactSamples",
    "DeviceRaySampler", "HashGridEncoder", "NGPOccTrainer", "NGPPropTrainer",
    "NGPRadianceField", "OccGridState", "PropTrainState", "RayIntervals",
    "RaySamples", "SinusoidalEncoder", "TiNeuVoxRadianceField", "TrainState",
    "compact_samples", "cuda", "get_proposal_requires_grad_fn",
    "importance_sampling", "init_occ_grid", "load_checkpoint", "march",
    "march_plain", "propnet_loss", "propnet_sampling", "ray_aabb_intersect",
    "render_image_with_occgrid", "render_rays_occgrid_test",
    "render_rays_with_occgrid", "sampling", "save_checkpoint", "searchsorted",
    "traverse_grids_padded", "update_occ_grid",
]
