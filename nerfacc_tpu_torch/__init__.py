"""nerfacc_tpu_torch: nerfacc_tpu's library API (estimators, scans,
volume rendering, losses), its occupancy-grid and proposal-network render and
train paths, and its CP, hash-grid (Instant-NGP) and TiNeuVox (dynamic)
radiance fields, the MLP fields (vanilla NeRF, and T-NeRF and NDRT for
dynamic scenes), the K-Planes space-time field, the CP field's tri-plane
levels with TensoRF, and the dense voxel field, with the CP and hash-grid
proposal fields, BARF's pose refinement and its trainer, the padded
traversals, lens undistortion and the dataset loaders, ported to PyTorch and
hand-written CUDA kernels for NVIDIA Hopper.

The functional ops take the JAX package's three layouts: batched rows, and
flattened buffers with ``packed_info`` or ``ray_indices`` (sorted or in
runs).  Importing the package builds nothing and needs no GPU: the kernels
compile at their first launch (see :mod:`nerfacc_tpu_torch.cuda`).  Every
kernel wrapper runs its kernel for CUDA tensors and its plain PyTorch twin
for CPU tensors.  Entry points put their state on the card unless given
``device="cpu"``.
"""
from . import cuda
from .cameras import (
    opencv_lens_undistortion,
    opencv_lens_undistortion_12,
    opencv_lens_undistortion_fisheye,
)
from .data.device_sampler import DeviceRaySampler
from .data_specs import RayIntervals, RaySamples
from .estimators.base import AbstractEstimator
from .estimators.occ_grid import (
    OccGridEstimator,
    OccGridState,
    init_occ_grid,
    sampling,
    update_occ_grid,
)
from .estimators.prop_net import (
    PropNetEstimator,
    get_proposal_requires_grad_fn,
    propnet_loss,
    propnet_sampling,
)
from .grid import (
    TraversalResult,
    march,
    march_plain,
    ray_aabb_intersect,
    traverse_grids,
    traverse_grids_padded,
    traverse_grids_voxel,
)
from .losses import distortion
from .models.cp_field import (
    CPDensityField,
    CPGridEncoder,
    CPRadianceField,
    TensoRFRadianceField,
)
from .models.encoders import HashGridEncoder, SinusoidalEncoder
from .models.kplanes import KPlanesEncoder, KPlanesRadianceField
from .models.mlp import (
    NDRTNeRFRadianceField,
    TNeRFRadianceField,
    VanillaNeRFRadianceField,
)
from .models.ngp import NGPDensityField, NGPRadianceField
from .models.pose import (
    coarse_to_fine_alpha,
    compose_pose,
    perturb_poses,
    pose_registration_errors,
    se3_exp,
    umeyama_alignment,
)
from .models.tineuvox import TiNeuVoxRadianceField
from .models.voxel_field import VoxelGridEncoder, VoxelRadianceField
from .pack import pack_info
from .pdf import importance_sampling, searchsorted
from .scan import exclusive_prod, exclusive_sum, inclusive_prod, inclusive_sum
from .trainers.barf import BARFTrainer, BARFTrainState
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
from .volrend import (
    accumulate_along_rays,
    accumulate_along_rays_,
    render_transmittance_from_alpha,
    render_transmittance_from_density,
    render_visibility_from_alpha,
    render_visibility_from_density,
    render_weight_from_alpha,
    render_weight_from_density,
    rendering,
)

__version__ = "0.1.0"

__all__ = [
    "AbstractEstimator", "BARFTrainState", "BARFTrainer", "CPDensityField", "CPGridEncoder", "CPRadianceField",
    "CompactSamples", "DeviceRaySampler", "HashGridEncoder", "KPlanesEncoder",
    "KPlanesRadianceField", "NDRTNeRFRadianceField", "NGPOccTrainer",
    "NGPDensityField", "NGPPropTrainer", "NGPRadianceField", "OccGridEstimator", "OccGridState",
    "PropNetEstimator", "PropTrainState", "RayIntervals", "RaySamples",
    "SinusoidalEncoder", "TNeRFRadianceField", "TensoRFRadianceField",
    "TiNeuVoxRadianceField", "TrainState", "TraversalResult", "VanillaNeRFRadianceField",
    "VoxelGridEncoder", "VoxelRadianceField", "coarse_to_fine_alpha", "compose_pose",
    "perturb_poses", "pose_registration_errors", "se3_exp", "umeyama_alignment",
    "__version__",
    "accumulate_along_rays", "accumulate_along_rays_", "compact_samples", "cuda",
    "distortion", "exclusive_prod", "exclusive_sum", "get_proposal_requires_grad_fn",
    "importance_sampling", "inclusive_prod", "inclusive_sum", "init_occ_grid",
    "load_checkpoint", "march", "march_plain", "opencv_lens_undistortion",
    "opencv_lens_undistortion_12", "opencv_lens_undistortion_fisheye", "pack_info",
    "propnet_loss",
    "propnet_sampling", "ray_aabb_intersect", "render_image_with_occgrid",
    "render_rays_occgrid_test", "render_rays_with_occgrid",
    "render_transmittance_from_alpha", "render_transmittance_from_density",
    "render_visibility_from_alpha", "render_visibility_from_density",
    "render_weight_from_alpha", "render_weight_from_density", "rendering",
    "sampling", "save_checkpoint", "searchsorted", "traverse_grids",
    "traverse_grids_padded", "traverse_grids_voxel", "update_occ_grid",
]
