"""Radiance fields, their encoders and the camera-pose tools (the JAX
package's ``nerfacc_tpu.models`` exports)."""
from .cp_field import CPDensityField, CPGridEncoder, CPRadianceField, TensoRFRadianceField
from .encoders import HashGridEncoder, SinusoidalEncoder, spherical_harmonics_16
from .kplanes import KPlanesEncoder, KPlanesRadianceField
from .mlp import NDRTNeRFRadianceField, TNeRFRadianceField, VanillaNeRFRadianceField
from .ngp import NGPDensityField, NGPRadianceField, contract_to_unisphere, trunc_exp
from .pose import (
    coarse_to_fine_alpha,
    compose_pose,
    perturb_poses,
    pose_registration_errors,
    se3_exp,
    umeyama_alignment,
)
from .tineuvox import TiNeuVoxRadianceField
from .voxel_field import VoxelGridEncoder, VoxelRadianceField

__all__ = [
    "CPDensityField", "CPGridEncoder", "CPRadianceField", "TensoRFRadianceField",
    "KPlanesEncoder", "KPlanesRadianceField", "TiNeuVoxRadianceField",
    "VoxelGridEncoder", "VoxelRadianceField", "coarse_to_fine_alpha", "compose_pose",
    "perturb_poses", "pose_registration_errors", "se3_exp", "umeyama_alignment",
    "HashGridEncoder", "SinusoidalEncoder", "spherical_harmonics_16",
    "VanillaNeRFRadianceField", "TNeRFRadianceField", "NDRTNeRFRadianceField",
    "NGPDensityField", "NGPRadianceField", "contract_to_unisphere", "trunc_exp",
]
