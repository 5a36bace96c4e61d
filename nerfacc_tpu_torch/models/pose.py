"""Camera-pose refinement (BARF): the SE(3) exponential map, pose
composition, pose noise, the Sim3-aligned registration errors and the
coarse-to-fine schedule.

PyTorch counterpart of nerfacc_tpu/models/pose.py.  Every 3x3 product is
written out elementwise in f32, so that no TF32 matmul can round it: a
rounding of ~0.4% there puts a floor of ~0.2-1 degree under every pose it
touches (the JAX package asks for ``precision="highest"`` for the same
reason).  The registration helpers are numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def _hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric cross-product matrix of ``w (..., 3)`` -> (..., 3, 3)."""
    zeros = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([zeros, -w[..., 2], w[..., 1]], dim=-1),
            torch.stack([w[..., 2], zeros, -w[..., 0]], dim=-1),
            torch.stack([-w[..., 1], w[..., 0], zeros], dim=-1),
        ],
        dim=-2,
    )


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of (..., 3, 3) matrices, elementwise in their dtype."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def matvec3(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``a @ v`` of (..., 3, 3) matrices and (..., 3) vectors, elementwise."""
    return (a * v[..., None, :]).sum(-1)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(3) -> SE(3).

    Args:
        xi: (..., 6) twists ``[omega (axis-angle), rho (translation
            generator)]``.

    Returns:
        (..., 3, 4) rigid transforms ``[R | t]``, ``R = exp([omega]x)`` and
        ``t = V(omega) @ rho``.  Below ``theta^2 < 1e-8`` the coefficients
        take their Taylor forms; the exact forms divide by 1 there, so that
        the branch ``where`` leaves unselected sends no NaN into the
        gradient at the identity.  The sine and cosine are taken in f64 of
        the f32 angle and rounded once.
    """
    omega, rho = xi[..., :3], xi[..., 3:]
    theta2 = (omega * omega).sum(-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    sin = torch.sin(theta.double()).to(theta.dtype)
    cos = torch.cos(theta.double()).to(theta.dtype)
    a = torch.where(small, 1.0 - theta2 / 6.0, sin / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - sin) / (theta2_safe * theta))
    W = _hat(omega)
    W2 = matmul3(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    R = eye + a[..., None, None] * W + b[..., None, None] * W2
    V = eye + b[..., None, None] * W + c[..., None, None] * W2
    return torch.cat([R, matvec3(V, rho)[..., None]], dim=-1)


def compose_pose(delta: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """``delta @ pose`` in homogeneous coordinates, both (..., 3, 4):
    ``R' = Rd @ Rp``, ``t' = Rd @ tp + td``."""
    Rd, td = delta[..., :3], delta[..., 3]
    Rp, tp = pose[..., :3], pose[..., 3]
    return torch.cat([matmul3(Rd, Rp), (matvec3(Rd, tp) + td)[..., None]], dim=-1)


def perturb_poses(
    camtoworlds: torch.Tensor,
    rot_std: float = 0.05,
    trans_std: float = 0.05,
    generator: Optional[torch.Generator] = None,
    xi: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Random SE(3) noise on poses (BARF's setup: known poses perturbed by
    gaussian twists): ``omega = rot_std N(0, 1)`` and ``rho = trans_std
    N(0, 1)``, each (n, 3), drawn from ``generator`` in that order, or the
    twists ``xi`` (n, 6) as given.

    Returns:
        (noisy (n, 3, 4) poses, the (n, 6) twists applied).
    """
    n = camtoworlds.shape[0]
    if xi is None:
        like = dict(dtype=camtoworlds.dtype, device=camtoworlds.device)
        omega = rot_std * torch.randn((n, 3), generator=generator, **like)
        rho = trans_std * torch.randn((n, 3), generator=generator, **like)
        xi = torch.cat([omega, rho], dim=-1)
    return compose_pose(se3_exp(xi), camtoworlds[..., :3, :4]), xi


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Similarity transform (s, R, t) minimising ``||dst - (s R src + t)||``
    (Umeyama's closed form through the SVD of the cross-covariance), in f64
    numpy."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs**2).sum() / src.shape[0]
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    t = mu_d - s * R @ mu_s
    return s, R, t


def pose_registration_errors(c2w_est, c2w_gt) -> Dict[str, float]:
    """BARF's pose errors after Sim3 alignment of the camera centres
    (:func:`umeyama_alignment`): the mean geodesic rotation error in
    degrees and the mean translation error in ground-truth units.  Takes
    (n, 3, 4) arrays or tensors."""
    c2w_est = np.asarray(_numpy(c2w_est), np.float64)
    c2w_gt = np.asarray(_numpy(c2w_gt), np.float64)
    s, R, t = umeyama_alignment(c2w_est[:, :3, 3], c2w_gt[:, :3, 3])
    centers = (s * (R @ c2w_est[:, :3, 3].T)).T + t
    trans_err = np.linalg.norm(centers - c2w_gt[:, :3, 3], axis=-1)
    R_est = R[None] @ c2w_est[:, :3, :3]
    rel = np.einsum("nij,nkj->nik", R_est, c2w_gt[:, :3, :3])  # R_est R_gt^T
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return {
        "rot_deg": float(np.degrees(np.arccos(cos)).mean()),
        "trans": float(trans_err.mean()),
    }


def coarse_to_fine_alpha(
    step,
    max_steps: int,
    max_deg: int,
    start_frac: float = 0.1,
    end_frac: float = 0.5,
) -> torch.Tensor:
    """BARF's coarse-to-fine window ``alpha``: 0 until ``start_frac *
    max_steps``, then linear up to ``max_deg`` at ``end_frac * max_steps``,
    in f32 from the step (a number or a tensor), as the jitted JAX schedule
    computes it: the division by the constant ramp length is a product
    with its f32 reciprocal."""
    s0 = start_frac * max_steps
    s1 = end_frac * max_steps
    step = torch.as_tensor(step, dtype=torch.float32)
    inv = 1.0 / torch.tensor(max(s1 - s0, 1.0), dtype=torch.float32)
    frac = torch.clamp((step - torch.tensor(s0, dtype=torch.float32)) * inv, 0.0, 1.0)
    return frac * max_deg


def _numpy(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
