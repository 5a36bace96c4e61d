"""Camera lens undistortion by fixed-iteration solves.

PyTorch counterpart of nerfacc_tpu/cameras.py: the OpenCV model (up to 8
parameters) and the fisheye model by Newton iteration, and the 12-parameter
model by OpenCV's fixed-point iteration, in full f32 (TF32 stays off inside
these functions).  None is differentiable: the outputs carry no gradient.
"""
from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def _full_f32():
    """TF32 off for the block (the pose math stays in full f32)."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _compute_residual_and_jacobian(x, y, xd, yd, params):
    """Residual and Jacobian of the 8-parameter OpenCV distortion model."""
    k1, k2, p1, p2, k3, k4, k5, k6 = torch.unbind(params, dim=-1)
    r = x * x + y * y
    alpha = 1.0 + r * (k1 + r * (k2 + r * k3))
    beta = 1.0 + r * (k4 + r * (k5 + r * k6))
    d = alpha / beta

    fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
    fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd

    alpha_r = k1 + r * (2.0 * k2 + r * (3.0 * k3))
    beta_r = k4 + r * (2.0 * k5 + r * (3.0 * k6))
    d_r = (alpha_r * beta - alpha * beta_r) / (beta * beta)
    d_x = 2.0 * x * d_r
    d_y = 2.0 * y * d_r

    fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
    fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
    fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
    fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
    return fx, fy, fx_x, fx_y, fy_x, fy_y


@torch.no_grad()
def opencv_lens_undistortion(
    uv: torch.Tensor, params: torch.Tensor, eps: float = 1e-6, iters: int = 10
) -> torch.Tensor:
    """Undistort the OpenCV lens model by ``iters`` Newton steps.

    Args:
        uv: (..., 2) distorted coordinates.
        params: (..., N), N in {0, 1, 2, 4, 8}: the first N of {k1, k2, p1,
            p2, k3, k4, k5, k6}, zero-padded to 8.
        eps: a step is taken only where the Jacobian's determinant exceeds it.

    Returns:
        (..., 2) undistorted coordinates (no gradient).
    """
    if uv.shape[-1] != 2:
        raise ValueError(f"uv must end in 2, got {tuple(uv.shape)}")
    n = params.shape[-1]
    if n not in (0, 1, 2, 4, 8):
        raise ValueError(f"params must have 0, 1, 2, 4 or 8 entries, got {n}")
    if n == 0:
        return uv.clone()
    with _full_f32():
        params = torch.nn.functional.pad(params, (0, 8 - n))
        params = params.expand(uv.shape[:-1] + (8,))
        x0, y0 = uv[..., 0], uv[..., 1]
        x, y = x0, y0
        for _ in range(iters):
            fx, fy, fx_x, fx_y, fy_x, fy_y = _compute_residual_and_jacobian(
                x, y, x0, y0, params
            )
            denom = fy_x * fx_y - fx_x * fy_y
            mask = denom.abs() > eps
            x = x + torch.where(mask, (fx * fy_y - fy * fx_y) / denom, 0.0)
            y = y + torch.where(mask, (fy * fx_x - fx * fy_x) / denom, 0.0)
        return torch.stack([x, y], dim=-1)


@torch.no_grad()
def opencv_lens_undistortion_fisheye(
    uv: torch.Tensor, params: torch.Tensor, eps: float = 1e-6, iters: int = 10
) -> torch.Tensor:
    """Undistort the OpenCV fisheye model {k1, k2, k3, k4} by ``iters``
    Newton steps on the angle theta; (..., 2) -> (..., 2), no gradient."""
    if uv.shape[-1] != 2 or params.shape[-1] != 4:
        raise ValueError(
            f"uv must end in 2 and params in 4, got {tuple(uv.shape)}, {tuple(params.shape)}"
        )
    with _full_f32():
        k1, k2, k3, k4 = torch.unbind(params.expand(uv.shape[:-1] + (4,)), dim=-1)
        u, v = uv[..., 0], uv[..., 1]
        theta_d = torch.sqrt(u * u + v * v)
        theta_d_clipped = theta_d.clamp(-math.pi / 2, math.pi / 2)
        theta = theta_d_clipped
        for _ in range(iters):
            t2 = theta * theta
            t4 = t2 * t2
            t6 = t4 * t2
            t8 = t4 * t4
            k1t2, k2t4, k3t6, k4t8 = k1 * t2, k2 * t4, k3 * t6, k4 * t8
            f = theta * (1 + k1t2 + k2t4 + k3t6 + k4t8) - theta_d_clipped
            fp = 1 + 3 * k1t2 + 5 * k2t4 + 7 * k3t6 + 9 * k4t8
            theta = theta - torch.where(fp.abs() > eps, f / fp, 0.0)
        scale = torch.where(
            theta_d > eps, torch.tan(theta) / theta_d.clamp_min(eps), 1.0
        )
        return uv * scale[..., None]


@torch.no_grad()
def opencv_lens_undistortion_12(
    uv: torch.Tensor, params: torch.Tensor, iters: int = 20
) -> torch.Tensor:
    """Undistort the 12-parameter OpenCV model {k1..k6, p1, p2, s1..s4}
    (rational radial, tangential and thin-prism terms) by ``iters`` steps
    of OpenCV's fixed-point iteration; (..., 2) -> (..., 2), no gradient."""
    if uv.shape[-1] != 2 or params.shape[-1] != 12:
        raise ValueError(
            f"uv must end in 2 and params in 12, got {tuple(uv.shape)}, {tuple(params.shape)}"
        )
    with _full_f32():
        k1, k2, k3, k4, k5, k6, p1, p2, s1, s2, s3, s4 = torch.unbind(
            params.expand(uv.shape[:-1] + (12,)), dim=-1
        )
        u, v = uv[..., 0], uv[..., 1]
        x, y = u, v
        for _ in range(iters):
            r2 = x * x + y * y
            icdist = (1 + ((k6 * r2 + k5) * r2 + k4) * r2) / (
                1 + ((k3 * r2 + k2) * r2 + k1) * r2
            )
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r2 * r2
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + s3 * r2 + s4 * r2 * r2
            x, y = (u - dx) * icdist, (v - dy) * icdist
        return torch.stack([x, y], dim=-1)
