"""Image quality metrics (PyTorch counterpart of nerfacc_tpu/utils/metrics.py),
computed in float64 on the images' device."""
from __future__ import annotations

import math

import torch


def psnr(img: torch.Tensor, ref: torch.Tensor, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio between two images in [0, data_range],
    computed in float64."""
    mse = float(torch.mean((img.double() - ref.double()) ** 2))
    return -10.0 * math.log10(max(mse, 1e-10) / data_range**2)


def _gaussian_kernel(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float64, device=device) - (size - 1) / 2.0
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _filter2d_sep(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 'valid'-mode filter over the (H, W) axes of (H, W, C)."""
    n = k.numel()
    rows = img.unfold(0, n, 1) @ k  # (H - n + 1, W, C)
    return rows.unfold(1, n, 1) @ k  # (H - n + 1, W - n + 1, C)


def ssim(
    img: torch.Tensor,
    ref: torch.Tensor,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> float:
    """Mean structural similarity (Wang et al. 2004) of (H, W[, C]) images:
    11x11 Gaussian window, sigma 1.5, per channel then averaged, 'valid'
    padding, the JAX package's constants."""
    img, ref = img.double(), ref.double()
    if img.ndim == 2:
        img, ref = img[..., None], ref[..., None]
    if img.shape != ref.shape:
        raise ValueError(f"shape mismatch: {tuple(img.shape)} vs {tuple(ref.shape)}")
    if min(img.shape[0], img.shape[1]) < kernel_size:
        raise ValueError("image smaller than the SSIM window")
    k = _gaussian_kernel(kernel_size, sigma, img.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _filter2d_sep(img, k)
    mu_y = _filter2d_sep(ref, k)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sig_xx = _filter2d_sep(img * img, k) - mu_xx
    sig_yy = _filter2d_sep(ref * ref, k) - mu_yy
    sig_xy = _filter2d_sep(img * ref, k) - mu_xy
    num = (2.0 * mu_xy + c1) * (2.0 * sig_xy + c2)
    den = (mu_xx + mu_yy + c1) * (sig_xx + sig_yy + c2)
    return float(torch.mean(num / den))
