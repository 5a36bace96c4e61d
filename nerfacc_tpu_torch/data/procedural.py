"""Procedural benchmark scene: Gaussian density blobs rendered analytically
to ground-truth images.

PyTorch counterpart of nerfacc_tpu/data/procedural.py's
``ProceduralSceneLoader``.  The scene constants come from the same
``np.random.default_rng(1234)`` draws and the camera rays from the same
numpy arithmetic, so both packages build the identical scene and rays; the
ground truth is integrated in PyTorch on the loader's device (no disk
cache).  Ported: the test split and the train split's random ray batches,
whose pixels come from the same ``np.random.default_rng(seed)`` call
sequence as the JAX loader's, so both loaders yield identical batches.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


def _look_at(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """OpenGL-style camera-to-world matrix (camera looks down -z)."""
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = s
    c2w[:3, 1] = u
    c2w[:3, 2] = -f
    c2w[:3, 3] = eye
    return c2w


class ProceduralSceneLoader:
    """Analytic-blob scene with the SubjectLoader interface.

    Args:
        split: "train" or "test" camera ring.
        n_train / n_test: camera counts on a ring, looking at the origin.
        width / height: image resolution.
        num_rays: train-split ray batch; None (or the test split) makes
            every item a whole view.
        color_bkgd_aug: background of a train batch, "white", "black" or
            "random" (one colour per batch).
        seed: seeds the batches' pixel draws.
        device: where the ground truth is rendered and items are returned.
    """

    NEAR, FAR = 2.0, 6.0
    OPENGL_CAMERA = True
    NUM_BLOBS = 24
    AABB_HALF = 1.2  # blob centres lie within 0.8 of this
    GT_SAMPLES = 512  # uniform samples per ray of the analytic render

    def __init__(
        self,
        split: str = "train",
        n_train: int = 24,
        n_test: int = 4,
        width: int = 320,
        height: int = 320,
        num_rays: Optional[int] = None,
        color_bkgd_aug: str = "white",
        seed: int = 42,
        device: Union[str, torch.device] = "cpu",
    ):
        self.split = split
        self.WIDTH, self.HEIGHT = width, height
        self.num_rays = num_rays
        self.training = num_rays is not None and split == "train"
        self.color_bkgd_aug = color_bkgd_aug
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        half, n_blobs = self.AABB_HALF, self.NUM_BLOBS
        self.aabb = np.array([-half] * 3 + [half] * 3, dtype=np.float32)

        rng = np.random.default_rng(1234)  # scene is fixed across seeds
        f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=self.device)
        self.blob_centers = f32(rng.uniform(-0.8 * half, 0.8 * half, (n_blobs, 3)))
        self.blob_scales = f32(rng.uniform(0.05, 0.22, (n_blobs,)))
        # dense blobs: rays saturate within a few samples of the surface
        self.blob_density = f32(rng.uniform(80.0, 300.0, (n_blobs,)))
        self.blob_colors = f32(rng.uniform(0.1, 1.0, (n_blobs, 3)))

        n_views = n_train if split == "train" else n_test
        phase = 0.0 if split == "train" else 0.5 / max(n_test, 1)
        radius = 4.0
        poses = []
        for i in range(n_views):
            theta = 2 * np.pi * (i / n_views + phase)
            phi = np.deg2rad(-30.0 + 20.0 * np.sin(3 * theta))
            eye = radius * np.array(
                [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
            )
            poses.append(
                _look_at(eye.astype(np.float32), np.zeros(3), np.array([0, 0, 1.0]))
            )
        self.camtoworlds = np.stack(poses).astype(np.float32)

        self.focal = 0.5 * width / np.tan(0.5 * np.deg2rad(50.0))
        self.K = np.array(
            [[self.focal, 0, width / 2.0], [0, self.focal, height / 2.0], [0, 0, 1]],
            dtype=np.float32,
        )
        self.images = self._render_gt_images()

    # -- analytic field -----------------------------------------------------
    def query_density(self, x: torch.Tensor) -> torch.Tensor:
        """sigma(x): sum of Gaussian blobs. (N, 3) -> (N, 1)."""
        return self._blob_weights(x).sum(dim=-1, keepdim=True)

    def query_rgb(self, x: torch.Tensor) -> torch.Tensor:
        w = self._blob_weights(x)
        w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-8)
        return w @ self.blob_colors

    def _blob_weights(self, x: torch.Tensor) -> torch.Tensor:
        d2 = ((x[:, None, :] - self.blob_centers[None]) ** 2).sum(dim=-1)  # (N, B)
        return self.blob_density * torch.exp(-0.5 * d2 / self.blob_scales**2)

    # -- ground-truth rendering --------------------------------------------
    def _render_rays_gt(self, rays_o: torch.Tensor, rays_d: torch.Tensor):
        n = self.GT_SAMPLES
        t = torch.linspace(self.NEAR, self.FAR, n + 1, device=self.device)
        t0, t1 = t[:-1], t[1:]
        tm = 0.5 * (t0 + t1)
        pos = rays_o[:, None, :] + tm[None, :, None] * rays_d[:, None, :]
        flat = pos.reshape(-1, 3)
        sigma = self.query_density(flat).reshape(pos.shape[:2])
        rgb = self.query_rgb(flat).reshape(pos.shape[:2] + (3,))
        sdt = sigma * (t1 - t0)[None, :]
        alpha = 1.0 - torch.exp(-sdt)
        trans = torch.exp(-torch.cumsum(sdt, dim=-1) + sdt)
        weights = trans * alpha
        color = (weights[..., None] * rgb).sum(dim=1)
        opacity = weights.sum(dim=1, keepdim=True)
        return color, opacity

    @torch.no_grad()
    def _render_gt_images(self) -> torch.Tensor:
        """(n_views, H, W, 4) uint8 RGBA."""
        x, y = self._pixel_grid()
        imgs = []
        for i in range(len(self.camtoworlds)):
            o, d = self._rays_for_pixels(np.full_like(x, i), x, y)
            rgba = []
            chunk = 4096
            for s in range(0, len(x), chunk):
                c, a = self._render_rays_gt(o[s : s + chunk], d[s : s + chunk])
                rgba.append(torch.cat([c, a], dim=-1))
            rgba = torch.cat(rgba).reshape(self.HEIGHT, self.WIDTH, 4)
            imgs.append((rgba * 255).clamp(0, 255).to(torch.uint8))
        return torch.stack(imgs)

    # -- SubjectLoader interface -------------------------------------------
    def __len__(self):
        return len(self.camtoworlds)

    def update_num_rays(self, num_rays: int) -> None:
        self.num_rays = num_rays

    def _pixel_grid(self):
        x, y = np.meshgrid(np.arange(self.WIDTH), np.arange(self.HEIGHT), indexing="xy")
        return x.reshape(-1), y.reshape(-1)

    def _rays_for_pixels(self, image_id, x, y):
        """Origins and unit directions, computed in numpy exactly as the JAX
        package does, returned as f32 tensors on the loader's device."""
        c2w = self.camtoworlds[image_id]
        camera_dirs = np.stack(
            [
                (x + 0.5 - self.K[0, 2]) / self.K[0, 0],
                (y + 0.5 - self.K[1, 2]) / self.K[1, 1] * -1.0,
                np.full_like(x, -1.0, dtype=np.float32),
            ],
            axis=-1,
        )
        directions = (camera_dirs[..., None, :] * c2w[..., :3, :3]).sum(-1)
        origins = np.broadcast_to(c2w[..., :3, -1], directions.shape)
        viewdirs = directions / np.linalg.norm(directions, axis=-1, keepdims=True)
        return (
            torch.tensor(origins.astype(np.float32), device=self.device),
            torch.tensor(viewdirs.astype(np.float32), device=self.device),
        )

    def _select_pixels(self, index: int):
        """(image ids, x, y, background) of one item, drawn from ``self.rng``
        in the JAX loader's order when training."""
        if self.training:
            n = self.num_rays
            image_id = self.rng.integers(0, len(self), size=(n,))
            x = self.rng.integers(0, self.WIDTH, size=(n,))
            y = self.rng.integers(0, self.HEIGHT, size=(n,))
            if self.color_bkgd_aug == "random":
                color_bkgd = self.rng.random(3, dtype=np.float32)
            elif self.color_bkgd_aug == "white":
                color_bkgd = np.ones(3, np.float32)
            else:
                color_bkgd = np.zeros(3, np.float32)
        else:
            x, y = self._pixel_grid()
            image_id = np.full_like(x, index)
            color_bkgd = np.ones(3, np.float32)
        return image_id, x, y, color_bkgd

    def __getitem__(self, index: int):
        """A train ray batch or one full view: rays and the ground truth
        alpha-blended over the item's background."""
        image_id, x, y, color_bkgd = self._select_pixels(index)
        pick = tuple(torch.as_tensor(a, device=self.device) for a in (image_id, y, x))
        rgba = self.images[pick].to(torch.float32) / 255.0
        origins, viewdirs = self._rays_for_pixels(image_id, x, y)
        color_bkgd = torch.tensor(color_bkgd, device=self.device)
        pixels = rgba[:, :3] * rgba[:, 3:] + color_bkgd * (1.0 - rgba[:, 3:])
        return {
            "rgb": pixels,
            "rays_o": origins,
            "rays_d": viewdirs,
            "color_bkgd": color_bkgd,
        }
