"""Ray batches drawn on the device.

PyTorch counterpart of nerfacc_tpu/data/device_sampler.py: the image set
and camera rig are staged on the device once, and each batch is drawn there
with a ``torch.Generator`` (pixel picks, RGBA fetch, background blend,
pinhole rays), so a training loop moves nothing from the host per step.  The
reference's loaders draw their batches on the GPU the same way.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch


class DeviceRaySampler:
    """A pinhole-camera image set on the device, and its random ray batches.

    Args:
        images: (n_images, H, W, 4) uint8 RGBA (or (..., 3) RGB).
        camtoworlds: (n_images, 4, 4) or (n_images, 3, 4) camera-to-world.
        K: (3, 3) shared pinhole intrinsics.
        num_rays: rays per batch.
        color_bkgd_aug: "white", "black" or "random" (one colour per batch).
        opengl_camera: the camera looks down -z with y up.
        device: where the tables live and batches are drawn.
    """

    def __init__(
        self,
        images,
        camtoworlds,
        K,
        num_rays: int,
        color_bkgd_aug: str = "white",
        opengl_camera: bool = True,
        device: Union[str, torch.device] = "cuda",
    ):
        self.device = torch.device(device)
        images = torch.as_tensor(images).to(self.device, torch.uint8)
        if images.ndim != 4 or images.shape[-1] not in (3, 4):
            raise ValueError(f"images {tuple(images.shape)}: want (n, H, W, 3 or 4)")
        if images.shape[-1] == 3:
            alpha = torch.full(images.shape[:-1] + (1,), 255, dtype=torch.uint8, device=self.device)
            images = torch.cat([images, alpha], dim=-1)
        n, h, w, _ = images.shape
        # the JAX sampler computes the flat pixel index in int32, which
        # would wrap past 2^31 pixels; the same limit holds here
        assert n * h * w < 2**31, (
            f"image set has {n * h * w} pixels, past the int32 flat pixel index"
        )
        self.n_images, self.height, self.width = n, h, w
        self.num_rays = int(num_rays)
        self.color_bkgd_aug = color_bkgd_aug
        self.opengl_camera = bool(opengl_camera)
        # one flat pixel table: one row gather per batch
        self.pixels = images.reshape(n * h * w, 4)
        c2w = torch.as_tensor(np.asarray(camtoworlds, np.float32))
        self.c2w = c2w[:, :3, :4].to(self.device)
        self.K = torch.as_tensor(np.asarray(K, np.float32)).to(self.device)

    def with_num_rays(self, num_rays: int) -> "DeviceRaySampler":
        """A sampler of ``num_rays``-ray batches over the same staged tables
        (no copy), for a training loop that resizes its batch.  Clones are
        cached per ray count in one dict that the base sampler and every
        clone share, so resizing a clone of a clone returns the object that
        resizing the base does: one sampler per bucket, as in the JAX
        package, where the sampler keys the jit cache."""
        num_rays = int(num_rays)
        if num_rays == self.num_rays:
            return self
        cache = self.__dict__.setdefault("_clones", {})
        cache.setdefault(self.num_rays, self)
        if num_rays not in cache:
            clone = object.__new__(DeviceRaySampler)
            clone.__dict__.update(
                {k: v for k, v in self.__dict__.items() if k != "_clones"}
            )
            clone.num_rays = num_rays
            clone._clones = cache
            cache[num_rays] = clone
        return cache[num_rays]

    @classmethod
    def from_loader(cls, loader, num_rays: Optional[int] = None) -> "DeviceRaySampler":
        """From a loader with ``images``, ``camtoworlds`` and ``K`` (the
        procedural loader's attributes), on the loader's device."""
        num_rays = loader.num_rays if num_rays is None else num_rays
        if not isinstance(num_rays, int) or num_rays <= 0:
            raise ValueError(
                f"num_rays must be a positive int, got {num_rays!r} "
                "(a test-split loader has none: pass it)"
            )
        return cls(
            images=loader.images,
            camtoworlds=loader.camtoworlds,
            K=loader.K,
            num_rays=num_rays,
            color_bkgd_aug=getattr(loader, "color_bkgd_aug", "white"),
            opengl_camera=getattr(loader, "OPENGL_CAMERA", True),
            device=loader.device,
        )

    def sample(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """One batch ``{rgb, rays_o, rays_d, color_bkgd}``, drawn from
        ``generator`` (a generator on the sampler's device)."""
        shape = (self.num_rays,)
        image_id = torch.randint(0, self.n_images, shape, generator=generator, device=self.device)
        x = torch.randint(0, self.width, shape, generator=generator, device=self.device)
        y = torch.randint(0, self.height, shape, generator=generator, device=self.device)
        if self.color_bkgd_aug == "random":
            color_bkgd = torch.rand(3, generator=generator, device=self.device)
        elif self.color_bkgd_aug == "white":
            color_bkgd = torch.ones(3, device=self.device)
        else:
            color_bkgd = torch.zeros(3, device=self.device)
        return self.batch(image_id, x, y, color_bkgd)

    def batch(self, image_id, x, y, color_bkgd) -> Dict[str, torch.Tensor]:
        """The batch of the given pixels: RGBA over ``color_bkgd`` and rays."""
        flat = (image_id * self.height + y) * self.width + x
        rgba = self.pixels[flat].to(torch.float32) / 255.0
        rgb = rgba[:, :3] * rgba[:, 3:] + color_bkgd * (1.0 - rgba[:, 3:])
        origins, viewdirs = self.rays(image_id, x, y)
        return {"rgb": rgb, "rays_o": origins, "rays_d": viewdirs, "color_bkgd": color_bkgd}

    def rays(self, image_id, x, y) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pinhole rays through pixel centres: origins and unit directions."""
        K = self.K
        sign = -1.0 if self.opengl_camera else 1.0
        xf, yf = x.to(torch.float32), y.to(torch.float32)
        camera_dirs = torch.stack(
            [
                (xf + 0.5 - K[0, 2]) / K[0, 0],
                (yf + 0.5 - K[1, 2]) / K[1, 1] * sign,
                torch.full_like(xf, sign),
            ],
            dim=-1,
        )
        c2w = self.c2w[image_id]  # (n_rays, 3, 4)
        directions = torch.einsum("nij,nj->ni", c2w[:, :, :3], camera_dirs)
        viewdirs = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
        return c2w[:, :, 3].contiguous(), viewdirs
