"""NeRF-Synthetic (Blender) dataset loader.

PyTorch counterpart of nerfacc_tpu/data/nerf_synthetic.py: 800x800 Blender
JSON scenes, the OpenGL camera convention with +0.5 pixel centres, train
batches of ``num_rays`` random (image, x, y) triples drawn from
``np.random.default_rng(seed)`` in the JAX loader's order, and whole views
in the test split; ``pixel_batch`` gives a train batch as pixels (BARF's
batches), from the same draws.  The rays are computed in numpy with the JAX loader's
arithmetic, so both packages give the same rays; the images live on the
loader's device as uint8 and every item comes back as tensors there.
Reading the images needs ``imageio``.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Union

import numpy as np
import torch


def read_image(path: str) -> np.ndarray:
    """One image file as a numpy array, through ``imageio``; a missing
    ``imageio`` raises and says so (no dataset is ever read empty)."""
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(
            f"reading {path} needs the imageio package, which is not installed"
        ) from e
    return imageio.imread(path)


def _load_renderings(root_fp: str, subject_id: str, split: str):
    """(images (n, H, W, 4) uint8, camtoworlds (n, 4, 4), focal, frames'
    JSON records) of one split."""
    data_dir = os.path.join(root_fp, subject_id)
    with open(os.path.join(data_dir, f"transforms_{split}.json"), "r") as fp:
        meta = json.load(fp)
    frames = meta["frames"]
    images = np.stack([read_image(os.path.join(data_dir, f["file_path"] + ".png"))
                       for f in frames])
    camtoworlds = np.stack([f["transform_matrix"] for f in frames])
    w = images.shape[2]
    focal = 0.5 * w / np.tan(0.5 * float(meta["camera_angle_x"]))
    return images, camtoworlds, focal, frames


class PinholeLoader:
    """The ray and batch logic the dataset loaders share: pinhole rays
    through pixel centres (OpenGL or OpenCV axes), train batches drawn from
    ``self.rng`` (image ids, x, y, then the background), whole views in the
    test split, and the RGB(A) over the item's background.  A subclass sets
    ``images`` (a uint8 tensor on ``device``), ``camtoworlds``, ``K``,
    ``WIDTH`` and ``HEIGHT``."""

    OPENGL_CAMERA = True

    def _setup(self, split, num_rays, color_bkgd_aug, batch_over_images, seed, device,
               train_splits=("train",)):
        self.split = split
        self.num_rays = num_rays
        self.training = num_rays is not None and split in train_splits
        self.color_bkgd_aug = color_bkgd_aug
        self.batch_over_images = batch_over_images
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)

    def __len__(self):
        return len(self.images)

    def update_num_rays(self, num_rays: int) -> None:
        self.num_rays = num_rays

    def _rays_for_pixels(self, image_id, x, y):
        """Origins and unit directions, computed in numpy as the JAX loaders
        do, returned as f32 tensors on the loader's device."""
        c2w = self.camtoworlds[image_id]
        sign = -1.0 if self.OPENGL_CAMERA else 1.0
        camera_dirs = np.stack(
            [
                (x + 0.5 - self.K[0, 2]) / self.K[0, 0],
                (y + 0.5 - self.K[1, 2]) / self.K[1, 1] * sign,
                np.full_like(x, sign, dtype=np.float32),
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

    def _background(self) -> np.ndarray:
        if self.color_bkgd_aug == "random":
            return self.rng.random(3, dtype=np.float32)
        if self.color_bkgd_aug == "white":
            return np.ones(3, np.float32)
        return np.zeros(3, np.float32)

    def _sample_pixels(self, index: int):
        """The (image, x, y) triples of one train batch, from ``self.rng``."""
        n = self.num_rays
        if self.batch_over_images:
            image_id = self.rng.integers(0, len(self.images), size=(n,))
        else:
            image_id = np.full((n,), index)
        x = self.rng.integers(0, self.WIDTH, size=(n,))
        y = self.rng.integers(0, self.HEIGHT, size=(n,))
        return image_id, x, y

    def _pixels(self, image_id, x, y, color_bkgd: torch.Tensor) -> torch.Tensor:
        """The RGB of the picked pixels over ``color_bkgd`` (RGB images are
        opaque)."""
        pick = tuple(torch.as_tensor(a, device=self.device) for a in (image_id, y, x))
        rgba = self.images[pick].to(torch.float32) / 255.0
        if rgba.shape[-1] == 3:
            return rgba
        return rgba[..., :3] * rgba[..., 3:] + color_bkgd * (1.0 - rgba[..., 3:])

    def __getitem__(self, index: int):
        """A train batch, or view ``index`` with a white background:
        ``{rgb, rays_o, rays_d, color_bkgd}`` on the loader's device."""
        if self.training:
            image_id, x, y = self._sample_pixels(index)
            color_bkgd = self._background()
        else:
            x, y = np.meshgrid(np.arange(self.WIDTH), np.arange(self.HEIGHT), indexing="xy")
            x, y = x.reshape(-1), y.reshape(-1)
            image_id = np.full_like(x, index)
            color_bkgd = np.ones(3, np.float32)
        self._last_image_id = image_id
        color_bkgd = torch.tensor(color_bkgd, device=self.device)
        origins, viewdirs = self._rays_for_pixels(image_id, x, y)
        return {
            "rgb": self._pixels(image_id, x, y, color_bkgd),
            "rays_o": origins,
            "rays_d": viewdirs,
            "color_bkgd": color_bkgd,
        }


class SubjectLoader(PinholeLoader):
    """One Blender scene (nerfacc_tpu/data/nerf_synthetic.py's
    ``SubjectLoader``).

    Args:
        subject_id: the scene's directory under ``root_fp``.
        split: "train", "val", "trainval" or "test".
        color_bkgd_aug: a train batch's background, "white", "black" or
            "random" (one colour a batch).
        num_rays: rays a train batch (None: whole views).
        near / far: the planes (default 2 / 6).
        batch_over_images: draw each ray's image (else item ``index``'s).
        seed: seeds the batches' draws.
        device: where the images live and items are returned (the card
            unless the caller asks for another).
    """

    SPLITS = ["train", "val", "trainval", "test"]
    SUBJECT_IDS = ["chair", "drums", "ficus", "hotdog", "lego", "materials", "mic", "ship"]
    WIDTH, HEIGHT = 800, 800
    NEAR, FAR = 2.0, 6.0
    OPENGL_CAMERA = True

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str,
        color_bkgd_aug: str = "white",
        num_rays: Optional[int] = None,
        near: Optional[float] = None,
        far: Optional[float] = None,
        batch_over_images: bool = True,
        seed: int = 42,
        device: Union[str, torch.device] = "cuda",
    ):
        if split not in self.SPLITS:
            raise ValueError(f"split {split!r}: want one of {self.SPLITS}")
        if color_bkgd_aug not in ("white", "black", "random"):
            raise ValueError(f"color_bkgd_aug {color_bkgd_aug!r}")
        self._setup(split, num_rays, color_bkgd_aug, batch_over_images, seed, device,
                    ("train", "trainval"))
        self.near = self.NEAR if near is None else near
        self.far = self.FAR if far is None else far
        images, camtoworlds, self.focal = self._load(root_fp, subject_id, split)
        if images.shape[1:3] != (self.HEIGHT, self.WIDTH):
            raise ValueError(
                f"{subject_id}: images of {images.shape[1:3]}, want "
                f"{(self.HEIGHT, self.WIDTH)}"
            )
        self.K = np.array(
            [[self.focal, 0, self.WIDTH / 2.0], [0, self.focal, self.HEIGHT / 2.0], [0, 0, 1]],
            dtype=np.float32,
        )
        self.images = torch.from_numpy(images.astype(np.uint8)).to(self.device)
        self.camtoworlds = camtoworlds.astype(np.float32)

    def _load(self, root_fp, subject_id, split):
        """(images, camtoworlds, focal); "trainval" joins train and val."""
        parts = ["train", "val"] if split == "trainval" else [split]
        loaded = [self._load_split(root_fp, subject_id, s) for s in parts]
        return (np.concatenate([p[0] for p in loaded]),
                np.concatenate([p[1] for p in loaded]), loaded[0][2])

    def _load_split(self, root_fp, subject_id, split):
        images, camtoworlds, focal, _ = _load_renderings(root_fp, subject_id, split)
        return images, camtoworlds, focal

    def pixel_batch(self, index: int):
        """A train batch as pixels, for a trainer that makes the rays from
        poses it refines (BARF): ``{img_ids, x, y}`` (int32), the pixels'
        ``rgb`` over the batch's ``color_bkgd``, on the loader's device,
        from the draws :meth:`__getitem__` makes (image ids, x, y, then the
        background)."""
        image_id, x, y = self._sample_pixels(index)
        color_bkgd = torch.tensor(self._background(), device=self.device)
        as_int = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=self.device)
        return {"img_ids": as_int(image_id), "x": as_int(x), "y": as_int(y),
                "rgb": self._pixels(image_id, x, y, color_bkgd), "color_bkgd": color_bkgd}
