"""Mip-NeRF 360 (COLMAP captures) dataset loader.

PyTorch counterpart of nerfacc_tpu/data/nerf_360_v2.py: parses a COLMAP
sparse model (``sparse/0/cameras.bin`` and ``images.bin``), recentres and
rescales the poses by the camera-similarity transform, downscales by
``factor`` (``images_<factor>/`` when present, else every factor-th pixel),
keeps every 8th image for the test split, and yields OpenCV-convention rays
(+z forward, no y flip).  The parsers and the pose arithmetic run in numpy,
as in the JAX loader, so both packages give the same poses and rays; the
images live on the loader's device as uint8 RGB.  Reading them needs
``imageio``.
"""
from __future__ import annotations

import os
import struct
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from .nerf_synthetic import PinholeLoader, read_image

# parameters a camera model carries, by COLMAP's model id
_MODEL_PARAMS = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4, 9: 5, 10: 12}


def _read_cameras_bin(path: str) -> Dict:
    cameras = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cam_id, model, w, h = struct.unpack("<iiQQ", f.read(24))
            num_p = _MODEL_PARAMS[model]
            params = struct.unpack("<" + "d" * num_p, f.read(8 * num_p))
            cameras[cam_id] = {"model": model, "width": w, "height": h,
                               "params": np.asarray(params)}
    return cameras


def _read_images_bin(path: str) -> Dict:
    images = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            im_id = struct.unpack("<i", f.read(4))[0]
            qvec = np.asarray(struct.unpack("<dddd", f.read(32)))
            tvec = np.asarray(struct.unpack("<ddd", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            c = f.read(1)
            while c != b"\x00":
                name += c
                c = f.read(1)
            n_p2d = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n_p2d)  # the 2D points
            images[im_id] = {"qvec": qvec, "tvec": tvec, "camera_id": cam_id,
                             "name": name.decode()}
    return images


def _qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
            [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
            [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y],
        ]
    )


def similarity_from_cameras(c2w: np.ndarray) -> Tuple[np.ndarray, float]:
    """The transform that turns the cameras' mean up vector to +z and moves
    the median of their look-at points to the origin, and the scale that
    brings the median camera distance to 1 (the standard 360
    preprocessing)."""
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]

    # (1) rotate the up vector to +z
    ups = R @ np.array([0, -1.0, 0])
    world_up = np.mean(ups, axis=0)
    world_up /= np.linalg.norm(world_up)
    up_camspace = np.array([0.0, 0.0, 1.0])
    c = (up_camspace * world_up).sum()
    cross = np.cross(world_up, up_camspace)
    skew = np.array(
        [
            [0.0, -cross[2], cross[1]],
            [cross[2], 0.0, -cross[0]],
            [-cross[1], cross[0], 0.0],
        ]
    )
    if c > -1:
        R_align = np.eye(3) + skew + (skew @ skew) * 1 / (1 + c)
    else:
        R_align = np.array([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]])
    R = R_align @ R
    fwds = np.sum(R * np.array([0, 0.0, 1.0]), axis=-1)
    t = (R_align @ t[..., None])[..., 0]

    # (2) recentre the scene
    nearest = t + (fwds * -t).sum(-1)[:, None] * fwds
    translate = -np.median(nearest, axis=0)
    transform = np.eye(4)
    transform[:3, 3] = translate
    transform[:3, :3] = R_align

    # (3) rescale it
    scale = 1.0 / np.median(np.linalg.norm(t + translate, axis=-1))
    return transform, scale


class SubjectLoader(PinholeLoader):
    """One Mip-NeRF 360 capture (nerfacc_tpu/data/nerf_360_v2.py's
    ``SubjectLoader``).

    Args:
        subject_id: the capture's directory under ``root_fp``.
        split: "train" or "test" (every 8th image, from the first).
        color_bkgd_aug: a train batch's background (the images are opaque,
            so it only comes back in the item).
        num_rays: rays a train batch (None: whole views).
        factor: the downscale factor of the images and intrinsics.
        batch_over_images: draw each ray's image (else item ``index``'s).
        seed: seeds the batches' draws.
        device: where the images live and items are returned (the card
            unless the caller asks for another).
    """

    SPLITS = ["train", "test"]
    SUBJECT_IDS = ["garden", "bicycle", "bonsai", "counter", "kitchen", "room", "stump"]
    OPENGL_CAMERA = False

    def __init__(
        self,
        subject_id: str,
        root_fp: str,
        split: str,
        color_bkgd_aug: str = "white",
        num_rays: Optional[int] = None,
        factor: int = 1,
        batch_over_images: bool = True,
        seed: int = 42,
        device: Union[str, torch.device] = "cuda",
    ):
        self._setup(split, num_rays, color_bkgd_aug, batch_over_images, seed, device)
        data_dir = os.path.join(root_fp, subject_id)
        sparse = os.path.join(data_dir, "sparse", "0")
        cameras = _read_cameras_bin(os.path.join(sparse, "cameras.bin"))
        images_meta = _read_images_bin(os.path.join(sparse, "images.bin"))

        cam = cameras[list(cameras.keys())[0]]
        # single-focal models (SIMPLE_PINHOLE 0, SIMPLE_RADIAL 2, RADIAL 3)
        # carry (f, cx, cy, ...), the others (fx, fy, cx, cy, ...)
        p = cam["params"]
        fx, fy, cx, cy = (p[0], p[0], p[1], p[2]) if cam["model"] in (0, 2, 3) else p[:4]
        self.K = np.array(
            [[fx / factor, 0, cx / factor], [0, fy / factor, cy / factor], [0, 0, 1]],
            dtype=np.float32,
        )

        items = sorted(images_meta.values(), key=lambda d: d["name"])
        scaled_dir = os.path.join(data_dir, f"images_{factor}")
        img_dir = (scaled_dir if factor > 1 and os.path.isdir(scaled_dir)
                   else os.path.join(data_dir, "images"))
        c2ws = []
        for it in items:
            w2c = np.eye(4)
            w2c[:3, :3] = _qvec2rotmat(it["qvec"])
            w2c[:3, 3] = it["tvec"]
            c2ws.append(np.linalg.inv(w2c))
        c2w = np.stack(c2ws)
        transform, scale = similarity_from_cameras(c2w)
        c2w = transform @ c2w
        c2w[:, :3, 3] *= scale

        keep = np.arange(len(items)) % 8 == 0
        if split == "train":
            keep = ~keep
        self.camtoworlds = c2w[keep].astype(np.float32)
        imgs = []
        for it, k in zip(items, keep):
            if not k:
                continue
            img = read_image(os.path.join(img_dir, it["name"]))
            if factor > 1 and "images_" not in img_dir:
                img = img[::factor, ::factor]  # nearest downsampling
            imgs.append(img[..., :3])
        images = np.stack(imgs).astype(np.uint8)
        self.HEIGHT, self.WIDTH = images.shape[1:3]
        self.images = torch.from_numpy(images).to(self.device)
