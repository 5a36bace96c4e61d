"""Port vs JAX: the dataset loaders (nerf_synthetic, dnerf_synthetic,
nerf_360_v2) on fixtures written into ``tmp_path`` (the writers of
tests/test_datasets.py, copied), and the examples' ``--data_root``
branches.  Rays, pixels, backgrounds and timestamps bit for bit."""
import json
import os
import struct
import sys

import numpy as np
import pytest
import torch
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

imageio = pytest.importorskip("imageio.v2")

from nerfacc_tpu.data.dnerf_synthetic import SubjectLoader as JaxDnerf
from nerfacc_tpu.data.nerf_360_v2 import SubjectLoader as Jax360
from nerfacc_tpu.data.nerf_synthetic import SubjectLoader as JaxBlender
from nerfacc_tpu_torch.data.device_sampler import DeviceRaySampler
from nerfacc_tpu_torch.data.dnerf_synthetic import SubjectLoader as Dnerf
from nerfacc_tpu_torch.data.nerf_360_v2 import SubjectLoader as Loader360
from nerfacc_tpu_torch.data.nerf_synthetic import SubjectLoader as Blender

W = H = 8
FOCAL = 8.0
CAM_ANGLE_X = 2.0 * np.arctan(0.5 * W / FOCAL)


def _write_blender_fixture(root, subject="tiny", times=None):
    d = os.path.join(root, subject)
    os.makedirs(d, exist_ok=True)
    c2ws = [np.eye(4), np.eye(4)]
    c2ws[0][:3, 3] = [1.0, 2.0, 3.0]
    c2ws[1][:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    c2ws[1][:3, 3] = [0.0, 0.0, 4.0]
    frames = []
    rng = np.random.default_rng(1)
    for i, c2w in enumerate(c2ws):
        img = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
        img[0, 0, 3] = 0  # one fully transparent pixel
        imageio.imwrite(os.path.join(d, f"r_{i}.png"), img)
        fr = {"file_path": f"r_{i}", "transform_matrix": c2w.tolist()}
        if times is not None:
            fr["time"] = times[i]
        frames.append(fr)
    meta = {"camera_angle_x": CAM_ANGLE_X, "frames": frames}
    for split in ("train", "val", "test"):
        with open(os.path.join(d, f"transforms_{split}.json"), "w") as f:
            json.dump(meta, f)
    return d


def _write_colmap_fixture(root, subject="garden", n_images=9):
    d = os.path.join(root, subject)
    sparse = os.path.join(d, "sparse", "0")
    imgdir = os.path.join(d, "images")
    os.makedirs(sparse, exist_ok=True)
    os.makedirs(imgdir, exist_ok=True)
    fx, fy, cx, cy = 10.0, 11.0, W / 2.0, H / 2.0
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, W, H))  # PINHOLE
        f.write(struct.pack("<dddd", fx, fy, cx, cy))
    rng = np.random.default_rng(0)
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", n_images))
        for i in range(n_images):
            f.write(struct.pack("<i", i + 1))
            q = np.array([1.0, 0.1 * i, -0.05 * i, 0.02])
            f.write(struct.pack("<dddd", *(q / np.linalg.norm(q))))
            f.write(struct.pack("<ddd", float(i), 0.0, float(i % 3)))
            f.write(struct.pack("<i", 1))
            f.write(f"img_{i:03d}.png".encode() + b"\x00")
            f.write(struct.pack("<Q", 2))
            f.write(b"\x00" * 48)
            img = rng.integers(0, 255, (H, W, 3)).astype(np.uint8)
            imageio.imwrite(os.path.join(imgdir, f"img_{i:03d}.png"), img)
    return d


@pytest.fixture
def tiny(monkeypatch):
    """The Blender loaders of both packages at the fixtures' 8x8."""
    for cls in (JaxBlender, Blender):
        monkeypatch.setattr(cls, "WIDTH", W)
        monkeypatch.setattr(cls, "HEIGHT", H)


def _assert_items_equal(out, ref, keys=("rgb", "rays_o", "rays_d", "color_bkgd")):
    for key in keys:
        np.testing.assert_array_equal(out[key].numpy(), np.asarray(ref[key]), err_msg=key)


@pytest.mark.parametrize("split,aug", [("train", "random"), ("trainval", "black"),
                                       ("test", "white")])
def test_blender_loader_matches_jax(tmp_path, tiny, split, aug):
    """Views or three consecutive train batches (the same draws from the
    same seed), K and the poses; the images on the loader's device as
    uint8."""
    _write_blender_fixture(str(tmp_path))
    num_rays = None if split == "test" else 17
    kw = dict(subject_id="tiny", root_fp=str(tmp_path), split=split, color_bkgd_aug=aug,
              num_rays=num_rays, seed=3)
    ref, out = JaxBlender(**kw), Blender(**kw, device="cpu")
    assert len(out) == len(ref) == (4 if split == "trainval" else 2)
    assert out.training == ref.training and out.focal == ref.focal
    np.testing.assert_array_equal(out.K, ref.K)
    np.testing.assert_array_equal(out.camtoworlds, ref.camtoworlds)
    np.testing.assert_array_equal(out.images.numpy(), ref.images)
    assert out.images.dtype == torch.uint8
    for i in range(3 if num_rays else len(out)):
        _assert_items_equal(out[i], ref[i])


def test_dnerf_loader_matches_jax(tmp_path, tiny, monkeypatch):
    """The frames' times from the JSON (or ``i / (n - 1)`` without one),
    per-ray timestamps of train batches and views."""
    for cls in (JaxDnerf, Dnerf):
        monkeypatch.setattr(cls, "WIDTH", W)
        monkeypatch.setattr(cls, "HEIGHT", H)
    _write_blender_fixture(str(tmp_path), times=[0.0, 0.5])
    _write_blender_fixture(str(tmp_path), subject="untimed")
    for subject in ("tiny", "untimed"):
        for split, num_rays in (("train", 9), ("test", None)):
            kw = dict(subject_id=subject, root_fp=str(tmp_path), split=split, num_rays=num_rays)
            ref, out = JaxDnerf(**kw), Dnerf(**kw, device="cpu")
            np.testing.assert_array_equal(out.timestamps.numpy(), ref.timestamps)
            for i in range(2):
                _assert_items_equal(out[i], ref[i], ("rgb", "rays_o", "rays_d", "timestamps"))
    assert out.timestamps.reshape(-1).tolist() == [0.0, 1.0]


@pytest.mark.parametrize("factor", [1, 2])
def test_360_loader_matches_jax(tmp_path, factor):
    """The COLMAP parse, the similarity recentring (poses bitwise), the
    every-8th test split, the downscale (nearest, no ``images_2/``), K,
    train batches and views, and the loaders feed the device sampler."""
    _write_colmap_fixture(str(tmp_path))
    for split, num_rays in (("train", 13), ("test", None)):
        kw = dict(subject_id="garden", root_fp=str(tmp_path), split=split, num_rays=num_rays,
                  factor=factor, color_bkgd_aug="random", seed=2)
        ref, out = Jax360(**kw), Loader360(**kw, device="cpu")
        assert len(out) == len(ref) == (7 if split == "train" else 2)
        assert (out.HEIGHT, out.WIDTH) == (ref.HEIGHT, ref.WIDTH) == (H // factor, W // factor)
        np.testing.assert_array_equal(out.K, ref.K)
        np.testing.assert_array_equal(out.camtoworlds, ref.camtoworlds)
        for i in range(2):
            _assert_items_equal(out[i], ref[i])
    sampler = DeviceRaySampler.from_loader(out, num_rays=32)
    batch = sampler.sample(torch.Generator().manual_seed(0))
    assert batch["rgb"].shape == (32, 3) and not sampler.opengl_camera
    np.testing.assert_allclose(batch["rays_d"].norm(dim=-1).numpy(), 1.0, atol=1e-6)


def test_loaders_feed_the_device_sampler(tmp_path, tiny):
    """A Blender train loader's sampler draws batches whose pixels are the
    loader's pixels at the drawn picks over the drawn background."""
    _write_blender_fixture(str(tmp_path))
    ds = Blender("tiny", str(tmp_path), "train", num_rays=16, color_bkgd_aug="random",
                 device="cpu")
    sampler = DeviceRaySampler.from_loader(ds)
    assert sampler.opengl_camera and sampler.num_rays == 16
    ids, x, y = (torch.tensor(a) for a in ([0, 1, 1], [0, 3, 7], [0, 2, 5]))
    bkgd = torch.tensor([0.2, 0.4, 0.6])
    batch = sampler.batch(ids, x, y, bkgd)
    np.testing.assert_allclose(batch["rgb"].numpy(), ds._pixels(ids, x, y, bkgd).numpy(),
                               rtol=0, atol=1e-7)
    o, d = ds._rays_for_pixels(ids.numpy(), x.numpy(), y.numpy())
    np.testing.assert_allclose(batch["rays_d"].numpy(), d.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(batch["rays_o"].numpy(), o.numpy())


def test_a_missing_imageio_says_so(tmp_path, tiny, monkeypatch):
    """Without ``imageio`` a loader raises an ImportError that names it:
    it never yields an empty dataset."""
    _write_blender_fixture(str(tmp_path))
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="imageio"):
        Blender("tiny", str(tmp_path), "test", device="cpu")
    monkeypatch.undo()
    _write_colmap_fixture(str(tmp_path))
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImportError, match="imageio"):
        Loader360("garden", str(tmp_path), "test", device="cpu")
