"""The port's device ray sampler against the host loaders' batch math, the
port's and the JAX package's (mirrors tests/test_device_sampler.py): for
given (image, x, y) pixels, the same rays and the same composited RGB."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.data import DeviceRaySampler as JaxSampler
from nerfacc_tpu.data.procedural import ProceduralSceneLoader as JaxLoader
from nerfacc_tpu_torch.data.device_sampler import DeviceRaySampler
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)


def _loader():
    return ProceduralSceneLoader(
        split="train", num_rays=64, width=32, height=24, n_train=3, seed=0, device="cpu"
    )


def _pixels(seed, ds, n=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, len(ds), size=(n,)), rng.integers(0, ds.WIDTH, size=(n,)),
            rng.integers(0, ds.HEIGHT, size=(n,)))


def test_rays_match_host_loader_and_jax_sampler(monkeypatch):
    """Origins and directions within 1e-6 of the port's host loader (numpy
    math) and of the JAX device sampler on the same camera rig."""
    ds = _loader()
    sampler = DeviceRaySampler.from_loader(ds)
    image_id, x, y = _pixels(1, ds)
    o_host, d_host = ds._rays_for_pixels(image_id, x, y)
    o, d = sampler.rays(*(torch.tensor(a) for a in (image_id, x, y)))
    np.testing.assert_allclose(o.numpy(), o_host.numpy(), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), d_host.numpy(), atol=1e-6)
    monkeypatch.setenv("NERFACC_TPU_GT_CACHE", "")
    jds = JaxLoader(split="train", num_rays=64, width=32, height=24, n_train=3, seed=0)
    jsampler = JaxSampler.from_loader(jds, num_rays=64)
    o_jax, d_jax = jsampler._rays(jsampler.arrays, *(jnp.asarray(a) for a in (image_id, x, y)))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_jax), atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_jax), atol=1e-6)


@pytest.mark.parametrize("color_bkgd_aug", ["white", "black"])
def test_pixels_match_host_compositing(color_bkgd_aug):
    """The batch's RGB over its background equals the host loader's item for
    the same pixels, bit for bit (the same uint8 table and arithmetic)."""
    ds = _loader()
    sampler = DeviceRaySampler.from_loader(ds)
    sampler.color_bkgd_aug = color_bkgd_aug
    image_id, x, y = _pixels(2, ds)
    bkgd = np.ones(3, np.float32) if color_bkgd_aug == "white" else np.zeros(3, np.float32)
    want = ds._item(image_id, x, y, bkgd)
    got = sampler.batch(*(torch.tensor(a) for a in (image_id, x, y)), torch.tensor(bkgd))
    assert torch.equal(got["rgb"], want["rgb"])
    np.testing.assert_allclose(got["rays_d"].numpy(), want["rays_d"].numpy(), atol=1e-6)


def test_sample_draws_from_the_generator():
    """Shapes, ranges and unit directions; the same generator seed gives
    the same batch, another seed another."""
    ds = _loader()
    sampler = DeviceRaySampler.from_loader(ds, num_rays=128)
    sampler.color_bkgd_aug = "random"
    a = sampler.sample(torch.Generator().manual_seed(0))
    b = sampler.sample(torch.Generator().manual_seed(0))
    c = sampler.sample(torch.Generator().manual_seed(1))
    assert a["rgb"].shape == a["rays_o"].shape == a["rays_d"].shape == (128, 3)
    assert a["color_bkgd"].shape == (3,)
    assert all(torch.equal(a[k], b[k]) for k in a) and not torch.equal(a["rgb"], c["rgb"])
    np.testing.assert_allclose(torch.linalg.norm(a["rays_d"], dim=-1).numpy(), 1.0, atol=1e-5)
    assert (a["rgb"] >= 0).all() and (a["rgb"] <= 1).all()


def test_contract_checks():
    """A test split carries no ray count; RGB images get an opaque alpha;
    the int32 flat pixel index bounds the image set."""
    test = ProceduralSceneLoader(split="test", n_test=1, width=8, height=8, device="cpu")
    with pytest.raises(ValueError, match="num_rays"):
        DeviceRaySampler.from_loader(test)
    rgb = torch.randint(0, 256, (2, 4, 5, 3), dtype=torch.uint8)
    s = DeviceRaySampler(rgb, np.tile(np.eye(4, dtype=np.float32), (2, 1, 1)), np.eye(3), 8, device="cpu")
    assert s.pixels.shape == (40, 4) and (s.pixels[:, 3] == 255).all()
    big = torch.zeros((1, 1, 1, 4), dtype=torch.uint8).expand(2**16, 2**8, 2**7, 4)
    with pytest.raises(AssertionError, match="int32"):
        DeviceRaySampler(big, np.tile(np.eye(4, dtype=np.float32), (2**16, 1, 1)), np.eye(3), 8, device="cpu")


def test_with_num_rays_shares_the_tables_and_one_clone_per_count():
    """Resized samplers read the base sampler's staged tables (no copy), and
    one dict of clones is shared by the base and every clone: a clone of a
    clone is the object the base gives for that count."""
    base = DeviceRaySampler.from_loader(_loader())
    a = base.with_num_rays(96)
    b = a.with_num_rays(128)
    assert b is base.with_num_rays(128) and a is b.with_num_rays(96)
    assert a.with_num_rays(64) is base and base.with_num_rays(64) is base
    assert (a.num_rays, b.num_rays, base.num_rays) == (96, 128, 64)
    for s in (a, b):
        for name in ("pixels", "c2w", "K"):
            assert getattr(s, name).data_ptr() == getattr(base, name).data_ptr()
    batch = b.sample(torch.Generator().manual_seed(0))
    assert batch["rays_o"].shape == (128, 3) and batch["rgb"].shape == (128, 3)
