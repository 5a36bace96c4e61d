"""Port vs JAX: the procedural scene's train split gives the same ray
batches from the same seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.data.procedural import ProceduralSceneLoader as JaxLoader
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)


@pytest.mark.parametrize("color_bkgd_aug", ["white", "black", "random"])
def test_train_batches_match_jax(color_bkgd_aug, monkeypatch):
    monkeypatch.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
    kw = dict(split="train", n_train=3, width=20, height=16, num_rays=64,
              color_bkgd_aug=color_bkgd_aug, seed=7)
    jax_ds, ds = JaxLoader(**kw), ProceduralSceneLoader(**kw, device="cpu")
    assert ds.training and len(ds) == len(jax_ds) == 3
    for _ in range(3):  # consecutive batches: the same rng call sequence
        ref, out = jax_ds[0], ds[0]
        for key in ("rays_o", "rays_d"):
            np.testing.assert_allclose(out[key].numpy(), ref[key], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out["color_bkgd"].numpy(), ref["color_bkgd"])
        # the two ground truths are integrated by each package: 1/255
        np.testing.assert_allclose(out["rgb"].numpy(), ref["rgb"], rtol=0, atol=1 / 255 + 1e-6)
        assert out["rgb"].shape == (64, 3)
    if color_bkgd_aug == "random":
        assert not np.array_equal(out["color_bkgd"].numpy(), ds[0]["color_bkgd"].numpy())


def test_update_num_rays_resizes_the_next_batch():
    ds = ProceduralSceneLoader(
        split="train", n_train=2, width=16, height=16, num_rays=32, device="cpu"
    )
    ds.update_num_rays(48)
    assert ds[0]["rays_o"].shape == (48, 3)
    test = ProceduralSceneLoader(
        split="test", n_test=1, width=16, height=16, num_rays=32, device="cpu"
    )
    assert not test.training and test[0]["rgb"].shape == (256, 3)


@pytest.mark.parametrize("split", ["train", "test"])
def test_dynamic_scene_matches_jax(split, monkeypatch):
    """The moving-blob scene: the same motion draws, frame times, rays and
    per-ray timestamps as the JAX loader, and each view's ground truth
    rendered at its own time within 1/255."""
    from nerfacc_tpu.data.procedural import ProceduralDynamicSceneLoader as JaxDynamic
    from nerfacc_tpu_torch.data.procedural import ProceduralDynamicSceneLoader

    monkeypatch.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
    kw = dict(split=split, n_train=3, n_test=2, width=20, height=16, seed=7)
    if split == "train":
        kw["num_rays"] = 64
    jax_ds, ds = JaxDynamic(**kw), ProceduralDynamicSceneLoader(**kw, device="cpu")
    np.testing.assert_array_equal(ds.view_times, jax_ds.view_times)
    np.testing.assert_array_equal(ds.timestamps.numpy(), np.asarray(jax_ds.timestamps))
    np.testing.assert_array_equal(ds.motion_dirs.numpy(), np.asarray(jax_ds.motion_dirs))
    np.testing.assert_array_equal(ds.motion_phase.numpy(), np.asarray(jax_ds.motion_phase))
    np.testing.assert_allclose(ds.images.numpy(), jax_ds.images, rtol=0, atol=1)
    for i in range(2):
        ref, out = jax_ds[i], ds[i]
        for key in ("rays_o", "rays_d"):
            np.testing.assert_allclose(out[key].numpy(), ref[key], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out["timestamps"].numpy(), ref["timestamps"])
        np.testing.assert_allclose(out["rgb"].numpy(), ref["rgb"], rtol=0, atol=1 / 255 + 1e-6)
    # the blobs move: the first and last views' ground truths see different scenes
    static = ProceduralSceneLoader(**kw, device="cpu")
    assert not np.array_equal(ds.images[-1].numpy(), static.images[-1].numpy())


@pytest.mark.parametrize("split", ["train", "test"])
def test_opaque_scene_matches_jax(split, monkeypatch):
    """The hard-surface scene: the same densities (``default_rng(4321)``),
    its test views' ground truth rendered by each package within 1e-5
    before the uint8 rounding and one level after it, and the same train
    batches; ``PROCEDURAL_SCENES`` holds the JAX package's eight names."""
    from nerfacc_tpu.data.procedural import PROCEDURAL_SCENES as JAX_SCENES
    from nerfacc_tpu_torch.data.procedural import PROCEDURAL_SCENES

    monkeypatch.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
    kw = dict(split=split, n_train=2, n_test=2, width=24, height=20, seed=3)
    if split == "train":
        kw["num_rays"] = 64
    jax_ds = JAX_SCENES["proceduralopaque"](**kw)
    ds = PROCEDURAL_SCENES["proceduralopaque"](**kw, device="cpu")
    assert set(PROCEDURAL_SCENES) == set(JAX_SCENES)
    assert PROCEDURAL_SCENES["procedural"] is ProceduralSceneLoader
    np.testing.assert_array_equal(ds.blob_density.numpy(), np.asarray(jax_ds.blob_density))
    np.testing.assert_array_equal(ds.blob_colors.numpy(), np.asarray(jax_ds.blob_colors))
    x, y = ds._pixel_grid()
    for i in range(len(ds)):
        o, d = ds._rays_for_pixels(np.full_like(x, i), x, y)
        colors, opacities = ds._render_rays_gt(o, d, ds._centers(i))
        ref_c, ref_a = jax_ds._render_rays_gt(jnp.asarray(o.numpy()), jnp.asarray(d.numpy()))
        np.testing.assert_allclose(colors.numpy(), np.asarray(ref_c), rtol=0, atol=1e-5)
        np.testing.assert_allclose(opacities.numpy(), np.asarray(ref_a), rtol=0, atol=1e-5)
    # solid balls: rays through them saturate
    assert float(opacities.max()) > 0.999
    np.testing.assert_allclose(ds.images.numpy(), jax_ds.images, rtol=0, atol=1)
    ref, out = jax_ds[0], ds[0]
    for key in ("rays_o", "rays_d"):
        np.testing.assert_allclose(out[key].numpy(), ref[key], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out["rgb"].numpy(), ref["rgb"], rtol=0, atol=1 / 255 + 1e-6)


@pytest.fixture(scope="module")
def unbounded_pair():
    """The unbounded scene from both packages: train and test splits, 2
    views of 16x16 each, the JAX ground truth rendered (no disk cache)."""
    from nerfacc_tpu.data.procedural import ProceduralUnboundedSceneLoader as JaxUnbounded
    from nerfacc_tpu_torch.data.procedural import ProceduralUnboundedSceneLoader

    kw = dict(n_train=2, n_test=2, width=16, height=16, seed=5)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NERFACC_TPU_GT_CACHE", "")
        jax_train = JaxUnbounded(split="train", num_rays=64, **kw)
        jax_test = JaxUnbounded(split="test", **kw)
    ports = (ProceduralUnboundedSceneLoader(split="train", num_rays=64, device="cpu", **kw),
             ProceduralUnboundedSceneLoader(split="test", device="cpu", **kw))
    return (jax_train, jax_test), ports


def test_unbounded_scene_matches_jax(unbounded_pair):
    """The 360 scene: the camera ring, K, the object and far blobs and the
    ground constants bitwise equal to the JAX loader's; both splits' ground
    truth (two views of 16x16) within one uint8 level; a seeded train batch
    bitwise, on the JAX images; the near and far planes."""
    (jax_train, jax_test), (train, test) = unbounded_pair
    assert (train.NEAR, train.FAR) == (jax_train.NEAR, jax_train.FAR) == (0.05, 20.0)
    for ds, jds in ((train, jax_train), (test, jax_test)):
        assert len(ds) == len(jds) == 2
        np.testing.assert_array_equal(ds.camtoworlds, jds.camtoworlds)
        np.testing.assert_array_equal(ds.K, jds.K)
        np.testing.assert_array_equal(ds.aabb, jds.aabb)
        for name in ("blob_centers", "blob_scales", "blob_density", "blob_colors",
                     "far_centers", "far_scales", "far_density", "far_colors"):
            np.testing.assert_array_equal(getattr(ds, name).numpy(),
                                          np.asarray(getattr(jds, name)), err_msg=name)
        np.testing.assert_allclose(ds.images.numpy(), jds.images, rtol=0, atol=1)
    assert (train.CONTENT_RADIUS, train.GROUND_Z0, train.GROUND_H, train.GROUND_DENSITY) == (
        jax_train.content_radius, jax_train.ground_z0, jax_train.ground_h,
        jax_train.ground_density)
    assert train.GT_FAR_SAMPLES == jax_train._gt_far_samples
    assert train.GT_SAMPLES == jax_train._gt_samples
    assert train.blob_centers.shape == (16, 3) and train.far_centers.shape == (12, 3)
    # the test ring sits half a step from the train ring
    assert not np.array_equal(train.camtoworlds, test.camtoworlds)
    # the ground and the far blobs fill the background: most test pixels
    # are opaque, and the view is not one colour
    alpha = test.images[..., 3].float() / 255
    assert float(alpha.mean()) > 0.5 and float(test.images[..., :3].float().std()) > 5
    train.images = torch.tensor(jax_train.images)
    for _ in range(2):  # consecutive batches: the same rng call sequence
        ref, out = jax_train[0], train[0]
        for key in ("rays_o", "rays_d", "rgb", "color_bkgd"):
            np.testing.assert_array_equal(out[key].numpy(), ref[key], err_msg=key)


def test_unbounded_scene_feeds_the_device_sampler(unbounded_pair):
    """``DeviceRaySampler.from_loader`` takes the unbounded loader as it is:
    its rays and composited colours for given pixels equal the loader's own
    item (colours bit for bit, rays within 1e-6)."""
    from nerfacc_tpu_torch.data.device_sampler import DeviceRaySampler

    _, (train, _) = unbounded_pair
    sampler = DeviceRaySampler.from_loader(train)
    assert sampler.num_rays == 64 and sampler.n_images == 2
    rng = np.random.default_rng(3)
    image_id, x, y = (rng.integers(0, n, size=64) for n in (2, 16, 16))
    bkgd = np.ones(3, np.float32)
    want = train._item(image_id, x, y, bkgd)
    got = sampler.batch(*(torch.tensor(a) for a in (image_id, x, y)), torch.tensor(bkgd))
    assert torch.equal(got["rgb"], want["rgb"])
    for key in ("rays_o", "rays_d"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=0, atol=1e-6)
    batch = sampler.sample(torch.Generator().manual_seed(0))
    assert batch["rgb"].shape == (64, 3) and bool(torch.isfinite(batch["rays_d"]).all())


# the scenes ported with the dynamic example: name -> the constants both
# loaders draw from the scene's own numpy generator
NEW_SCENES = {
    "proceduraltextured": ("tex_freqs", "tex_phases", "tex_weights", "blob_density"),
    "proceduralthin": ("rod_a", "rod_b", "rod_radius", "rod_colors"),
    "proceduralmixed": ("fog_centers", "fog_scales", "fog_density", "fog_colors",
                        "blob_density"),
    "procedurallocaldyn": ("motion_freq", "appear_t0", "appear_t1", "motion_dirs",
                           "motion_phase"),
}


@pytest.mark.parametrize("name", list(NEW_SCENES))
def test_new_scenes_match_jax(name, monkeypatch):
    """``PROCEDURAL_SCENES`` names the JAX package's loader classes by the
    same names (``--scene proceduraltextured`` and ``proceduralthin`` no
    longer fall back to the translucent scene); each new scene's constants
    bitwise, its test views (two of 20x16) within one uint8 level of the
    JAX ground truth and a train batch's rays and per-ray times equal."""
    from nerfacc_tpu.data.procedural import PROCEDURAL_SCENES as JAX_SCENES
    from nerfacc_tpu_torch.data.procedural import PROCEDURAL_SCENES

    monkeypatch.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
    assert list(PROCEDURAL_SCENES) == list(JAX_SCENES)
    for key, cls in PROCEDURAL_SCENES.items():
        assert cls.__name__ == JAX_SCENES[key].__name__, key
    kw = dict(n_train=3, n_test=2, width=20, height=16, seed=3)
    jax_test, test = JAX_SCENES[name](split="test", **kw), PROCEDURAL_SCENES[name](
        split="test", device="cpu", **kw)
    for attr in NEW_SCENES[name]:
        np.testing.assert_array_equal(getattr(test, attr).numpy(),
                                      np.asarray(getattr(jax_test, attr)), err_msg=attr)
    np.testing.assert_allclose(test.images.numpy(), jax_test.images, rtol=0, atol=1)
    assert float(test.images[..., 3].float().mean()) > 10  # something is in view
    jax_train = JAX_SCENES[name](split="train", num_rays=64, **kw)
    train = PROCEDURAL_SCENES[name](split="train", num_rays=64, device="cpu", **kw)
    train.images = torch.tensor(jax_train.images)
    ref, out = jax_train[0], train[0]
    assert set(out) == set(ref)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-6,
                                   err_msg=key)
