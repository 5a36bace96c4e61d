"""Port vs JAX: the procedural scene's train split gives the same ray
batches from the same seed."""
import jax.numpy as jnp
import numpy as np
import pytest

from nerfacc_tpu.data.procedural import ProceduralSceneLoader as JaxLoader
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader


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
    batches; ``PROCEDURAL_SCENES`` names both ported scenes."""
    from nerfacc_tpu.data.procedural import PROCEDURAL_SCENES as JAX_SCENES
    from nerfacc_tpu_torch.data.procedural import PROCEDURAL_SCENES

    monkeypatch.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
    kw = dict(split=split, n_train=2, n_test=2, width=24, height=20, seed=3)
    if split == "train":
        kw["num_rays"] = 64
    jax_ds = JAX_SCENES["proceduralopaque"](**kw)
    ds = PROCEDURAL_SCENES["proceduralopaque"](**kw, device="cpu")
    assert set(PROCEDURAL_SCENES) == {"procedural", "proceduralopaque"}
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
