"""Port vs JAX: the procedural scene's train split gives the same ray
batches from the same seed."""
import numpy as np
import pytest

from nerfacc_tpu.data.procedural import ProceduralSceneLoader as JaxLoader
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader


@pytest.mark.parametrize("color_bkgd_aug", ["white", "black", "random"])
def test_train_batches_match_jax(color_bkgd_aug, monkeypatch):
    monkeypatch.setenv("NERFACC_TPU_GT_CACHE", "")  # render, do not cache on disk
    kw = dict(split="train", n_train=3, width=20, height=16, num_rays=64,
              color_bkgd_aug=color_bkgd_aug, seed=7)
    jax_ds, ds = JaxLoader(**kw), ProceduralSceneLoader(**kw)
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
    ds = ProceduralSceneLoader(split="train", n_train=2, width=16, height=16, num_rays=32)
    ds.update_num_rays(48)
    assert ds[0]["rays_o"].shape == (48, 3)
    test = ProceduralSceneLoader(split="test", n_test=1, width=16, height=16, num_rays=32)
    assert not test.training and test[0]["rgb"].shape == (256, 3)
