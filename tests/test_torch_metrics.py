"""Port vs JAX: image metrics, and the evaluation that reports them."""
import numpy as np
import pytest
import torch

from nerfacc_tpu.utils.metrics import psnr as jax_psnr
from nerfacc_tpu.utils.metrics import ssim as jax_ssim
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer
from nerfacc_tpu_torch.utils.metrics import psnr, ssim
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)


@pytest.mark.parametrize("seed,shape", [(0, (32, 32, 3)), (1, (32, 40, 3)), (2, (16, 16))])
def test_ssim_and_psnr_match_jax(seed, shape):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 1, shape).astype(np.float32)
    img = np.clip(ref + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    out = ssim(torch.tensor(img), torch.tensor(ref))
    assert abs(out - jax_ssim(img, ref)) <= 1e-6
    assert 0.0 < out < 1.0
    assert abs(psnr(torch.tensor(img), torch.tensor(ref)) - jax_psnr(img, ref)) <= 1e-6
    assert abs(ssim(torch.tensor(ref), torch.tensor(ref)) - 1.0) <= 1e-12


def test_ssim_refuses_images_smaller_than_the_window():
    with pytest.raises(ValueError):
        ssim(torch.zeros(8, 8, 3), torch.zeros(8, 8, 3))


def test_eval_metrics_reports_ssim():
    ds = ProceduralSceneLoader(split="test", width=16, height=16, n_test=2, device="cpu")
    trainer = NGPOccTrainer(
        field=CPRadianceField(AABB, resolutions=(16, 32, 64), ranks=(8, 8, 8)),
        aabb=AABB, grid_resolution=32, device="cpu",
    )
    state = trainer.refresh_occ_grid(trainer.init_state(), 0)
    m = trainer.eval_metrics(state, ds)
    assert set(m) == {"psnr", "ssim", "views"}
    h, w = ds.HEIGHT, ds.WIDTH
    colors = trainer.render_image(state, ds[1])
    view = ssim(colors.reshape(h, w, 3), ds[1]["rgb"].reshape(h, w, 3))
    assert m["views"][1]["ssim"] == pytest.approx(view, abs=1e-12)
    assert m["ssim"] == pytest.approx(np.mean([v["ssim"] for v in m["views"]]))
    assert -1.0 < m["ssim"] < 1.0
