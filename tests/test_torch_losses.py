"""Port vs JAX: the distortion regulariser (nerfacc_tpu_torch/losses.py),
its values and gradients, on sorted ray ids and on runs out of order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.losses import distortion as jax_distortion
from nerfacc_tpu_torch.losses import distortion
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)


@pytest.mark.parametrize("order", ["sorted", "runs"])
@pytest.mark.parametrize("masked", [False, True])
def test_distortion_matches_jax(order, masked):
    """Per-ray losses within 1e-6 (1e-5 relative); the gradients for the
    weights and both bounds within 1e-5 of their largest entry."""
    rng = np.random.default_rng(3)
    counts = np.array([5, 0, 9, 1, 12, 3])
    ids = np.repeat(np.arange(6), counts).astype(np.int32)
    if order == "runs":  # ray 2 split in two runs, rays interleaved
        perm = np.r_[5:10, 0:5, 14:26, 10:14, 26:29]
        ids = ids[perm]
    n = ids.shape[0]
    dt = rng.uniform(0.01, 0.2, n).astype(np.float32)
    t1 = (2.0 + np.cumsum(dt)).astype(np.float32)
    t0 = (t1 - dt).astype(np.float32)
    w = rng.uniform(0, 0.3, n).astype(np.float32)
    masks = rng.uniform(size=n) > 0.25 if masked else None

    def jax_loss(w, a, b):
        return jax_distortion(w, a, b, jnp.asarray(ids), 6,
                              None if masks is None else jnp.asarray(masks))

    want = jax_loss(*(jnp.asarray(v) for v in (w, t0, t1)))
    cot = rng.normal(size=(6, 1)).astype(np.float32)
    want_g = jax.grad(lambda *v: jnp.sum(jax_loss(*v) * cot), argnums=(0, 1, 2))(
        *(jnp.asarray(v) for v in (w, t0, t1)))
    tw, ta, tb = (torch.tensor(v, requires_grad=True) for v in (w, t0, t1))
    got = distortion(tw, ta, tb, torch.tensor(ids), 6,
                     None if masks is None else torch.tensor(masks))
    assert got.shape == (6, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    (got * torch.tensor(cot)).sum().backward()
    for g, wg in zip((tw.grad, ta.grad, tb.grad), want_g):
        wg = np.asarray(wg)
        np.testing.assert_allclose(g.numpy(), wg, rtol=0, atol=1e-5 * np.abs(wg).max())
