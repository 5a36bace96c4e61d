"""Port vs JAX: the reference-compatible traversals (``traverse_grids``,
``traverse_grids_voxel``, ``TraversalResult``) on the cases of
tests/test_voxel_traversal.py and with a step limit, and the lens
undistortion functions on tests/test_camera.py's inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu import cameras as jax_cameras
from nerfacc_tpu.grid import traverse_grids as jax_traverse_grids
from nerfacc_tpu.grid import traverse_grids_voxel as jax_traverse_grids_voxel
from nerfacc_tpu_torch import (
    TraversalResult,
    opencv_lens_undistortion,
    opencv_lens_undistortion_12,
    opencv_lens_undistortion_fisheye,
    traverse_grids,
    traverse_grids_voxel,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)


def _scene(n_rays=32, res=16, seed=0, occ_frac=0.3, levels=1):
    """tests/test_voxel_traversal.py's scene (rays from a sphere of radius
    2.5 towards the origin, a random grid), with ``levels`` cascade levels."""
    rng = np.random.default_rng(seed)
    bins = rng.random((levels, res, res, res)) < occ_frac
    aabbs = np.stack([np.array([-1.0, -1, -1, 1, 1, 1]) * 2**i for i in range(levels)])
    o = rng.normal(size=(n_rays, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.5
    d = -o + rng.normal(size=(n_rays, 3)) * 0.2
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return [a.astype(np.float32) if a.dtype != bool else a for a in (bins, aabbs, o, d)]


def _diagonal():
    """One ray along the diagonal of a full 128^3 grid (its voxel
    truncation case)."""
    d = np.asarray([1.0, 1.0, 1.0]) / np.sqrt(3.0)
    bins = np.ones((1, 128, 128, 128), bool)
    aabbs = np.array([[-1.0, -1, -1, 1, 1, 1]], np.float32)
    return bins, aabbs, (-2.0 * d)[None].astype(np.float32), d[None].astype(np.float32)


def _both(fn_jax, fn_port, arrays, **kw):
    bins, aabbs, o, d = arrays
    ref = fn_jax(jnp.asarray(o), jnp.asarray(d), jnp.asarray(bins), jnp.asarray(aabbs), **kw)
    out = fn_port(torch.tensor(o), torch.tensor(d), torch.tensor(bins), torch.tensor(aabbs),
                  **{k: torch.tensor(np.asarray(v)) if isinstance(v, jax.Array) else v
                     for k, v in kw.items()})
    return ref, out


@pytest.mark.parametrize("case", ["seed0", "seed1", "levels2", "levels3", "diagonal-1024",
                                  "diagonal-256", "diagonal-resume"])
def test_traverse_grids_voxel_matches_jax_bitwise(case):
    """Every field of the result bit for bit, the truncated diagonal and
    its resumption from the termination plane included (the plane
    crossings as fused multiply-adds, as XLA computes them)."""
    kw = {}
    if case.startswith("diagonal"):
        arrays, kw["max_edges"] = _diagonal(), 256 if case != "diagonal-1024" else 1024
        if case == "diagonal-resume":
            part, _ = _both(jax_traverse_grids_voxel, traverse_grids_voxel, arrays, **kw)
            assert not bool(part.terminated[0])
            kw["near_planes"] = part.termination_planes
    else:
        seed, levels = {"seed0": (0, 1), "seed1": (1, 1), "levels2": (2, 2),
                        "levels3": (3, 3)}[case]
        arrays = _scene(seed=seed, levels=levels)
        kw["max_edges"] = 512 if levels == 1 else 128 * levels
    ref, out = _both(jax_traverse_grids_voxel, traverse_grids_voxel, arrays, **kw)
    assert isinstance(out, TraversalResult)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(ref, name)),
                                      err_msg=name)
    assert out.valid.any()


@pytest.mark.parametrize("step,cone,limit,levels", [
    (0.0, 0.0, None, 1), (0.0, 0.0, 3, 2), (0.02, 0.0, None, 1), (0.02, 0.01, 5, 2),
    (0.01, 0.004, None, 3),
], ids=["voxel", "voxel-limit", "uniform", "cone-limit", "cone"])
def test_traverse_grids_matches_jax(step, cone, limit, levels):
    """``traverse_grids`` with 300 candidates a ray (``step_size`` 0: one
    interval a voxel crossing; ``traverse_steps_limit`` caps the samples a
    ray and ends it after its last): the masks ``is_left`` / ``is_right`` /
    ``is_valid`` equal, the edges, midpoints and termination planes within
    5e-7 (the cone orbit's power rounds apart by an ulp, exact
    otherwise); ``over_allocate`` changes nothing."""
    arrays = _scene(seed=4 + levels, levels=levels)
    kw = dict(step_size=step, cone_angle=cone, max_samples=300, traverse_steps_limit=limit)
    (ji, js, jterm), (ti, ts, tterm) = _both(jax_traverse_grids, traverse_grids, arrays, **kw)
    for got, want in ((ti.is_left, ji.is_left), (ti.is_right, ji.is_right),
                      (ts.is_valid, js.is_valid)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in ((ti.vals, ji.vals), (ts.vals, js.vals), (tterm, jterm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-7)
    np.testing.assert_array_equal(ts.ray_indices.numpy(), np.asarray(js.ray_indices))
    assert ts.is_valid.any()
    if limit is not None:
        assert int(ts.is_valid.sum(-1).max()) == limit
    again = traverse_grids(*(torch.tensor(a) for a in (arrays[2], arrays[3], arrays[0], arrays[1])),
                           over_allocate=True, **kw)
    assert torch.equal(again[1].is_valid, ts.is_valid)


def test_opencv_undistortion_matches_jax():
    """tests/test_camera.py's round trips: the 8-parameter model (and its
    1, 2 and 4 parameter prefixes, zero-padded) and the fisheye model
    within 5e-7 of JAX's (XLA fuses some of the Newton step's
    multiply-adds), the 12-parameter model's fixed point bitwise; each
    recovers the undistorted points within 1e-5; no gradient."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(42))
    x = jax.random.uniform(k1, (3, 1000, 2), minval=-1.0, maxval=1.0)
    params = jax.random.uniform(k2, (8,), minval=-0.01, maxval=0.01)
    xd = jax_cameras._opencv_lens_distortion(x, params)
    for n in (1, 2, 4, 8):
        want = jax_cameras.opencv_lens_undistortion(xd, params[:n], 1e-10, 10)
        got = opencv_lens_undistortion(torch.tensor(np.asarray(xd)).requires_grad_(True),
                                       torch.tensor(np.asarray(params[:n])), 1e-10, 10)
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-7)
    np.testing.assert_allclose(got.numpy(), np.asarray(x), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        opencv_lens_undistortion(torch.tensor(np.asarray(xd)), torch.zeros(0)).numpy(),
        np.asarray(xd))

    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    x = jax.random.uniform(k1, (1000, 2), minval=-0.5, maxval=0.5)
    params = jax.random.uniform(k2, (4,), minval=-0.01, maxval=0.01)
    xd = jax_cameras._opencv_lens_distortion_fisheye(x, params)
    want = jax_cameras.opencv_lens_undistortion_fisheye(xd, params, 1e-10, 20)
    got = opencv_lens_undistortion_fisheye(torch.tensor(np.asarray(xd)),
                                           torch.tensor(np.asarray(params)), 1e-10, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=5e-7)
    np.testing.assert_allclose(got.numpy(), np.asarray(x), rtol=0, atol=1e-5)

    uv = np.random.default_rng(0).uniform(-0.4, 0.4, (128, 2)).astype(np.float32)
    params = np.asarray([1e-2, -2e-3, 1e-4, 5e-3, -1e-3, 1e-4, 1e-3, -5e-4,
                         2e-4, -1e-4, 1e-4, 5e-5], np.float32)
    distorted = jax_cameras._opencv_lens_distortion_12(jnp.asarray(uv), jnp.asarray(params))
    want = jax_cameras.opencv_lens_undistortion_12(distorted, jnp.asarray(params))
    got = opencv_lens_undistortion_12(torch.tensor(np.asarray(distorted)), torch.tensor(params))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(got.numpy(), uv, rtol=0, atol=1e-5)


def test_undistortion_keeps_full_f32_and_restores_tf32(monkeypatch):
    """The functions turn TF32 off while they run (seen from inside the
    Newton step) and put the caller's setting back."""
    import nerfacc_tpu_torch.cameras as cameras

    seen = []
    inner = cameras._compute_residual_and_jacobian

    def spy(*args):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return inner(*args)

    monkeypatch.setattr(cameras, "_compute_residual_and_jacobian", spy)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    opencv_lens_undistortion(torch.zeros(4, 2), torch.full((4,), 1e-3))
    assert seen == [False] * 10 and torch.backends.cuda.matmul.allow_tf32
