"""Port vs JAX: the pose tools (the SE(3) exponential map and its gradient
at the identity, composition, noise from injected twists, the Sim3-aligned
registration errors, the coarse-to-fine schedule) and the sinusoidal
encoder's coarse-to-fine window, from numpy-seeded inputs.

Bounds.  The pose maps within 2e-6 of JAX's ``precision="highest"`` f32
(XLA sums the 3x3 products in another order, and its f32 sine and cosine
round apart from the port's, taken in f64 and rounded once); their
gradients within 1e-5 relative, finite at the identity; the registration
errors (f64 numpy in both) within 1e-9; the schedule bitwise the jitted one;
the windowed encoding within 2e-6 of its scale (JAX's f32 cosine against
the port's, rounded once from f64), the identity part bitwise.  The pose
math's precision floor of tests/test_pose.py:113 is held here on the CPU
and, with TF32 where it exists, on the card by chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models import pose as jax_pose
from nerfacc_tpu.models.encoders import SinusoidalEncoder as JaxSinusoidal
from nerfacc_tpu_torch.models import pose
from nerfacc_tpu_torch.models.encoders import SinusoidalEncoder
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)


def _twists(seed=0, n=64, scale=0.5):
    """(n, 6) twists: large, small (Taylor branch) and exactly zero ones."""
    rng = np.random.default_rng(seed)
    xi = (scale * rng.standard_normal((n, 6))).astype(np.float32)
    xi[:8, :3] *= 1e-5  # theta^2 < 1e-8: the Taylor branch
    xi[8:12] = 0.0
    return xi


def _rotations(seed, n):
    rng = np.random.default_rng(seed)
    c2w = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        w = rng.normal(size=3)
        c2w[i, :, :3] = np.asarray(jax_pose.se3_exp(jnp.asarray(np.r_[w, 0, 0, 0],
                                                                jnp.float32)))[:, :3]
        c2w[i, :, 3] = 4.0 * rng.normal(size=3)
    return c2w


def test_se3_exp_and_compose_match_jax():
    xi = _twists()
    ref = np.asarray(jax_pose.se3_exp(jnp.asarray(xi)))
    out = pose.se3_exp(torch.tensor(xi)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)
    np.testing.assert_array_equal(out[8:12], np.broadcast_to(np.eye(3, 4), (4, 3, 4)))
    c2w = _rotations(1, len(xi))
    ref = np.asarray(jax_pose.compose_pose(jax_pose.se3_exp(jnp.asarray(xi)),
                                           jnp.asarray(c2w)))
    got = pose.compose_pose(pose.se3_exp(torch.tensor(xi)), torch.tensor(c2w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6 * np.abs(ref).max())


def test_se3_exp_gradient_matches_jax_and_is_finite_at_the_identity():
    """The gradient of a weighted sum of the transforms, at large, small
    and zero twists: the exact branch divides by 1 where the Taylor branch
    is taken, so no NaN reaches the gradient at xi = 0."""
    xi = _twists(2)
    w = np.random.default_rng(3).standard_normal((len(xi), 3, 4)).astype(np.float32)
    ref = np.asarray(jax.grad(lambda x: jnp.sum(jax_pose.se3_exp(x) * w))(jnp.asarray(xi)))
    t = torch.tensor(xi, requires_grad=True)
    (pose.se3_exp(t) * torch.tensor(w)).sum().backward()
    got = t.grad.numpy()
    assert np.isfinite(got).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    zero = torch.zeros(3, 6, requires_grad=True)
    pose.se3_exp(zero).sum().backward()
    assert torch.isfinite(zero.grad).all()


def test_perturb_poses_from_injected_twists_and_the_registration_errors():
    """JAX's draw fed in as the twists gives JAX's noisy poses; the Sim3
    registration errors of those poses, and the port's own draw reads
    about the same error size."""
    c2w = _rotations(4, 24)
    noisy_ref, xi = jax_pose.perturb_poses(jax.random.PRNGKey(0), jnp.asarray(c2w), 0.05, 0.05)
    noisy, xi_out = pose.perturb_poses(torch.tensor(c2w), xi=torch.tensor(np.asarray(xi)))
    np.testing.assert_array_equal(xi_out.numpy(), np.asarray(xi))
    np.testing.assert_allclose(noisy.numpy(), np.asarray(noisy_ref), rtol=0, atol=1e-5)
    err_ref = jax_pose.pose_registration_errors(np.asarray(noisy_ref), c2w)
    err = pose.pose_registration_errors(noisy, torch.tensor(c2w))
    for k in ("rot_deg", "trans"):
        assert err[k] == pytest.approx(err_ref[k], rel=1e-4)
    same = pose.pose_registration_errors(np.asarray(noisy_ref), c2w)
    for k in ("rot_deg", "trans"):
        assert same[k] == pytest.approx(err_ref[k], rel=0, abs=1e-9)
    s, R, t = pose.umeyama_alignment(c2w[:, :, 3], 2.0 * c2w[:, :, 3] + 1.0)
    s_ref, R_ref, t_ref = jax_pose.umeyama_alignment(c2w[:, :, 3], 2.0 * c2w[:, :, 3] + 1.0)
    assert s == pytest.approx(s_ref, abs=1e-12)
    np.testing.assert_allclose(R, R_ref, atol=1e-12)
    np.testing.assert_allclose(t, t_ref, atol=1e-12)
    drawn, _ = pose.perturb_poses(torch.tensor(c2w), 0.05, 0.05,
                                  generator=torch.Generator().manual_seed(0))
    own = pose.pose_registration_errors(drawn, c2w)
    assert 0.5 < own["rot_deg"] < 10.0 and err_ref["rot_deg"] > 0.5


def test_pose_math_precision_floor():
    """tests/test_pose.py:113 on the port: 1e-4 rad of noise (~0.009 deg)
    reads back within 3x of its applied magnitude plus 0.02 deg, where
    bf16-rounded pose math read ~1.2 deg."""
    rng = np.random.default_rng(11)
    c2w = _rotations(11, 24)
    xi = torch.tensor(1e-4 * rng.standard_normal((24, 6)), dtype=torch.float32)
    noisy, _ = pose.perturb_poses(torch.tensor(c2w), xi=xi)
    err = pose.pose_registration_errors(noisy, c2w)
    applied = float(np.degrees(np.linalg.norm(xi[:, :3].numpy(), axis=-1).mean()))
    assert err["rot_deg"] < 3.0 * applied + 0.02, (err, applied)


def test_coarse_to_fine_alpha_matches_jax():
    for max_steps, start, end in ((1000, 0.1, 0.5), (80, 0.1, 0.5), (7, 0.0, 0.0), (30, 0.2, 0.9)):
        for step in range(0, max_steps + 3):
            ref = float(jax.jit(jax_pose.coarse_to_fine_alpha, static_argnums=(1, 2, 3, 4))(
                jnp.float32(step), max_steps, 10, start, end))
            got = float(pose.coarse_to_fine_alpha(step, max_steps, 10, start, end))
            assert got == ref, (max_steps, step)


@pytest.mark.parametrize("alpha", [0.0, 0.3, 2.75, 6.0, 10.0, None])
def test_windowed_encoder_matches_jax(alpha):
    """Band k weighted by ``(1 - cos(pi clip(alpha - k, 0, 1))) / 2`` on its
    sines and cosines alike, degree-major; the identity never windowed;
    ``alpha=None`` the full spectrum."""
    x = np.random.default_rng(5).uniform(-1.5, 1.5, (512, 3)).astype(np.float32)
    jenc = JaxSinusoidal(3, 0, 10, True)
    a = None if alpha is None else jnp.float32(alpha)
    ref = np.asarray(jax.jit(lambda v, a: jenc(v, alpha=a))(jnp.asarray(x), a))
    enc = SinusoidalEncoder(3, 0, 10, True)
    got = enc(torch.tensor(x), alpha).numpy()
    np.testing.assert_array_equal(got[:, :3], x)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)
    if alpha == 0.0:
        assert not got[:, 3:].any()
    if alpha is not None:
        tensor_alpha = enc(torch.tensor(x), torch.tensor(alpha, dtype=torch.float32)).numpy()
        np.testing.assert_array_equal(tensor_alpha, got)
