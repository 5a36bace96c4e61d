"""Port vs JAX: sorted-segment compositing (kernels G3/G5's twins) against
render_weight_from_density(indices_sorted=True) + segment_sum_sorted, and
its gradients against jax.grad through them."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.ops.sorted_segments import segment_sum_sorted as jax_segment_sum
from nerfacc_tpu.volrend import render_weight_from_density as jax_weights
from nerfacc_tpu_torch.ops.sorted_segments import (
    composite_sorted,
    composite_sorted_backward_plain,
    composite_sorted_plain,
    exclusive_sum_sorted,
)


def _buffer(seed, n_rays, n_fill, max_sigma_exp):
    """A sorted flat buffer: empty rays, then ``n_fill`` trailing fill slots
    (ray id n_rays), as a budgeted JAX buffer has."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 40, n_rays)
    counts[::7] = 0  # empty rays
    ids = np.concatenate(
        [np.repeat(np.arange(n_rays), counts), np.full(n_fill, n_rays)]
    ).astype(np.int32)
    n = ids.shape[0]
    dt = rng.uniform(4e-3, 6e-3, n).astype(np.float32)
    t0 = np.zeros(n, np.float32)
    for r in range(n_rays):
        sel = ids == r
        t0[sel] = 2.0 + np.cumsum(dt[sel]) - dt[sel]
    t1 = (t0 + dt).astype(np.float32)
    sigmas = (10.0 ** rng.uniform(-1, max_sigma_exp, n)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ends = np.cumsum(counts)
    seg_starts = (ends - counts).astype(np.int32)
    seg_ends = (ends - 1).astype(np.int32)
    return ids, t0, t1, sigmas, rgbs, seg_starts, seg_ends


def _oracle(ids, t0, t1, sigmas, rgbs, n_rays, prefix):
    """float64 per-segment weights and per-ray sums."""
    sdt = np.minimum(sigmas.astype(np.float64) * (t1 - t0), 40.0)
    w = np.zeros_like(sdt)
    for r in range(n_rays):
        sel = ids == r
        excl = np.cumsum(sdt[sel]) - sdt[sel]
        p = 1.0 if prefix is None else prefix[r]
        w[sel] = p * np.exp(-excl) * (1.0 - np.exp(-sdt[sel]))
    t_mid = 0.5 * (t0.astype(np.float64) + t1)
    packed = np.concatenate([rgbs, np.ones_like(t_mid[:, None]), t_mid[:, None]], -1)
    acc = np.zeros((n_rays, 5))
    valid = ids < n_rays
    np.add.at(acc, ids[valid], w[valid, None] * packed[valid])
    return w, acc


# max_sigma_exp 13 reaches the trunc_exp cap (1e13), the optical-depth cap
# regime of tests/test_rendering.py::test_extreme_density_weights_bounded.
# There the JAX reference's block-decomposed exclusive sum is itself only
# within ~eps * (sum over a 128-slot block) ~ 1e-3 of the exact value (the
# bound that test asserts), so the port is held to 1e-5 against a float64
# per-segment oracle and to JAX's own 1e-3 against JAX.
@pytest.mark.parametrize(
    "max_sigma_exp,n_fill,with_prefix,jax_tol",
    [(2, 0, False, 1e-5), (2, 37, True, 1e-5), (13, 11, False, 1e-3),
     (13, 0, True, 1e-3)],
)
def test_composite_matches_jax(max_sigma_exp, n_fill, with_prefix, jax_tol):
    n_rays = 64
    ids, t0, t1, sigmas, rgbs, ss, se = _buffer(
        max_sigma_exp + n_fill, n_rays, n_fill, max_sigma_exp
    )
    valid = ids < n_rays
    prefix = None
    if with_prefix:
        prefix = np.random.default_rng(1).uniform(0.2, 1.0, n_rays).astype(np.float32)

    w_ref, _, _ = jax_weights(
        jnp.asarray(t0), jnp.asarray(t1), jnp.asarray(sigmas),
        ray_indices=jnp.asarray(ids), n_rays=n_rays, masks=jnp.asarray(valid),
        prefix_trans=(
            None if prefix is None
            else jnp.asarray(prefix[np.minimum(ids, n_rays - 1)])
        ),
        indices_sorted=True, seg_starts=jnp.asarray(ss), seg_ends=jnp.asarray(se),
    )
    t_mid = 0.5 * (t0 + t1)
    packed = np.concatenate([rgbs, np.ones_like(t_mid[:, None]), t_mid[:, None]], -1)
    acc_ref = np.asarray(
        jax_segment_sum(
            w_ref[:, None] * jnp.asarray(packed), jnp.asarray(ids), n_rays,
            jnp.asarray(ss), jnp.asarray(se),
        )
    )
    w_64, acc_64 = _oracle(ids, t0, t1, sigmas, rgbs, n_rays, prefix)

    colors, opacities, depths, weights = composite_sorted(
        torch.tensor(t0), torch.tensor(t1), torch.tensor(sigmas),
        torch.tensor(rgbs), torch.tensor(ids), n_rays, torch.tensor(ss),
        torch.tensor(se), None if prefix is None else torch.tensor(prefix),
        return_weights=True,
    )
    acc = torch.cat([colors, opacities, depths], -1).numpy()
    for ref_w, ref_acc, tol in ((w_ref, acc_ref, jax_tol), (w_64, acc_64, 1e-5)):
        np.testing.assert_allclose(weights.numpy(), np.asarray(ref_w), atol=tol, rtol=1e-5)
        np.testing.assert_allclose(acc[:, :4], ref_acc[:, :4], atol=tol, rtol=1e-5)
        np.testing.assert_allclose(acc[:, 4], ref_acc[:, 4], atol=10 * tol, rtol=1e-5)
    assert (weights.numpy()[~valid] == 0).all()  # fill slots are never written
    empty = (se - ss + 1) == 0
    assert (opacities.numpy()[empty] == 0).all()
    bound = 1.0 if prefix is None else prefix[:, None]
    assert (opacities.numpy() <= bound + 1e-6).all()


def test_exclusive_sum_is_segment_local():
    """Each ray's exclusive sum restarts at its first slot, whatever the
    magnitude of the rays before it (the global-cumsum failure mode)."""
    ids = torch.tensor([0, 0, 0, 2, 2, 3], dtype=torch.int32)
    vals = torch.tensor([1e6, 1e6, 1e6, 0.5, 0.25, 7.0])
    ss = torch.tensor([0, 3, 3, 5], dtype=torch.int32)
    se = torch.tensor([2, 2, 4, 5], dtype=torch.int32)
    out = exclusive_sum_sorted(vals, ids, 4, ss, se)
    torch.testing.assert_close(
        out, torch.tensor([0.0, 1e6, 2e6, 0.0, 0.5, 0.0]), rtol=0, atol=0
    )


def _jax_sums(t0, t1, ids, n_rays, ss, se, sigmas, rgbs):
    """JAX's compositing of a sorted buffer: (n_rays, 5) rgb, opacity and
    depth sums, differentiable in sigmas and rgbs."""
    valid = jnp.asarray(ids) < n_rays
    w, _, _ = jax_weights(
        jnp.asarray(t0), jnp.asarray(t1), sigmas, ray_indices=jnp.asarray(ids),
        n_rays=n_rays, masks=valid, indices_sorted=True,
        seg_starts=jnp.asarray(ss), seg_ends=jnp.asarray(se),
    )
    t_mid = jnp.asarray(0.5 * (t0 + t1))
    packed = jnp.concatenate([rgbs, jnp.ones_like(t_mid[:, None]), t_mid[:, None]], -1)
    return jax_segment_sum(
        w[:, None] * packed, jnp.asarray(ids), n_rays, jnp.asarray(ss), jnp.asarray(se)
    )


def _cut(ids, t0, t1, sigmas, rgbs, ss, se, budget):
    """The buffer cut at ``budget`` slots, with the JAX budget contract's
    segment bounds: the rays after the cut are empty."""
    n_rays = ss.shape[0]
    counts = (se - ss + 1).clip(min=0)
    ends = np.cumsum(counts)
    ss = np.minimum(ends - counts, budget).astype(np.int32)
    se = (np.minimum(ends, budget) - 1).astype(np.int32)
    return ids[:budget], t0[:budget], t1[:budget], sigmas[:budget], rgbs[:budget], ss, se


def _autograd_f64(t0, t1, ids, n_rays, ss, se, sigmas, rgbs, cot):
    """float64 oracle: autograd through the plain forward."""
    s = torch.tensor(sigmas, dtype=torch.float64, requires_grad=True)
    r = torch.tensor(rgbs, dtype=torch.float64, requires_grad=True)
    T = torch.tensor
    out = composite_sorted_plain(
        T(t0).double(), T(t1).double(), s, r, T(ids), n_rays, T(ss), T(se)
    )
    (torch.cat(out[:3], -1) * T(cot).double()).sum().backward()
    return s.grad.numpy(), r.grad.numpy()


# Cases: empty rays and fill slots (seed 2's buffer); a buffer cut by a
# budget, so later rays are empty and one is partial; densities up to 1e13,
# past the sigma*dt cap at 40, where the capped samples get no density
# gradient; single-sample rays.  Against a float64 oracle the port is held
# to 1e-5 of the largest gradient, and so against JAX, except at 1e13
# densities: there JAX's block-decomposed forward is itself only within
# ~1e-3 (test_composite_matches_jax above), and its gradient with it.
@pytest.mark.parametrize("case,jax_tol", [
    ("fill", 1e-5), ("cut", 1e-5), ("hard", 1e-3), ("single", 1e-5),
])
def test_composite_grads_match_jax(case, jax_tol):
    n_rays = 64
    if case == "single":
        rng = np.random.default_rng(5)
        ids = np.arange(n_rays, dtype=np.int32)
        ss = se = ids.copy()
        t0 = rng.uniform(2.0, 5.0, n_rays).astype(np.float32)
        t1 = (t0 + 5e-3).astype(np.float32)
        sigmas = (10.0 ** rng.uniform(-1, 3, n_rays)).astype(np.float32)
        rgbs = rng.uniform(0, 1, (n_rays, 3)).astype(np.float32)
    else:
        ids, t0, t1, sigmas, rgbs, ss, se = _buffer(
            {"fill": 2, "cut": 3, "hard": 13}[case], n_rays,
            17 if case == "fill" else 0, 13 if case == "hard" else 2,
        )
        if case == "cut":
            ids, t0, t1, sigmas, rgbs, ss, se = _cut(
                ids, t0, t1, sigmas, rgbs, ss, se, budget=ids.shape[0] // 2
            )
            assert (se < ss).sum() > n_rays // 3  # rays after the cut are empty
        if case == "hard":
            sigmas[::5] = 1e13
    rng = np.random.default_rng(11)
    gc = rng.standard_normal((n_rays, 3)).astype(np.float32)
    go = rng.standard_normal((n_rays, 1)).astype(np.float32)
    gd = rng.standard_normal((n_rays, 1)).astype(np.float32)
    cot = jnp.asarray(np.concatenate([gc, go, gd], -1))

    ref_s, ref_r = jax.grad(
        lambda s, r: jnp.sum(_jax_sums(t0, t1, ids, n_rays, ss, se, s, r) * cot),
        (0, 1),
    )(jnp.asarray(sigmas), jnp.asarray(rgbs))
    ref_s, ref_r = np.asarray(ref_s), np.asarray(ref_r)
    T = torch.tensor
    d_s, d_r = composite_sorted_backward_plain(
        T(t0), T(t1), T(sigmas), T(rgbs), T(ids), n_rays, T(ss), T(se), T(gc),
        T(go), T(gd),
    )
    valid = ids < n_rays
    oracle = _autograd_f64(t0, t1, ids, n_rays, ss, se, sigmas, rgbs, np.asarray(cot))
    for (want_s, want_r), tol in (((ref_s, ref_r), jax_tol), (oracle, 1e-5)):
        np.testing.assert_allclose(
            d_s.numpy()[valid], want_s[valid], rtol=0,
            atol=tol * np.abs(want_s).max(),
        )
        np.testing.assert_allclose(
            d_r.numpy()[valid], want_r[valid], rtol=0,
            atol=tol * np.abs(want_r).max(),
        )
    assert (d_s.numpy()[~valid] == 0).all() and (d_r.numpy()[~valid] == 0).all()
    if case == "hard":
        capped = sigmas * (t1 - t0) >= 40.0
        assert capped.sum() > 10 and (d_s.numpy()[capped] == 0).all()
    assert np.abs(ref_s).max() > 0 and np.abs(ref_r).max() > 0


def test_composite_wrapper_gradients_and_contract():
    """The wrapper differentiates in sigmas and rgbs through the closed-form
    twin (kernel G5 on the card), agrees with autograd of the plain forward,
    gives the weights no gradient, and refuses a gradient for
    prefix_trans."""
    ids, t0, t1, sigmas, rgbs, ss, se = _buffer(4, 32, 5, 2)
    T = torch.tensor
    args = (T(t0), T(t1))
    tail = (T(ids), 32, T(ss), T(se))
    s1, r1 = T(sigmas, requires_grad=True), T(rgbs, requires_grad=True)
    s2, r2 = T(sigmas, requires_grad=True), T(rgbs, requires_grad=True)
    out = composite_sorted(*args, s1, r1, *tail, return_weights=True)
    ref = composite_sorted_plain(*args, s2, r2, *tail)
    assert all(o.grad_fn is not None for o in out[:3]) and not out[3].requires_grad
    cot = [
        torch.randn(o.shape, generator=torch.Generator().manual_seed(i))
        for i, o in enumerate(ref[:3])
    ]
    sum((o * c).sum() for o, c in zip(out[:3], cot)).backward()
    sum((o * c).sum() for o, c in zip(ref[:3], cot)).backward()
    torch.testing.assert_close(s1.grad, s2.grad, rtol=0, atol=1e-5 * float(s2.grad.abs().max()))
    torch.testing.assert_close(r1.grad, r2.grad, rtol=0, atol=1e-6)
    prefix = torch.full((32,), 0.5, requires_grad=True)
    with pytest.raises(NotImplementedError):
        composite_sorted(*args, s1, r1, *tail, prefix)


def test_reverse_exclusive_sum_is_segment_local():
    ids = torch.tensor([0, 0, 0, 2, 2, 3], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 4.0, 0.5, 0.25, 7.0])
    ss = torch.tensor([0, 3, 3, 5], dtype=torch.int32)
    se = torch.tensor([2, 2, 4, 5], dtype=torch.int32)
    out = exclusive_sum_sorted(vals, ids, 4, ss, se, reverse=True)
    torch.testing.assert_close(
        out, torch.tensor([6.0, 4.0, 0.0, 0.25, 0.0, 0.0]), rtol=0, atol=0
    )
