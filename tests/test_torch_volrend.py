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
from nerfacc_tpu.volrend import rendering as jax_rendering
from nerfacc_tpu_torch.ops.sorted_segments import (
    composite_sorted,
    composite_sorted_backward_plain,
    composite_sorted_plain,
    exclusive_sum_sorted,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)


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


def _scan32(x, reverse=False):
    """A 32-lane Hillis-Steele inclusive scan in float32, as a warp runs it
    with ``__shfl_up_sync`` (``__shfl_down_sync`` with ``reverse``): lane l
    adds lane l - o (l + o) for o = 1, 2, 4, 8, 16."""
    x = x.astype(np.float32)
    for o in (1, 2, 4, 8, 16):
        y = x.copy()
        if reverse:
            y[:-o] = x[:-o] + x[o:]
        else:
            y[o:] = x[o:] + x[:-o]
        x = y
    return x


def _g5_chunked(t0, t1, sigmas, rgbs, ss, se, gc, go, gd, prefix):
    """Kernel G5's arithmetic order in float32: per ray, chunks of 32 lanes;
    forward, an inclusive scan of the capped optical depth shifted one lane
    plus the carried total of the earlier chunks; backward, last chunk
    first, a reverse scan of w v shifted one lane plus the carried sum of
    the later chunks.  Returns (dsigmas, drgbs, trans); fill slots 0."""
    f32 = np.float32
    n = t0.shape[0]
    d_s, d_r, trans_all = np.zeros(n, f32), np.zeros((n, 3), f32), np.zeros(n, f32)
    lane = np.arange(32)
    for r in range(ss.shape[0]):
        start, end = int(ss[r]), int(se[r])
        if end < start:
            continue
        p = f32(1.0) if prefix is None else f32(prefix[r])
        chunks, carry, kept = (end - start) // 32 + 1, f32(0.0), []
        for c in range(chunks):
            i = start + 32 * c + lane
            valid = i <= end
            j = np.minimum(i, end)
            delta = np.where(valid, t1[j] - t0[j], f32(0.0)).astype(f32)
            sig = np.where(valid, sigmas[j], f32(0.0)).astype(f32)
            sdt = (sig * delta).astype(f32)
            sd = np.where(sdt > 40.0, f32(40.0), sdt).astype(f32)
            incl = _scan32(sd)
            excl = np.concatenate([[carry], carry + incl[:-1]]).astype(f32)
            carry = f32(carry + incl[31])
            e = np.exp(-sd).astype(f32)
            trans = (np.exp(-excl).astype(f32) * p).astype(f32)
            w = (trans * (f32(1.0) - e)).astype(f32)
            t_mid = (f32(0.5) * (t0[j] + t1[j])).astype(f32)
            v = (rgbs[j] @ gc[r]).astype(f32) + go[r, 0] + gd[r, 0] * t_mid
            first = (trans * e * v).astype(f32)
            wv = np.where(valid, w * v, f32(0.0)).astype(f32)
            d_r[i[valid]] = w[valid, None] * gc[r]
            trans_all[i[valid]] = trans[valid]
            kept.append((i, valid, first, wv, delta, ~(sdt < 40.0)))
        later = f32(0.0)
        for i, valid, first, wv, delta, capped in reversed(kept):
            incl = _scan32(wv, reverse=True)
            suffix = np.concatenate([later + incl[1:], [later]]).astype(f32)
            later = f32(later + incl[0])
            ds = np.where(capped, f32(0.0), delta * (first - suffix)).astype(f32)
            d_s[i[valid]] = ds[valid]
    return d_s, d_r, trans_all


def _chunk_buffer(case):
    """Rays of 1, 31, 32, 33 and 4096 samples among empty rays, with fill
    slots; ``hard`` puts samples at and past sigma*dt = 40 on every ray."""
    rng = np.random.default_rng({"lengths": 21, "hard": 22}[case])
    counts = np.array([1, 0, 31, 32, 0, 33, 4096, 5], np.int64)
    n_rays, n_fill = counts.shape[0], 9
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
    # the long ray stays translucent (optical depth ~ 6 over 4096 samples)
    sigmas = np.where(ids == 6, rng.uniform(0.0, 0.6, n),
                      10.0 ** rng.uniform(-1, 2.5, n)).astype(np.float32)
    if case == "hard":
        for r in range(n_rays):
            idx = np.flatnonzero(ids == r)
            if idx.size:
                k = idx[idx.size // 2]  # mid-ray, and the last sample
                sigmas[k] = np.float32(40.0) / (t1[k] - t0[k])  # at the cap
                sigmas[idx[-1]] = 1e13  # past it
    rgbs = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ends = np.cumsum(counts)
    return ids, t0, t1, sigmas, rgbs, (ends - counts).astype(np.int32), (ends - 1).astype(np.int32)


# JAX's reference differences a block-decomposed cumsum, so past the cap
# (1e13 densities) it is itself only within ~1e-3 (test_composite_matches_jax
# above); the chunked order and the twin are held to 1e-5 against a float64
# oracle there, and to JAX's 1e-3 against JAX.
@pytest.mark.parametrize("case,with_prefix,jax_tol", [
    ("lengths", False, 1e-5), ("lengths", True, 1e-5),
    ("hard", False, 1e-3), ("hard", True, 1e-3),
])
def test_g5_chunked_scan_order_matches_jax(case, with_prefix, jax_tol):
    """Kernel G5's warp-chunk scan order, emulated in float32, and the plain
    twin against JAX's weights and gradients (render_weight_from_density,
    the VJPs of exclusive_sum_sorted and segment_sum_sorted) and a float64
    oracle, within 1e-5 of the largest gradient; T never exceeds the
    prefix transmittance."""
    ids, t0, t1, sigmas, rgbs, ss, se = _chunk_buffer(case)
    n_rays = ss.shape[0]
    valid = ids < n_rays
    rng = np.random.default_rng(23)
    gc = rng.standard_normal((n_rays, 3)).astype(np.float32)
    go = rng.standard_normal((n_rays, 1)).astype(np.float32)
    gd = rng.standard_normal((n_rays, 1)).astype(np.float32)
    prefix = rng.uniform(0.2, 1.0, n_rays).astype(np.float32) if with_prefix else None
    cot = jnp.asarray(np.concatenate([gc, go, gd], -1))
    pt = None if prefix is None else jnp.asarray(prefix[np.minimum(ids, n_rays - 1)])

    def sums(s, r):
        w, _, _ = jax_weights(
            jnp.asarray(t0), jnp.asarray(t1), s, ray_indices=jnp.asarray(ids),
            n_rays=n_rays, masks=jnp.asarray(valid), prefix_trans=pt,
            indices_sorted=True, seg_starts=jnp.asarray(ss), seg_ends=jnp.asarray(se),
        )
        t_mid = jnp.asarray(0.5 * (t0 + t1))
        packed = jnp.concatenate([r, jnp.ones_like(t_mid[:, None]), t_mid[:, None]], -1)
        return jax_segment_sum(
            w[:, None] * packed, jnp.asarray(ids), n_rays, jnp.asarray(ss), jnp.asarray(se)
        ), w

    ref_s, ref_r = jax.grad(lambda s, r: jnp.sum(sums(s, r)[0] * cot), (0, 1))(
        jnp.asarray(sigmas), jnp.asarray(rgbs)
    )
    ref_s, ref_r = np.asarray(ref_s), np.asarray(ref_r)

    s64 = torch.tensor(sigmas, dtype=torch.float64, requires_grad=True)
    r64 = torch.tensor(rgbs, dtype=torch.float64, requires_grad=True)
    T = torch.tensor
    out = composite_sorted_plain(
        T(t0).double(), T(t1).double(), s64, r64, T(ids), n_rays, T(ss), T(se),
        None if prefix is None else T(prefix).double(),
    )
    (torch.cat(out[:3], -1) * T(np.asarray(cot)).double()).sum().backward()
    oracle = (s64.grad.numpy(), r64.grad.numpy())

    emu_s, emu_r, emu_trans = _g5_chunked(t0, t1, sigmas, rgbs, ss, se, gc, go, gd, prefix)
    twin_s, twin_r = composite_sorted_backward_plain(
        T(t0), T(t1), T(sigmas), T(rgbs), T(ids), n_rays, T(ss), T(se), T(gc),
        T(go), T(gd), None if prefix is None else T(prefix),
    )
    for got_s, got_r in ((emu_s, emu_r), (twin_s.numpy(), twin_r.numpy())):
        for (want_s, want_r), tol in (((ref_s, ref_r), jax_tol), (oracle, 1e-5)):
            np.testing.assert_allclose(
                got_s[valid], want_s[valid], rtol=0, atol=tol * np.abs(want_s).max()
            )
            np.testing.assert_allclose(
                got_r[valid], want_r[valid], rtol=0, atol=tol * np.abs(want_r).max()
            )
        assert (got_s[~valid] == 0).all() and (got_r[~valid] == 0).all()
    # the chunked transmittance: within the prefix, and JAX's weights from it
    bound = np.ones(n_rays, np.float32) if prefix is None else prefix
    assert (emu_trans[valid] <= bound[ids[valid]]).all()
    w_ref = np.asarray(sums(jnp.asarray(sigmas), jnp.asarray(rgbs))[1])
    sd = np.minimum(sigmas * (t1 - t0), np.float32(40.0))
    w_emu = emu_trans * (1.0 - np.exp(-sd))
    np.testing.assert_allclose(w_emu[valid], w_ref[valid], rtol=1e-5, atol=jax_tol)
    if case == "hard":
        capped = valid & (sigmas * (t1 - t0) >= 40.0)
        assert capped.sum() >= 10 and (emu_s[capped] == 0).all()


def _butterfly(v):
    """A ``__shfl_xor_sync`` butterfly over the last axis (a power of two
    lanes) in float32: lane l adds lane l ^ o for o = width / 2, ..., 1;
    returns lane 0's total."""
    v = v.astype(np.float32)
    lane = np.arange(v.shape[-1])
    o = v.shape[-1] // 2
    while o:
        v = (v + v[..., lane ^ o]).astype(np.float32)
        o //= 2
    return v[..., 0]


def _g3_chunked(t0, t1, sigmas, rgbs, ss, se, prefix):
    """Kernel G3's arithmetic order in float32: G5's chunked transmittance
    (the two kernels share the chunk scan); per lane, running partials over
    the chunks of w, w t_mid and, for each of the lane's three colour words
    (word f = lane + 32 j of the chunk's 96 is component f % 3 of sample
    f / 3), w of its sample times the word; then one butterfly per sum.
    Returns (colours (n_rays, 3), opacities, depths (n_rays,), weights);
    fill slots get weight 0 (their transmittance is 0)."""
    f32 = np.float32
    n_rays = ss.shape[0]
    zero = np.zeros((n_rays, 3), f32)
    _, _, trans = _g5_chunked(t0, t1, sigmas, rgbs, ss, se, zero, zero[:, :1],
                              zero[:, :1], prefix)
    sdt = (sigmas * (t1 - t0)).astype(f32)
    sd = np.where(sdt > 40.0, f32(40.0), sdt)
    w = (trans * (f32(1.0) - np.exp(-sd).astype(f32))).astype(f32)
    t_mid = (f32(0.5) * (t0 + t1)).astype(f32)
    words = rgbs.reshape(-1)
    lane = np.arange(32)
    out = np.zeros((n_rays, 5), f32)  # r, g, b, opacity, depth
    for r in range(n_rays):
        start, end = int(ss[r]), int(se[r])
        part = np.zeros((5, 32), f32)
        for base in range(start, end + 1, 32):
            i = base + lane
            valid = i <= end
            wl = np.where(valid, w[np.minimum(i, end)], f32(0.0))
            part[3] += wl
            part[4] += (wl * t_mid[np.minimum(i, end)]).astype(f32)
            for j in range(3):
                f = lane + 32 * j
                live = base + f // 3 <= end
                p = np.where(live, w[np.minimum(base + f // 3, end)]
                             * words[np.minimum(3 * base + f, 3 * end + 2)], f32(0.0))
                part[f % 3, lane] += p.astype(f32)
        out[r] = _butterfly(part)
    return out[:, :3], out[:, 3], out[:, 4], w


# As for G5: past the cap JAX's reference is itself only within ~1e-3, so
# the chunked order is held to 1e-5 against a float64 oracle there and to
# JAX's 1e-3 against JAX.
@pytest.mark.parametrize("case,with_prefix,jax_tol", [
    ("lengths", False, 1e-5), ("lengths", True, 1e-5),
    ("hard", False, 1e-3), ("hard", True, 1e-3),
])
def test_g3_chunked_scan_order_matches_jax(case, with_prefix, jax_tol):
    """Kernel G3's order (G5's chunk scan, per-lane partials, one butterfly),
    emulated in float32, against JAX's ``rendering`` (unnormalised depths)
    and a float64 oracle: colours and opacities within the tolerance, depths
    and weights within it times their largest entry."""
    ids, t0, t1, sigmas, rgbs, ss, se = _chunk_buffer(case)
    n_rays = ss.shape[0]
    valid = ids < n_rays
    prefix = None
    if with_prefix:
        prefix = np.random.default_rng(24).uniform(0.2, 1.0, n_rays).astype(np.float32)
    colors, opac, depth, w = _g3_chunked(t0, t1, sigmas, rgbs, ss, se, prefix)

    def field(*_):
        return jnp.asarray(rgbs), jnp.asarray(sigmas)

    ref_c, ref_o, ref_d, extras = jax_rendering(
        jnp.asarray(t0), jnp.asarray(t1), ray_indices=jnp.asarray(ids), n_rays=n_rays,
        rgb_sigma_fn=field, expected_depths=False, masks=jnp.asarray(valid),
    )
    ref_w = np.asarray(extras["weights"])
    if prefix is not None:  # the prefix scales each ray's weights and sums
        pt = prefix[np.minimum(ids, n_rays - 1)]
        ref_c, ref_o, ref_d = (np.asarray(a) * prefix[:, None] for a in (ref_c, ref_o, ref_d))
        ref_w = ref_w * pt
    w64, acc64 = _oracle(ids, t0, t1, sigmas, rgbs, n_rays, prefix)
    jax_ref = (np.asarray(ref_c), np.asarray(ref_o)[:, 0], np.asarray(ref_d)[:, 0], ref_w)
    oracle = (acc64[:, :3], acc64[:, 3], acc64[:, 4], w64)
    for want, tol in ((jax_ref, jax_tol), (oracle, 1e-5)):
        np.testing.assert_allclose(colors, want[0], rtol=0, atol=tol)
        np.testing.assert_allclose(opac, want[1], rtol=0, atol=tol)
        np.testing.assert_allclose(depth, want[2], rtol=0, atol=tol * np.abs(want[2]).max())
        np.testing.assert_allclose(w[valid], want[3][valid], rtol=0,
                                   atol=tol * np.abs(want[3]).max())
    assert (w[~valid] == 0).all()
    bound = np.ones(n_rays, np.float32) if prefix is None else prefix
    assert (opac <= bound + 1e-6).all()


# -- the rest of volrend.py on its three layouts -----------------------------

from nerfacc_tpu import volrend as jax_volrend  # noqa: E402
from nerfacc_tpu_torch import volrend  # noqa: E402

VR_RAYS = 6


def _layout(name, seed):
    """Bounds, densities, alphas and colours with the layout's index
    arguments (numpy), and the ray id of every sample: batched rows; a
    ``packed_info`` buffer with empty rays; an ``indices`` buffer whose runs
    are out of order (ray 1's samples in two runs)."""
    rng = np.random.default_rng(seed)
    if name == "batched":
        shape, kw, rid = (VR_RAYS, 9), {}, np.repeat(np.arange(VR_RAYS), 9)
    elif name == "packed_info":
        counts = np.array([4, 0, 7, 3, 0, 9], np.int32)
        packed = np.stack([np.cumsum(counts) - counts, counts], -1).astype(np.int32)
        rid = np.repeat(np.arange(VR_RAYS), counts)
        shape, kw = (int(counts.sum()),), {"packed_info": packed, "n_rays": VR_RAYS}
    else:
        rid = np.array([3, 3, 1, 1, 1, 0, 0, 5, 5, 5, 5, 1, 1, 4], np.int32)
        shape, kw = rid.shape, {"ray_indices": rid, "n_rays": VR_RAYS}
    dt = rng.uniform(0.05, 0.3, shape).astype(np.float32)
    t1 = (1.0 + np.cumsum(dt.reshape(-1))).reshape(shape).astype(np.float32)
    t0 = (t1 - dt).astype(np.float32)
    sigmas = (10.0 ** rng.uniform(-1.5, 1.2, shape)).astype(np.float32)
    alphas = rng.uniform(0.0, 0.7, shape).astype(np.float32)
    rgbs = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    masks = rng.uniform(size=shape) > 0.2
    return t0, t1, sigmas, alphas, rgbs, masks, kw, rid


def _kw(kw, lib):
    conv = jnp.asarray if lib == "jax" else torch.tensor
    return {k: (v if isinstance(v, int) else conv(v)) for k, v in kw.items()}


VR_CASES = {
    # function -> (its array arguments from the layout, extra keywords)
    "render_transmittance_from_alpha": (("alphas",), {}),
    "render_weight_from_alpha": (("alphas",), {}),
    "render_transmittance_from_density": (("t0", "t1", "sigmas"), {}),
    "render_weight_from_density": (("t0", "t1", "sigmas"), {}),
    "render_visibility_from_alpha": (("alphas",), dict(early_stop_eps=0.2, alpha_thre=0.1)),
    "render_visibility_from_density": (
        ("t0", "t1", "sigmas"), dict(early_stop_eps=0.2, alpha_thre=0.1)),
}


@pytest.mark.parametrize("layout", ["batched", "packed_info", "indices"])
@pytest.mark.parametrize("masked", [False, True], ids=["", "masks-prefix"])
@pytest.mark.parametrize("fn", sorted(VR_CASES))
def test_volrend_function_matches_jax(fn, masked, layout):
    """Every output within 1e-6 (1e-6 relative), visibility equal; with
    ``masks`` and a per-sample ``prefix_trans``.  The gradient of a random
    weighting of the differentiable outputs within 1e-5 of its largest
    entry."""
    t0, t1, sigmas, alphas, _, masks, kw, _ = _layout(layout, 7)
    arrays = dict(t0=t0, t1=t1, sigmas=sigmas, alphas=alphas)
    names, extra = VR_CASES[fn]
    if masked:
        prefix = np.random.default_rng(8).uniform(0.3, 1.0, t0.shape).astype(np.float32)
        extra = dict(extra, masks=masks, prefix_trans=prefix)
    args = [arrays[n] for n in names]

    def jax_call(*xs):
        out = getattr(jax_volrend, fn)(*xs, **_kw(kw, "jax"), **_kw(extra, "jax"))
        return out if isinstance(out, tuple) else (out,)

    want = jax_call(*(jnp.asarray(a) for a in args))
    targs = [torch.tensor(a, requires_grad=not fn.startswith("render_visibility"))
             for a in args]
    got = getattr(volrend, fn)(*targs, **_kw(kw, "torch"), **_kw(extra, "torch"))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    if fn.startswith("render_visibility"):
        return
    ws = [np.random.default_rng(9 + i).normal(size=np.asarray(w).shape).astype(np.float32)
          for i, w in enumerate(want)]
    want_grads = jax.grad(
        lambda *xs: sum(jnp.sum(o * jnp.asarray(w)) for o, w in zip(jax_call(*xs), ws)),
        argnums=tuple(range(len(args))),
    )(*(jnp.asarray(a) for a in args))
    sum((o * torch.tensor(w)).sum() for o, w in zip(got, ws)).backward()
    for t, w in zip(targs, want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("layout", ["batched", "indices"])
@pytest.mark.parametrize("with_values", [False, True])
def test_accumulate_along_rays_matches_jax(layout, with_values):
    """Sums within 1e-6, gradients within 1e-6; the in-place form adds into
    its buffer and returns it; a fill id ``n_rays`` is dropped."""
    _, _, _, alphas, rgbs, masks, kw, _ = _layout(layout, 11)
    ids = kw.get("ray_indices")
    if ids is not None:
        ids = ids.copy()
        ids[-1] = VR_RAYS  # fill
    n = None if ids is None else VR_RAYS
    vals = rgbs if with_values else None
    want = jax_volrend.accumulate_along_rays(
        jnp.asarray(alphas), None if vals is None else jnp.asarray(vals),
        None if ids is None else jnp.asarray(ids), n, masks=jnp.asarray(masks))
    w = torch.tensor(alphas, requires_grad=True)
    got = volrend.accumulate_along_rays(
        w, None if vals is None else torch.tensor(vals),
        None if ids is None else torch.tensor(ids), n, masks=torch.tensor(masks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    got.sum().backward()
    want_g = jax.grad(lambda a: jnp.sum(jax_volrend.accumulate_along_rays(
        a, None if vals is None else jnp.asarray(vals),
        None if ids is None else jnp.asarray(ids), n, masks=jnp.asarray(masks))))(
        jnp.asarray(alphas))
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_g), rtol=1e-6, atol=1e-6)
    if ids is not None:
        outputs = torch.ones((VR_RAYS, 3 if with_values else 1))
        back = volrend.accumulate_along_rays_(
            torch.tensor(alphas), None if vals is None else torch.tensor(vals),
            torch.tensor(ids), outputs)
        assert back is outputs
        want_ = jax_volrend.accumulate_along_rays_(
            jnp.asarray(alphas), None if vals is None else jnp.asarray(vals),
            jnp.asarray(ids), jnp.ones(outputs.shape))
        np.testing.assert_allclose(outputs.numpy(), np.asarray(want_), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout", ["batched", "sorted", "indices"])
@pytest.mark.parametrize("route", ["sigma", "alpha"])
@pytest.mark.parametrize("opts", ["plain", "masks-bkgd-sums"])
def test_rendering_matches_jax(layout, route, opts):
    """JAX's signature on both: colours, opacities, depths and every extra
    within 1e-5 (1e-5 relative), on the batched rows, a sorted flat buffer
    and a flat buffer whose runs are out of order; with ``masks``,
    ``render_bkgd`` and ``expected_depths=False``.  The gradients, through a
    loss on the colours, opacities, depths and ``extras["weights"]``, for
    the field's outputs within 1e-5 of their largest entry."""
    t0, t1, sigmas, alphas, rgbs, masks, kw, rid = _layout(
        "packed_info" if layout == "sorted" else layout, 13)
    ids = None if layout == "batched" else rid.astype(np.int32)
    n = None if ids is None else VR_RAYS
    field_out = sigmas if route == "sigma" else alphas
    opt = {}
    if opts != "plain":
        opt = dict(masks=masks, render_bkgd=np.array([0.2, 0.5, 1.0], np.float32),
                   expected_depths=False)
    rng = np.random.default_rng(14)
    wc, wo, wd = (rng.normal(size=s).astype(np.float32)
                  for s in ((VR_RAYS, 3), (VR_RAYS, 1), (VR_RAYS, 1)))
    ww = rng.normal(size=t0.shape).astype(np.float32)
    key = "rgb_sigma_fn" if route == "sigma" else "rgb_alpha_fn"

    def jax_render(c, s):
        def fn(a, b, r):
            assert (r is None) == (ids is None)
            return c, s
        out = jax_volrend.rendering(
            jnp.asarray(t0), jnp.asarray(t1), None if ids is None else jnp.asarray(ids), n,
            **{key: fn}, **_kw({k: v for k, v in opt.items() if k != "expected_depths"},
                               "jax"),
            expected_depths=opt.get("expected_depths", True))
        return out

    def loss(out, lib):
        conv = jnp.asarray if lib == "jax" else torch.tensor
        c, o, d, ex = out
        return ((c * conv(wc)).sum() + (o * conv(wo)).sum() + (d * conv(wd)).sum()
                + (ex["weights"] * conv(ww)).sum())

    want = jax_render(jnp.asarray(rgbs), jnp.asarray(field_out))
    want_g = jax.grad(lambda c, s: loss(jax_render(c, s), "jax"), argnums=(0, 1))(
        jnp.asarray(rgbs), jnp.asarray(field_out))
    tc, ts = torch.tensor(rgbs, requires_grad=True), torch.tensor(field_out, requires_grad=True)

    def fn(a, b, r):
        assert (r is None) == (ids is None)
        return tc, ts

    got = volrend.rendering(
        torch.tensor(t0), torch.tensor(t1), None if ids is None else torch.tensor(ids), n,
        **{key: fn}, **_kw({k: v for k, v in opt.items() if k != "expected_depths"}, "torch"),
        expected_depths=opt.get("expected_depths", True))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert set(got[3]) == set(want[3])
    for k in want[3]:
        np.testing.assert_allclose(got[3][k].detach().numpy(), np.asarray(want[3][k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    loss(got, "torch").backward()
    for g, w in zip((tc.grad, ts.grad), want_g):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_rendering_takes_jax_keywords_and_rejects_no_callback():
    """The JAX call, keyword for keyword, runs on the port; neither callback
    is an error in both."""
    t = torch.linspace(0, 1, 9)
    ids = torch.tensor([0, 0, 0, 1, 1, 1, 1, 2])
    out = volrend.rendering(
        t_starts=t[:-1], t_ends=t[1:], ray_indices=ids, n_rays=3,
        rgb_sigma_fn=lambda t0, t1, r: (torch.ones(8, 3), torch.ones(8)),
        rgb_alpha_fn=None, render_bkgd=None, expected_depths=True, masks=None)
    assert out[0].shape == (3, 3) and set(out[3]) == {"weights", "alphas", "trans",
                                                      "sigmas", "rgbs"}
    with pytest.raises(ValueError):
        volrend.rendering(t[:-1], t[1:], ids, 3)
    with pytest.raises(ValueError):
        jax_volrend.rendering(jnp.asarray(t[:-1].numpy()), jnp.asarray(t[1:].numpy()))
    # no samples at all (every ray missed the grid): the background, and a
    # gradient path to the callback's outputs
    sig, rgb = torch.zeros(0, requires_grad=True), torch.zeros((0, 3), requires_grad=True)
    empty = torch.zeros(0)
    out = volrend.rendering(empty, empty, torch.zeros(0, dtype=torch.long), 3,
                            rgb_sigma_fn=lambda *_: (rgb, sig), render_bkgd=torch.ones(3))
    torch.testing.assert_close(out[0], torch.ones(3, 3))
    out[0].sum().backward()
    assert sig.grad.shape == (0,) and rgb.grad.shape == (0, 3)
