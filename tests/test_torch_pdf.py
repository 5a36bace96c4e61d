"""Port vs JAX: the batched searchsorted and importance sampling (kernel
G14's plain version), and the f32 fused multiply-add they rest on.

JAX runs jitted, as inside the proposal trainer's step: XLA's CPU backend
then contracts the CDF position ``u = u_floor + (sid + bias) * u_step`` into
a fused multiply-add (eager JAX does not), and the port follows the jitted
form.  Stratified jitter is JAX's own draw, handed to the port as ``bias``.
"""
import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.data_specs import RayIntervals as JaxIntervals
from nerfacc_tpu.pdf import importance_sampling as jax_importance_sampling
from nerfacc_tpu.pdf import searchsorted as jax_searchsorted
from nerfacc_tpu_torch.data_specs import RayIntervals
from nerfacc_tpu_torch.pdf import (
    cdf_positions,
    importance_sampling,
    importance_sampling_plain,
    samples_and_edges,
    searchsorted,
)
from nerfacc_tpu_torch.utils.fp import fma_f32
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)


def _round_f32(q: fractions.Fraction) -> np.float32:
    """The f32 nearest to the rational ``q``, ties to even."""
    c = np.float32(float(q))
    best = None
    for x in (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))):
        d = abs(fractions.Fraction(float(x)) - q)
        even = int(x.view(np.int32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, x)
    return best[1]


def test_fma_f32_rounds_once():
    """Against exact rational arithmetic: random operands, and operands
    built so that the f64 sum lands exactly halfway between two f32 values
    while the exact sum does not (where rounding twice would go wrong)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4000).astype(np.float32)
    b = rng.standard_normal(4000).astype(np.float32)
    c = (rng.standard_normal(4000) * 10.0 ** rng.integers(-6, 6, 4000)).astype(np.float32)
    # With c = 1 + 2^-23 and a * b = 2^-24 (1 - 2^-46), the exact sum lies
    # 2^-70 below the midpoint 1 + 3 * 2^-24 of c and its even neighbour
    # 1 + 2^-22; the f64 sum rounds onto the midpoint, and rounding that to
    # f32 again would give the neighbour.  Then the same mirrored, and an
    # exact tie (a * b = 2^-24), which goes to the even neighbour.
    m = np.float32(1.0 + 2.0**-23)
    tie_a = np.array([2.0**-12 * (1 + 2.0**-23), -(2.0**-12) * (1 + 2.0**-23), 2.0**-12], np.float32)
    tie_b = np.array([2.0**-12 * (1 - 2.0**-23), 2.0**-12 * (1 - 2.0**-23), 2.0**-12], np.float32)
    tie_c = np.array([m, -m, m], np.float32)
    a, b, c = (np.concatenate([x, y]) for x, y in ((a, tie_a), (b, tie_b), (c, tie_c)))
    got = fma_f32(*(torch.tensor(x) for x in (a, b, c))).numpy()
    want = np.array([
        _round_f32(fractions.Fraction(float(x)) * fractions.Fraction(float(y))
                   + fractions.Fraction(float(z)))
        for x, y, z in zip(a, b, c)
    ])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[-3] == m and got[-2] == -m  # not 1 + 2^-22 (rounded twice)
    assert got[-1] == np.float32(1.0 + 2.0**-22)


def _intervals(seed, n_rays, n_edges):
    rng = np.random.default_rng(seed)
    vals = np.sort(rng.uniform(size=(n_rays, n_edges)), -1).astype(np.float32)
    cdfs = np.sort(rng.uniform(size=(n_rays, n_edges)), -1).astype(np.float32)
    return vals, cdfs


def _special_rows(n_edges):
    """Rows where the rules bite: CDF plateaus (a stretch of zero density),
    a CDF that is 0 throughout, one with its mass in the last bin, positions
    exactly on CDF values (uniform steps with bias 0), repeated edges."""
    rng = np.random.default_rng(7)
    vals = np.sort(rng.uniform(2.0, 6.0, (6, n_edges)), -1).astype(np.float32)
    vals[5, 3:6] = vals[5, 3]  # repeated edges
    ramp = np.linspace(0.0, 1.0, n_edges, dtype=np.float32)
    plateau = np.minimum(ramp * 3.0, 0.4).astype(np.float32)
    plateau[n_edges // 2 :] = np.linspace(0.4, 1.0, n_edges - n_edges // 2)
    cdfs = np.stack([
        plateau,
        np.zeros(n_edges, np.float32),
        np.where(np.arange(n_edges) < n_edges - 1, 0.0, 1.0).astype(np.float32),
        ramp,
        np.where(np.arange(n_edges) < 2, 0.0, 0.6).astype(np.float32),
        ramp,
    ])
    bias = np.array([0.5, 0.5, 0.25, 0.0, 0.0, 0.9], np.float32)
    return vals, cdfs, bias


def _jax_sampling(vals, cdfs, n, bias):
    """JAX's jitted importance sampling, stratified with ``bias`` as its
    draw: the key is replaced by a function returning ``bias``."""
    stratified = bias is not None

    def fn(v, c, b):
        uniform = jax.random.uniform
        jax.random.uniform = lambda key, shape, dtype=jnp.float32: b.reshape(shape).astype(dtype)
        try:
            iv, s = jax_importance_sampling(
                JaxIntervals(vals=v), c, n, stratified,
                key=jax.random.PRNGKey(0) if stratified else None,
            )
        finally:
            jax.random.uniform = uniform
        return iv.vals, s.vals

    b = np.zeros(vals.shape[0], np.float32) if bias is None else bias
    edges, samples = jax.jit(fn)(jnp.asarray(vals), jnp.asarray(cdfs), jnp.asarray(b))
    return np.asarray(samples), np.asarray(edges)


CASES = {
    # tests/test_pdf.py: the docstring golden, the resampler comparison, the
    # stratified case; then the first proposal level (E = 2) and n = 1
    "golden": (np.array([[0.0, 1.0], [0.0, 2.0]], np.float32),
               np.array([[0.0, 0.5], [0.0, 1.0]], np.float32), 2, None),
    "resampler": (*_intervals(42, 5, 101), 100, None),
    "stratified": (*_intervals(0, 8, 33), 16, np.random.default_rng(1).uniform(size=8).astype(np.float32)),
    "first-level": (np.tile(np.array([[0.0, 1.0]], np.float32), (16, 1)),
                    np.tile(np.array([[0.0, 1.0]], np.float32), (16, 1)), 32,
                    np.random.default_rng(2).uniform(size=16).astype(np.float32)),
    "one-sample": (*_intervals(3, 4, 9), 1, None),
    "plateaus-zero-rows-ties": (*_special_rows(17)[:2], 16, _special_rows(17)[2]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_importance_sampling_matches_jax_bitwise(case):
    """Samples and edges bit for bit against jitted JAX, stratified cases
    with JAX's draws as ``bias``; the entry point and the plain version
    agree on CPU tensors."""
    vals, cdfs, n, bias = CASES[case]
    want_s, want_e = _jax_sampling(vals, cdfs, n, bias)
    tb = None if bias is None else torch.tensor(bias)
    iv, s = importance_sampling(
        RayIntervals(torch.tensor(vals)), torch.tensor(cdfs), n,
        stratified=bias is not None, bias=tb,
    )
    np.testing.assert_array_equal(s.vals.numpy(), want_s)
    np.testing.assert_array_equal(iv.vals.numpy(), want_e)
    assert s.vals.shape == (vals.shape[0], n) and iv.vals.shape == (vals.shape[0], n + 1)
    if case == "golden":
        np.testing.assert_allclose(iv.vals.numpy(), [[0.0, 0.5, 1.0], [0.0, 1.0, 2.0]])
        np.testing.assert_allclose(s.vals.numpy(), [[0.25, 0.75], [0.5, 1.5]])
    if case == "plateaus-zero-rows-ties":
        # the all-zero CDF puts every sample at the midpoint of its last bin
        assert (s.vals[1] == 0.5 * (vals[1, -2] + vals[1, -1])).all()


def _search_rule(vals, cdfs, bias, n):
    """Kernel G14's rule on a row that passes its vote, in torch: ``cnt``,
    the count of the first E - 1 CDF values <= u, by a search, then the
    entries at the ends of that prefix (cnt - 1, or 0 where cnt = 0, and
    cnt, E - 1 included) in place of the masked max and min."""
    u = cdf_positions(cdfs, bias, n)
    cnt = torch.searchsorted(cdfs[:, :-1].contiguous(), u.contiguous(), right=True)
    lo = (cnt - 1).clamp(min=0)
    return samples_and_edges(vals, u, cdfs.gather(1, lo), vals.gather(1, lo),
                             cdfs.gather(1, cnt), vals.gather(1, cnt))


def _passes_the_vote(vals, cdfs):
    """G14's vote: nondecreasing edges and CDF (so no NaN) and no -0.0."""
    rows = np.concatenate([vals, cdfs])
    return bool((np.diff(rows, axis=-1) >= 0).all()
                and not (rows.view(np.uint32) == 0x80000000).any())


SEARCH_CASES = {
    **CASES,
    # biases that put samples below the first CDF value (cnt = 0) and past
    # the last (cnt = E - 1), and positions on CDF values
    "outside-the-row": (*_intervals(11, 6, 9), 8,
                        np.array([-3.0, -0.5, 8.5, 12.0, 0.5, -1.0], np.float32)),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_rule_matches_the_reductions_bitwise(case):
    """On rows that pass G14's vote (plateaus, an all-zero CDF, positions on
    CDF values, repeated edges, cnt = 0 and cnt = E - 1), the kernel's
    search rule gives the jitted JAX function's and the plain version's
    samples and edges bit for bit."""
    vals, cdfs, n, bias = SEARCH_CASES[case]
    assert _passes_the_vote(vals, cdfs)
    b = np.full(vals.shape[0], 0.5, np.float32) if bias is None else bias
    tv, tc, tb = (torch.tensor(x) for x in (vals, cdfs, b))
    got_s, got_e = _search_rule(tv, tc, tb, n)
    ref_s, ref_e = importance_sampling_plain(tv, tc, tb, n)
    want_s, want_e = _jax_sampling(vals, cdfs, n, bias)
    for got, ref, want in ((got_s, ref_s, want_s), (got_e, ref_e, want_e)):
        np.testing.assert_array_equal(got.numpy().view(np.int32), ref.numpy().view(np.int32))
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
    if case == "outside-the-row":
        u = cdf_positions(tc, tb, n)
        cnt = (tc[:, None, :-1] <= u[:, :, None]).sum(-1)
        assert (cnt == 0).any() and (cnt == vals.shape[1] - 1).any()


def test_importance_sampling_generator_and_contract():
    """The stratified draw comes from the caller's generator (one per ray);
    samples stay sorted and the edges within each row's span."""
    vals, cdfs = _intervals(5, 32, 17)
    g = torch.Generator().manual_seed(0)
    iv, s = importance_sampling(RayIntervals(torch.tensor(vals)), torch.tensor(cdfs), 8, True, g)
    bias = torch.rand(32, generator=torch.Generator().manual_seed(0))
    ref_s, ref_e = importance_sampling_plain(torch.tensor(vals), torch.tensor(cdfs), bias, 8)
    assert torch.equal(s.vals, ref_s) and torch.equal(iv.vals, ref_e)
    assert (torch.diff(s.vals, dim=-1) >= 0).all()
    assert (iv.vals[:, 0] >= torch.tensor(vals[:, 0])).all()
    assert (iv.vals[:, -1] <= torch.tensor(vals[:, -1])).all()


def test_searchsorted_matches_jax():
    """tests/test_pdf.py's batched case: 10 rows, 101 sorted keys and
    queries; both index arrays equal JAX's."""
    rng = np.random.default_rng(42)
    key = np.sort(rng.uniform(size=(10, 101)), -1).astype(np.float32)
    query = np.sort(rng.uniform(size=(10, 101)), -1).astype(np.float32)
    query[0, :5] = key[0, :5]  # queries exactly on keys
    want = jax_searchsorted(JaxIntervals(vals=jnp.asarray(key)), JaxIntervals(vals=jnp.asarray(query)))
    got = searchsorted(RayIntervals(torch.tensor(key)), RayIntervals(torch.tensor(query)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _packed(seed, counts, low=0.0, high=1.0):
    """Sorted values of each ray's segment, flattened, with packed_info."""
    rng = np.random.default_rng(seed)
    vals = np.concatenate([np.sort(rng.uniform(low, high, c)) for c in counts]).astype(np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return vals, np.stack([starts, counts], -1).astype(np.int32)


def _jax_varying(vals, cdfs, n_per_ray, max_n, bias, packed_info=None):
    """JAX's per-ray-count importance sampling, jitted, stratified with
    ``bias`` as its draw (as :func:`_jax_sampling`): edges, is_left,
    is_right, samples, is_valid as numpy."""
    stratified = bias is not None

    def fn(v, c, n, b, pi):
        uniform = jax.random.uniform
        jax.random.uniform = lambda key, shape, dtype=jnp.float32: b.reshape(shape).astype(dtype)
        try:
            iv, s = jax_importance_sampling(
                JaxIntervals(vals=v, packed_info=pi), c, n, stratified,
                key=jax.random.PRNGKey(0) if stratified else None, max_intervals_per_ray=max_n,
            )
        finally:
            jax.random.uniform = uniform
        return iv.vals, iv.is_left, iv.is_right, s.vals, s.is_valid

    b = np.zeros(len(n_per_ray), np.float32) if bias is None else bias
    pi = None if packed_info is None else jnp.asarray(packed_info)
    out = jax.jit(fn)(jnp.asarray(vals), jnp.asarray(cdfs), jnp.asarray(n_per_ray, jnp.int32),
                      jnp.asarray(b), pi)
    return [np.asarray(o) for o in out]


def _varying_case(case):
    """(vals, cdfs, packed_info, counts, max_n, bias) of one case."""
    counts = np.array([8, 4, 1, 6, 0, 8, 2, 5], np.int32)
    bias = np.random.default_rng(8).uniform(size=8).astype(np.float32)
    if case in ("batched", "batched-stratified"):
        vals, cdfs = _intervals(12, 8, 33)
        return vals, cdfs, None, counts, 8, bias if case.endswith("stratified") else None
    if case == "batched-special-rows":  # plateaus, an all-zero CDF, ties
        vals, cdfs, b = _special_rows(17)
        return vals, cdfs, None, np.array([16, 3, 1, 7, 16, 2], np.int32), 16, b
    # flattened: rays of 2 to 40 edges (and one of 1), padded past the counts
    seg = np.array([2, 9, 40, 1, 17, 5, 33, 3])
    vals, pi = _packed(13, seg, 2.0, 6.0)
    cdfs, _ = _packed(14, seg)
    return vals, cdfs, pi, counts + 3, 12, bias if case == "packed-stratified" else None


VARYING_CASES = ["batched", "batched-stratified", "batched-special-rows", "packed",
                 "packed-stratified"]


@pytest.mark.parametrize("case", VARYING_CASES)
def test_importance_sampling_per_ray_counts_match_jax_bitwise(case):
    """One count a ray (0, 1, and counts below the padded width among
    them), on the batched and the flattened layout, stratified and not:
    padded samples and edges bit for bit against jitted JAX, and the
    ``is_valid`` / ``is_left`` / ``is_right`` masks equal; each ray's valid
    samples nondecreasing and its edges within its span."""
    vals, cdfs, pi, counts, max_n, bias = _varying_case(case)
    want = _jax_varying(vals, cdfs, counts, max_n, bias, pi)
    intervals = RayIntervals(torch.tensor(vals),
                             packed_info=None if pi is None else torch.tensor(pi))
    iv, s = importance_sampling(
        intervals, torch.tensor(cdfs), torch.tensor(counts), stratified=bias is not None,
        bias=None if bias is None else torch.tensor(bias), max_intervals_per_ray=max_n,
    )
    got = [iv.vals, iv.is_left, iv.is_right, s.vals, s.is_valid]
    for name, g, w in zip(("edges", "is_left", "is_right", "samples", "is_valid"), got, want):
        assert g.shape == w.shape, name
        if g.dtype == torch.bool:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy().view(np.int32), w.view(np.int32), err_msg=name)
    assert s.vals.shape == (len(counts), max_n) and iv.vals.shape == (len(counts), max_n + 1)
    for r, n in enumerate(counts):
        assert int(s.is_valid[r].sum()) == n and int(iv.is_left[r].sum()) == n
        t = s.vals[r, :n]
        assert bool((t[1:] >= t[:-1]).all())
    # the default width is the largest count
    iv2, s2 = importance_sampling(intervals, torch.tensor(cdfs), counts.tolist(),
                                  stratified=bias is not None,
                                  bias=None if bias is None else torch.tensor(bias))
    assert s2.vals.shape[1] == counts.max()
    assert torch.equal(s2.vals, s.vals[:, : counts.max()])


def test_importance_sampling_per_ray_counts_agree_with_the_int_path():
    """Each ray of a per-ray-count call (batched) against the int path on
    that ray alone with its own count, within 1e-5 (the step is a quotient
    there and a product with 1/n here), closing edge included; n = 1 rays
    give [t_min, t_max], as JAX's test holds them."""
    vals, cdfs = _intervals(5, 4, 32)
    counts = [8, 4, 1, 6]
    iv, s = importance_sampling(RayIntervals(torch.tensor(vals)), torch.tensor(cdfs),
                                torch.tensor(counts), max_intervals_per_ray=8)
    for r, n in enumerate(counts):
        iv_r, s_r = importance_sampling(RayIntervals(torch.tensor(vals[r : r + 1])),
                                        torch.tensor(cdfs[r : r + 1]), n)
        np.testing.assert_allclose(s.vals[r, :n].numpy(), s_r.vals[0].numpy(), atol=1e-5)
        np.testing.assert_allclose(iv.vals[r, : n + 1].numpy(), iv_r.vals[0].numpy(), atol=1e-5)
    assert float(iv.vals[2, 0]) == vals[2, 0] and float(iv.vals[2, 1]) == vals[2, -1]
    with pytest.raises(ValueError, match="one count a ray"):
        importance_sampling(RayIntervals(torch.tensor(vals.reshape(-1))),
                            torch.tensor(cdfs.reshape(-1)), 8)


def test_searchsorted_flattened_golden():
    """JAX's docstring golden (tests/test_pdf.py), packed keys and queries."""
    key = RayIntervals(torch.tensor([0.0, 1.0, 0.0, 1.0, 2.0]),
                       packed_info=torch.tensor([[0, 2], [2, 3]]))
    query = RayIntervals(torch.tensor([0.5, 1.5, 2.5]), packed_info=torch.tensor([[0, 1], [1, 2]]))
    ids_left, ids_right = searchsorted(key, query)
    assert ids_left.tolist() == [0, 3, 3] and ids_right.tolist() == [1, 4, 4]


@pytest.mark.parametrize("layout", ["packed-packed", "packed-ray-indices", "batched-packed",
                                    "batched-ray-indices"])
def test_searchsorted_flattened_matches_jax(layout):
    """Flattened queries (by ``packed_info``, with empty rays, or by
    ``ray_indices``) into flattened keys (rays of 1 to 40 entries) or
    batched keys, some queries exactly on keys and some outside each ray's
    span: both index arrays equal JAX's."""
    seg = np.array([3, 1, 40, 17, 2, 9])
    q_counts = np.array([5, 2, 30, 0, 4, 11])
    k_vals, k_pi = _packed(20, seg, 0.0, 1.0)
    if layout.startswith("batched"):
        k_vals = np.sort(np.random.default_rng(21).uniform(size=(6, 33)), -1).astype(np.float32)
        k_pi = None
    q_vals, q_pi = _packed(22, q_counts, -0.1, 1.1)
    q_vals[0] = k_vals.reshape(-1)[1]  # a query on a key
    ray_ids = np.repeat(np.arange(6), q_counts).astype(np.int32)
    by_ids = layout.endswith("ray-indices")
    jkey = JaxIntervals(vals=jnp.asarray(k_vals),
                        packed_info=None if k_pi is None else jnp.asarray(k_pi))
    jq = JaxIntervals(vals=jnp.asarray(q_vals), packed_info=None if by_ids else jnp.asarray(q_pi),
                      ray_indices=jnp.asarray(ray_ids) if by_ids else None)
    want = jax_searchsorted(jkey, jq)
    key = RayIntervals(torch.tensor(k_vals), packed_info=None if k_pi is None else torch.tensor(k_pi))
    q = RayIntervals(torch.tensor(q_vals), packed_info=None if by_ids else torch.tensor(q_pi),
                     ray_indices=torch.tensor(ray_ids) if by_ids else None)
    got = searchsorted(key, q)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
