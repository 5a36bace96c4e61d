"""Port vs JAX: the sparse-grid estimators.  ``SparseGrid``'s packed words
bit for bit (rz = 40, bit 31 set), built from masks and coordinates, unpacked,
and pooled into its mip pyramid;
``traverse_vdbs`` under a cap that cuts rays; both traversals of
``SparseGridEstimator`` and ``N3TreeEstimator`` against JAX's through the
visibility filter's three routes; the VDB update before and after warmup
with JAX's draws injected; the empty start; the state dict carried from
JAX and round-tripped.  Grids come across through the bridge, JAX's random
draws are fed to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.estimators import sparse_grid as jsg
from nerfacc_tpu_torch.estimators.base import AbstractEstimator
from nerfacc_tpu_torch.estimators.sparse_grid import (
    N3TreeEstimator,
    SparseGrid,
    SparseGridEstimator,
    VDBEstimator,
    _unpack_bits_z,
    sparse_grid_from_dense,
    sparse_grid_from_ijk,
    traverse_vdbs,
)
from nerfacc_tpu_torch.grid import march, ray_aabb_intersect
from nerfacc_tpu_torch.utils.jax_bridge import sparse_grid_estimator_from_numpy

AABB = [-1.0, -1.0, -1.0, 1.0, 1.0, 1.0]
STEP = 1e-2
# two f32 ulps relative: JAX's march runs unfused, the port's computes as
# jitted XLA does (tests/test_torch_quickstart.py); the candidates are the same
ULPS2 = 2.4e-7


def _rays(n, seed):
    """Rays from a sphere of radius 2.5 toward the box, as
    tests/test_sparse_grid.py draws them."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.5
    d = -o + rng.normal(size=(n, 3)) * 0.2
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _dense(shape, p, seed):
    return np.random.default_rng(seed).random(shape) < p


def _state(est):
    return jax.tree.map(np.asarray, est.state_dict())


@pytest.fixture
def jitted_visibility(monkeypatch):
    """The JAX estimator's visibility filter, jitted: eagerly, its segmented
    associative scan compiles each slice of each new sample count (2-14 s a
    count here); jitted, the same function compiles as one program (~0.5
    s).  A last bit that moves with it may flip a sample at a threshold,
    which the comparison allows."""
    static = ("n_rays", "early_stop_eps", "alpha_thre")
    for name in ("render_visibility_from_density", "render_visibility_from_alpha"):
        monkeypatch.setattr(jsg, name, jax.jit(getattr(jsg, name), static_argnames=static))


@pytest.mark.parametrize("shape", [(16, 16, 40), (8, 16, 64)], ids=["rz40", "rz64"])
def test_words_match_jax_bitwise(shape):
    """The packed words equal ``_pack_bits_z``'s, bit 31 (a negative word)
    included; each package unpacks the other's words to the mask; the
    grid's sizes and voxel sizes are JAX's."""
    dense = _dense(shape, 0.5, 0)
    aabb = [-1.0, -2.0, -0.5, 1.0, 2.0, 1.5]
    jgrid = jsg.sparse_grid_from_dense(dense, aabb)
    grid = sparse_grid_from_dense(dense, aabb, device="cpu")
    want = np.asarray(jgrid.words)
    assert grid.words.dtype == torch.int32 and (want < 0).any()
    np.testing.assert_array_equal(grid.words.numpy(), want)
    np.testing.assert_array_equal(grid.binaries[0].numpy(), dense)
    np.testing.assert_array_equal(_unpack_bits_z(torch.tensor(want), shape[2]).numpy(), dense)
    assert grid.resolution == jgrid.resolution and grid.total_voxels == jgrid.total_voxels
    np.testing.assert_array_equal(grid.voxel_sizes.numpy(), np.asarray(jgrid.voxel_sizes))


def test_grid_from_ijk_matches_jax():
    """Coordinates with repeats in, the mask, the words and the row-major
    ``ijk_enabled`` out, as JAX's."""
    ijk = np.random.default_rng(1).integers(0, 16, (200, 3))
    ijk[100:120] = ijk[:20]
    jgrid = jsg.sparse_grid_from_ijk(ijk, (16, 16, 40), AABB)
    grid = sparse_grid_from_ijk(ijk, (16, 16, 40), AABB, device="cpu")
    np.testing.assert_array_equal(grid.words.numpy(), np.asarray(jgrid.words))
    np.testing.assert_array_equal(grid.ijk_enabled().numpy(), np.asarray(jgrid.ijk_enabled()))
    assert grid.ijk_enabled().shape[0] == len({tuple(r) for r in ijk})


def test_mip_pyramid_matches_jax():
    """Every level equal to JAX's max-pooled pyramid; a level that does not
    halve raises."""
    dense = _dense((32, 16, 32), 0.05, 2)
    jpyr = jsg.sparse_grid_from_dense(dense, AABB).mip_pyramid(4)
    pyr = sparse_grid_from_dense(dense, AABB, device="cpu").mip_pyramid(4)
    assert [tuple(p.shape) for p in pyr] == [tuple(p.shape) for p in jpyr]
    for got, want in zip(pyr, jpyr):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < pyr[1].float().mean() < pyr[2].float().mean() < 1
    with pytest.raises(ValueError):
        sparse_grid_from_dense(_dense((16, 16, 40), 0.5, 0), AABB, device="cpu").mip_pyramid(5)


@pytest.mark.parametrize("cone_angle", [0.0, 1e-2])
def test_traverse_vdbs_matches_jax(cone_angle):
    """Under a cap of 160 candidates, which cuts rays: equal ray ids, the
    bounds within two ulps; the uncapped march gives some rays more."""
    dense = _dense((32, 32, 32), 0.5, 42)
    o, d = _rays(64, 0)
    kw = dict(step_size=STEP, cone_angle=cone_angle, max_samples=160)
    want = [np.asarray(a) for a in jsg.traverse_vdbs(
        jnp.asarray(o), jnp.asarray(d), jsg.sparse_grid_from_dense(dense, AABB), **kw)]
    grid = sparse_grid_from_dense(dense, AABB, device="cpu")
    got = [a.numpy() for a in traverse_vdbs(torch.tensor(o), torch.tensor(d), grid, **kw)]
    assert got[2].dtype == np.int32
    np.testing.assert_array_equal(got[2], want[2])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, w, rtol=ULPS2, atol=0)
    capped = np.bincount(got[2], minlength=64)
    uncapped = march(torch.tensor(o), torch.tensor(d), grid.binaries, grid.aabb[None],
                     step_size=STEP, cone_angle=cone_angle).counts.numpy()
    assert (uncapped >= capped).all() and (uncapped > capped).sum() >= 5


def _margins(fn, route, rid, t0, t1, eps, thre):
    """Per candidate sample: the relative distance of its transmittance
    (float64, from the callback's f32 outputs) from ``eps``, or of its
    alpha from ``thre``, whichever is smaller."""
    out = fn(torch.tensor(t0), torch.tensor(t1), torch.tensor(rid)).double().numpy()
    alpha = 1.0 - np.exp(-np.minimum(out * (t1 - t0), 40.0)) if route == "sigma" else out
    margin = np.empty_like(alpha)
    for r in np.unique(rid):
        sel = rid == r
        trans = np.concatenate([[1.0], np.cumprod(1.0 - alpha[sel])[:-1]])
        margin[sel] = np.minimum(np.abs(trans - eps) / eps, np.abs(alpha[sel] - thre) / thre)
    return margin


def _callback(lib, route, o, d):
    """The same density (or alpha) in both packages; the port's exps in
    float64, rounded once (PyTorch's f32 exp on the CPU may run through
    MKL's reduced-accuracy vector math)."""
    ro, rd = (jnp.asarray(o), jnp.asarray(d)) if lib == "jax" else (
        torch.tensor(o), torch.tensor(d))

    def fn(t0, t1, rid):
        pos = ro[rid] + (0.5 * (t0 + t1))[:, None] * rd[rid]
        r2 = (pos * pos).sum(-1)
        if lib == "jax":
            sigma = 30.0 * jnp.exp(-6.0 * (r2 - 0.3) ** 2)
            return sigma if route == "sigma" else 1.0 - jnp.exp(-sigma * (t1 - t0))
        sigma = (30.0 * torch.exp(-6.0 * (r2.double() - 0.3) ** 2)).float()
        if route == "sigma":
            return sigma
        return (1.0 - torch.exp(-(sigma * (t1 - t0)).double())).float()
    return fn


CASES = [(cls, traversal, route, False)
         for cls in ("vdb", "n3tree") for traversal in ("windowed", "padded")
         for route in ("sigma", "alpha", "none")]
CASES += [("vdb", "windowed", "sigma", True), ("n3tree", "padded", "none", True)]


@pytest.mark.parametrize("cls,traversal,route,stratified", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_sampling_matches_jax(cls, traversal, route, stratified, jitted_visibility):
    """Both estimators' exact-size samples against JAX's on one grid (a
    sparse 32^3 grid, ``max_samples`` 256, which cuts some rays in
    ``padded``), after the visibility filter (``early_stop_eps`` and
    ``alpha_thre`` 1e-2, the latter capped at the mean occupancy): equal ray
    ids; the bounds within two ulps for ``padded`` and within 1e-5 for
    ``windowed`` (JAX restarts each window round's lattice at its
    termination plane, so its own windowed bounds sit within 1e-5 of its
    padded ones).  JAX filters on padded rows and the port on the flat
    buffer, so a last-bit difference may flip a sample whose transmittance
    or alpha lies within 1e-5 (relative) of its threshold; only such may
    differ.  The port's windowed samples are its uncapped march's, bit for
    bit.  A stratified case feeds JAX's key-split draw as ``near_jitter``.
    """
    dense = _dense((32, 32, 32), 0.35, 21)
    occs = np.random.default_rng(3).uniform(0, 0.05, dense.size).astype(np.float32)
    jcls, pcls = {"vdb": (jsg.VDBEstimator, VDBEstimator),
                  "n3tree": (jsg.N3TreeEstimator, N3TreeEstimator)}[cls]
    jest = jcls(init_grid=jsg.sparse_grid_from_dense(dense, AABB), max_samples=256, seed=5)
    jest.occs = jnp.asarray(occs)
    est = pcls(roi_aabb=AABB, resolution=4, max_samples=256, device="cpu")
    sparse_grid_estimator_from_numpy(est, _state(jest))
    o, d = _rays(48, 13)
    near = None
    if stratified:  # the estimator's key split, then sampling's draw
        _, sub = jax.random.split(jest._key)
        near = torch.tensor(np.asarray(jax.random.uniform(sub, (48,))))
    kw = dict(render_step_size=STEP, early_stop_eps=1e-2, alpha_thre=1e-2,
              stratified=stratified, traversal=traversal)
    cb = {} if route == "none" else {f"{route}_fn": _callback("jax", route, o, d)}
    want = [np.asarray(a) for a in jest.sampling(jnp.asarray(o), jnp.asarray(d), **cb, **kw)]
    cb = {} if route == "none" else {f"{route}_fn": _callback("torch", route, o, d)}
    got = [a.numpy() for a in est.sampling(torch.tensor(o), torch.tensor(d), **cb, **kw,
                                           near_jitter=near)]
    assert got[0].dtype == np.int64 and got[0].shape[0] > 20 * 48
    cand = [a.numpy() for a in est.sampling(
        torch.tensor(o), torch.tensor(d), near_jitter=near,
        **{k: v for k, v in kw.items() if k not in ("early_stop_eps", "alpha_thre")})]
    near_planes = np.zeros(48, np.float32) if near is None else near.numpy() * STEP

    def keys(rid, t0):  # (ray, orbit index) of each sample
        return list(zip(rid, np.rint((t0 - near_planes[rid]) / STEP).astype(np.int64)))

    differ = set(keys(*got[:2])) ^ set(keys(*want[:2]))
    if differ:  # only samples near a threshold may flip
        thre = min(1e-2, float(occs.mean()))
        margin = _margins(_callback("torch", route, o, d), route, *cand, 1e-2, thre)
        cand_keys = keys(*cand[:2])
        flips = [margin[cand_keys.index(k)] for k in differ]
        assert all(m <= 1e-5 for m in flips), (len(differ), flips)
        return
    np.testing.assert_array_equal(got[0], want[0])
    tol = dict(rtol=ULPS2, atol=0) if traversal == "padded" else dict(rtol=0, atol=1e-5)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, **tol)
    if traversal == "windowed":  # the whole orbit: the uncapped march, bit for bit
        # JAX ends its windowed rounds after 64, and a round moves a live ray
        # on by at least its 40 windows of 8 candidates: no orbit here is
        # long enough to be cut there
        _, t_far, hits = ray_aabb_intersect(torch.tensor(o), torch.tensor(d), est.aabbs)
        assert hits.any() and float(t_far[hits].max()) / STEP < 64 * 40 * 8
        res = march(torch.tensor(o), torch.tensor(d), est.binaries, est.aabbs,
                    near_planes=torch.tensor(near_planes), far_planes=torch.full((48,), 1e10),
                    step_size=STEP)
        whole = [res.ray_indices.long().numpy(), res.t_starts.numpy(), res.t_ends.numpy()]
        for g, w in zip(cand, whole):
            np.testing.assert_array_equal(g, w)
    elif route == "none":  # the cap cut some rays
        assert (np.bincount(cand[0], minlength=48) < np.bincount(
            est.sampling(torch.tensor(o), torch.tensor(d), near_jitter=near,
                         render_step_size=STEP, stratified=stratified)[0].numpy(),
            minlength=48)).sum() >= 5


def _occ_fn(lib):
    """A smooth shell around the origin in both packages, (N, 3) -> (N, 1);
    the port's exp in float64, rounded once."""
    if lib == "jax":
        return lambda x: 0.05 * jnp.exp(-8.0 * ((x * x).sum(-1, keepdims=True) - 0.4) ** 2)
    return lambda x: (0.05 * torch.exp(
        -8.0 * ((x * x).sum(-1, keepdims=True).double() - 0.4) ** 2)).float()


def _jax_update_draws(key, enabled, cells, warmup):
    """The draws ``SparseGridEstimator._update`` makes from the estimator's
    key ``key``: the voxel ids and the jitter."""
    _, sub = jax.random.split(key)
    k_sel, k_jit = jax.random.split(sub)
    if warmup:
        ids = jnp.arange(cells, dtype=jnp.int32)
    else:
        n_q = cells // 4
        k1, k2 = jax.random.split(k_sel)
        keys = jax.random.uniform(k2, (cells,)) + jnp.where(enabled, 0.0, 1.0)
        _, order = jax.lax.sort_key_val(keys, jnp.arange(cells, dtype=jnp.int32))
        ids = jnp.concatenate([jax.random.randint(k1, (n_q,), 0, cells), order[:n_q]])
    jitter = jax.random.uniform(k_jit, (ids.shape[0], 3))
    return torch.tensor(np.asarray(ids)), torch.tensor(np.asarray(jitter))


@pytest.mark.parametrize("step", [0, 512], ids=["warmup", "after-warmup"])
def test_update_matches_jax(step):
    """One update from the same grid and occupancies (16 x 16 x 40 voxels,
    occupancies in [0, 0.05)) with JAX's draws: occupancies within 1e-6,
    words equal.  After warmup the ids hold duplicates (a quarter of the
    voxels drawn uniformly, and enabled ones drawn again), which decay once;
    only the touched voxels change state or occupancy."""
    aabb = [-1.0, -1.0, -1.25, 1.0, 1.0, 1.25]
    dense = _dense((16, 16, 40), 0.5, 8)
    occs = np.random.default_rng(9).uniform(0, 0.05, dense.size).astype(np.float32)
    jest = jsg.SparseGridEstimator(init_grid=jsg.sparse_grid_from_dense(dense, aabb), seed=4)
    jest.occs = jnp.asarray(occs)
    est = SparseGridEstimator(roi_aabb=aabb, resolution=4, device="cpu")
    sparse_grid_estimator_from_numpy(est, _state(jest))
    ids, jitter = _jax_update_draws(jest._key, jnp.asarray(dense.reshape(-1)), dense.size,
                                    step == 0)
    jest.update_every_n_steps(step, _occ_fn("jax"), warmup_steps=256)
    est.update_every_n_steps(step, _occ_fn("torch"), warmup_steps=256, ids=ids, jitter=jitter)
    want = _state(jest)
    np.testing.assert_allclose(est.occs.numpy(), want["occs"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(est.grid_words.numpy(), want["grid_words"])
    flipped = est.binaries[0].numpy() != dense
    assert flipped.any()
    if step:
        assert torch.unique(ids).numel() < ids.numel()  # duplicates
        untouched = np.ones(dense.size, bool)
        untouched[ids.numpy()] = False
        assert not flipped.reshape(-1)[untouched].any()
        np.testing.assert_array_equal(est.occs.numpy()[untouched], occs[untouched])


def test_update_touches_only_its_draws():
    """Past warmup, with the estimator's own draws and a field that is empty
    everywhere: voxels change, at most the half that was drawn; off the
    interval nothing moves; the update refuses to run in eval mode."""
    est = SparseGridEstimator(
        init_grid=sparse_grid_from_dense(_dense((16,) * 3, 0.7, 5), AABB, device="cpu"),
        seed=1, device="cpu")
    est.occs.fill_(0.5)
    before = est.binaries.clone()
    est.update_every_n_steps(520, lambda x: torch.zeros(x.shape[0], 1), warmup_steps=256)
    assert torch.equal(est.binaries, before)
    est.update_every_n_steps(512, lambda x: torch.zeros(x.shape[0], 1), warmup_steps=256)
    changed = int((est.binaries != before).sum())
    assert 0 < changed <= est.occs.numel() // 2
    assert int((est.occs != 0.5).sum()) <= est.occs.numel() // 2
    est.eval()
    with pytest.raises(RuntimeError):
        est.update_every_n_steps(0, lambda x: torch.zeros(x.shape[0], 1))


def test_empty_start_is_all_disabled():
    """Without a grid the estimator starts all disabled (JAX's code; its
    docstring says "fully enabled"): JAX's state, and no samples."""
    jest = jsg.SparseGridEstimator(roi_aabb=AABB, resolution=(16, 16, 40))
    est = SparseGridEstimator(roi_aabb=AABB, resolution=(16, 16, 40), device="cpu")
    want = _state(jest)
    for key, value in est.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[key]))
    assert not est.binaries.any()
    o, d = _rays(8, 0)
    assert est.sampling(torch.tensor(o), torch.tensor(d), render_step_size=STEP)[0].numel() == 0


@pytest.mark.parametrize("cls", ["vdb", "n3tree"])
def test_state_dict_round_trip(cls):
    """JAX's state dict (rz = 40) into the port through the bridge and into
    a second estimator through PyTorch's own ``load_state_dict``: JAX's
    keys, the words and occupancies bit for bit, the resolution restored,
    the unpacked grid and pyramid rebuilt after the load."""
    jcls, pcls = {"vdb": (jsg.VDBEstimator, VDBEstimator),
                  "n3tree": (jsg.N3TreeEstimator, N3TreeEstimator)}[cls]
    dense = _dense((16, 16, 40), 0.5, 11)
    jest = jcls(init_grid=jsg.sparse_grid_from_dense(dense, AABB))
    jest.occs = jnp.asarray(np.random.default_rng(0).random(dense.size, np.float32))
    want = _state(jest)
    est = pcls(roi_aabb=AABB, resolution=8, device="cpu")
    assert isinstance(est, AbstractEstimator) and isinstance(est, torch.nn.Module)
    sparse_grid_estimator_from_numpy(est, want)
    assert set(est.state_dict()) == set(want)
    for key, value in est.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(want[key]))
    est2 = pcls(roi_aabb=[0.0] * 3 + [1.0] * 3, resolution=(16, 16, 40), device="cpu")
    stale = est2.binaries
    est2.load_state_dict(est.state_dict())
    assert est2.grid.resolution == (16, 16, 40)
    assert est2.binaries is not stale
    np.testing.assert_array_equal(est2.binaries[0].numpy(), dense)
    np.testing.assert_array_equal(est2.grid_aabb.numpy(), np.asarray(AABB, np.float32))
    assert [p.shape[-1] for p in est2.pyramid()] == [40, 20, 10]


def test_unpacked_grid_is_cached_per_grid():
    """``binaries`` and ``pyramid()`` are built once per grid: the same
    objects until the grid changes (an update, or a new grid set)."""
    dense = _dense((16,) * 3, 0.5, 23)
    est = SparseGridEstimator(init_grid=sparse_grid_from_dense(dense, AABB, device="cpu"),
                              device="cpu")
    b, p = est.binaries, est.pyramid()
    assert est.binaries is b and est.pyramid() is p and p[0] is b
    est.update_every_n_steps(0, lambda x: torch.ones(x.shape[0]))
    assert est.binaries is not b and bool(est.binaries.all())
    est.grid = SparseGrid(sparse_grid_from_dense(~dense, AABB, device="cpu").words,
                          est.grid_aabb, (16, 16, 16))
    np.testing.assert_array_equal(est.pyramid()[0][0].numpy(), ~dense)
