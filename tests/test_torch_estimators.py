"""Port vs JAX: the estimators.  ``update_occ_grid``'s three modes (warmup,
the sampled update with duplicate ids, the striped refresh with decay^S),
``OccGridEstimator.sampling`` with a density and an alpha callback against
JAX's exact-size output, ``mark_invisible_cells``, the estimator's state
carried both ways by the bridge, and ``PropNetEstimator``'s sampling, loss
and optimizer step.  JAX's random draws are fed to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfacc_tpu.estimators.occ_grid import OccGridEstimator as JaxOccGridEstimator
from nerfacc_tpu.estimators.occ_grid import OccGridState as JaxOccGridState
from nerfacc_tpu.estimators.occ_grid import update_occ_grid as jax_update_occ_grid
from nerfacc_tpu.estimators.prop_net import PropNetEstimator as JaxPropNetEstimator
from nerfacc_tpu.models.cp_field import CPDensityField as JaxDensityField
from nerfacc_tpu_torch.estimators.base import AbstractEstimator
from nerfacc_tpu_torch.estimators.occ_grid import OccGridEstimator, update_occ_grid
from nerfacc_tpu_torch.estimators.prop_net import PropNetEstimator
from nerfacc_tpu_torch.models.cp_field import CPDensityField
from nerfacc_tpu_torch.utils.jax_bridge import (
    occ_grid_estimator_from_numpy,
    occ_grid_estimator_to_numpy,
    occ_state_from_numpy,
    prop_fields_from_numpy,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
RES = 16
LEVELS = 2


def _occ_fn(lib):
    """The same smooth occupancy in both packages: a shell around the
    origin, (N, 3) -> (N,).  The port's side takes its exp in float64 and
    rounds once: PyTorch's f32 exp on the CPU may run through MKL's vector
    math at reduced accuracy on some threads (fault F2's cause)."""
    if lib == "jax":
        return lambda x: 0.05 * jnp.exp(-8.0 * ((x * x).sum(-1) - 0.4) ** 2)
    return lambda x: (0.05 * torch.exp(-8.0 * ((x * x).sum(-1).double() - 0.4) ** 2)).float()


def _start_state(seed):
    """A grid part-way through training: occupancies in [0, 0.05), a tenth
    marked invisible (-1), binarised at 0.01."""
    rng = np.random.default_rng(seed)
    occs = rng.uniform(0, 0.05, LEVELS * RES**3).astype(np.float32)
    occs[rng.uniform(size=occs.shape) < 0.1] = -1.0
    est = JaxOccGridEstimator(AABB, RES, LEVELS)
    return est.state.aabbs, occs, (occs > 0.01).reshape(LEVELS, RES, RES, RES)


def _jax_draws(key, mode, cells, n_stripe):
    """The draws ``update_occ_grid`` makes from ``key`` in ``mode``."""
    _, k_uni, k_occ, k_eval = jax.random.split(key, 4)
    if mode == "warmup":
        return dict(jitter=jax.random.uniform(k_eval, (LEVELS, cells, 3)))
    if mode == "striped":
        return dict(jitter=jax.random.uniform(k_eval, (LEVELS, n_stripe, 3)))
    return dict(jitter=jax.random.uniform(k_eval, (LEVELS, 2 * (cells // 4), 3)),
                uniform_ids=jax.random.randint(k_uni, (LEVELS, cells // 4), 0, cells,
                                               dtype=jnp.int32))


def _jax_occupied_ids(key, binaries, cells):
    """The sampled update's occupied draw, as ``update_occ_grid`` sorts it."""
    _, _, k_occ, _ = jax.random.split(key, 4)
    n = cells // 4
    rbits = jax.random.bits(k_occ, (LEVELS * cells,)).astype(jnp.uint32)
    keys = ((rbits >> 8) | jnp.where(binaries.reshape(-1), 0, 1 << 30)).astype(jnp.int32)
    iota = jnp.broadcast_to(jnp.arange(cells, dtype=jnp.int32)[None, :], (LEVELS, cells))
    _, ids = jax.lax.sort_key_val(keys.reshape(LEVELS, cells), iota)
    return ids[:, :n]


@pytest.mark.parametrize("mode", ["warmup", "sampled", "striped"])
def test_update_modes_match_jax(mode):
    """Each mode from the same grid with JAX's draws: occupancies within
    1e-5 relative (the cell points' f32 arithmetic, which XLA fuses
    differently, moves the field's value by up to ~10 ulps; read 1.2e-6),
    binaries equal away from the threshold.  The sampled update's ids hold duplicates (a
    uniform draw of a quarter of the cells, and occupied cells drawn
    again), which the EMA-max scatter must decay once and max over."""
    aabbs, occs, binaries = _start_state(1)
    jstate = JaxOccGridState(jnp.asarray(aabbs), jnp.asarray(occs), jnp.asarray(binaries))
    state = occ_state_from_numpy(np.asarray(aabbs), occs, binaries, device="cpu")
    key = jax.random.PRNGKey(3)
    step, stripes, interval = (10, 1, 16) if mode == "warmup" else (300, 4, 16)
    cells = RES**3
    kw = dict(warmup_steps=256, dense=mode != "sampled", dense_stripes=stripes,
              update_interval=interval)
    ref = jax_update_occ_grid(jstate, key, jnp.asarray(step), _occ_fn("jax"), **kw)
    draws = {k: torch.tensor(np.asarray(v)) for k, v in
             _jax_draws(key, mode, cells, cells // stripes).items()}
    if mode == "sampled":
        occupied = torch.tensor(np.asarray(_jax_occupied_ids(key, jnp.asarray(binaries), cells)))
        ids = torch.cat([draws["uniform_ids"], occupied], -1)
        assert any(len(torch.unique(r)) < r.numel() for r in ids)  # duplicates
        draws["occupied_ids"] = occupied
    out = update_occ_grid(state, _occ_fn("torch"), step=step, **kw, **draws)
    want = np.asarray(ref.occs)
    np.testing.assert_allclose(out.occs.numpy(), want, rtol=1e-5, atol=0)
    assert (out.occs.numpy() == -1).sum() == (occs == -1).sum()
    changed = out.occs.numpy() != occs
    assert changed.mean() > (0.3 if mode != "striped" else 0.15)
    if mode == "striped":  # one stripe: cells [start, start + n) of each level
        start = (step // interval) % stripes * (cells // stripes)
        lvl = changed.reshape(LEVELS, cells)
        assert not lvl[:, :start].any() and not lvl[:, start + cells // stripes:].any()
    visible = want >= 0
    thre = min(want[visible].mean(), 1e-2)
    far = np.abs(want - thre) > 1e-6
    np.testing.assert_array_equal(out.binaries.numpy().reshape(-1)[far],
                                  np.asarray(ref.binaries).reshape(-1)[far])


def test_ema_update_decays_duplicates_once():
    """A cell written three times decays once and keeps the largest write."""
    state = occ_state_from_numpy(
        np.array([[-1, -1, -1, 1, 1, 1]], np.float32), np.full(8, 0.5, np.float32),
        np.ones((1, 2, 2, 2), bool), device="cpu")
    ids = torch.tensor([[5, 5, 5, 1]])
    vals = iter([torch.tensor([0.1, 0.3, 0.2, 0.0])])
    out = update_occ_grid(
        state, lambda x: next(vals), step=300, uniform_ids=ids[:, :2],
        occupied_ids=ids[:, 2:], jitter=torch.zeros(1, 4, 3), ema_decay=0.5,
    )
    want = torch.full((8,), 0.5)
    want[5] = 0.3  # max(0.5 * 0.5, 0.1, 0.3, 0.2)
    want[1] = 0.25  # max(0.5 * 0.5, 0.0)
    torch.testing.assert_close(out.occs, want)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    o[: n // 2] = o[: n // 2] / np.linalg.norm(o[: n // 2], axis=-1, keepdims=True) * 1.9
    d = (rng.uniform(-0.4, 0.4, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


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


@pytest.mark.parametrize("route", ["sigma", "alpha", "none"])
@pytest.mark.parametrize("stratified", [False, True])
def test_sampling_matches_jax(route, stratified):
    """Exact-size flattened samples against JAX's estimator on the same
    grid: equal ray ids and bounds (bit for bit), after the visibility
    filter (``early_stop_eps`` 1e-2, ``alpha_thre`` 1e-2 capped at the
    mean occupancy, invisible cells included).  JAX filters on padded rows
    and the port on the flat buffer, so a last-bit difference in an
    exclusive sum may flip a sample whose transmittance lies within 1e-5
    (relative) of ``early_stop_eps``; only such samples may differ.  With
    ``max_samples`` = 48, rays whose orbit crosses more than 48 candidates
    are cut at the same candidate in both."""
    aabbs, occs, binaries = _start_state(2)
    jest = JaxOccGridEstimator(AABB, RES, LEVELS, max_samples=48, seed=5)
    jest.load_state_dict({"aabbs": jnp.asarray(aabbs), "occs": jnp.asarray(occs),
                          "binaries": jnp.asarray(binaries)})
    est = OccGridEstimator(AABB, RES, LEVELS, max_samples=48, device="cpu")
    occ_grid_estimator_from_numpy(est, jax.tree.map(np.asarray, jest.state_dict()))
    o, d = _rays(64, 7)
    step = 0.02
    near = None
    if stratified:  # the estimator's key split, then sampling_padded's draw
        _, sub = jax.random.split(jax.random.PRNGKey(5))
        near = torch.tensor(np.asarray(jax.random.uniform(sub, (64,))))

    def callback(lib):
        ro, rd = (jnp.asarray(o), jnp.asarray(d)) if lib == "jax" else (
            torch.tensor(o), torch.tensor(d))

        def fn(t0, t1, rid):  # the port's exps in float64, as in _occ_fn
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

    kw = dict(render_step_size=step, early_stop_eps=1e-2, alpha_thre=1e-2,
              stratified=stratified, near_plane=0.1)
    cb = {} if route == "none" else {f"{route}_fn": callback("jax")}
    want = [np.asarray(a) for a in jest.sampling(jnp.asarray(o), jnp.asarray(d), **cb, **kw)]
    cb = {} if route == "none" else {f"{route}_fn": callback("torch")}
    got = [a.numpy() for a in est.sampling(torch.tensor(o), torch.tensor(d), **cb, **kw,
                                           near_jitter=near)]
    assert got[0].dtype == np.int64
    differ = set(zip(*got[:2])) ^ set(zip(*want[:2]))
    if differ:  # only samples within 1e-5 of a threshold may flip
        cand = [a.numpy() for a in est.sampling(
            torch.tensor(o), torch.tensor(d), near_jitter=near,
            **{k: v for k, v in kw.items() if k not in ("early_stop_eps", "alpha_thre")})]
        thre = min(1e-2, float(occs.mean()))
        margin = _margins(callback("torch"), route, *cand, 1e-2, thre)
        flips = [margin[(cand[0] == r) & (cand[1] == t)] for r, t in differ]
        assert all(m.size == 1 and m[0] <= 1e-5 for m in flips), (len(differ), flips)
        return
    order = np.lexsort((got[1], got[0]))
    np.testing.assert_array_equal(order, np.arange(len(order)))  # sorted by ray, then t
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[0] > 0
    if route == "none":  # the cap cut some rays: uncapped, they emit more
        from nerfacc_tpu_torch.grid import march

        uncapped = march(torch.tensor(o), torch.tensor(d), est.binaries, est.aabbs,
                         near_planes=torch.full((64,), 0.1) + (0 if near is None else near * step),
                         step_size=step).counts.numpy()
        capped = np.bincount(got[0], minlength=64)
        assert (uncapped >= capped).all() and (uncapped > capped).sum() >= 5


def test_mark_invisible_cells_matches_jax():
    """Two cameras looking at the box, one near plane: the cells marked -1
    equal JAX's, and some are marked and some not."""
    K = np.array([[[40.0, 0, 32], [0, 40.0, 32], [0, 0, 1]]] * 2, np.float32)
    c2w = np.zeros((2, 3, 4), np.float32)
    c2w[0, :, :3] = np.eye(3)
    c2w[0, :, 3] = [0.0, 0.0, -2.5]
    c2w[1, :, :3] = [[0, 0, 1], [0, 1, 0], [-1, 0, 0]]
    c2w[1, :, 3] = [2.5, 0.3, 0.0]
    jest = JaxOccGridEstimator(AABB, RES, LEVELS)
    jest.mark_invisible_cells(jnp.asarray(K), jnp.asarray(c2w), 64, 64, near_plane=1.0,
                              chunk=1000)
    est = OccGridEstimator(AABB, RES, LEVELS, device="cpu")
    est.mark_invisible_cells(torch.tensor(K), torch.tensor(c2w), 64, 64, near_plane=1.0,
                             chunk=1000)
    want = np.asarray(jest.occs)
    np.testing.assert_array_equal(est.occs.numpy(), want)
    assert 0.05 < (want == -1).mean() < 0.95


def test_state_dict_round_trip_and_module_protocol():
    """JAX's ``state_dict()`` into the port's buffers and back, bit for bit;
    the keys are JAX's; ``train()``/``eval()`` are PyTorch's, and the update
    refuses to run in eval mode."""
    aabbs, occs, binaries = _start_state(4)
    jest = JaxOccGridEstimator(AABB, RES, LEVELS)
    jest.load_state_dict({"aabbs": jnp.asarray(aabbs), "occs": jnp.asarray(occs),
                          "binaries": jnp.asarray(binaries)})
    est = OccGridEstimator(AABB, RES, LEVELS, device="cpu")
    assert isinstance(est, AbstractEstimator) and isinstance(est, torch.nn.Module)
    jsd = jax.tree.map(np.asarray, jest.state_dict())
    occ_grid_estimator_from_numpy(est, jsd)
    assert set(est.state_dict()) == set(jsd)
    back = occ_grid_estimator_to_numpy(est)
    for k in jsd:
        assert back[k].dtype == jsd[k].dtype
        np.testing.assert_array_equal(back[k], jsd[k])
    est.eval()
    with pytest.raises(RuntimeError):
        est.update_every_n_steps(0, _occ_fn("torch"))
    est.train()
    est.update_every_n_steps(16, _occ_fn("torch"), n=16)
    assert (est.occs.numpy() != occs).any() and est.binaries.dtype == torch.bool


def test_update_every_n_steps_runs_the_sampled_update_after_warmup():
    """Off-interval steps leave the grid; past ``warmup_steps`` the sampled
    update touches at most half the cells a level; before it, every visible
    cell decays or rises."""
    est = OccGridEstimator(AABB, RES, 1, device="cpu", seed=3)
    est.update_every_n_steps(3, _occ_fn("torch"), n=16)
    assert (est.occs == 0).all()
    est.update_every_n_steps(0, _occ_fn("torch"), warmup_steps=4, n=16)
    first = est.occs.clone()
    assert (first > 0).all()
    est.update_every_n_steps(16, _occ_fn("torch"), warmup_steps=4, n=16)
    touched = (est.occs != first).float().mean()
    assert 0.2 < float(touched) <= 0.5


PROP_RAYS, PROP_S, PROP_FINAL = 8, 32, 16


def test_prop_net_estimator_matches_jax():
    """``PropNetEstimator`` against JAX's (tests/test_prop.py's golden) from
    the same f32 proposal field (bridged): the final intervals within 1e-6, the
    loss of :meth:`compute_loss` and of ``update_every_n_steps`` within 1e-5
    relative of JAX's, and the parameters after one Adam step (JAX's
    ``optax.adam(1e-2)``, the port's ``torch.optim.Adam(lr=1e-2)``) within
    1e-6 of the step size (a step moves each entry by ~1e-2 times the sign
    of its gradient).  ``requires_grad=False`` returns 0.0 and keeps the
    cache empty; a parameter the loss does not reach gets a zero gradient."""
    aabb = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
    jpf = JaxDensityField(aabb=aabb, resolutions=(8,), ranks=(4,), hidden_dim=16,
                          compute_dtype=jnp.float32)
    params0 = jpf.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    o = (rng.normal(size=(PROP_RAYS, 3)) * 0.1).astype(np.float32)
    d = rng.normal(size=(PROP_RAYS, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    trans = np.repeat(np.linspace(1.0, 0.1, PROP_FINAL, dtype=np.float32)[None], PROP_RAYS, 0)

    def builder(params):
        def fn(t0, t1):
            pos = jnp.asarray(o)[:, None] + (0.5 * (t0 + t1))[..., None] * jnp.asarray(d)[:, None]
            return jpf(params, pos.reshape(-1, 3)).reshape(t0.shape)
        return [fn]

    kw = dict(prop_samples=[PROP_S], num_samples=PROP_FINAL, n_rays=PROP_RAYS,
              near_plane=0.1, far_plane=3.0, sampling_type="uniform", requires_grad=True)
    jest = JaxPropNetEstimator(optimizer=optax.adam(1e-2), params=params0,
                               sigma_fns_builder=builder)
    jt0, jt1 = jest.sampling(**kw)
    jloss = jest.update_every_n_steps(jnp.asarray(trans), requires_grad=True, loss_scaler=8.0)
    jest.sampling(**kw)
    jloss2 = float(jest.compute_loss(jnp.asarray(trans), 8.0))

    pf = CPDensityField(aabb, resolutions=(8,), ranks=(4,), hidden_dim=16,
                        compute_dtype=torch.float32)
    prop_fields_from_numpy([pf], [jax.tree.map(np.asarray, params0)])
    extra = torch.nn.Parameter(torch.ones(3))  # reached by no loss
    opt = torch.optim.Adam([*pf.parameters(), extra], lr=1e-2)
    est = PropNetEstimator(optimizer=opt)
    to, td = torch.tensor(o), torch.tensor(d)

    def fn(t0, t1):
        pos = to[:, None] + (0.5 * (t0 + t1))[..., None] * td[:, None]
        return pf(pos.reshape(-1, 3)).reshape(t0.shape)

    t0, t1 = est.sampling([fn], device="cpu", **kw)
    np.testing.assert_allclose(t0.numpy(), np.asarray(jt0), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t1.numpy(), np.asarray(jt1), rtol=1e-6, atol=1e-6)
    assert not t0.requires_grad and len(est.prop_cache) == 2
    loss = est.update_every_n_steps(torch.tensor(trans), requires_grad=True, loss_scaler=8.0)
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    assert est.prop_cache == [] and torch.equal(extra.grad, torch.zeros(3))
    want = _cp_density_state(jest.params)
    for name, p in pf.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6 * 1e-2, err_msg=name)
    est.sampling([fn], device="cpu", **kw)
    assert float(est.compute_loss(torch.tensor(trans), 8.0)) == pytest.approx(jloss2, rel=1e-5)
    assert est.update_every_n_steps(torch.tensor(trans), requires_grad=False) == 0.0
    assert est.prop_cache == []


def _cp_density_state(tree):
    from nerfacc_tpu_torch.utils.jax_bridge import cp_density_field_params_from_numpy

    return cp_density_field_params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")
