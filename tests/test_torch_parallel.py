"""Port vs JAX, the distributed layer: the port's data-parallel occupancy and
proposal steps, and its (data, model) tensor-parallel occupancy steps, on
gloo process groups on the CPU, against the JAX package's steps on the
virtual CPU mesh that tests/conftest.py forces (the configuration of
tests/test_parallel.py, f32 fields).

Three process groups run here, each spawned once for the module: two
ranks (data parallelism: the occupancy and proposal steps against JAX, a
stratified step against the single-process step, each rank alone in a
group of one against ``train_step``, the dry run of 2), four ranks on a
(2, 2) mesh (two tensor-parallel steps against JAX, the sharding, the
checkpoint round trip), and the dry run of 4 through
``dryrun_multichip``.  The ranks run functions of the port
(``nerfacc_tpu_torch.parallel.dryrun``) on numpy inputs: no rank imports
JAX.  Every spawn has a 120 s limit."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerfacc_tpu.models.cp_field import CPDensityField as JaxDensityField
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
from nerfacc_tpu.parallel import make_dp_prop_step as jax_dp_prop_step
from nerfacc_tpu.parallel import make_dp_train_step as jax_dp_train_step
from nerfacc_tpu.parallel import make_mesh as jax_make_mesh
from nerfacc_tpu.parallel import make_mesh_2d as jax_make_mesh_2d
from nerfacc_tpu.parallel import make_tp_field as jax_make_tp_field
from nerfacc_tpu.parallel import make_tp_train_step as jax_tp_train_step
from nerfacc_tpu.parallel import permute_w1 as jax_permute_w1
from nerfacc_tpu.parallel import shard_batch as jax_shard_batch
from nerfacc_tpu.parallel import tp_w1_permutation as jax_tp_w1_permutation
from nerfacc_tpu.trainers import NGPOccTrainer as JaxTrainer
from nerfacc_tpu.trainers import NGPPropTrainer as JaxPropTrainer
from nerfacc_tpu_torch import parallel
from nerfacc_tpu_torch.parallel import dryrun
from nerfacc_tpu_torch.utils.jax_bridge import cp_field_params_from_numpy, prop_params_from_numpy
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
SMALL = dict(resolutions=(16, 64), ranks=(8, 8))
GRID = 16
N_RAYS = 64
TIMEOUT = 120
# tests/test_parallel.py's trainer, with the settings both packages take
# alike; the JAX one marches padded orbits long enough to reach every
# orbit's end (the port's march walks each to its end)
OCC = dict(grid_resolution=GRID, render_step_size=2e-2, sample_budget=16384, warmup_steps=4,
           update_interval=2, max_steps=100, stratified=False)
JAX_OCC = dict(OCC, traversal="padded", windowed=False, max_samples_per_ray=512,
               dynamic_budget=False)
PROP_FIELD = dict(resolutions=(16,), ranks=(8,), hidden_dim=16)
PROP = dict(prop_samples=[32], num_samples=16, near_plane=2.0, far_plane=6.0,
            sampling_type="uniform", stratified=False, max_steps=100)
FIELD = dict(aabb=AABB, compute_dtype=torch.float32, **SMALL)


def _batch(n=N_RAYS, seed=0):
    """A numpy ray batch aimed at the box, handed to both packages."""
    rng = np.random.default_rng(seed)
    rays_o = (rng.normal(size=(n, 3)) * 0.1 + [3.0, 0.0, 0.0]).astype(np.float32)
    rays_d = -rays_o / np.linalg.norm(rays_o, axis=-1, keepdims=True)
    return {"rays_o": rays_o, "rays_d": rays_d.astype(np.float32),
            "rgb": rng.uniform(size=(n, 3)).astype(np.float32),
            "color_bkgd": np.ones(3, np.float32)}


def _gradient_recorder():
    """An optax 'optimizer' whose state becomes the gradient tree and whose
    updates are zero (tests/test_torch_train.py's)."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def _numpy_state(state):
    return (jax.tree.map(np.asarray, state.params),
            tuple(np.asarray(a) for a in (state.occ_state.aabbs, state.occ_state.occs,
                                          state.occ_state.binaries)))


def _cells(state):
    """The refresh's cell jitter of the step with ``state``'s key, as
    ``_step_body`` and ``update_occ_grid`` draw it."""
    _, k_occ, _, _ = jax.random.split(state.key, 4)
    return np.asarray(jax.random.uniform(jax.random.split(k_occ, 4)[3], (1, GRID**3, 3)))


@pytest.fixture(scope="module")
def occ_ref():
    """JAX's DP occupancy step on a 2-device mesh: its inputs, aux,
    gradients (recorded), the parameters Adam makes of them, the grid."""
    trainer = JaxTrainer(field=JaxField(aabb=AABB, compute_dtype=jnp.float32, **SMALL),
                         aabb=list(AABB), **JAX_OCC)
    adam = trainer.optimizer
    trainer.optimizer = _gradient_recorder()
    state = trainer.init_state()
    params, occ = _numpy_state(state)
    cells = _cells(state)
    batch = _batch()
    mesh = jax_make_mesh(2)
    new, aux = jax_dp_train_step(trainer, mesh)(state, jax_shard_batch(dict(batch), mesh))
    grads = jax.tree.map(np.asarray, new.opt_state)
    jparams = jax.tree.map(jnp.asarray, params)
    updates, _ = adam.update(jax.tree.map(jnp.asarray, grads), adam.init(jparams), jparams)
    return {
        "params": params, "occ": occ, "cells": cells, "batch": batch,
        "aux": {k: np.asarray(v) for k, v in aux.items()},
        "grads": cp_field_params_from_numpy(grads, device="cpu"),
        "updated": cp_field_params_from_numpy(
            jax.tree.map(np.asarray, optax.apply_updates(jparams, updates)), device="cpu"),
        "binaries": np.asarray(new.occ_state.binaries),
    }


@pytest.fixture(scope="module")
def prop_ref():
    """JAX's DP proposal step (``requires_grad``) on a 2-device mesh."""
    trainer = JaxPropTrainer(
        field=JaxField(aabb=AABB, compute_dtype=jnp.float32, **SMALL),
        prop_fields=[JaxDensityField(aabb=AABB, compute_dtype=jnp.float32, **PROP_FIELD)],
        **PROP)
    state = trainer.init_state()
    params = jax.tree.map(np.asarray, state.params)
    batch = _batch(seed=1)
    mesh = jax_make_mesh(2)
    new, aux = jax_dp_prop_step(trainer, mesh)(state, jax_shard_batch(dict(batch), mesh),
                                               requires_grad=True)
    return {"params": params, "batch": batch,
            "aux": {k: float(v) for k, v in aux.items()},
            "updated": prop_params_from_numpy(jax.tree.map(np.asarray, new.params), device="cpu")}


@pytest.fixture(scope="module")
def tp_ref():
    """JAX's two DP+TP occupancy steps on a (2, 2) mesh, from its whole
    initial state (W1 not yet permuted)."""
    trainer = JaxTrainer(field=jax_make_tp_field(
        JaxField(aabb=AABB, compute_dtype=jnp.float32, **SMALL)), aabb=list(AABB), **JAX_OCC)
    state = trainer.init_state()
    params, occ = _numpy_state(state)
    cells = _cells(state)
    batch = _batch(seed=2)
    perm = jax_tp_w1_permutation(trainer.field.ranks, 2)
    state = state._replace(params=jax_permute_w1(state.params, perm))
    step, shard_state, shard_tp_batch = jax_tp_train_step(trainer, jax_make_mesh_2d(2, 2))
    state = shard_state(state)
    auxs = []
    for i in range(2):
        state, aux = step(state, shard_tp_batch(dict(batch)))
        auxs.append({k: np.asarray(v) for k, v in aux.items()})
        if i == 0:  # the state between the steps, for the bridge (the step donates it)
            adam = next(s for s in state.opt_state if hasattr(s, "mu"))
            after_one = {"params": jax.tree.map(np.asarray, state.params),
                         "occ": _numpy_state(state)[1], "step": int(state.step),
                         "adam": (int(adam.count), jax.tree.map(np.asarray, adam.mu),
                                  jax.tree.map(np.asarray, adam.nu))}
    return {"params": params, "occ": occ, "cells": cells, "batch": batch, "aux": auxs,
            "after_one": after_one, "perm": perm, "final": cp_field_params_from_numpy(
                jax.tree.map(np.asarray, state.params), device="cpu"),
            "binaries": np.asarray(state.occ_state.binaries)}


@pytest.fixture(scope="module")
def two_ranks(occ_ref, prop_ref):
    """Every two-rank case, in one gloo group of two CPU ranks."""
    field = FIELD
    cases = [
        ("occ_jax", "occ", dict(field=field, trainer=OCC, params=occ_ref["params"],
                                occ=occ_ref["occ"], batch=occ_ref["batch"], steps=1,
                                cell_jitter=occ_ref["cells"])),
        ("prop_jax", "prop", dict(field=field, prop=dict(aabb=AABB, compute_dtype=field[
            "compute_dtype"], **PROP_FIELD), trainer=PROP, params=prop_ref["params"],
            batch=prop_ref["batch"])),
        ("stratified", "occ", dict(field=field, trainer=dict(OCC, stratified=True),
                                   batch=_batch(seed=3), steps=1, single=True)),
        ("alone", "occ", dict(field=field, trainer=dict(OCC, stratified=True),
                              batch=_batch(seed=4), steps=3, single=True, group="self")),
        ("dryrun", "dryrun", 2),
    ]
    return parallel.spawn(2, dryrun.run_cases, None, cases, backend="gloo", device="cpu",
                          timeout=TIMEOUT)


@pytest.fixture(scope="module")
def four_ranks(tp_ref):
    """The tensor-parallel case on a (2, 2) mesh of four CPU ranks."""
    spec = dict(field=FIELD, trainer=OCC, params=tp_ref["params"], occ=tp_ref["occ"],
                batch=tp_ref["batch"], steps=2, cell_jitter=tp_ref["cells"])
    # JAX's state after its first step (W1 permuted, Adam's moments) carried
    # into the ranks by the bridge, then the second step
    bridged = dict(field=FIELD, trainer=OCC, batch=tp_ref["batch"], steps=1, permuted=True,
                   **tp_ref["after_one"])
    return parallel.spawn(4, dryrun.run_cases, (2, 2),
                          [("tp", "tp", spec), ("bridged", "tp", bridged)], backend="gloo",
                          device="cpu", timeout=TIMEOUT)


def _close(got, want, rtol, atol, what):
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), w.numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {name}")


def test_exports():
    """JAX's nine names, and the port's launcher, gather and dry run."""
    for name in ("make_mesh", "shard_batch", "make_dp_train_step", "make_dp_prop_step",
                 "make_mesh_2d", "make_tp_field", "make_tp_train_step", "permute_w1",
                 "tp_w1_permutation", "spawn", "gather_state", "dryrun_multichip"):
        assert callable(getattr(parallel, name)), name


def test_tp_w1_permutation_matches_jax():
    for ranks, n in (((8, 8), 2), ((32, 32, 32), 2), ((16, 64), 4)):
        np.testing.assert_array_equal(parallel.tp_w1_permutation(ranks, n),
                                      jax_tp_w1_permutation(ranks, n))


def test_dp_occ_step_matches_jax(two_ranks, occ_ref):
    """The 2-rank DP occupancy step against JAX's DP step on a 2-device
    mesh, from JAX's parameters, grid and cell jitter.  Loss and mse 1e-5
    relative; counts equal; the summed gradients at tests/test_torch_train.py's
    f32 bounds (1e-3 of each leaf's largest entry, 3e-4 relative Frobenius);
    the parameters after Adam within 1e-6 (Adam moves an entry by about lr =
    1e-4 here, tests/test_torch_prop.py's bound); the refreshed binaries
    equal; both ranks' states bitwise equal."""
    ref = occ_ref
    for rank in two_ranks:
        dp = rank["occ_jax"]["dp"]
        aux = dp["aux"][0]
        for key in ("loss", "mse"):
            assert float(aux[key]) == pytest.approx(float(ref["aux"][key]), rel=1e-5), key
        for key in ("n_rays_ok", "n_rendering_samples", "n_total_samples", "overflow"):
            assert int(aux[key]) == int(ref["aux"][key]), key
        for name, want in ref["grads"].items():
            got, want = dp["grads"][name], want.numpy()
            assert np.linalg.norm(got - want) <= 3e-4 * np.linalg.norm(want), name
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max())
        _close(dp["params"], ref["updated"], 0, 1e-6, "updated")
        np.testing.assert_array_equal(dp["binaries"], ref["binaries"])
    a, b = (r["occ_jax"]["dp"] for r in two_ranks)
    for name in a["params"]:
        np.testing.assert_array_equal(a["params"][name], b["params"][name])


def test_dp_prop_step_matches_jax(two_ranks, prop_ref):
    """The 2-rank DP proposal step against JAX's ``make_dp_prop_step``:
    loss, mse and prop loss 1e-5 relative, every leaf of both groups after
    Adam within 1e-6 (tests/test_torch_prop.py's bounds)."""
    for rank in two_ranks:
        dp = rank["prop_jax"]["dp"]
        for key in ("loss", "mse", "prop_loss"):
            assert float(dp["aux"][key]) == pytest.approx(prop_ref["aux"][key], rel=1e-5), key
        want = prop_ref["updated"]
        leaves = list(want["field"].values()) + [v for p in want["props"] for v in p.values()]
        assert len(leaves) == len(dp["params"])
        for got, w in zip(dp["params"], leaves):
            np.testing.assert_allclose(got, w.numpy(), rtol=0, atol=1e-6)


def test_dp_stratified_step_equals_global_step(two_ranks):
    """A stratified 2-rank DP step against the single-process step on the
    global batch: each rank takes its block of the global near-plane
    jitter, so only the order of the sums differs.  test_parallel.py's DP
    bounds: loss 1e-5 relative, parameters rtol 2e-4 / atol 2e-6, binaries
    equal; the two ranks' states bitwise equal."""
    single = two_ranks[0]["stratified"]["single"]
    for rank in two_ranks:
        dp = rank["stratified"]["dp"]
        assert float(dp["aux"][0]["loss"]) == pytest.approx(
            float(single["aux"][0]["loss"]), rel=1e-5)
        assert int(dp["aux"][0]["n_rendering_samples"]) == int(
            single["aux"][0]["n_rendering_samples"])
        for name, want in single["params"].items():
            np.testing.assert_allclose(dp["params"][name], want, rtol=2e-4, atol=2e-6)
        np.testing.assert_array_equal(dp["binaries"], single["binaries"])
    a, b = (r["stratified"]["dp"] for r in two_ranks)
    for name in a["params"]:
        np.testing.assert_array_equal(a["params"][name], b["params"][name])


def test_dp_in_a_group_of_one_is_train_step_bitwise(two_ranks):
    """Each rank alone in a group of one (every collective real): three
    stratified DP steps, two occupancy refreshes among them, give
    ``train_step``'s parameters, gradients, grid and aux bit for bit."""
    res = two_ranks[0]["alone"]
    dp, single = res["dp"], res["single"]
    for name in single["params"]:
        np.testing.assert_array_equal(dp["params"][name], single["params"][name])
        np.testing.assert_array_equal(dp["grads"][name], single["grads"][name])
    np.testing.assert_array_equal(dp["occs"], single["occs"])
    np.testing.assert_array_equal(dp["binaries"], single["binaries"])
    for got, want in zip(dp["aux"], single["aux"]):
        for key in want:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), key)


def test_tp_steps_match_jax(four_ranks, tp_ref):
    """Two (2, 2) DP+TP steps against JAX's ``make_tp_train_step`` from the
    same whole state, W1 in shard-major order on both: each step's loss
    1e-4 relative and counts equal, the gathered parameters after both
    steps rtol 2e-4 / atol 2e-5 (tests/test_parallel.py's TP bounds; W1
    compared in the permuted layout both keep), binaries equal."""
    gathered = four_ranks[0]["tp"]["gathered"]
    np.testing.assert_array_equal(four_ranks[0]["tp"]["perm"], tp_ref["perm"])
    for rank in four_ranks:
        for got, want in zip(rank["tp"]["aux"], tp_ref["aux"]):
            assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4)
            assert int(got["n_rendering_samples"]) == int(want["n_rendering_samples"])
    _close(gathered["params"], tp_ref["final"], 2e-4, 2e-5, "after two steps")
    np.testing.assert_array_equal(gathered["binaries"], tp_ref["binaries"])


def test_tp_step_from_a_bridged_jax_state(four_ranks, tp_ref):
    """JAX's TP state after its first step (parameters with W1 permuted,
    Adam's moments and count, the grid) carried into each rank by
    ``occ_train_state_from_numpy``: the port's second step gives JAX's
    second loss and parameters at the TP bounds."""
    res = four_ranks[0]["bridged"]
    for rank in four_ranks:
        got = rank["bridged"]["aux"][0]
        assert float(got["loss"]) == pytest.approx(float(tp_ref["aux"][1]["loss"]), rel=1e-4)
    _close(res["gathered"]["params"], tp_ref["final"], 2e-4, 2e-5, "bridged")
    assert res["gathered"]["step"] == 2


def test_tp_field_draws_its_part_of_the_whole_field(four_ranks):
    """A field from ``make_tp_field`` initialises to its rank's part of the
    whole field's draw, W1 permuted."""
    assert all(rank["tp"]["init_equal"] for rank in four_ranks)


def test_tp_sharding_is_real(four_ranks):
    """Each rank holds rank / 2 columns of every line table and rows / 2 of
    W1, and so do their Adam moments; the other leaves whole."""
    for rank in four_ranks:
        shapes = rank["tp"]["shapes"]
        for i, R in enumerate(SMALL["resolutions"]):
            assert shapes[f"encoder.lines.{i}"] == [(3, R, SMALL["ranks"][i] // 2)] * 3
        assert shapes["mlp_base.0"] == [(sum(SMALL["ranks"]) // 2, 64)] * 3
        assert shapes["mlp_base.1"] == [(64, 16)] * 3


def test_tp_checkpoint_roundtrip(four_ranks):
    """Saved from rank 0 in the gathered layout, loaded, re-sharded: the
    next step gives the live step's loss within 1e-6."""
    for rank in four_ranks:
        live, restored = rank["tp"]["roundtrip"]
        assert np.isfinite(live) and abs(live - restored) < 1e-6


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(two_ranks, n):
    """The dry run on gloo CPU ranks: n = 2 in the two-rank group, n = 4
    through ``dryrun_multichip`` (a (2, 2) mesh); JAX's line, finite
    losses, the round trip within 1e-6."""
    res = two_ranks[0]["dryrun"] if n == 2 else parallel.dryrun_multichip(
        4, backend="gloo", device="cpu", timeout=TIMEOUT)[0]
    mesh = "data=2 x model=1" if n == 2 else "data=2 x model=2"
    assert res["line"].startswith(
        f"dryrun_multichip({n}): ok (occ mesh {mesh}, prop DP x{n}, ckpt-roundtrip=ok), loss=")
    assert np.isfinite(res["loss"]) and np.isfinite(res["prop_loss"])
    assert abs(res["live"] - res["restored"]) < 1e-6
