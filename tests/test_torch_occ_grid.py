"""Port vs JAX: the dense occupancy refresh (EMA-max over every cell, then
binarisation), with the JAX package's own cell jitter injected."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.estimators.occ_grid import OccGridState as JaxOccGridState
from nerfacc_tpu.estimators.occ_grid import init_occ_grid as jax_init_occ_grid
from nerfacc_tpu.estimators.occ_grid import update_occ_grid as jax_update_occ_grid
from nerfacc_tpu.models.cp_field import CPRadianceField as JaxField
from nerfacc_tpu_torch.estimators.occ_grid import init_occ_grid, update_occ_grid
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.utils.jax_bridge import (
    cp_field_params_from_numpy,
    occ_state_from_numpy,
    occ_state_to_numpy,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
STEP = 5e-3
SMALL = dict(resolutions=(16, 32, 64), ranks=(8, 8, 8))


@pytest.mark.parametrize("levels", [1, 2])
def test_dense_update_matches_jax(levels):
    jfield = JaxField(aabb=AABB, compute_dtype=jnp.float32, **SMALL)
    jparams = jfield.init(jax.random.PRNGKey(levels))
    field = CPRadianceField(AABB, compute_dtype=torch.float32, **SMALL)
    field.load_state_dict(
        cp_field_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    )

    jstate = jax_init_occ_grid(jnp.asarray(AABB), 32, levels)
    # a prior EMA state, with some cells marked invisible (-1)
    rng = np.random.default_rng(levels)
    occs = rng.uniform(0, 0.05, jstate.occs.shape).astype(np.float32)
    occs[rng.uniform(size=occs.shape) < 0.1] = -1.0
    jstate = JaxOccGridState(jstate.aabbs, jnp.asarray(occs), jstate.binaries)
    state = occ_state_from_numpy(*(np.asarray(a) for a in (
        jstate.aabbs, jstate.occs, jstate.binaries)), device="cpu")

    key = jax.random.PRNGKey(7)
    jitter = jax.random.uniform(
        jax.random.split(key, 4)[3], (levels, 32**3, 3), jnp.float32
    )
    ref = jax_update_occ_grid(
        jstate, key, jnp.asarray(0),
        lambda x: jfield.query_density(jparams, x)[..., 0] * STEP,
        dense=True,
    )
    with torch.no_grad():
        out = update_occ_grid(
            state,
            lambda x: field.query_density(x)[..., 0] * STEP,
            torch.tensor(np.asarray(jitter)),
            eval_chunk=5000,  # several chunks, one ragged
        )

    ref_occs = np.asarray(ref.occs)
    np.testing.assert_allclose(out.occs.numpy(), ref_occs, rtol=1e-5, atol=1e-9)
    visible = ref_occs >= 0
    thre = min(ref_occs[visible].mean(), 1e-2)
    far_from_thre = np.abs(ref_occs - thre) > 1e-6
    b, rb = out.binaries.numpy().reshape(-1), np.asarray(ref.binaries).reshape(-1)
    np.testing.assert_array_equal(b[far_from_thre], rb[far_from_thre])
    assert 0.05 < b.mean() < 0.95


def test_init_and_bridge_round_trip():
    jstate = jax_init_occ_grid(jnp.asarray(AABB), (8, 16, 32), 3)
    state = init_occ_grid(AABB, (8, 16, 32), 3, device="cpu")
    np.testing.assert_array_equal(state.aabbs.numpy(), np.asarray(jstate.aabbs))
    assert state.binaries.shape == jstate.binaries.shape
    assert state.binaries.dtype == torch.bool
    rng = np.random.default_rng(0)
    arrays = (
        np.asarray(jstate.aabbs),
        rng.uniform(-1, 1, state.occs.shape).astype(np.float32),
        rng.uniform(size=state.binaries.shape) < 0.5,
    )
    for a, b in zip(occ_state_to_numpy(occ_state_from_numpy(*arrays, device="cpu")), arrays):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("levels", [1, 2])
def test_per_cell_data_follows_its_cells_across_chunks(levels):
    """``cell_data`` reaches ``occ_eval_fn`` beside its own cells' points in
    every chunk, a ragged last one included: each cell's value comes back as
    its occupancy, and the point handed with it lies inside that cell."""
    state = init_occ_grid(AABB, 16, levels, device="cpu")
    cells = state.cells_per_lvl
    jitter = torch.rand((levels, cells, 3), generator=torch.Generator().manual_seed(3))
    ids = torch.arange(levels * cells)
    seen = []

    def occ_eval_fn(x, data):
        seen.append((x, data))
        return data.to(torch.float32) / (levels * cells)

    out = update_occ_grid(state, occ_eval_fn, jitter, eval_chunk=1000, cell_data=ids)
    assert len(seen) == -(-levels * cells // 1000)
    torch.testing.assert_close(out.occs, ids.to(torch.float32) / (levels * cells),
                               rtol=0, atol=0)
    x = torch.cat([s[0] for s in seen])
    data = torch.cat([s[1] for s in seen])
    lvl, cell = data // cells, data % cells
    lo, hi = state.aabbs[lvl, :3], state.aabbs[lvl, 3:]
    ijk = torch.floor((x - lo) / (hi - lo) * 16).long()
    assert torch.equal(ijk[:, 0] * 256 + ijk[:, 1] * 16 + ijk[:, 2], cell)
