"""Port vs JAX: the multiresolution hash encode (the CPU twins of kernels
G6/G7) against the JAX package's HashGridEncoder on its XLA path, against
its Pallas kernel K4 in interpret mode, and its table gradient against
jax.grad of both table-gradient modes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.models.encoders import HashGridEncoder as JaxEncoder
from nerfacc_tpu.models.encoders import _hash_corners
from nerfacc_tpu_torch.models.encoders import HashGridEncoder
from nerfacc_tpu_torch.ops.hash_encode import (
    BWD_MAX_SLOTS,
    hash_bwd_item_samples,
    hash_bwd_operations,
    hash_bwd_workspace_words,
    hash_corners_plain,
    hash_encode,
    hash_encode_backward,
    hash_encode_backward_plain,
    hash_encode_forward,
    hash_encode_plain,
)
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

# (n_levels, log2_hashmap_size, base_resolution, max_resolution)
NGP = (16, 12, 16, 4096)  # the NGP field's levels and resolutions, T cut
DENSITY = (5, 11, 16, 128)  # the proposal density field's


def _encoders(levels, log2_t, base, top, **jax_kw):
    kw = dict(n_levels=levels, log2_hashmap_size=log2_t, base_resolution=base,
              max_resolution=top)
    return JaxEncoder(n_features_per_level=2, **kw, **jax_kw), HashGridEncoder(**kw)


def _inputs(seed, n, levels, log2_t):
    """Points in [-0.1, 1.1]^3 (some outside the grid, so some corners lie
    below 0 and wrap in uint32), an O(1) table and a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    table = rng.uniform(-1.0, 1.0, (levels, 1 << log2_t, 2)).astype(np.float32)
    cot = rng.standard_normal((n, 2 * levels)).astype(np.float32)
    return x, table, cot


@pytest.mark.parametrize("levels,base,top", [(16, 16, 4096), (4, 4, 128), (5, 16, 128)])
def test_resolutions_match_jax(levels, base, top):
    """floor(base * growth^l) in f64, as the JAX package evaluates it (the
    finest level can fall one short of ``top``: 4095 at 16 levels)."""
    jax_enc, enc = _encoders(levels, 12, base, top)
    assert enc.resolutions == jax_enc.resolutions
    assert len(enc.resolutions) == levels and enc.resolutions[0] == base
    assert enc.output_dim == jax_enc.output_dim and enc.table_size == jax_enc.table_size


@pytest.mark.parametrize("cfg", [NGP, DENSITY], ids=["ngp", "density"])
def test_corners_match_jax_bitwise(cfg):
    """Hash ids and trilinear weights equal JAX's bit for bit, points below
    0 included: ``frac = pos - floor(pos)`` with ``pos`` rounded first is
    what XLA's CPU backend computes (no fused multiply-add)."""
    levels, log2_t = cfg[:2]
    jax_enc, enc = _encoders(*cfg)
    x, _, _ = _inputs(0, 4000, levels, log2_t)
    idx_ref, w_ref = jax.jit(
        lambda x: _hash_corners(x, jax_enc.resolutions, jax_enc.table_size)
    )(jnp.asarray(x))
    idx, w = hash_corners_plain(torch.tensor(x), enc.resolutions, enc.table_size)
    assert (x < 0).any()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_ref))
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_ref))


@pytest.mark.parametrize("cfg", [NGP, DENSITY], ids=["ngp", "density"])
def test_twin_matches_jax_xla_encoder(cfg):
    """The forward twin against HashGridEncoder(lookup="xla") under jit, as
    every JAX field and trainer runs it: bit for bit.  Corners and weights
    are equal (above), and jitted XLA on the CPU sums the corners as fused
    multiply-adds in the order c = 0..7, as the twin does.  Eager JAX rounds
    each product first, which differs in the last bit on ~44% of outputs:
    within 1e-6 of the largest entry."""
    levels, log2_t = cfg[:2]
    jax_enc, enc = _encoders(*cfg, lookup="xla")
    x, table, _ = _inputs(1, 3000, levels, log2_t)
    args = (jnp.asarray(table), jnp.asarray(x))
    got = hash_encode_plain(torch.tensor(x), torch.tensor(table), enc.resolutions)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax.jit(jax_enc.__call__)(*args)))
    eager = np.asarray(jax_enc(*args))
    np.testing.assert_allclose(got.numpy(), eager, rtol=0, atol=1e-6 * np.abs(eager).max())
    with torch.no_grad():
        enc.table.copy_(torch.tensor(table))
        np.testing.assert_array_equal(enc(torch.tensor(x)).numpy(), got.numpy())


@pytest.mark.parametrize(
    "cfg,n", [((16, 12, 4, 128), 300), ((5, 11, 4, 64), 123), ((8, 11, 4, 64), 200)],
    ids=["L16", "L5", "L8"],
)
def test_twin_matches_pallas_kernel_k4(cfg, n):
    """Against K4 itself (nerfacc_tpu/ops/hash_vmem.py, interpret mode) at
    the shapes of tests/test_hash_vmem.py: 1e-5, that test's bound (K4
    sums its lane folds in another order)."""
    levels, log2_t = cfg[:2]
    jax_enc, enc = _encoders(*cfg, lookup="vmem")
    x, table, _ = _inputs(2, n, levels, log2_t)
    x = np.clip(x, 0.0, 1.0)  # K4's fold assumes in-grid points
    want = np.asarray(jax_enc(jnp.asarray(table), jnp.asarray(x)))
    got = hash_encode_plain(torch.tensor(x), torch.tensor(table), enc.resolutions)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("table_grad", ["scatter", "sorted_blocks"])
@pytest.mark.parametrize("cfg", [NGP, DENSITY], ids=["ngp", "density"])
def test_table_gradient_matches_jax(cfg, table_grad):
    """The table gradient through ``hash_encode``'s autograd (the G7 twin)
    against jax.grad of both JAX table-gradient modes, within 1e-5 of the
    largest entry (the same rounded f32 updates, summed in another order by
    the sorted blocks; in the same order by XLA's scatter on the CPU)."""
    levels, log2_t = cfg[:2]
    jax_enc, enc = _encoders(*cfg, table_grad=table_grad)
    x, table, cot = _inputs(3, 2500, levels, log2_t)
    want = np.asarray(jax.grad(
        lambda t: jnp.sum(jax_enc(t, jnp.asarray(x)) * cot)
    )(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    (hash_encode(torch.tensor(x), t, enc.resolutions) * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    direct = hash_encode_backward_plain(
        torch.tensor(x), torch.tensor(cot), table.shape, enc.resolutions
    )
    np.testing.assert_array_equal(direct.numpy(), t.grad.numpy())


def test_wrappers_run_the_twins_on_cpu_tensors():
    x, table, cot = _inputs(4, 500, 5, 11)
    x, table, cot = torch.tensor(x), torch.tensor(table), torch.tensor(cot)
    res = (16, 23, 33, 48, 70)
    torch.testing.assert_close(
        hash_encode_forward(x, table, res), hash_encode_plain(x, table, res), rtol=0, atol=0
    )
    torch.testing.assert_close(
        hash_encode_backward(x, cot, table.shape, res),
        hash_encode_backward_plain(x, cot, table.shape, res), rtol=0, atol=0,
    )


def test_hash_encode_refuses_a_position_gradient():
    """No position gradient exists on this path: asking for one raises
    rather than returning none."""
    enc = HashGridEncoder(n_levels=2, log2_hashmap_size=8, max_resolution=32)
    x = torch.rand(10, 3, requires_grad=True)
    with pytest.raises(ValueError, match="position gradient"):
        enc(x)
    assert enc(x.detach()).shape == (10, 4)


def test_init_draws_the_tcnn_range():
    enc = HashGridEncoder(n_levels=4, log2_hashmap_size=12).init(
        torch.Generator().manual_seed(0)
    )
    table = enc.table.detach()
    assert table.shape == (4, 4096, 2)
    assert float(table.abs().max()) <= 1e-4 and float(table.abs().max()) > 0.99e-4
    assert abs(float(table.mean())) < 2e-6


@pytest.mark.parametrize("levels,log2_t,want", [
    (16, 19, 28 + 8 * 2 * 2**19 + 8 * 2**19 // 4),  # the NGP field: 72 MiB
    (5, 17, 12 + 5 * 2 * 2**17 + 5 * 2**17 // 4),  # NGPDensityField
    (1, 4, 4 + 2 * 16 + 4),  # T = 2^4
    (3, 0, 8 + 3 * 2 * 2 + 2),  # T = 1 takes two rows a slot, the flags round up
])
def test_g7_workspace_holds_a_slot_a_level_up_to_eight(levels, log2_t, want):
    """G7's workspace (the kernel refuses less): a head of counts in 32-byte
    units, then min(L, BWD_MAX_SLOTS) level slots of int64 sums and their
    flag bytes, whatever the sample count; at the NGP field's shape 75.5
    MB, where the int64 twin of the whole table and its flags took 151 MB."""
    assert BWD_MAX_SLOTS == 8
    words = hash_bwd_workspace_words(levels, 1 << log2_t)
    assert words == want
    head = (2 + 3 * levels + 7) // 8 * 4
    assert head * 2 >= 2 + 3 * levels and head % 4 == 0
    if (levels, log2_t) == (16, 19):
        entries = 16 * 2**19 * 2
        assert round(8 * words / 1e6, 1) == 75.5
        assert round(8 * (entries + entries // 8 + 1) / 1e6, 1) == 151.0


def test_g7_operations_replay_counts_records_and_runs():
    """The replay of G7's operations on hand-placed points: a level that is
    not staged takes one 32-byte bulk reduction for each pair of corners of
    a cell with even x index, two 16-byte ones for an odd one, and a run of
    lanes on one record counts once; a staged level (res 16) adds into its
    cube and writes each touched cell out, and a corner outside the cube is
    one atomic a feature."""
    res = (16, 100)
    # level 1 (res 100): cells x = 10 (even) for lanes 0-2, 11 (odd) for lane 3
    x = torch.tensor([[0.101, 0.5, 0.5], [0.102, 0.5, 0.5], [0.103, 0.5, 0.5],
                      [0.115, 0.5, 0.5]])
    rows = hash_corners_plain(x, res[1:], 2**12)[0][:, 0]  # (4, 8)
    assert bool(((rows[:3, 4:] ^ rows[:3, :4]) == 1).all())  # even: row pairs
    ops = hash_bwd_operations(x, res, 2**12)
    assert ops["bulk_32"] == 4 and ops["bulk_16"] == 8
    # level 0: all four samples in one cell: eight runs, all inside the
    # cube, its eight cells written out
    assert ops["shared"] == 2 * 8 and ops["atomics"] == 2 * 8
    # a point below 0 puts its level-0 corners with x index -1 outside the
    # cube; at level 1 its cell's x index is -1, odd (uint32 wrap)
    y = torch.tensor([[-0.01, 0.5, 0.5]])
    ops = hash_bwd_operations(y, res, 2**12)
    assert ops["shared"] == 2 * 4 and ops["atomics"] == 2 * 4 + 2 * 4
    assert ops["bulk_32"] == 0 and ops["bulk_16"] == 8
    # lanes 31 and 32 lie in different warps: no run across them
    z = torch.full((33, 3), 0.5)
    ops = hash_bwd_operations(z, res, 2**12)
    assert ops["bulk_32"] == 2 * 4 and ops["bulk_16"] == 0
    # cells of one cube in two items (four times the other levels' samples)
    # are written out by each
    w = torch.full((4 * hash_bwd_item_samples(5000) + 1, 3), 0.5)
    assert hash_bwd_operations(w, (16,), 2**12)["atomics"] == 2 * 2 * 8


@pytest.mark.parametrize("n,want", [(0, 2048), (2**18, 2048), (2**20 - 1, 2048),
                                    (2**20, 4096), (2**22, 4096)])
def test_g7_item_samples(n, want):
    """The samples of a level one G7 sum item takes: a multiple of the
    kernel's 512 threads (it refuses others), 2048, and 4096 from 2^20
    samples on (the 360 cascade's first proposal level)."""
    assert hash_bwd_item_samples(n) == want and want % 512 == 0
