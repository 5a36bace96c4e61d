"""Port vs JAX, the gathers: kernels G11 (K5, coarse-occupancy lookup), G12
(K6, per-lane gather) and G13 (P1, row gather) through their plain
versions, against the Pallas kernels in interpret mode and jnp.take, bit for
bit, out-of-range indices included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu.ops.coarse_occ import coarse_occ_lookup as jax_coarse_occ_lookup
from nerfacc_tpu.ops.lane_gather import lane_gather as jax_lane_gather
from nerfacc_tpu_torch.ops.coarse_occ import coarse_occ_lookup
from nerfacc_tpu_torch.ops.lane_gather import lane_gather, lane_gather_plain, lane_gather_route
from nerfacc_tpu_torch.ops.row_gather import row_gather
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)


def _bits(a):
    """Compare floats by their bits (NaN included); bf16 through f32."""
    a = np.asarray(a)
    if a.dtype != np.float32:
        a = a.astype(np.float32)
    return a.view(np.int32)


@pytest.mark.parametrize("binary", [True, False], ids=["binary", "non-binary"])
def test_coarse_occ_lookup_matches_interpreted_k5(binary):
    """A (64, 256) summary, 1000 lookups plus out-of-range rows and lanes
    (negative, at and past the end), against K5 interpreted: bit for bit.
    A non-binary summary shows K5's bf16 rounding of the table."""
    rng = np.random.default_rng(0)
    rows, lanes = 64, 256
    S = rng.uniform(size=(rows, lanes)).astype(np.float32)
    if binary:
        S = (S > 0.8).astype(np.float32)
    row = rng.integers(0, rows, 1000).astype(np.int32)
    lane = rng.integers(0, lanes, 1000).astype(np.int32)
    row[:6] = [-1, rows, rows + 7, 3, 5, -(2**31)]
    lane[6:12] = [-1, lanes, lanes + 3, 2**31 - 1, 0, lanes - 1]
    want = jax_coarse_occ_lookup(jnp.asarray(row), jnp.asarray(lane), jnp.asarray(S), interpret=True)
    got = coarse_occ_lookup(torch.tensor(row), torch.tensor(lane), torch.tensor(S))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert (got[:3] == 0).all() and (got[6:9] == 0).all() and got[5] == 0
    if not binary:
        assert (got[12:].numpy() != S[row[12:], lane[12:]]).any()  # rounded to bf16


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_lane_gather_matches_interpreted_k6(dtype):
    """tests/test_lane_gather.py's shapes (T = 64, 256 rows x 128 lanes),
    in src's dtype, with indices in [-T, 0) (counted from the end) and
    outside [-T, T) (NaN), against K6 interpreted: bit for bit."""
    rng = np.random.default_rng(1)
    T, N = 64, 256
    src = rng.standard_normal((T, 128)).astype(np.float32)
    idx = rng.integers(0, T, (N, 128)).astype(np.int32)
    idx[0, :6] = [-1, -T, T, -T - 1, 2**31 - 1, -(2**31)]
    want = jax_lane_gather(jnp.asarray(src, dtype), jnp.asarray(idx), interpret=True)
    tsrc = torch.tensor(src).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    got = lane_gather(tsrc, torch.tensor(idx))
    assert got.dtype == tsrc.dtype and got.shape == (N, 128)
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(np.asarray(want)))
    assert torch.isnan(got[0, 2:6].float()).all() and not torch.isnan(got[1:].float()).any()


def test_lane_gather_shape_errors():
    """K6's two errors, with its messages."""
    with pytest.raises(ValueError, match="multiple of T"):
        lane_gather(torch.zeros((64, 128)), torch.zeros((96, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="128 lanes"):
        lane_gather(torch.zeros((64, 64)), torch.zeros((64, 64), dtype=torch.int32))


@pytest.mark.parametrize("F", [128, 2, 3], ids=["P1-rows", "P1-ngp-width", "odd-width"])
def test_row_gather_matches_numpy_and_jnp_take(F):
    """P1's row gather ``out[i] = tab[idx[i]]`` (a 2^10-row table here)
    against numpy fancy indexing where the indices are in range, and
    against jnp.take (P1's XLA baseline) everywhere: an index in [-T, 0)
    counts from the end, one outside [-T, T) reads NaN."""
    rng = np.random.default_rng(F)
    T = 1024
    tab = rng.standard_normal((T, F)).astype(np.float32)
    idx = rng.integers(0, T, 4096).astype(np.int32)
    got = row_gather(torch.tensor(tab), torch.tensor(idx))
    np.testing.assert_array_equal(got.numpy(), tab[idx])
    idx[:5] = [-1, -T, T, -T - 1, 2**31 - 1]
    got = row_gather(torch.tensor(tab), torch.tensor(idx))
    want = jax.jit(lambda t, i: jnp.take(t, i, axis=0))(jnp.asarray(tab), jnp.asarray(idx))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    assert torch.isnan(got[2:5]).all()


def test_coarse_occ_lookup_rounds_bf16_ties_to_even():
    """A summary of bf16 ties (f32 values halfway between two bf16 numbers,
    both parities of the last bf16 bit), against K5 interpreted: bit for
    bit.  This pins round-to-nearest-even in the plain version, which the
    card holds G11 to; truncation or rounding half away from zero would
    differ on half of the entries."""
    rng = np.random.default_rng(5)
    rows, lanes = 32, 128
    high = rng.integers(0x3F00, 0x4100, (rows, lanes), dtype=np.uint32)  # ~[0.5, 8)
    high[:, ::2] |= 1  # odd last bf16 bit: the tie rounds up
    high[:, 1::2] &= ~np.uint32(1)  # even: the tie rounds down
    S = ((high << 16) | 0x8000).view(np.float32)
    row = np.repeat(np.arange(rows, dtype=np.int32), lanes)
    lane = np.tile(np.arange(lanes, dtype=np.int32), rows)
    want = jax_coarse_occ_lookup(jnp.asarray(row), jnp.asarray(lane), jnp.asarray(S), interpret=True)
    got = coarse_occ_lookup(torch.tensor(row), torch.tensor(lane), torch.tensor(S))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    up = (high + 1) << 16  # an odd last bit rounds up, to the even neighbour
    np.testing.assert_array_equal(_bits(got.numpy()).reshape(rows, lanes)[:, ::2],
                                  up[:, ::2].view(np.int32))
    np.testing.assert_array_equal(_bits(got.numpy()).reshape(rows, lanes)[:, 1::2],
                                  (high[:, 1::2] << 16).view(np.int32))


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("T, dtype, route", [
    # chip_smoke.py phase 1e's tables: T = 512, 2^14, and 2^16 (also the
    # NGP-shaped lookup's)
    (512, F32, 32), (512, BF16, 32), (2**14, F32, 0), (2**14, BF16, 16),
    (2**16, F32, 0), (2**16, BF16, 0),
    # each side of each boundary: a block keeps 224 KB of table rows, 7168
    # rows of 32 bytes or 14336 of 16; 32-byte rows hold while half the rows
    # fit (f32) or three quarters (bf16), 16-byte rows while half fit
    (7168, F32, 32), (7169, F32, 32), (14336, F32, 32), (14337, F32, 0),
    (7169, BF16, 32), (9557, BF16, 32), (9558, BF16, 16), (14336, BF16, 16),
    (14337, BF16, 16), (28672, BF16, 16), (28673, BF16, 0),
], ids=lambda v: str(v).replace("torch.", ""))
def test_lane_gather_route_is_a_function_of_the_table(T, dtype, route):
    """G12's route from (T, dtype) alone: the bytes of each table row a
    block keeps in shared memory, or 0 past the shared-memory route."""
    assert lane_gather_route(T, dtype) == route


@pytest.mark.parametrize("T, dtype, route", [
    (3584, F32, 32), (3585, F32, 0), (2389, BF16, 32), (2390, BF16, 16), (7168, BF16, 16),
    (7169, BF16, 0),
], ids=lambda v: str(v).replace("torch.", ""))
def test_lane_gather_route_follows_the_table_budget(monkeypatch, T, dtype, route):
    """The route boundaries move with SHARED_TABLE_BYTES, the one budget the
    wrapper also passes to the kernel: at a quarter of it, a quarter of the
    heights."""
    import nerfacc_tpu_torch.ops.lane_gather as lane_gather_mod

    monkeypatch.setattr(lane_gather_mod, "SHARED_TABLE_BYTES", lane_gather_mod.SHARED_TABLE_BYTES // 4)
    assert lane_gather_mod.lane_gather_route(T, dtype) == route


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_lane_gather_at_the_largest_shared_memory_table(dtype):
    """K6 interpreted on the largest table of G12's shared-memory route
    (T = 14336 f32, 28672 bf16, one block of T rows) against the plain
    version, indices in [-T - 8, T + 8): bit for bit."""
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    T = 28672 if dtype == jnp.bfloat16 else 14336
    assert lane_gather_route(T, tdtype) > 0 and lane_gather_route(T + 1, tdtype) == 0
    rng = np.random.default_rng(T)
    src = rng.standard_normal((T, 128)).astype(np.float32)
    idx = rng.integers(-T - 8, T + 8, (T, 128)).astype(np.int32)
    want = jax_lane_gather(jnp.asarray(src, dtype), jnp.asarray(idx), interpret=True)
    got = lane_gather_plain(torch.tensor(src).to(tdtype), torch.tensor(idx))
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(np.asarray(want)))
    assert torch.isnan(got.float()).any() and not torch.isnan(got.float()).all()
