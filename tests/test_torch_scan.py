"""Port vs JAX: the segmented scans of nerfacc_tpu_torch/scan.py (the four
scans on the batched, ``packed_info`` and ``indices`` layouts, with
``normalize``), their gradients, and ``pack_info``.  Inputs are made with
numpy from a seed and fed to both packages."""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfacc_tpu import scan as jax_scan
from nerfacc_tpu.pack import pack_info as jax_pack_info
from nerfacc_tpu_torch import scan
from nerfacc_tpu_torch.pack import pack_info
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

SUMS = ("inclusive_sum", "exclusive_sum")
PRODS = ("inclusive_prod", "exclusive_prod")
# chunk counts with empty rows, first and inside
COUNTS = np.array([0, 3, 0, 5, 1, 0, 4, 7], np.int32)
# runs of equal ids out of order; id 0 forms three separate runs
RUN_IDS = np.array([2, 2, 0, 0, 0, 1, 3, 3, 0, 0, 4, 0, 5, 5, 5, 5], np.int32)


def _layouts(rng, zeros):
    """(name, inputs, packed_info, indices) for each layout."""
    def vals(shape):
        v = rng.uniform(0.2, 1.5, shape).astype(np.float32)
        if zeros:  # exact zeros, several in one segment
            v.reshape(-1)[rng.choice(v.size, v.size // 5, replace=False)] = 0.0
        return v

    n = int(COUNTS.sum())
    packed = np.stack([np.cumsum(COUNTS) - COUNTS, COUNTS], -1).astype(np.int32)
    return [
        ("batched", vals((4, 9)), None, None),
        ("packed_info", vals((n,)), packed, None),
        ("indices", vals((RUN_IDS.shape[0],)), None, RUN_IDS),
    ]


def _jax(name, x, packed, ids, normalize):
    kw = dict(packed_info=None if packed is None else jnp.asarray(packed),
              indices=None if ids is None else jnp.asarray(ids))
    if normalize:
        kw["normalize"] = True
    return getattr(jax_scan, name)(x, **kw)


def _port(name, x, packed, ids, normalize):
    kw = dict(packed_info=None if packed is None else torch.tensor(packed),
              indices=None if ids is None else torch.tensor(ids))
    if normalize:
        kw["normalize"] = True
    return getattr(scan, name)(x, **kw)


@pytest.mark.parametrize("layout", ["batched", "packed_info", "indices"])
@pytest.mark.parametrize("name,normalize", [
    *((n, False) for n in SUMS + PRODS), *((n, True) for n in SUMS),
])
def test_scan_matches_jax(name, normalize, layout):
    """Values within 1e-6 relative (1e-6 absolute), and the gradient of a
    random weighting of the output within 1e-5 of its largest entry; the
    products with exact zeros in the inputs, whose gradient both packages
    take exactly (JAX's associative scan, autograd's cumprod)."""
    rng = np.random.default_rng(zlib.crc32(f"{name}-{normalize}-{layout}".encode()))
    _, x, packed, ids = next(lay for lay in _layouts(rng, name in PRODS) if lay[0] == layout)
    w = rng.normal(size=x.shape).astype(np.float32)

    want = np.asarray(_jax(name, jnp.asarray(x), packed, ids, normalize))
    want_grad = np.asarray(jax.grad(
        lambda v: jnp.sum(_jax(name, v, packed, ids, normalize) * jnp.asarray(w))
    )(jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    out = _port(name, tx, packed, ids, normalize)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), want_grad, rtol=0,
                               atol=1e-5 * np.abs(want_grad).max())
    if name in PRODS:
        assert (x == 0).any() and np.isfinite(tx.grad.numpy()).all()


def test_segments_are_runs_and_sums_are_segment_local():
    """With ``indices`` a segment is a run: id 0's three runs restart the
    sum.  A run of large values ahead of a small one leaves the small
    run's sums exact (a global cumsum differenced at the start would not)."""
    ids = torch.tensor([0, 0, 1, 0, 0, 2, 2])
    x = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 1e8, 1e8])
    torch.testing.assert_close(
        scan.inclusive_sum(x, indices=ids), torch.tensor([1.0, 3.0, 4.0, 8.0, 24.0, 1e8, 2e8])
    )
    big = torch.cat([torch.full((4096,), 1e7), torch.full((5,), 1e-3)])
    ids = torch.cat([torch.zeros(4096, dtype=torch.long), torch.ones(5, dtype=torch.long)])
    out = scan.exclusive_sum(big, indices=ids)[-5:]
    torch.testing.assert_close(out, torch.arange(5, dtype=torch.float32) * 1e-3,
                               rtol=1e-6, atol=0)


def test_empty_and_all_empty_rows():
    """No samples at all, and packed rows that are all empty."""
    for name in SUMS + PRODS:
        out = getattr(scan, name)(torch.zeros(0), indices=torch.zeros(0, dtype=torch.long))
        assert out.shape == (0,)
    packed = torch.tensor([[0, 0], [0, 2], [2, 0]])
    torch.testing.assert_close(
        scan.exclusive_prod(torch.tensor([3.0, 5.0]), packed_info=packed),
        torch.tensor([1.0, 3.0]),
    )


@pytest.mark.parametrize("with_n", [True, False])
def test_pack_info_matches_jax(with_n):
    """Equal, trailing empty rays included when ``n_rays`` is given."""
    ids = np.repeat(np.arange(6), [2, 0, 3, 1, 0, 4]).astype(np.int32)
    n = 8 if with_n else None
    want = np.asarray(jax_pack_info(jnp.asarray(ids), n))
    got = pack_info(torch.tensor(ids), n)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
