"""Sums whose result does not depend on the order of their terms.

The JAX package's scatter-adds are ordered on the TPU and on the CPU, so a
train step gives the same bits on every run.  On the card a floating-point
atomic adds in whatever order the threads reach it, so the port sums in one
of two ways that fix the result:

* **Fixed point** (kernels G4 and G7 and their plain versions).  A term
  ``t = w * c`` (a weight ``w <= 1`` times a cotangent ``c``) becomes the
  int64 ``round(w * (c * 2^k))``, both products rounded to f32, with one
  power of two ``2^k`` per launch taken from a bound on the largest term and
  on the count of terms an entry may take, so that no sum reaches 2^62.
  Scaling ``c`` once is exact (``c * 2^k`` stays an f32 normal or rounds a
  term far below the quantum), and spares the kernels a multiply a term.
  Integer adds do not depend on their order, so the kernel, whatever its
  blocking, and the plain version here give the same int64 sums, and the
  same f32 result, ``f32(f64(sum) * 2^-k)``.  A term that is +-inf or NaN
  is kept apart and makes its entry what an f64 sum of the entry's terms
  would (NaN where both infinities meet).  The bound is a power of two from
  the exponents of the operands' largest finite magnitudes
  (:func:`exponent_bound`), so the kernel's integer arithmetic and this
  module's agree on ``k``.
* **A sorted sum** (:func:`index_add_rows`, :func:`take_along_last`): on the
  card PyTorch's ``index_put_(..., accumulate=True)`` sorts the indices and
  adds each row's terms in their order; on the CPU ``index_add_`` adds them
  serially in order, where ``index_put_``'s accumulation runs in parallel
  and rounds differently from run to run.
"""
from __future__ import annotations

import torch

# |sum| < 2^62 for every entry, and the scale 2^k an f32 normal: at most
# 2^127, which leaves terms below 2^-127 rounded (to 0), far below any
# quantum a real bound gives
SUM_BITS = 62
MAX_EXPONENT = 127


def exponent_bound(x: torch.Tensor) -> torch.Tensor:
    """For finite, non-negative f32 ``x``: the int64 ``e`` with ``x < 2^e``,
    ``E - 126`` for the biased exponent ``E`` (zero and subnormals: -126)."""
    return (x.to(torch.float32).contiguous().view(torch.int32) >> 23).long() - 126


def finite_abs_max(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The largest finite ``|x|`` (0 if there is none), over all of ``x`` or
    over ``dim``, as f32."""
    a = x.to(torch.float32).abs()
    a = torch.where(torch.isfinite(a), a, torch.zeros((), dtype=a.dtype, device=a.device))
    if a.numel() == 0:
        shape = () if dim is None else tuple(s for i, s in enumerate(a.shape) if i not in dim)
        return a.new_zeros(shape)
    return a.amax() if dim is None else a.amax(dim=dim)


def scale_exponent(term_exponent: torch.Tensor, count: int) -> torch.Tensor:
    """``k`` for terms below ``2^term_exponent``, at most ``count`` of them
    an entry: ``count * 2^(term_exponent + k) <= 2^61``, and ``k`` at most
    :data:`MAX_EXPONENT`.  Finite f32 terms lie below 2^128."""
    bits = int(count).bit_length() + 1
    e = term_exponent.clamp(max=128)
    return (SUM_BITS - bits - e).clamp(max=MAX_EXPONENT)


def pow2(k: torch.Tensor) -> torch.Tensor:
    """``2^k`` as f64, exactly, for int64 ``k`` in f64's normal range."""
    return ((k.long() + 1023) << 52).view(torch.float64)


def scale(c: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``c * 2^k`` in f32, ``2^k`` an f32 normal (``-126 <= k <= 127``);
    ``k`` broadcasts against ``c``."""
    return c * ((k.long() + 127) << 23).int().view(torch.float32)


def quantize(t: torch.Tensor):
    """Scaled f32 terms as fixed point: ``(round(t) as int64, the
    non-finite terms as f64)``, the finite terms 0 in the second and the
    others 0 in the first.  Rounding is to nearest even, as the kernels'
    ``__float2ll_rn``."""
    finite = torch.isfinite(t)
    zero = torch.zeros((), dtype=t.dtype, device=t.device)
    q = torch.round(torch.where(finite, t, zero)).long()
    return q, torch.where(finite, zero, t).double()


def from_fixed(acc: torch.Tensor, special: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """The f32 entries ``f32(f64(acc) * 2^-k)``, or, where an entry took a
    non-finite term, f32 of the f64 sum of those terms (NaN as the kernels
    write it)."""
    out = (acc.double() * pow2(-k)).float()
    out = torch.where(special != 0, special.float(), out)
    return torch.where(torch.isnan(out), torch.full_like(out, float("nan")), out)


def index_add_rows(out: torch.Tensor, idx: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``out[idx[i]] += src[i]`` in place, each row's terms added in their
    order: ``index_put_(..., accumulate=True)`` (sorted) on the card,
    ``index_add_`` (serial) elsewhere.  Differentiable in ``src``."""
    if out.is_cuda:
        return out.index_put_((idx,), src, accumulate=True)
    return out.index_add_(0, idx, src)


def take_along_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x.gather(-1, idx)`` for ``idx`` of ``x``'s shape but the last axis,
    whose backward sums each entry's cotangents in a fixed order: advanced
    indexing (an ``index_put_`` accumulation, sorted) on the card, where
    ``gather``'s backward is an atomic ``scatter_add_``; ``gather`` (a serial
    scatter per row) elsewhere."""
    if not x.is_cuda:
        return x.gather(-1, idx)
    lead = torch.meshgrid(*[torch.arange(s, device=x.device) for s in idx.shape[:-1]],
                          indexing="ij")
    return x[tuple(i[..., None] for i in lead) + (idx,)]
