"""Holds the port's fixed-order scatters to the sums they replace, on the card.

    python3 scripts/check_ordered_scatters.py

For the interlevel loss's CDF reads (``take_along_last``, advanced
indexing, against ``gather``) and ``segment_sum_sorted``'s row sums
(``index_add_rows``, a sorted ``index_put_``, against ``index_add_``) at the
proposal path's shapes: the forward values equal, and the largest error of
each gradient or sum against an f64 sum of the same terms, printed beside
the largest entry, and whether two calls give the same bits.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

from nerfacc_tpu_torch.ops.ordered_sums import index_add_rows, take_along_last  # noqa: E402


def main():
    if not torch.cuda.is_available():
        raise SystemExit("check_ordered_scatters: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    for n_rays, n_key, n_query in ((4096, 129, 65), (4096, 65, 129)):
        x = torch.sort(torch.rand(n_rays, n_key, generator=g, device=dev), -1).values
        x.requires_grad_()
        idx = torch.randint(0, n_key, (n_rays, n_query), generator=g, device=dev)
        cot = torch.randn(n_rays, n_query, generator=g, device=dev)
        grads = []
        for read in (take_along_last, take_along_last, lambda t, i: t.gather(-1, i)):
            out = read(x, idx)
            (out * cot).sum().backward()
            grads.append((out.detach(), x.grad.clone()))
            x.grad = None
        exact = torch.zeros(n_rays, n_key, dtype=torch.float64, device=dev).scatter_add_(
            -1, idx, cot.double())
        err = [float((gr.double() - exact).abs().max()) for _, gr in grads[1:]]
        print(f"CDF reads ({n_rays}, {n_key}) <- ({n_rays}, {n_query}): values equal "
              f"{torch.equal(grads[0][0], grads[2][0])}; gradient against f64: fixed order "
              f"{err[0]:.3g}, gather {err[1]:.3g}, largest entry "
              f"{float(exact.abs().max()):.4g}; two calls bitwise "
              f"{torch.equal(grads[0][1], grads[1][1])}")
    src = torch.randn(2**18, 5, generator=g, device=dev)
    ids = torch.sort(torch.randint(0, 4096, (2**18,), generator=g, device=dev)).values
    fixed = index_add_rows(torch.zeros(4096, 5, device=dev), ids, src)
    again = index_add_rows(torch.zeros(4096, 5, device=dev), ids, src)
    atomic = torch.zeros(4096, 5, device=dev).index_add_(0, ids, src)
    exact = torch.zeros(4096, 5, dtype=torch.float64, device=dev).index_add_(0, ids, src.double())
    print(f"segment sums 2^18 -> 4096 rows: against f64 fixed order "
          f"{float((fixed.double() - exact).abs().max()):.3g}, index_add_ "
          f"{float((atomic.double() - exact).abs().max()):.3g}, largest entry "
          f"{float(exact.abs().max()):.4g}; two calls bitwise {torch.equal(fixed, again)}")


if __name__ == "__main__":
    main()
