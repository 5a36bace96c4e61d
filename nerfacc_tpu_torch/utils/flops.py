"""Analytic matmul FLOP counts of the CP radiance and density fields
(PyTorch counterpart of nerfacc_tpu/utils/flops.py).

A deliberate lower bound of useful work: the dense matmul FLOPs of the
encoder (counted as the JAX package's (1, R) @ (R, rank) hat dots, although
the port's kernels read two rows) and the MLPs; traversal, compositing and
the optimizer are not counted.  A backward pass counts twice its forward.
Divide by seconds and by the H100's 989 bf16 TFLOP/s (dense) for a share of
the peak.
"""
from __future__ import annotations

H100_PEAK_BF16_FLOPS = 989e12


def _mlp_flops(dims) -> int:
    """Forward FLOPs/sample of a dense MLP with layer widths ``dims``."""
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def cp_encoder_flops_per_sample(encoder) -> int:
    """Forward FLOPs/sample of a CPGridEncoder, counted as the JAX
    package's dense dots (the port's gathers read two rows a hat): three (1,
    R) @ (R, rank) hat dots per line level; per tri-plane level three (1, R)
    @ (R, R * rank) dots and the (R, rank) x (R, 1) contraction, and in VM
    mode three more line dots."""
    total = sum(3 * 2 * R * rank for R, rank in zip(encoder.resolutions, encoder.ranks))
    vm = getattr(encoder, "plane_mode", "product") == "vm"
    for R, rank in zip(getattr(encoder, "plane_resolutions", ()),
                       getattr(encoder, "plane_ranks", ())):
        total += 3 * (2 * R * R * rank + 2 * R * rank)
        if vm:
            total += 3 * 2 * R * rank  # the complementary-axis line dots
    return total


def cp_field_flops_per_sample(field, backward: bool = True) -> int:
    """FLOPs/sample of a full CPRadianceField evaluation (encoder, base MLP,
    view head), with its gradient pass, which counts twice the forward,
    when ``backward``."""
    fwd = (
        cp_encoder_flops_per_sample(field.encoder)
        + _mlp_flops(field.base_dims)
        + _mlp_flops(field.head_dims)
    )
    return fwd * (3 if backward else 1)


def cp_density_flops_per_sample(field, backward: bool = False) -> int:
    """FLOPs/sample of a CPDensityField query (encoder and its one MLP), a
    proposal level's evaluation, with its gradient pass when ``backward``."""
    fwd = cp_encoder_flops_per_sample(field.encoder) + _mlp_flops(field.base_dims)
    return fwd * (3 if backward else 1)


def cp_density_query_flops_per_sample(field) -> int:
    """Forward density-only query (encoder and base MLP): the occupancy
    refresh's evaluation."""
    return cp_encoder_flops_per_sample(field.encoder) + _mlp_flops(field.base_dims)
