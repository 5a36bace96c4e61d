"""Kernels G1-G14 against their PyTorch twins on the card, and the
gradients that reach the train steps through them.

These need an NVIDIA Hopper GPU and nvcc; elsewhere they skip.  Run them on
the card with ``python -m pytest tests/test_torch_kernels.py -q``.
"""
import math

import numpy as np
import pytest
import torch

from nerfacc_tpu_torch import cuda
from nerfacc_tpu_torch.grid import march, march_plain
from nerfacc_tpu_torch.data.procedural import (
    ProceduralSceneLoader,
    ProceduralUnboundedSceneLoader,
)
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.models.encoders import HashGridEncoder
from nerfacc_tpu_torch.models.ngp import NGPDensityField, NGPRadianceField
from nerfacc_tpu_torch.models.tineuvox import TiNeuVoxRadianceField
from nerfacc_tpu_torch.data.procedural import ProceduralDynamicSceneLoader
from nerfacc_tpu_torch.ops.cp_level import (
    cp_level_backward,
    cp_level_backward_plain,
    cp_level_encode,
    cp_level_encode_plain,
)
from nerfacc_tpu_torch.ops.hash_encode import (
    hash_bwd_item_samples,
    hash_corners_plain,
    hash_encode,
    hash_encode_backward,
    hash_encode_backward_plain,
    hash_encode_forward,
    hash_encode_plain,
)
from nerfacc_tpu_torch.ops import hat_matmul
from nerfacc_tpu_torch.ops.hat_matmul import (
    hat_bwd_line,
    hat_bwd_line_plain,
    hat_bwd_x,
    hat_bwd_x_plain,
    hat_cp_level,
    hat_fwd,
    hat_interp_matmul,
    hat_interp_matmul_plain,
    hat_level_fwd,
    hat_level_plain,
)
from nerfacc_tpu_torch.ops.sorted_segments import (
    composite_sorted,
    composite_sorted_backward,
    composite_sorted_backward_plain,
    composite_sorted_plain,
)
from nerfacc_tpu_torch.ops.coarse_occ import coarse_occ_lookup, coarse_occ_lookup_plain
from nerfacc_tpu_torch.ops import lane_gather as lane_gather_mod
from nerfacc_tpu_torch.ops.lane_gather import lane_gather, lane_gather_plain
from nerfacc_tpu_torch.ops.row_gather import row_gather, row_gather_plain
from nerfacc_tpu_torch.data.device_sampler import DeviceRaySampler
from nerfacc_tpu_torch.data_specs import RayIntervals
from nerfacc_tpu_torch.models.cp_field import CPDensityField
from nerfacc_tpu_torch.pdf import importance_sampling, importance_sampling_plain
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer
from nerfacc_tpu_torch.trainers.ngp_prop import NGPPropTrainer
from nerfacc_tpu_torch.utils.rendering import compact_samples
from torch_threads import one_thread  # noqa: F401 (autouse: one PyTorch thread)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("R", [32, 128, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_level_kernel_matches_twin(dev, R, dtype):
    g = torch.Generator(device=dev).manual_seed(R)
    u = torch.rand((5000, 3), generator=g, device=dev)
    u[:2] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], device=dev)
    lines = 1 + 0.1 * torch.randn((3, R, 32), generator=g, device=dev)
    n0 = cuda.LAUNCHES["cp_level_fwd"]
    out = cp_level_encode(u, lines, dtype)
    assert cuda.LAUNCHES["cp_level_fwd"] == n0 + 1
    torch.testing.assert_close(out, cp_level_encode_plain(u, lines, dtype), rtol=0, atol=0)


@pytest.mark.parametrize("rank,n", [(16, 5003), (32, 5003), (32, 2**16), (6, 4099),
                                    (34, 129), (1, 33), (200, 65)])
@pytest.mark.parametrize("layout", ["march", "proposal"])
def test_cp_level_kernel_at_other_ranks_on_ray_ordered_coordinates(dev, rank, n, layout):
    """G1 bitwise against the plain version where a sample's group of lanes
    takes four columns a lane by 16-byte loads (ranks 16 and 32) or by masked
    4-byte loads (6, 34, 1, 200; 200 loops over column chunks), at sample
    counts that leave a group or a warp partly empty, on ray-ordered
    coordinates with long runs of samples on one row and some at 0 and 1."""
    u = _ray_ordered_u(dev, n, layout, rank + n)
    g = torch.Generator(device=dev).manual_seed(rank)
    for R in (16, 64, 512):
        lines = 1 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            n0 = cuda.LAUNCHES["cp_level_fwd"]
            out = cp_level_encode(u, lines, dtype)
            assert cuda.LAUNCHES["cp_level_fwd"] == n0 + 1
            ref = cp_level_encode_plain(u, lines, dtype)
            assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_level_kernel_on_a_misaligned_table(dev, dtype):
    """A table 4 bytes off a 16-byte boundary takes the masked 4-byte loads:
    still bitwise equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(11)
    u = _ray_ordered_u(dev, 3001, "march", 11)
    flat = 1 + 0.1 * torch.randn(3 * 128 * 32 + 1, generator=g, device=dev)
    lines = flat[1:].view(3, 128, 32)
    assert lines.is_contiguous() and lines.data_ptr() % 16 != 0
    out = cp_level_encode(u, lines, dtype)
    ref = cp_level_encode_plain(u, lines, dtype)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("m,cone_angle", [(1, 0.0), (2, 0.0), (2, 0.004)])
def test_march_kernel_matches_twin(dev, m, cone_angle):
    rng = np.random.default_rng(m)
    n = 2048
    theta = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([4 * np.cos(theta), 4 * np.sin(theta), rng.uniform(-1, 1, n)], -1)
    d = rng.uniform(-1.5, 1.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = torch.tensor(o, dtype=torch.float32, device=dev)
    d = torch.tensor(d, dtype=torch.float32, device=dev)
    binaries = torch.tensor(rng.uniform(size=(m, 64, 64, 64)) < 0.3, device=dev)
    aabbs = torch.tensor(
        [[-1.5 * 2**i] * 3 + [1.5 * 2**i] * 3 for i in range(m)],
        dtype=torch.float32, device=dev,
    )
    mask = torch.tensor(rng.uniform(size=n) < 0.9, device=dev)
    args = (o, d, binaries, aabbs, None, None, 5e-3, cone_angle, mask)
    out, ref = march(*args), march_plain(*args)
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _march_case(dev, case):
    """Rays, grid and planes of one edge case of the warp-per-ray march."""
    rng = np.random.default_rng(len(case))
    n = {"1 ray": 1, "31 rays": 31, "33 rays": 33}.get(case, 2048)
    m = 8 if case == "m=8, cone" else 1
    theta = rng.uniform(0, 2 * np.pi, n)
    o = np.stack([4 * np.cos(theta), 4 * np.sin(theta), rng.uniform(-1, 1, n)], -1)
    d = rng.uniform(-1.5, 1.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if case == "missing rays":
        d[::2] = -d[::2]  # pointing away from every box
    near = np.zeros(n)
    if case == "near inside":
        near = rng.uniform(2.0, 6.0, n)  # the box spans t ~ 2.5 to 5.5
    o, d, near = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (o, d, near))
    binaries = torch.tensor(rng.uniform(size=(m, 64, 64, 64)) < 0.3, device=dev)
    aabbs = torch.tensor(
        [[-1.5 * 2**i] * 3 + [1.5 * 2**i] * 3 for i in range(m)],
        dtype=torch.float32, device=dev,
    )
    far = torch.full_like(near, 1e10)
    cone = 0.004 if case == "m=8, cone" else 0.0
    return (o, d, binaries, aabbs, near, far, 5e-3, cone, None)


@pytest.mark.parametrize(
    "case", ["1 ray", "31 rays", "33 rays", "missing rays", "near inside", "m=8, cone"]
)
def test_march_kernel_matches_twin_at_its_edges(dev, case):
    """One warp per ray, at ray counts that leave a block partly empty, rays
    that miss the box, near planes inside it (the walk starts at 0) and
    eight levels under cone stepping: equal to the twin in every output."""
    args = _march_case(dev, case)
    n0 = cuda.LAUNCHES["march"]
    out, ref = march(*args), march_plain(*args)
    assert cuda.LAUNCHES["march"] == n0 + 1
    assert int(out.counts.sum()) > 0 or case == "1 ray"
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize(
    "case,window",
    [("eval chunk", 128), ("eval chunk", 100), ("near inside", 64), ("m=8, cone", 128),
     ("missing rays", 128), ("33 rays", 32)],
)
def test_windowed_march_kernel_matches_plain_round_by_round(dev, case, window):
    """G2 with ``max_samples`` against ``march_plain``, round after round as
    the eval renderer runs it (each round from the last one's termination
    planes, its alive mask dropping the rays that terminated and a few at
    random): counts, samples, planes and flags bitwise in every round."""
    if case == "eval chunk":
        o, d, binaries, aabbs, near, far, step, cone, _ = _march_case(dev, "8192 rays")
        o, d = o.repeat(4, 1), d.repeat(4, 1)
        near, far = near.repeat(4), far.repeat(4)
    else:
        o, d, binaries, aabbs, near, far, step, cone, _ = _march_case(dev, case)
    g = torch.Generator(device=dev).manual_seed(len(case) + window)
    alive = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    emitted = 0
    for _ in range(2 + 4000 // window):
        args = (o, d, binaries, aabbs, near, far, step, cone, alive)
        out = march(*args, max_samples=window)
        ref = march_plain(*args, max_samples=window)
        for a, b in zip(out, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        emitted += out.ray_indices.shape[0]
        drop = torch.rand(o.shape[0], generator=g, device=dev) < 0.05
        alive = alive & ~out.terminated & ~drop
        near = out.termination_planes
        if not bool(alive.any()):
            break
    assert emitted > 0 or case == "missing rays"
    assert not bool(alive.any())


def test_eval_renderer_on_the_card_renders_an_empty_grid_as_background(dev):
    """The early-stopping renderer through G2 and G3 on a fresh state's
    empty grid: no sample, every ray retired in its first round, the
    background colour."""
    aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    ds = ProceduralSceneLoader("test", n_test=1, width=32, height=32, device=dev)
    trainer = NGPOccTrainer(field=CPRadianceField(aabb), aabb=aabb, grid_resolution=32,
                            device=dev)
    data = ds[0]
    colors, opacities, _, n_samples = trainer.render_view(trainer.init_state(), data)
    assert n_samples == 0 and (opacities == 0).all()
    assert torch.equal(colors, data["color_bkgd"].expand(32 * 32, 3))


def _composite_buffer(dev):
    rng = np.random.default_rng(0)
    n_rays = 4096
    counts = torch.tensor(rng.integers(0, 300, n_rays), dtype=torch.int32)
    counts[::9] = 0
    n = int(counts.sum())
    ids = torch.repeat_interleave(torch.arange(n_rays, dtype=torch.int32), counts)
    ends = torch.cumsum(counts, 0)
    ss, se = (ends - counts).int(), (ends - 1).int()
    t0 = torch.tensor(rng.uniform(2, 6, n), dtype=torch.float32)
    t1 = t0 + 5e-3
    sigmas = torch.tensor(10.0 ** rng.uniform(-1, 4, n), dtype=torch.float32)
    rgbs = torch.tensor(rng.uniform(0, 1, (n, 3)), dtype=torch.float32)
    prefix = torch.tensor(rng.uniform(0.3, 1, n_rays), dtype=torch.float32)
    args = [x.to(dev) for x in (t0, t1, sigmas, rgbs, ids)]
    return args + [n_rays, ss.to(dev), se.to(dev), prefix.to(dev)]


def test_composite_kernel_matches_twin(dev):
    args = _composite_buffer(dev) + [True]
    out, ref = composite_sorted(*args), composite_sorted_plain(*args)
    for a, b, tol in zip(out, ref, (1e-5, 1e-5, 1e-4, 1e-5)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=tol)


def test_packed_samples_feed_the_composite(dev):
    """The march's packed buffer is what the composite walks."""
    n = 512
    o = torch.tensor([[0.0, 0.0, 4.0]], device=dev).expand(n, 3).contiguous()
    d = torch.nn.functional.normalize(
        torch.randn(n, 3, device=dev) * 0.2 + torch.tensor([0.0, 0.0, -1.0], device=dev),
        dim=-1,
    )
    binaries = torch.ones((1, 32, 32, 32), dtype=torch.bool, device=dev)
    aabbs = torch.tensor([[-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]], device=dev)
    s = compact_samples(march(o, d, binaries, aabbs, step_size=5e-3))
    sig = torch.full((s.num_valid,), 0.5, device=dev)
    rgb = torch.rand((s.num_valid, 3), device=dev)
    out = composite_sorted(
        s.t_starts, s.t_ends, sig, rgb, s.ray_indices, n, s.seg_starts, s.seg_ends
    )
    ref = composite_sorted_plain(
        s.t_starts, s.t_ends, sig, rgb, s.ray_indices, n, s.seg_starts, s.seg_ends
    )
    torch.testing.assert_close(out[1], ref[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("R", [32, 128, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_level_backward_kernel_matches_twin(dev, R, dtype):
    """G4 against the closed-form twin, bit for bit: both sum in fixed point
    (ops/ordered_sums.py), so the order of the adds does not matter."""
    g = torch.Generator(device=dev).manual_seed(R + 1)
    u = torch.rand((2**16 + 3, 3), generator=g, device=dev)
    u[:2] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], device=dev)
    lines = 1 + 0.1 * torch.randn((3, R, 32), generator=g, device=dev)
    cot = torch.randn((u.shape[0], 32), generator=g, device=dev)
    n0 = cuda.LAUNCHES["cp_level_bwd"]
    out = cp_level_backward(u, cot, lines, dtype)
    assert cuda.LAUNCHES["cp_level_bwd"] == n0 + 1
    assert _bits_equal(out, cp_level_backward_plain(u, cot, lines, dtype))


def _bits_equal(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_cp_level_backward_refuses_a_table_past_shared_memory(dev):
    """G4 keeps int64 copies of the three axes' tables in shared memory, over
    slices of the features or one axis at a time where the whole do not fit;
    a table whose f32 size is past the card's opt-in limit (256 KiB here)
    raises, uncounted."""
    u = torch.rand((1024, 3), device=dev)
    lines = torch.ones((3, 2048, 32), device=dev)
    n0 = cuda.LAUNCHES["cp_level_bwd"]
    with pytest.raises(RuntimeError, match="cp_level_bwd"):
        cp_level_backward(u, torch.ones((1024, 32), device=dev), lines, torch.float32)
    assert cuda.LAUNCHES["cp_level_bwd"] == n0


def _ray_ordered_u(dev, n, layout, seed, clamp=True):
    """Encoder coordinates in the ray order of a train step: rays from
    cameras at radius 4 through the AABB [-1.5, 1.5]^3, points normalised and
    clamped to [0, 1] (so some sit exactly at 0 and 1; ``clamp=False``
    leaves the points before and past the box outside [0, 1]).
    ``proposal``: 128 uniform samples per ray over [2, 6]; ``march``:
    samples 5e-3 apart."""
    rng = np.random.default_rng(seed)
    per_ray = 128 if layout == "proposal" else 400
    n_rays = -(-n // per_ray)
    theta = rng.uniform(0, 2 * np.pi, n_rays)
    o = np.stack([4 * np.cos(theta), 4 * np.sin(theta), rng.uniform(-1, 1, n_rays)], -1)
    d = rng.uniform(-0.8, 0.8, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if layout == "proposal":
        t = np.linspace(2.0, 6.0, 129)[:-1] + 2.0 / 128
    else:
        t = 2.6 + 5e-3 * np.arange(per_ray)
    pts = (o[:, None] + t[None, :, None] * d[:, None]).reshape(-1, 3)[:n]
    u = (pts + 1.5) / 3.0
    if clamp:
        u = np.clip(u, 0.0, 1.0)
    return torch.tensor(u.astype(np.float32), device=dev)


@pytest.mark.parametrize("R,rank,layout", [
    (16, 16, "proposal"), (64, 16, "proposal"),
    (32, 32, "march"), (128, 32, "march"), (512, 32, "march"),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_level_backward_kernel_on_ray_ordered_coordinates(dev, R, rank, layout, dtype):
    """G4 on a train step's coordinates: long runs of samples on one row
    (merged in registers before the shared add), many exactly at u = 0 or
    1; bit for bit, as on uniform coordinates."""
    u = _ray_ordered_u(dev, 2**16 + 5, layout, R + rank)
    assert bool(((u == 0) | (u == 1)).any()) and bool(((u > 0) & (u < 1)).all(1).any())
    g = torch.Generator(device=dev).manual_seed(R)
    lines = 1 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev)
    cot = torch.randn((u.shape[0], rank), generator=g, device=dev)
    n0 = cuda.LAUNCHES["cp_level_bwd"]
    out = cp_level_backward(u, cot, lines, dtype)
    assert cuda.LAUNCHES["cp_level_bwd"] == n0 + 1
    assert _bits_equal(out, cp_level_backward_plain(u, cot, lines, dtype))


@pytest.mark.parametrize("rank", [6, 8, 24, 34, 48])
def test_cp_level_backward_kernel_at_other_ranks(dev, rank):
    """G4 at ranks other than the fields': 6 and 8 (four samples a warp at a
    time, on 8 lanes each), 24 (one sample on 24 of 32 lanes), 34 and 48 (two
    warps a run, the second on 2 or 16 of its lanes)."""
    g = torch.Generator(device=dev).manual_seed(rank)
    u = _ray_ordered_u(dev, 5003, "march", rank)
    lines = 1 + 0.1 * torch.randn((3, 64, rank), generator=g, device=dev)
    cot = torch.randn((u.shape[0], rank), generator=g, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        out = cp_level_backward(u, cot, lines, dtype)
        assert _bits_equal(out, cp_level_backward_plain(u, cot, lines, dtype))


@pytest.mark.parametrize("R,rank", [(1024, 32), (16384, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_level_backward_kernel_takes_the_axes_in_turn(dev, R, rank, dtype):
    """Where the three int64 tables exceed shared memory: at (1024, 32) a
    block keeps the three axes over a slice of 8 features (192 KiB); at
    (16384, 3) not even one feature of three axes fits (384 KiB), so a block
    keeps one axis's table of one feature (128 KiB), the axes in turn.  Bit
    for bit, and the same bits from two calls."""
    g = torch.Generator(device=dev).manual_seed(7)
    u = torch.rand((2**15 + 1, 3), generator=g, device=dev)
    lines = 1 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev)
    cot = torch.randn((u.shape[0], rank), generator=g, device=dev)
    out = cp_level_backward(u, cot, lines, dtype)
    assert _bits_equal(out, cp_level_backward(u, cot, lines, dtype))
    assert _bits_equal(out, cp_level_backward_plain(u, cot, lines, dtype))


def _g4_shape(dev, case, g):
    """Coordinates, tables and a cotangent at one of G4's timed shapes:
    ``uniform`` N = 2^18 at the CP field's R = 512; ``ray`` the CP train
    step's samples in ray order at R = 32, 128, 512 (rank 32); ``proposal``
    the proposal field's 4096 rays x 128 samples at (16, 16) and (64, 16);
    ``rows16`` every sample on 16 rows an axis (u in [0.5, 0.53] at R = 512)."""
    kind, R, rank = case
    if kind == "uniform":
        u = torch.rand((2**18, 3), generator=g, device=dev)
    elif kind == "ray":
        u = _ray_ordered_u(dev, 2**18, "march", R)
    elif kind == "proposal":
        u = _ray_ordered_u(dev, 4096 * 128, "proposal", R)
    else:
        u = 0.5 + 0.03 * torch.rand((2**18, 3), generator=g, device=dev)
    lines = 1 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev)
    cot = torch.randn((u.shape[0], rank), generator=g, device=dev)
    return u, lines, cot


@pytest.mark.parametrize("case", [
    ("uniform", 512, 32), ("ray", 32, 32), ("ray", 128, 32), ("ray", 512, 32),
    ("proposal", 16, 16), ("proposal", 64, 16), ("rows16", 512, 32),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_level_backward_is_deterministic(dev, case, dtype):
    """G4 at each of its timed shapes: two calls give the same bits, and they
    are the plain version's (both sum in fixed point)."""
    g = torch.Generator(device=dev).manual_seed(case[1] + case[2])
    u, lines, cot = _g4_shape(dev, case, g)
    if case[0] == "rows16":
        rows = torch.floor(u * (case[1] - 1))
        assert all(int(torch.unique(rows[:, a]).numel()) <= 16 for a in range(3))
    first = cp_level_backward(u, cot, lines, dtype)
    assert _bits_equal(first, cp_level_backward(u, cot, lines, dtype))
    assert _bits_equal(first, cp_level_backward_plain(u, cot, lines, dtype))


def test_cp_level_backward_keeps_infinities_and_nans(dev):
    """A +-inf or NaN product makes its entries what an f64 sum makes them,
    as in the plain version; the other entries stay bitwise equal."""
    g = torch.Generator(device=dev).manual_seed(5)
    u = torch.rand((4096, 3), generator=g, device=dev)
    lines = 1 + 0.1 * torch.randn((3, 64, 16), generator=g, device=dev)
    cot = torch.randn((4096, 16), generator=g, device=dev)
    u[:3] = torch.tensor([[0.2, 0.2, 0.2], [0.2, 0.2, 0.2], [0.7, 0.7, 0.7]], device=dev)
    cot[0, 0], cot[1, 0], cot[2, 1] = math.inf, -math.inf, math.nan
    for dtype in (torch.float32, torch.bfloat16):
        out = cp_level_backward(u, cot, lines, dtype)
        ref = cp_level_backward_plain(u, cot, lines, dtype)
        assert int((~torch.isfinite(ref)).sum()) >= 6
        assert _bits_equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cp_level_output_carries_a_gradient_on_the_card(dev, dtype):
    """On CUDA tensors the kernel path is differentiable in the tables (its
    gradient is G4's), and in f32 equal to autograd of the plain forward."""
    g = torch.Generator(device=dev).manual_seed(3)
    u = torch.rand((4099, 3), generator=g, device=dev)
    lines = (1 + 0.1 * torch.randn((3, 64, 32), generator=g, device=dev)).requires_grad_()
    out = cp_level_encode(u, lines, dtype)
    assert out.grad_fn is not None
    cot = torch.randn(out.shape, generator=g, device=dev)
    n0 = cuda.LAUNCHES["cp_level_bwd"]
    out.backward(cot)
    assert cuda.LAUNCHES["cp_level_bwd"] == n0 + 1
    if dtype == torch.float32:
        ref_lines = lines.detach().clone().requires_grad_()
        cp_level_encode_plain(u, ref_lines, dtype).backward(cot)
        ref = ref_lines.grad
    else:
        ref = cp_level_backward_plain(u, cot, lines.detach(), dtype)
    torch.testing.assert_close(lines.grad, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def test_composite_backward_kernel_matches_twin(dev):
    """G5 against the closed-form twin, with a prefix transmittance, empty
    rays and densities past the optical-depth cap: 1e-5 of the largest
    gradient (the same f32 arithmetic along each ray)."""
    args = _composite_buffer(dev)
    n_rays = args[5]
    g = torch.Generator(device=dev).manual_seed(4)
    cots = [torch.randn((n_rays, c), generator=g, device=dev) for c in (3, 1, 1)]
    n0 = cuda.LAUNCHES["composite_bwd"]
    out = composite_sorted_backward(*args[:8], *cots, args[8])
    assert cuda.LAUNCHES["composite_bwd"] == n0 + 1
    ref = composite_sorted_backward_plain(*args[:8], *cots, args[8])
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


def test_composite_backward_reads_non_contiguous_inputs(dev):
    """G5 given column slices of one (n_rays, 5) cotangent (as autograd
    hands them through a ``torch.cat`` of the sums) and a strided density:
    the same gradients as from contiguous copies.  The wrapper once made
    its contiguous copies inside the call's arguments, where each was freed
    as soon as its pointer was taken and the next copy could take its
    memory before the kernel read it."""
    args = _composite_buffer(dev)
    n_rays = args[5]
    g = torch.Generator(device=dev).manual_seed(9)
    cat = torch.randn((n_rays, 5), generator=g, device=dev)
    strided = torch.stack([args[2], args[2]], -1)[:, 0]
    assert not strided.is_contiguous() and not cat[:, :3].is_contiguous()
    out = composite_sorted_backward(*args[:2], strided, *args[3:8], cat[:, :3],
                                    cat[:, 3:4], cat[:, 4:5], args[8])
    ref = composite_sorted_backward(*args[:8], cat[:, :3].contiguous(),
                                    cat[:, 3:4].contiguous(), cat[:, 4:5].contiguous(),
                                    args[8])
    for a, b in zip(out, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _g5_case(dev, case):
    """A sorted buffer for one edge case of the warp-per-ray G5: the
    arguments of composite_sorted_backward and the mask of slots inside a
    segment."""
    rng = np.random.default_rng(len(case))
    if case == "proposal layout":  # 4096 rays x 64 samples, one row each
        counts = np.full(4096, 64)
    elif case == "opaque last":  # the 360 cascade's 4096 rays x 48 samples
        counts = np.full(4096, 48)
    else:
        counts = np.concatenate([[1, 31, 32, 33, 257, 1500, 0, 0, 2100],
                                 rng.integers(0, 300, 200)])
        counts[-200::13] = 0
    n_rays = counts.shape[0]
    n_fill = 77 if case == "fill and cut" else 0
    ids = np.concatenate([np.repeat(np.arange(n_rays), counts), np.full(n_fill, n_rays)])
    n = ids.shape[0]
    t0 = np.zeros(n)
    for r, c in enumerate(counts):  # each ray's intervals, 5e-3 apart
        t0[ids == r] = 2.0 + 5e-3 * np.arange(c)
    t1 = t0 + 5e-3
    sigmas = 10.0 ** rng.uniform(-1, 3.5, n)
    sigmas[ids == 5] = rng.uniform(0.0, 0.4, counts[5])  # a long translucent ray
    if case == "past the cap":
        sigmas[(ids == 4) | (ids == 9)] = 1e13  # whole rays past sigma*dt = 40
        sigmas[::7] = 40.0 / 5e-3
    ends = np.cumsum(counts)
    if case == "opaque last":  # the trainer's opaque background
        sigmas[ends - 1] = np.inf
    ss, se = ends - counts, ends - 1
    if case == "fill and cut":  # rays past the budget empty, one partial
        budget = int(ends[8]) + 100
        ss, se = np.minimum(ss, budget), np.minimum(ends, budget) - 1
        ids = np.where(np.arange(n) < budget, ids, n_rays)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device=dev)
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    rgbs = f32(rng.uniform(0, 1, (n, 3)))
    cots = [f32(rng.standard_normal((n_rays, c))) for c in (3, 1, 1)]
    prefix = f32(rng.uniform(0.3, 1.0, n_rays)) if case == "prefix" else None
    args = (f32(t0), f32(t1), f32(sigmas), rgbs, i32(ids), n_rays, i32(ss), i32(se),
            *cots, prefix)
    return args, torch.tensor(ids < n_rays, device=dev)


@pytest.mark.parametrize("case", [
    "lengths", "past the cap", "prefix", "fill and cut", "proposal layout", "opaque last",
])
def test_composite_backward_kernel_at_its_edges(dev, case):
    """G5, one warp per ray: rays of 1, 31, 32, 33 and 257 samples (chunk
    edges), 1500 and 2100 (past the 256 kept in registers), empty rays,
    whole rays past the optical-depth cap, a prefix transmittance, fill slots
    and a budget cut (both read exactly 0), the proposal path's 64 samples
    per ray, and the 360 cascade's 48 with an infinite last density (the
    opaque background: every gradient finite, the last sample's 0); 1e-5
    of the largest gradient against the twin."""
    args, inside = _g5_case(dev, case)
    n0 = cuda.LAUNCHES["composite_bwd"]
    out = composite_sorted_backward(*args)
    assert cuda.LAUNCHES["composite_bwd"] == n0 + 1
    ref = composite_sorted_backward_plain(*args)
    for a, b in zip(out, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))
        assert bool((a[~inside] == 0).all())
    if case == "fill and cut":
        assert int((~inside).sum()) > 77
    if case == "past the cap":
        capped = args[2] * (args[1] - args[0]) >= 40.0
        assert bool((out[0][capped] == 0).all())
    if case == "opaque last":
        assert bool((out[0].reshape(4096, 48)[:, -1] == 0).all())


@pytest.mark.parametrize("case", [
    "lengths", "past the cap", "prefix", "fill and cut", "proposal layout", "no weights",
    "opaque last",
])
def test_composite_kernel_at_its_edges(dev, case):
    """G3, one warp per ray, on G5's edge buffers: rays of 1, 31, 32, 33 and
    257 samples (chunk edges), 1500 and 2100, empty rays, whole rays past
    the optical-depth cap, a prefix transmittance, fill slots and a budget
    cut (their weights stay exactly 0), the proposal path's 64 samples per
    ray, the 360 cascade's 48 with an infinite last density (every ray's
    opacity 1), no weights asked for, and 209 rays (a block partly empty).  Colour
    and opacity within 1e-5, depth within 1e-4 of the twin (chip_smoke.py's
    bounds), the weights within 1e-5."""
    args, inside = _g5_case(dev, "lengths" if case == "no weights" else case)
    fwd = args[:8] + (args[11], case != "no weights")
    n0 = cuda.LAUNCHES["composite_fwd"]
    out = composite_sorted(*fwd)
    assert cuda.LAUNCHES["composite_fwd"] == n0 + 1
    ref = composite_sorted_plain(*fwd)
    for a, b, tol in zip(out[:3], ref[:3], (1e-5, 1e-5, 1e-4)):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=0, atol=tol)
    if case == "no weights":
        assert out[3] is None
    else:
        torch.testing.assert_close(out[3], ref[3], rtol=0, atol=1e-5)
        assert bool((out[3][~inside] == 0).all())
    empty = args[7] < args[6]
    assert bool((out[1][empty] == 0).all())
    assert int(empty.sum()) > 0 or case in ("proposal layout", "opaque last")
    if case == "opaque last":  # the last sample takes what light is left
        assert float((out[1] - 1).abs().max()) <= 1e-6


def test_composite_output_carries_a_gradient_on_the_card(dev):
    args = _composite_buffer(dev)
    sigmas = args[2].clone().requires_grad_()
    rgbs = args[3].clone().requires_grad_()
    out = composite_sorted(*args[:2], sigmas, rgbs, *args[4:8], return_weights=True)
    assert all(o.grad_fn is not None for o in out[:3]) and not out[3].requires_grad
    g = torch.Generator(device=dev).manual_seed(5)
    cots = [torch.randn(o.shape, generator=g, device=dev) for o in out[:3]]
    sum((o * c).sum() for o, c in zip(out[:3], cots)).backward()
    ref = composite_sorted_backward_plain(*args[:8], *cots)
    torch.testing.assert_close(sigmas.grad, ref[0], rtol=0, atol=1e-5 * float(ref[0].abs().max()))
    torch.testing.assert_close(rgbs.grad, ref[1], rtol=0, atol=1e-5 * float(ref[1].abs().max()))


def _hash_inputs(dev, n=2**15, levels=16, log2_t=14):
    """Points in [-0.1, 1.1]^3 (corners below 0 wrap in uint32), an O(1)
    table and a cotangent."""
    g = torch.Generator(device=dev).manual_seed(levels)
    res = HashGridEncoder(n_levels=levels, log2_hashmap_size=log2_t).resolutions
    x = torch.rand((n, 3), generator=g, device=dev) * 1.2 - 0.1
    table = torch.rand((levels, 1 << log2_t, 2), generator=g, device=dev) * 2 - 1
    cot = torch.randn((n, 2 * levels), generator=g, device=dev)
    return x, table, cot, res


@pytest.mark.parametrize("levels,log2_t", [(16, 14), (5, 19), (5, 17)])
def test_hash_encode_kernels_match_twins(dev, levels, log2_t):
    """G6 bitwise: the twin rounds each fused multiply-add once, as the
    kernel does.  G7 bitwise: both sum in fixed point.  (5, 17) is the
    proposal field's ``NGPDensityField``: G6's last group of four levels runs
    one."""
    x, table, cot, res = _hash_inputs(dev, levels=levels, log2_t=log2_t)
    n0 = dict(cuda.LAUNCHES)
    out = hash_encode_forward(x, table, res)
    g_table = hash_encode_backward(x, cot, table.shape, res)
    assert cuda.LAUNCHES["hash_fwd"] == n0["hash_fwd"] + 1
    assert cuda.LAUNCHES["hash_bwd"] == n0["hash_bwd"] + 1
    ref = hash_encode_plain(x, table, res)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert _bits_equal(g_table, hash_encode_backward_plain(x, cot, table.shape, res))


@pytest.mark.parametrize("levels,log2_t", [(16, 19), (16, 8), (3, 12)])
@pytest.mark.parametrize("n", [2**15 + 7, 4099])
def test_hash_table_gradient_on_ray_ordered_positions(dev, levels, log2_t, n):
    """G7 on a train step's positions in ray order (runs of neighbouring
    samples on one corner row, merged in the warp before the atomic), the
    points before and past the box outside [0, 1]^3, at the NGP width (16
    levels: res 16, whose cube of corner cells a block stages in shared
    memory, and res 23 onwards, which go to global atomics), with a table of
    2^8 rows (corners of many cells collide after the mask) and one of 3
    levels; G6 beside it, bitwise.  G7 bitwise too."""
    # the cloud widened about its centre, so that the rays' ends leave the box
    x = (_ray_ordered_u(dev, n, "march", levels + n, clamp=False) - 0.5) * 1.2 + 0.5
    assert bool(((x < 0) | (x > 1)).any()) and bool(((x > 0) & (x < 1)).all(1).any())
    g = torch.Generator(device=dev).manual_seed(log2_t)
    res = HashGridEncoder(n_levels=levels, log2_hashmap_size=log2_t).resolutions
    assert res[0] == 16
    table = torch.rand((levels, 1 << log2_t, 2), generator=g, device=dev) * 2 - 1
    cot = torch.randn((n, 2 * levels), generator=g, device=dev)
    n0 = dict(cuda.LAUNCHES)
    out = hash_encode_forward(x, table, res)
    g_table = hash_encode_backward(x, cot, table.shape, res)
    assert cuda.LAUNCHES["hash_fwd"] == n0["hash_fwd"] + 1
    assert cuda.LAUNCHES["hash_bwd"] == n0["hash_bwd"] + 1
    ref = hash_encode_plain(x, table, res)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))
    assert _bits_equal(g_table, hash_encode_backward_plain(x, cot, table.shape, res))


@pytest.mark.parametrize("case", ["uniform", "ray", "proposal", "proposal360"])
def test_hash_table_gradient_is_deterministic(dev, case):
    """G7 at its timed shapes: the NGP field's (16 levels, T = 2^19) on
    N = 2^18 points in [-0.1, 1.1]^3 and on a train step's positions in ray
    order, and the proposal field's (5 levels, T = 2^17) on 2^19 and 2^20
    ray-ordered points: two calls give the same bits, and they are the
    plain version's (both sum in fixed point)."""
    if case.startswith("proposal"):
        levels, log2_t = 5, 17
        n = 2**19 if case == "proposal" else 2**20
        x = (_ray_ordered_u(dev, n, "proposal", n, clamp=False) - 0.5) * 0.8 + 0.5
    else:
        levels, log2_t = 16, 19
        x = (_ray_ordered_u(dev, 2**18, "march", 3, clamp=False) - 0.5) * 1.2 + 0.5
    g = torch.Generator(device=dev).manual_seed(levels + log2_t)
    if case == "uniform":
        x = torch.rand((2**18, 3), generator=g, device=dev) * 1.2 - 0.1
    res = HashGridEncoder(n_levels=levels, log2_hashmap_size=log2_t).resolutions
    cot = torch.randn((x.shape[0], 2 * levels), generator=g, device=dev)
    shape = (levels, 1 << log2_t, 2)
    first = hash_encode_backward(x, cot, shape, res)
    assert _bits_equal(first, hash_encode_backward(x, cot, shape, res))
    assert _bits_equal(first, hash_encode_backward_plain(x, cot, shape, res))


def _refresh_order_x(dev, cells, seed):
    """One jittered point per cell of a cells^3 grid, in the dense refresh's
    row-major cell order, 1% of them pushed up to 0.1 outside [0, 1]^3."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.arange(cells**3, device=dev)
    coords = torch.stack([ids // cells**2, (ids // cells) % cells, ids % cells], -1).float()
    x = (coords + torch.rand((cells**3, 3), generator=g, device=dev)) / cells
    k = cells**3 // 100
    pick = torch.randperm(cells**3, generator=g, device=dev)[:k]
    push = 0.1 * torch.rand(k, generator=g, device=dev)
    x[pick, 1] = torch.where(pick % 2 == 0, -push, 1.0 + push)
    return x


@pytest.mark.parametrize("order", ["ray", "refresh"])
@pytest.mark.parametrize("levels,log2_t", [(16, 19), (16, 12), (5, 12), (3, 8)])
def test_hash_encode_forward_is_bitwise_on_the_paths_orders(dev, order, levels, log2_t):
    """G6 (level groups, row-pair loads) bitwise equal to the plain version,
    whose corner sums are fused multiply-adds rounded once: on a train step's
    positions in ray order and on the refresh's points in cell order, with
    points outside [0, 1]^3 among them; at the NGP width, with a table small
    enough that corners collide, and at level counts that leave the last
    group part empty; n leaves the last block part empty."""
    if order == "ray":
        x = (_ray_ordered_u(dev, 2**15 + 7, "march", levels, clamp=False) - 0.5) * 1.2 + 0.5
    else:
        x = _refresh_order_x(dev, 33, levels)
    assert bool(((x < 0) | (x > 1)).any())
    g = torch.Generator(device=dev).manual_seed(log2_t)
    res = HashGridEncoder(n_levels=levels, log2_hashmap_size=log2_t).resolutions
    table = torch.rand((levels, 1 << log2_t, 2), generator=g, device=dev) * 2 - 1
    n0 = cuda.LAUNCHES["hash_fwd"]
    out = hash_encode_forward(x, table, res)
    assert cuda.LAUNCHES["hash_fwd"] == n0 + 1
    ref = hash_encode_plain(x, table, res)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def test_hash_encode_forward_on_a_misaligned_table(dev):
    """A table 8 bytes off a 16-byte boundary takes one 8-byte load per
    corner in place of the row pairs: still bitwise equal."""
    x = _refresh_order_x(dev, 24, 3)
    res = HashGridEncoder(n_levels=16, log2_hashmap_size=12).resolutions
    g = torch.Generator(device=dev).manual_seed(9)
    flat = torch.rand(16 * 4096 * 2 + 2, generator=g, device=dev) * 2 - 1
    table = flat[2:].view(16, 4096, 2)
    assert table.is_contiguous() and table.data_ptr() % 16 != 0
    out = hash_encode_forward(x, table, res)
    ref = hash_encode_plain(x, table, res)
    assert torch.equal(out.view(torch.int32), ref.view(torch.int32))


def test_hash_table_gradient_keeps_nan_and_sums_a_cell_of_many(dev):
    """Every sample in one cell of level 0 (one run across every warp, and one
    staged cell a block, over four blocks): the sums within 1e-5 of the
    largest entry of an f64 sum of the same f32 products (the plain
    version's own f32 sum of 12,293 terms a row strays ~1e-5 of it, so it is
    no reference here); a NaN in the cotangent reaches its rows as in the
    plain version."""
    n = 3 * 4096 + 5
    res = HashGridEncoder(n_levels=2, log2_hashmap_size=10).resolutions
    g = torch.Generator(device=dev).manual_seed(5)
    x = 0.5 + 0.01 * torch.rand((n, 3), generator=g, device=dev)
    cot = torch.randn((n, 4), generator=g, device=dev)
    g_table = hash_encode_backward(x, cot, (2, 1024, 2), res)
    idx, w = hash_corners_plain(x, res, 1024)
    rows = (idx + 1024 * torch.arange(2, device=dev)[None, :, None]).reshape(-1)
    upd = (w[..., None] * cot.reshape(n, 2, 1, 2)).reshape(-1, 2)
    ref = torch.zeros((2048, 2), dtype=torch.float64, device=dev).index_add_(
        0, rows, upd.double()).reshape(2, 1024, 2)
    torch.testing.assert_close(g_table.double(), ref, rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    cot[n // 2, 0] = float("nan")
    g_table = hash_encode_backward(x, cot, (2, 1024, 2), res)
    ref = hash_encode_backward_plain(x, cot, (2, 1024, 2), res)
    assert torch.equal(g_table.isnan(), ref.isnan())
    assert _bits_equal(g_table, ref)


# G7's edges: (levels, log2 T, n, resolutions base/top); the design sums
# hash_bwd_item_samples(n) samples of a level an item into one of min(L, 8)
# level slots, reused in turn past 8 levels, and zeroes and writes 16384
# rows an item
_ITEM = hash_bwd_item_samples(2**15)
_G7_EDGES = {
    "rows past one write item, levels past the slots": (10, 15, 3 * _ITEM + 1, 16, 4096),
    "T = 2^4, every corner collides": (9, 4, 5000, 16, 4096),
    "L = 1": (1, 19, 5000, 16, 16),
    "L = 1, res 512": (1, 12, 5000, 512, 512),
    "n = 0": (16, 12, 0, 16, 4096),
    "n = 1": (16, 12, 1, 16, 4096),
    "n one past an item": (16, 12, _ITEM + 1, 16, 4096),
    "n one past a staged level's item": (16, 12, 4 * _ITEM + 1, 16, 4096),
    "n one past an item of 2^20 samples": (5, 12, 2**20 + 1, 16, 128),
    "T = 1": (4, 0, 3000, 16, 128),
}


@pytest.mark.parametrize("case", list(_G7_EDGES))
def test_hash_table_gradient_at_the_designs_edges(dev, case):
    """G7 bitwise its plain version and itself over two calls at the edges
    of its design: more levels than slots (a slot's sums and flags zeroed
    for its next level), rows past one write item, samples past one item
    (of each size), a table so small that every corner collides (and one
    row), one level, no sample and one; points in [-0.1, 1.1]^3, whose
    corners below 0 wrap in uint32.  One launch a call."""
    levels, log2_t, n, base, top = _G7_EDGES[case]
    g = torch.Generator(device=dev).manual_seed(log2_t + n)
    res = HashGridEncoder(n_levels=levels, log2_hashmap_size=log2_t, base_resolution=base,
                          max_resolution=top).resolutions
    x = torch.rand((n, 3), generator=g, device=dev) * 1.2 - 0.1
    cot = torch.randn((n, 2 * levels), generator=g, device=dev)
    shape = (levels, 1 << log2_t, 2)
    n0 = cuda.LAUNCHES["hash_bwd"]
    first = hash_encode_backward(x, cot, shape, res)
    assert cuda.LAUNCHES["hash_bwd"] == n0 + 1
    assert _bits_equal(first, hash_encode_backward(x, cot, shape, res))
    ref = hash_encode_backward_plain(x, cot, shape, res)
    assert _bits_equal(first, ref)
    if n == 0:
        assert not bool(first.any())


def test_hash_table_gradient_keeps_infinities_apart_in_every_slot(dev):
    """+inf, -inf and NaN cotangents at levels that share a slot (0, 8, 16:
    eight slots for 17 levels) and at levels that do not, in different
    sum items and write items, one entry taking both infinities (NaN), the
    rest finite: bitwise the plain version, whose entries are the f64 sums
    of their terms; the flags of a slot do not reach its next level."""
    levels, T = 17, 2**15
    g = torch.Generator(device=dev).manual_seed(11)
    res = HashGridEncoder(n_levels=levels, log2_hashmap_size=15).resolutions
    n = 3 * _ITEM + 5
    x = torch.rand((n, 3), generator=g, device=dev) * 1.2 - 0.1
    cot = torch.randn((n, 2 * levels), generator=g, device=dev)
    cot[7, 0] = float("inf")  # level 0, slot 0
    cot[_ITEM + 3, 2 * 8] = -float("inf")  # level 8, slot 0 again
    cot[n - 1, 2 * 4 + 1] = float("nan")  # level 4, slot 4
    cot[100, 2 * 5] = float("inf")  # level 5: one sample's two signs meet
    x[101] = x[100]
    cot[101, 2 * 5] = -float("inf")
    shape = (levels, T, 2)
    out = hash_encode_backward(x, cot, shape, res)
    ref = hash_encode_backward_plain(x, cot, shape, res)
    assert _bits_equal(out, ref)
    assert _bits_equal(out, hash_encode_backward(x, cot, shape, res))
    for level, want in ((0, 1), (8, 1), (4, 1), (5, 1), (6, 0), (16, 0)):
        bad = ~torch.isfinite(out[level])
        assert (int(bad.sum()) > 0) == bool(want), level
    assert bool(torch.isnan(out[5]).any()) and bool(torch.isnan(out[4]).any())
    assert not bool(torch.isnan(out[0]).any()) and bool(torch.isposinf(out[0]).any())
    assert bool(torch.isneginf(out[8]).any()) and not bool(torch.isposinf(out[8]).any())


def test_hash_encode_carries_the_table_gradient_on_the_card(dev):
    x, table, cot, res = _hash_inputs(dev, n=4099, levels=4, log2_t=12)
    table.requires_grad_()
    out = hash_encode(x, table, res)
    assert out.grad_fn is not None
    out.backward(cot)
    ref_table = table.detach().clone().requires_grad_()
    hash_encode_plain(x, ref_table, res).backward(cot)
    ref = ref_table.grad
    torch.testing.assert_close(table.grad, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_hash_encode_refuses_what_the_kernels_do_not_take(dev):
    """F != 2, or a non-power-of-two T, raises before a launch."""
    x = torch.rand((64, 3), device=dev)
    n0 = cuda.LAUNCHES["hash_fwd"]
    for shape in ((2, 256, 4), (2, 300, 2)):
        with pytest.raises(ValueError, match="hash_encode"):
            hash_encode_forward(x, torch.zeros(shape, device=dev), (16, 32))
    assert cuda.LAUNCHES["hash_fwd"] == n0


def _hat_inputs(dev, R, rank, n=2**16 + 3):
    """Coordinates with 1% past either end of [0, 1] and some on grid points
    (0 and 1 among them), a table near 1 and a cotangent."""
    g = torch.Generator(device=dev).manual_seed(R + rank)
    x = torch.rand(n, generator=g, device=dev)
    k = n // 100
    push = torch.rand(k, generator=g, device=dev) * 1.5 / (R - 1)
    x[:k] = torch.where(torch.arange(k, device=dev) % 2 == 0, -push, 1.0 + push)
    x[k : k + 64] = torch.randint(0, R, (64,), generator=g, device=dev) / (R - 1)
    x[k : k + 2] = torch.tensor([0.0, 1.0], device=dev)
    line = 1 + 0.1 * torch.randn((R, rank), generator=g, device=dev)
    cot = torch.randn((n, rank), generator=g, device=dev)
    return x, line, cot


@pytest.mark.parametrize("R,rank", [(32, 16), (128, 16), (512, 32), (64, 24)])
def test_hat_kernels_match_plain_versions(dev, R, rank):
    """G8 bitwise; G9 within 1e-6 of its largest entry (each block's sums in
    fixed point rounded to f32, the plain version's sum rounded once from
    f64); G10 within 1e-5 (the rank sum in another order) and exactly 0 on
    grid points."""
    x, line, cot = _hat_inputs(dev, R, rank)
    n0 = dict(cuda.LAUNCHES)
    out = hat_fwd(x, line)
    dline = hat_bwd_line(x, cot, R)
    dx = hat_bwd_x(x, cot, line)
    for name in ("hat_fwd", "hat_bwd_line", "hat_bwd_x"):
        assert cuda.LAUNCHES[name] == n0[name] + 1, name
    torch.testing.assert_close(out, hat_interp_matmul_plain(x, line), rtol=0, atol=0)
    ref = hat_bwd_line_plain(x, cot, R)
    torch.testing.assert_close(dline, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))
    ref = hat_bwd_x_plain(x, cot, line)
    torch.testing.assert_close(dx, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
    # k / (R - 1) times (R - 1) is k again for about half of the k
    on_grid = (x * (R - 1)) == torch.round(x * (R - 1))
    assert on_grid.sum() >= 16 and (dx[on_grid] == 0).all()


def _level_inputs(dev, R, rank, n=2**15 + 3):
    """Points (n, 3) over [-0.02, 1.02]^3 with some axes on grid points (0
    and 1 among them), the level's three tables near 1 and a cotangent."""
    g = torch.Generator(device=dev).manual_seed(R * rank + n)
    x = torch.rand((n, 3), generator=g, device=dev) * 1.04 - 0.02
    x[:64] = torch.randint(0, R, (64, 3), generator=g, device=dev) / (R - 1)
    x[64:66] = torch.tensor([[0.0, 1.0, 0.5], [1.0, 0.0, 1.0]], device=dev)
    lines = 1 + 0.1 * torch.randn((3, R, rank), generator=g, device=dev)
    cot = torch.randn((n, rank), generator=g, device=dev)
    return x, lines, cot


def _per_axis_level(x, lines):
    """The level as ``CPGridEncoder(use_pallas=True)`` composed it per axis
    (three one-axis launches of G8), JAX's order."""
    prod = hat_interp_matmul(x[:, 0], lines[0])
    for axis in (1, 2):
        prod = prod * hat_interp_matmul(x[:, axis], lines[axis])
    return prod


# TiNeuVox's levels; rank 24 and 6 leave lanes of a group idle, and 6 takes
# the masked 4-byte loads and stores
@pytest.mark.parametrize("R,rank", [(32, 16), (128, 16), (512, 32), (64, 24), (16, 6)])
def test_hat_level_kernel_matches_plain_version(dev, R, rank):
    """G8's three-axis instance: one launch, the product (a_0 a_1) a_2 and,
    when kept, the three axes' interpolants, all bitwise equal to the
    per-axis plain composition; the one-axis instance at the same shape."""
    x, lines, _ = _level_inputs(dev, R, rank)
    ref, ref_axes = hat_level_plain(x, lines)
    for keep in (False, True):
        n0 = cuda.LAUNCHES["hat_fwd"]
        prod, axes = hat_level_fwd(x, lines, keep)
        assert cuda.LAUNCHES["hat_fwd"] == n0 + 1
        assert torch.equal(prod.view(torch.int32), ref.view(torch.int32))
        if keep:
            assert torch.equal(axes.view(torch.int32), ref_axes.view(torch.int32))
        else:
            assert axes is None
    for i in range(3):
        out = hat_fwd(x[:, i], lines[i])
        assert torch.equal(out.view(torch.int32), ref_axes[i].view(torch.int32))


def test_hat_level_kernel_on_a_misaligned_table(dev):
    """Tables 4 bytes off a 16-byte boundary take the 4-byte paths."""
    x, lines, _ = _level_inputs(dev, 128, 16, n=4099)
    flat = torch.empty(lines.numel() + 1, device=dev)
    shifted = flat[1:].view(lines.shape)
    shifted.copy_(lines)
    assert shifted.data_ptr() % 16 != 0
    for keep in (False, True):
        prod, _ = hat_level_fwd(x, shifted, keep)
        assert torch.equal(prod, hat_level_plain(x, lines)[0])


@pytest.mark.parametrize("R,rank", [(32, 16), (128, 16), (512, 32)])
def test_hat_level_gradients_match_the_per_axis_route(dev, R, rank):
    """Forward and both gradients of ``hat_cp_level`` bitwise equal to those
    of the per-axis route: the same cotangents reach G9 (deterministic) and
    G10 on the same coordinates.  One G8 launch in place of three."""
    x0, lines0, cot = _level_inputs(dev, R, rank)
    grads = []
    for level, launches in ((_per_axis_level, 3), (hat_cp_level, 1)):
        x = x0.clone().requires_grad_()
        lines = lines0.clone().requires_grad_()
        n0 = dict(cuda.LAUNCHES)
        out = level(x, lines)
        assert cuda.LAUNCHES["hat_fwd"] == n0["hat_fwd"] + launches
        out.backward(cot)
        assert cuda.LAUNCHES["hat_bwd_line"] == n0["hat_bwd_line"] + 3
        assert cuda.LAUNCHES["hat_bwd_x"] == n0["hat_bwd_x"] + 3
        grads.append((out.detach(), x.grad, lines.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_hat_level_writes_only_the_product_without_a_gradient(dev, monkeypatch):
    """Under ``torch.no_grad``, or when neither input requires a gradient,
    the level asks the kernel for the product alone and saves nothing."""
    calls = []
    real = hat_matmul.hat_level_fwd

    def spy(x, lines, keep_axes):
        calls.append(keep_axes)
        return real(x, lines, keep_axes)

    monkeypatch.setattr(hat_matmul, "hat_level_fwd", spy)
    x, lines, _ = _level_inputs(dev, 32, 16, n=1000)
    with torch.no_grad():
        out = hat_cp_level(x.requires_grad_(), lines.requires_grad_())
    assert out.grad_fn is None and calls == [False]
    out = hat_cp_level(x.detach(), lines.detach())
    assert out.grad_fn is None and calls == [False, False]
    assert torch.equal(out, hat_level_plain(x.detach(), lines.detach())[0])


def test_cp_grid_encoder_hat_route_matches_the_per_axis_route(dev):
    """``CPGridEncoder(use_pallas=True)`` at TiNeuVox's levels: three G8
    launches a forward, output, table gradients and the points' total
    gradient bitwise equal to the per-axis route (autograd adds the three
    levels' point gradients in the same order as before)."""
    from nerfacc_tpu_torch.models.cp_field import CPGridEncoder

    enc = CPGridEncoder((32, 128, 512), (16, 16, 32), use_pallas=True).to(dev)
    enc.init(torch.Generator(device=dev).manual_seed(4))
    g = torch.Generator(device=dev).manual_seed(5)
    x0 = torch.rand((2**14 + 9, 3), generator=g, device=dev) * 1.1 - 0.05
    cot = torch.randn((x0.shape[0], enc.output_dim), generator=g, device=dev)

    def per_axis(x):
        x = x.clamp(0.0, 1.0)
        return torch.cat([_per_axis_level(x, line) for line in enc.lines], dim=-1)

    results = []
    for route, launches in ((per_axis, 9), (enc, 3)):
        enc.zero_grad()
        x = x0.clone().requires_grad_()
        n0 = cuda.LAUNCHES["hat_fwd"]
        out = route(x)
        assert cuda.LAUNCHES["hat_fwd"] == n0 + launches
        out.backward(cot)
        results.append([out.detach(), x.grad] + [line.grad.clone() for line in enc.lines])
    for a, b in zip(*results):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 33, 2**16 + 5])
@pytest.mark.parametrize("rank", [1, 6, 24, 34, 48])
def test_hat_coordinate_gradient_at_other_ranks(dev, rank, n):
    """G10 at ranks that are not TiNeuVox's: 16-byte loads (24, 48) and
    masked 4-byte loads (1, 6, 34, where idle lanes of a group add 0), n
    that leaves the last warp partly empty; coordinates over [-0.1, 1.1],
    some on grid points.  Within 1e-5 of the largest entry, exactly 0 on
    grid points; the same with a cotangent that is not 16-byte aligned
    (masked loads at every rank)."""
    R = 64
    g = torch.Generator(device=dev).manual_seed(rank * 7 + n)
    x = torch.rand(n, generator=g, device=dev) * 1.2 - 0.1
    if n > 1:
        k = min(n - 1, 16)
        x[1 : 1 + k] = torch.randint(0, R, (k,), generator=g, device=dev) / (R - 1)
    line = 1 + 0.1 * torch.randn((R, rank), generator=g, device=dev)
    cot = torch.randn((n, rank), generator=g, device=dev)
    shifted = torch.empty(n * rank + 1, device=dev)[1:].view(n, rank)
    shifted.copy_(cot)
    on_grid = (x * (R - 1)) == torch.round(x * (R - 1))
    ref = hat_bwd_x_plain(x, cot, line)
    for c in (cot, shifted):
        n0 = cuda.LAUNCHES["hat_bwd_x"]
        dx = hat_bwd_x(x, c, line)
        assert cuda.LAUNCHES["hat_bwd_x"] == n0 + 1
        torch.testing.assert_close(dx, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))
        assert bool((dx[on_grid] == 0).all())
    if n > 33:
        assert int(on_grid.sum()) >= 4


@pytest.mark.parametrize("n", [1, 33, 2**16])
@pytest.mark.parametrize("R,rank", [(32, 16), (128, 16), (512, 32)])
def test_hat_line_gradient_is_deterministic(dev, R, rank, n):
    """G9 at TiNeuVox's three levels: two calls give the same bits (each
    block sums in fixed point, the blocks in block order), within 1e-6 of
    the largest entry of the plain version's once-rounded f64 sum."""
    g = torch.Generator(device=dev).manual_seed(R + n)
    x = torch.rand(n, generator=g, device=dev) * 1.02 - 0.01
    cot = torch.randn((n, rank), generator=g, device=dev)
    first = hat_bwd_line(x, cot, R)
    assert torch.equal(first.view(torch.int32), hat_bwd_line(x, cot, R).view(torch.int32))
    ref = hat_bwd_line_plain(x, cot, R)
    torch.testing.assert_close(first, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))


def test_hat_line_gradient_keeps_infinities_and_nans(dev):
    """A +-inf or NaN product makes its entries what an f64 sum makes them
    (NaN, +inf, -inf, and NaN where both infinities meet); the other
    entries stay within 1e-6 of the plain version."""
    R, rank, n = 32, 16, 4096
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.rand(n, generator=g, device=dev)
    cot = torch.randn((n, rank), generator=g, device=dev)
    x[:4] = torch.tensor([0.2, 0.2, 0.5, 0.8], device=dev)
    # the last is finite in f32 and +inf in bf16
    cot[0, 0], cot[1, 0], cot[2, 1], cot[3, 2] = math.inf, -math.inf, math.nan, 3.4e38
    out, ref = hat_bwd_line(x, cot, R), hat_bwd_line_plain(x, cot, R)
    special = ~torch.isfinite(ref)
    assert special.sum() >= 6
    assert torch.equal(out[special].isnan(), ref[special].isnan())
    assert torch.equal(out[special & ~ref.isnan()], ref[special & ~ref.isnan()])
    scale = float(ref[~special].abs().max())
    torch.testing.assert_close(out[~special], ref[~special], rtol=0, atol=1e-6 * scale)


def test_hat_wrapper_launches_the_coordinate_kernel_only_when_asked(dev):
    x, line, cot = _hat_inputs(dev, 64, 16, n=4099)
    line.requires_grad_()
    n0 = dict(cuda.LAUNCHES)
    hat_interp_matmul(x, line).backward(cot)
    assert cuda.LAUNCHES["hat_bwd_line"] == n0["hat_bwd_line"] + 1
    assert cuda.LAUNCHES["hat_bwd_x"] == n0["hat_bwd_x"]
    xg = x.clone().requires_grad_()
    hat_interp_matmul(xg, line.detach()).backward(cot)
    assert cuda.LAUNCHES["hat_bwd_x"] == n0["hat_bwd_x"] + 1
    assert cuda.LAUNCHES["hat_bwd_line"] == n0["hat_bwd_line"] + 1
    ref = hat_bwd_x_plain(x, cot, line.detach())
    torch.testing.assert_close(xg.grad, ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


def test_hat_line_gradient_refuses_a_table_past_shared_memory(dev):
    x = torch.rand(1024, device=dev)
    n0 = cuda.LAUNCHES["hat_bwd_line"]
    with pytest.raises(RuntimeError, match="hat_bwd_line"):
        hat_bwd_line(x, torch.ones((1024, 64), device=dev), 4096)
    assert cuda.LAUNCHES["hat_bwd_line"] == n0


def test_tineuvox_train_step_on_the_card_reaches_every_parameter(dev):
    """A time-dependent train step through the kernels: G8-G10 launch and
    every parameter, the deformation network's included, gets a finite,
    nonzero gradient."""
    aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    ds = ProceduralDynamicSceneLoader("train", n_train=3, width=32, height=32,
                                      num_rays=256, device=dev)
    trainer = NGPOccTrainer(
        field=TiNeuVoxRadianceField(aabb, device=dev), aabb=aabb, grid_resolution=32,
        timestamps=ds.timestamps, field_reg_weight=1e-4, weight_decay=0.0, device=dev,
    )
    state = trainer.init_state()
    cuda.reset_launches()
    state, aux = trainer.train_step(state, ds[0])
    for name in ("hat_fwd", "hat_bwd_line", "hat_bwd_x", "march", "composite_fwd",
                 "composite_bwd"):
        assert cuda.LAUNCHES[name] > 0, cuda.LAUNCHES
    assert cuda.LAUNCHES["hat_bwd_x"] == cuda.LAUNCHES["hat_bwd_line"] == 9
    assert torch.isfinite(aux["loss"]) and aux["n_rendering_samples"] > 0
    for name, p in state.params.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert float(p.grad.abs().max()) > 0, name


@pytest.mark.parametrize("kind", ["cp", "ngp", "tineuvox"])
def test_view_that_meets_no_occupied_cell_renders_its_background(dev, kind):
    """Through the kernels, rays that meet no occupied cell (the empty grid
    of a fresh state) give every kernel and the field an empty batch."""
    aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    if kind == "tineuvox":
        ds = ProceduralDynamicSceneLoader("test", n_test=1, width=32, height=32, device=dev)
        field, timestamps = TiNeuVoxRadianceField(aabb, device=dev), ds.timestamps
    else:
        ds = ProceduralSceneLoader("test", n_test=1, width=32, height=32, device=dev)
        field = CPRadianceField(aabb) if kind == "cp" else NGPRadianceField(aabb)
        timestamps = None
    trainer = NGPOccTrainer(field=field, aabb=aabb, grid_resolution=32,
                            timestamps=timestamps, device=dev)
    data = ds[0]
    colors, opacities, _, n_samples = trainer.render_rays(trainer.init_state(), data)
    torch.cuda.synchronize()
    assert n_samples == 0 and (opacities == 0).all()
    assert torch.equal(colors, data["color_bkgd"].expand(32 * 32, 3))


@pytest.mark.parametrize("kind", ["cp", "ngp"])
def test_train_step_on_the_card_reaches_every_parameter(dev, kind):
    """A train step through the kernels leaves a finite, nonzero gradient on
    every encoder table and MLP weight, and launches the field's encoder
    kernels and the march and composite kernels."""
    aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    ds = ProceduralSceneLoader("train", n_train=2, width=32, height=32,
                               num_rays=256, device=dev)
    field = CPRadianceField(aabb) if kind == "cp" else NGPRadianceField(aabb)
    trainer = NGPOccTrainer(field=field, aabb=aabb, grid_resolution=32, device=dev)
    state = trainer.init_state()
    cuda.reset_launches()
    state, aux = trainer.train_step(state, ds[0])
    encoder = ("cp_level_fwd", "cp_level_bwd") if kind == "cp" else ("hash_fwd", "hash_bwd")
    for name in (*encoder, "march", "composite_fwd", "composite_bwd"):
        assert cuda.LAUNCHES[name] > 0, cuda.LAUNCHES
    assert torch.isfinite(aux["loss"]) and aux["n_rendering_samples"] > 0
    for name, p in state.params.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert float(p.grad.abs().max()) > 0, name


def _same_bits(a, b):
    """Bitwise equality, NaNs included."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.view(torch.int16 if a.element_size() == 2 else torch.int32),
        b.view(torch.int16 if b.element_size() == 2 else torch.int32),
    )


def test_gather_kernels_match_plain_versions(dev):
    """G11, G12 (f32 and bf16) and G13 (a float4, a float2 and a scalar row
    width) bit for bit, out-of-range indices included; one launch each."""
    g = torch.Generator(device=dev).manual_seed(11)
    S = torch.rand((256, 1024), generator=g, device=dev)
    row = torch.randint(-3, 259, (2**16 + 5,), generator=g, device=dev, dtype=torch.int32)
    lane = torch.randint(-3, 1027, (2**16 + 5,), generator=g, device=dev, dtype=torch.int32)
    n0 = dict(cuda.LAUNCHES)
    assert _same_bits(coarse_occ_lookup(row, lane, S), coarse_occ_lookup_plain(row, lane, S))
    assert cuda.LAUNCHES["coarse_occ"] == n0["coarse_occ"] + 1
    for dtype in (torch.float32, torch.bfloat16):
        src = torch.randn((512, 128), generator=g, device=dev).to(dtype)
        idx = torch.randint(-600, 600, (2048, 128), generator=g, device=dev, dtype=torch.int32)
        assert _same_bits(lane_gather(src, idx), lane_gather_plain(src, idx)), dtype
    assert cuda.LAUNCHES["lane_gather"] == n0["lane_gather"] + 2
    for F in (128, 2, 3):
        tab = torch.randn((2**14, F), generator=g, device=dev)
        idx = torch.randint(-2**14 - 5, 2**14 + 5, (2**18,), generator=g, device=dev,
                            dtype=torch.int32)
        assert _same_bits(row_gather(tab, idx), row_gather_plain(tab, idx)), F
    assert cuda.LAUNCHES["row_gather"] == n0["row_gather"] + 3
    with pytest.raises(ValueError, match="128 lanes"):
        lane_gather(torch.zeros((64, 64), device=dev), torch.zeros((64, 64), dtype=torch.int32, device=dev))


@pytest.mark.parametrize("dtype, T, route", [
    # all rows in shared memory; then the largest table of each route (some
    # rows through L2), each also a few rows less (an odd height: 3 T rows,
    # no multiple of a block's pieces); and the first past it
    (torch.float32, 512, 32), (torch.float32, 7165, 32), (torch.float32, 14336, 32),
    (torch.float32, 14333, 32), (torch.float32, 14337, 0), (torch.float32, 14339, 0),
    (torch.bfloat16, 512, 32), (torch.bfloat16, 7165, 32), (torch.bfloat16, 9557, 32),
    (torch.bfloat16, 9554, 32), (torch.bfloat16, 9558, 16), (torch.bfloat16, 14336, 16),
    (torch.bfloat16, 28672, 16), (torch.bfloat16, 28669, 16), (torch.bfloat16, 28673, 0),
], ids=lambda v: str(v).replace("torch.", ""))
def test_lane_gather_routes_match_plain_version(dev, dtype, T, route):
    """Each G12 route, bit for bit, with indices in [-T - 8, T + 8); one
    launch a call."""
    assert lane_gather_mod.lane_gather_route(T, dtype) == route
    g = torch.Generator(device=dev).manual_seed(T)
    src = torch.randn((T, 128), generator=g, device=dev).to(dtype)
    idx = torch.randint(-T - 8, T + 8, (3 * T, 128), generator=g, device=dev,
                        dtype=torch.int32)
    n0 = cuda.LAUNCHES["lane_gather"]
    assert _same_bits(lane_gather(src, idx), lane_gather_plain(src, idx))
    assert cuda.LAUNCHES["lane_gather"] == n0 + 1


@pytest.mark.parametrize("T", [300, 2**13, 2**14], ids=["resident", "half-resident", "route0"])
def test_lane_gather_reads_non_contiguous_and_misaligned_inputs(dev, T):
    """Column-strided src and idx, and idx 4 bytes past a 16-byte boundary
    (the shared-memory route reads it 16 bytes at a time), at 7 blocks of T
    rows: bitwise equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(T)
    src = torch.randn((T, 256), generator=g, device=dev)[:, ::2]
    wide = torch.randint(-T, T, (7 * T, 256), generator=g, device=dev, dtype=torch.int32)
    idx = wide[:, 64:192]
    assert not src.is_contiguous() and not idx.is_contiguous()
    assert _same_bits(lane_gather(src, idx), lane_gather_plain(src, idx))
    flat = torch.randint(-T, T, (7 * T * 128 + 1,), generator=g, device=dev, dtype=torch.int32)
    shifted = flat[1:].view(7 * T, 128)
    assert shifted.data_ptr() % 16 == 4
    assert _same_bits(lane_gather(src, shifted), lane_gather_plain(src, shifted))


def test_lane_gather_refuses_a_route_it_does_not_have(dev, monkeypatch):
    """A route the kernel does not have (16-byte rows of an f32 table, whose
    4 columns would read half sectors) is refused and raises, uncounted; it
    does not give way to another route."""
    monkeypatch.setattr(lane_gather_mod, "lane_gather_route", lambda T, dtype: 16)
    src = torch.zeros((2**14, 128), device=dev)
    idx = torch.zeros((2**14, 128), dtype=torch.int32, device=dev)
    n0 = cuda.LAUNCHES["lane_gather"]
    with pytest.raises(RuntimeError, match="lane_gather"):
        lane_gather(src, idx)
    assert cuda.LAUNCHES["lane_gather"] == n0


@pytest.mark.parametrize("dtype, T, route", [(torch.float32, 1024, 32), (torch.bfloat16, 2048, 16)],
                         ids=["f32", "bf16"])
def test_lane_gather_keeps_the_rows_the_wrapper_budgets(dev, monkeypatch, dtype, T, route):
    """The shared-memory route sizes its table from the wrapper's
    SHARED_TABLE_BYTES: at a 16 KB budget half the rows are kept and half go
    through L2, and the result is bitwise the plain version's."""
    monkeypatch.setattr(lane_gather_mod, "SHARED_TABLE_BYTES", 16 * 1024)
    assert lane_gather_mod.lane_gather_route(T, dtype) == route
    g = torch.Generator(device=dev).manual_seed(T)
    src = torch.randn((T, 128), generator=g, device=dev).to(dtype)
    idx = torch.randint(-T - 8, T + 8, (5 * T, 128), generator=g, device=dev, dtype=torch.int32)
    assert _same_bits(lane_gather(src, idx), lane_gather_plain(src, idx))


@pytest.mark.parametrize("n", [1, 3, 5, 4099, 2**18 + 3])
def test_coarse_occ_lookup_takes_any_count_and_alignment(dev, n):
    """G11 at counts that are no multiple of a block's threads (nor of 4),
    on aligned tensors and on views 4 bytes past a 16-byte boundary, with
    lookups outside the table: bitwise equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(n)
    S = torch.rand((256, 1024), generator=g, device=dev)
    row = torch.randint(-3, 259, (n + 1,), generator=g, device=dev, dtype=torch.int32)
    lane = torch.randint(-3, 1027, (n + 1,), generator=g, device=dev, dtype=torch.int32)
    for r, l in ((row[:n], lane[:n]), (row[1:], lane[1:])):
        n0 = cuda.LAUNCHES["coarse_occ"]
        assert _same_bits(coarse_occ_lookup(r, l, S), coarse_occ_lookup_plain(r, l, S))
        assert cuda.LAUNCHES["coarse_occ"] == n0 + 1


def _pdf_rows(g, n_rays, E):
    """Sorted rows, and among them rows that fail G14's monotone-row vote:
    each eighth row from the third on has its vals out of order, its CDF
    out of order, a NaN in its CDF or vals, or a -0.0 in its CDF (beside a
    +0.0) or vals, in turn.  Row 0 has an all-zero CDF, row 1 a plateau."""
    dev = g.device
    vals = torch.sort(torch.rand((n_rays, E), generator=g, device=dev) * 4 + 2, dim=-1)[0]
    cdfs = torch.sort(torch.rand((n_rays, E), generator=g, device=dev), dim=-1)[0]
    cdfs[0] = 0.0
    cdfs[1, E // 3 : 2 * E // 3] = float(cdfs[1, E // 3])
    j = E // 2
    for k, r in enumerate(range(2, n_rays, 8)):
        case = k % 6
        if case == 0:
            vals[r, [0, j]] = vals[r, [j, 0]]
        elif case == 1:
            cdfs[r] = cdfs[r].flip(0)
        elif case == 2:
            cdfs[r, j] = float("nan")
        elif case == 3:
            vals[r, j] = float("nan")
        elif case == 4:
            cdfs[r, :2] = torch.tensor([-0.0, 0.0])
        else:
            vals[r, 0] = -0.0
    return vals, cdfs


@pytest.mark.parametrize(
    "E,n", [(2, 128), (129, 64), (17, 1), (300, 200), (2, 1), (129, 33), (6144, 64),
            (2, 256), (257, 96), (97, 48)])
def test_importance_sampling_kernel_matches_plain_version(dev, E, n):
    """G14 bit for bit, stratified and not, in one launch on sorted rows
    (with plateaus and an all-zero CDF row, which take its search) mixed
    with rows that fail its monotone-row vote (which take its walk), and
    with biases that put samples below the first edge (cnt = 0) and past
    the last (cnt = E - 1); at E = 2, n = 1, n not a multiple of 32, more
    samples than a chunk, the largest E the wrapper takes, and the 360
    cascade's three resamplings (2 -> 256, 257 -> 96, 97 -> 48)."""
    n_rays = 64 if E > 1000 else 1000
    g = torch.Generator(device=dev).manual_seed(E + n)
    vals, cdfs = _pdf_rows(g, n_rays, E)
    outside = torch.rand(n_rays, generator=g, device=dev) * (n + 4) - 2
    for bias in (torch.full((n_rays,), 0.5, device=dev),
                 torch.rand(n_rays, generator=g, device=dev), outside):
        n0 = cuda.LAUNCHES["importance_sampling"]
        iv, s = importance_sampling(RayIntervals(vals), cdfs, n, True, bias=bias)
        assert cuda.LAUNCHES["importance_sampling"] == n0 + 1
        ref_s, ref_e = importance_sampling_plain(vals, cdfs, bias, n)
        assert _same_bits(s.vals, ref_s) and _same_bits(iv.vals, ref_e)


def test_importance_sampling_refuses_a_row_past_the_kernel(dev):
    """The wrapper raises on a row longer than G14 stages, and takes the
    longest it does."""
    bias = torch.full((2,), 0.5, device=dev)
    for E, ok in ((6144, True), (6145, False)):
        vals = torch.linspace(2.0, 6.0, E, device=dev).expand(2, E).contiguous()
        if ok:
            importance_sampling(RayIntervals(vals), vals - 2.0, 8, True, bias=bias)
        else:
            with pytest.raises(ValueError, match="edges"):
                importance_sampling(RayIntervals(vals), vals - 2.0, 8, True, bias=bias)


def test_composite_keeps_a_nan_optical_depth(dev):
    """An infinite density on a zero-length sample (the opaque background on
    a collapsed last interval) gives NaN, as in the plain version and the
    JAX package; the cap at 40 does not turn it into an opaque sample."""
    t0 = torch.tensor([2.0, 3.0, 3.5], device=dev)
    t1 = torch.tensor([3.0, 3.5, 3.5], device=dev)
    sig = torch.tensor([0.1, 0.2, float("inf")], device=dev)
    rgb = torch.rand((3, 3), device=dev)
    ids = torch.zeros(3, dtype=torch.int32, device=dev)
    ss, se = (torch.tensor([v], dtype=torch.int32, device=dev) for v in (0, 2))
    out = composite_sorted(t0, t1, sig, rgb, ids, 1, ss, se)
    ref = composite_sorted_plain(t0, t1, sig, rgb, ids, 1, ss, se)
    assert torch.isnan(out[1]).all() and torch.isnan(ref[1]).all()


@pytest.mark.parametrize("config", ["bounded-cp", "cascade-ngp"])
def test_prop_train_step_on_the_card_reaches_every_parameter(dev, config):
    """A proposal train step with ``requires_grad`` through the kernels on a
    device-sampled batch: bench.py's configuration (CP fields: G1, G3, G4,
    G5 and G14 launch, G14 twice), and the proposal example's 360 cascade
    with the hash-grid fields (two NGPDensityFields, [256, 96] -> 48,
    lindisp, the opaque last sample, on the unbounded scene: G6, G7, G3, G5
    and G14, G14 three times); every leaf of both groups gets a finite,
    nonzero gradient."""
    if config == "bounded-cp":
        aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
        ds = ProceduralSceneLoader("train", n_train=2, width=32, height=32, num_rays=256,
                                   device=dev)
        trainer = NGPPropTrainer(
            field=CPRadianceField(aabb), prop_fields=[CPDensityField(aabb)], device=dev,
        )
        encoder = ("cp_level_fwd", "cp_level_bwd")
    else:
        aabb = (-1.0, -1.0, -1.0, 1.0, 1.0, 1.0)
        ds = ProceduralUnboundedSceneLoader("train", n_train=2, width=32, height=32,
                                            num_rays=256, device=dev)
        trainer = NGPPropTrainer(
            field=NGPRadianceField(aabb, unbounded=True),
            prop_fields=[NGPDensityField(aabb, unbounded=True) for _ in range(2)],
            prop_samples=[256, 96], num_samples=48, near_plane=ds.NEAR, far_plane=ds.FAR,
            sampling_type="lindisp", opaque_bkgd=True, device=dev,
        )
        encoder = ("hash_fwd", "hash_bwd")
    state = trainer.init_state()
    cuda.reset_launches()
    state, aux = trainer.train_steps_sampled(state, DeviceRaySampler.from_loader(ds), [True])
    for name in encoder + ("composite_fwd", "composite_bwd", "importance_sampling"):
        assert cuda.LAUNCHES[name] > 0, cuda.LAUNCHES
    assert cuda.LAUNCHES["importance_sampling"] == len(trainer.prop_samples) + 1
    assert torch.isfinite(aux["loss"]).all() and float(aux["prop_loss"][0]) > 0
    for p in trainer.leaves(state.params):
        assert p.grad is not None and torch.isfinite(p.grad).all()
        assert float(p.grad.abs().max()) > 0


def test_library_api_runs_its_kernels(dev):
    """The quick start's calls on the card: ``OccGridEstimator.sampling``
    marches through G2, ``rendering``'s flat route composites through G3
    and G5 (runs of equal ids out of order included), and both equal the
    same calls on CPU tensors (the plain versions): the samples bit for
    bit, colours within 1e-5 and gradients within 1e-5 of their largest
    entry."""
    import nerfacc_tpu_torch

    results = {}
    for where in ("cpu", dev):
        est = nerfacc_tpu_torch.OccGridEstimator([-1.0] * 3 + [1.0] * 3, 32, device=where)
        gen = torch.Generator().manual_seed(3)
        centers = (torch.stack(torch.meshgrid(*[torch.arange(32)] * 3, indexing="ij"), -1)
                   + 0.5) / 16 - 1.0
        est.binaries = (centers.norm(dim=-1) < 0.7)[None].to(where)
        rng = np.random.default_rng(2)
        o = torch.tensor(rng.uniform(-2, 2, (256, 3)), dtype=torch.float32)
        d = torch.nn.functional.normalize(-o + torch.tensor(rng.normal(0, 0.2, (256, 3)),
                                                            dtype=torch.float32), dim=-1)
        o, d = o.to(where), d.to(where)
        before = dict(cuda.LAUNCHES)
        rid, t0, t1 = est.sampling(o, d, render_step_size=1e-2)
        perm = torch.arange(rid.shape[0], device=rid.device).flip(0)  # runs out of order
        rid, t0, t1 = rid[perm], t0[perm], t1[perm]
        sig = torch.linspace(0.1, 30.0, rid.shape[0], device=rid.device).requires_grad_(True)
        rgb = torch.rand((rid.shape[0], 3), generator=gen).to(rid.device).requires_grad_(True)
        out = nerfacc_tpu_torch.rendering(t0, t1, rid, n_rays=256,
                                          rgb_sigma_fn=lambda *_: (rgb, sig))
        (out[0].sum() + out[1].sum() + out[2].sum()).backward()
        if where == dev:
            for name in ("march", "composite_fwd", "composite_bwd"):
                assert cuda.LAUNCHES[name] > before[name], name
        results[str(where)] = [x.detach().cpu() for x in (rid, t0, t1, *out[:3], sig.grad,
                                                            rgb.grad)]
    cpu, card = results["cpu"], results[str(dev)]
    for a, b in zip(cpu[:3], card[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert cpu[0].shape[0] > 1000
    for a, b in zip(cpu[3:], card[3:]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-5 * float(a.abs().max()))


@pytest.mark.parametrize("step,cone,limit,levels", [
    (5e-3, 0.0, None, 1), (1e-3, 0.004, None, 4), (1e-2, 0.004, 5, 2)])
def test_traverse_grids_takes_its_samples_from_the_march_kernel(dev, step, cone, limit, levels):
    """``traverse_grids`` on the card: G2 launched once, its samples placed
    on the lattice; every output bitwise that of the padded traversal on
    the card with the PyTorch occupancy test (``through_march=False``), the
    step limit applied alike."""
    from nerfacc_tpu_torch.grid import traverse_grids, traverse_grids_padded

    rng = np.random.default_rng(levels)
    n = 1024
    o = rng.normal(size=(n, 3))
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 1.8
    d = -o + rng.normal(size=(n, 3)) * 0.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    binaries = rng.uniform(size=(levels, 32, 32, 32)) < 0.3
    aabbs = np.array([[-1.0 * 2**i] * 3 + [1.0 * 2**i] * 3 for i in range(levels)])
    near = np.full(n, 0.2)
    card = [torch.tensor(a, dtype=torch.bool if a.dtype == bool else torch.float32, device=dev)
            for a in (o, d, binaries, aabbs, near)]
    kw = dict(step_size=step, cone_angle=cone, max_samples=1200)
    n0 = cuda.LAUNCHES["march"]
    ti, ts, tterm = traverse_grids(*card[:4], near_planes=card[4], traverse_steps_limit=limit,
                                   **kw)
    assert cuda.LAUNCHES["march"] == n0 + 1
    ref = traverse_grids_padded(*card[:4], near_planes=card[4], valid_samples_limit=limit,
                                **kw)
    assert cuda.LAUNCHES["march"] == n0 + 1 and int(ref.valid.sum()) > 0
    assert torch.equal(ts.is_valid, ref.valid)
    assert torch.equal(ti.vals, ref.t_edges) and torch.equal(tterm, ref.termination_planes)
    assert torch.equal(ti.is_left[:, :-1], ref.valid) and torch.equal(ti.is_right[:, 1:], ref.valid)


@pytest.mark.parametrize("kind", ["cp", "ngp"])
def test_field_rows_do_not_depend_on_the_batch(dev, kind):
    """A point's colour and density on the card are the same, bit for bit,
    in a batch of 1, 100, 4096 or 2^18 rows: the MLPs pad small batches
    (``models/ngp.py::_GEMM_MIN_ROWS``), so cuBLAS does not sum their rows
    in another order than a large batch's."""
    aabb = [-1.5] * 3 + [1.5] * 3
    field = CPRadianceField(aabb) if kind == "cp" else NGPRadianceField(aabb)
    field.init(torch.Generator().manual_seed(3))
    field = field.to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.rand((1 << 18, 3), generator=g, device=dev) * 3.0 - 1.5
    d = torch.nn.functional.normalize(torch.randn((1 << 18, 3), generator=g, device=dev), dim=-1)
    with torch.no_grad():
        rgb, density = field(x, d)
        for m in (1, 100, 4096):
            rgb_m, density_m = field(x[:m].clone(), d[:m].clone())
            assert torch.equal(rgb_m, rgb[:m]) and torch.equal(density_m, density[:m]), m
