"""Kernels G1-G5 against their PyTorch twins on the card, and the
gradients that reach the train step through them.

These need an NVIDIA Hopper GPU and nvcc; elsewhere they skip.  Run them on
the card with ``python -m pytest tests/test_torch_kernels.py -q``.
"""
import numpy as np
import pytest
import torch

from nerfacc_tpu_torch import cuda
from nerfacc_tpu_torch.grid import march, march_plain
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader
from nerfacc_tpu_torch.models.cp_field import CPRadianceField
from nerfacc_tpu_torch.ops.cp_level import (
    cp_level_backward,
    cp_level_backward_plain,
    cp_level_encode,
    cp_level_encode_plain,
)
from nerfacc_tpu_torch.ops.sorted_segments import (
    composite_sorted,
    composite_sorted_backward,
    composite_sorted_backward_plain,
    composite_sorted_plain,
)
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer
from nerfacc_tpu_torch.utils.rendering import compact_samples

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
    """G4 against the closed-form twin; the kernel's f32 sums run in atomic
    order, so 1e-4 of the largest entry (a reordered sum, and in bf16 a rare
    flip of one product's rounding)."""
    g = torch.Generator(device=dev).manual_seed(R + 1)
    u = torch.rand((2**16 + 3, 3), generator=g, device=dev)
    u[:2] = torch.tensor([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0]], device=dev)
    lines = 1 + 0.1 * torch.randn((3, R, 32), generator=g, device=dev)
    cot = torch.randn((u.shape[0], 32), generator=g, device=dev)
    n0 = cuda.LAUNCHES["cp_level_bwd"]
    out = cp_level_backward(u, cot, lines, dtype)
    assert cuda.LAUNCHES["cp_level_bwd"] == n0 + 1
    ref = cp_level_backward_plain(u, cot, lines, dtype)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4 * float(ref.abs().max()))


def test_cp_level_backward_refuses_a_table_past_shared_memory(dev):
    """G4 keeps one axis's (R, rank) f32 table in shared memory; a table
    larger than the card's opt-in limit (256 KiB here) raises, uncounted."""
    u = torch.rand((1024, 3), device=dev)
    lines = torch.ones((3, 2048, 32), device=dev)
    n0 = cuda.LAUNCHES["cp_level_bwd"]
    with pytest.raises(RuntimeError, match="cp_level_bwd"):
        cp_level_backward(u, torch.ones((1024, 32), device=dev), lines, torch.float32)
    assert cuda.LAUNCHES["cp_level_bwd"] == n0


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


def test_train_step_on_the_card_reaches_every_parameter(dev):
    """A train step through the kernels leaves a finite, nonzero gradient on
    every encoder table and MLP weight, and launches both backward kernels."""
    aabb = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
    ds = ProceduralSceneLoader("train", n_train=2, width=32, height=32,
                               num_rays=256, device=dev)
    trainer = NGPOccTrainer(
        field=CPRadianceField(aabb), aabb=aabb, grid_resolution=32, device=dev,
    )
    state = trainer.init_state()
    cuda.reset_launches()
    state, aux = trainer.train_step(state, ds[0])
    assert all(count > 0 for count in cuda.LAUNCHES.values()), cuda.LAUNCHES
    assert torch.isfinite(aux["loss"]) and aux["n_rendering_samples"] > 0
    for name, p in state.params.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert float(p.grad.abs().max()) > 0, name
