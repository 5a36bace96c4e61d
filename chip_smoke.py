#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU,
and check them.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from ``nerfacc_tpu_torch/csrc`` and runs:

1. each forward kernel (G1 CP level, G2 march, G3 composite) against its
   PyTorch twin on the card at the slice's shapes, timed with CUDA events;
   1b. the backward kernels (G4 CP level, G5 composite) likewise;
2. the serving slice: ``NGPOccTrainer`` with the full-width
   ``CPRadianceField`` (resolutions 32/128/512, rank 32, bf16), parameters
   from seed 42, four dense refreshes of the 128^3 occupancy grid, then
   ``eval_metrics`` over the procedural scene's four 320x320 test views; the
   kernels' launch counts over this phase must all be positive;
3. view 0 rendered again through the twins alone, against phase 2's image;
4. the training slice: ``train_step`` on the train split (6 views at
   256x256, 2048 rays, a 2^18-sample budget, stratified, a dense refresh
   every 16 steps) for ``TRAIN_STEPS`` steps; the loss must halve and all
   five kernels' launch counts over this phase must be positive;
5. one train step through the kernels against the same step through the
   plain twins, from phase 4's state with the same batch and jitter, for
   the bf16 field and for an f32 field on the same parameters;
6. ``eval_metrics`` on phase 4's trained field, which must beat phase 2's
   untrained PSNR by 3 dB.

Every check raises on failure, so the exit code is nonzero and the result
line is not printed.  The last line of standard output is a JSON object with
``"ok": true`` and the device; the line before it lists each kernel's launch
count over the training phase, error and times.  Without a CUDA device the
script fails at once.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from nerfacc_tpu_torch import cuda  # noqa: E402
from nerfacc_tpu_torch.cuda import _build  # noqa: E402
from nerfacc_tpu_torch.data.procedural import ProceduralSceneLoader  # noqa: E402
from nerfacc_tpu_torch.grid import march, march_plain  # noqa: E402
from nerfacc_tpu_torch.models.cp_field import CPRadianceField  # noqa: E402
from nerfacc_tpu_torch.ops.cp_level import (  # noqa: E402
    cp_level_backward,
    cp_level_backward_plain,
    cp_level_encode,
    cp_level_encode_plain,
)
from nerfacc_tpu_torch.ops.sorted_segments import (  # noqa: E402
    composite_sorted,
    composite_sorted_backward,
    composite_sorted_backward_plain,
    composite_sorted_plain,
)
from nerfacc_tpu_torch.trainers.ngp_occ import NGPOccTrainer, TrainState  # noqa: E402
from nerfacc_tpu_torch.utils import flops  # noqa: E402
from nerfacc_tpu_torch.utils.rendering import compact_samples  # noqa: E402

AABB = [-1.5, -1.5, -1.5, 1.5, 1.5, 1.5]
N_REFRESH = 4
G1_N = 2**18
G2_RAYS = 8192
FLIP_ALLOWANCE = 1e-3  # share of rays whose sample count may differ
TRAIN_STEPS = 1000  # not a multiple of the refresh interval: phase 5's step
TRAIN_RAYS = 2048
TRAIN_BUDGET = 2**18
# Phase 5: each gradient leaf of a kernel step against the twin step, by
# relative Frobenius norm, worst of STEP_REPEATS runs.  f32: only the order of
# the atomic sums differs (readings up to 2.5e-5 on an H100, PERF.md §6).
# bf16: the field rounds each MLP weight gradient to bf16 last, so order-only
# differences of ~1e-5 flip a few entries by one bf16 ulp, which is at most
# 2^-7 of the entry: a leaf reads below 2^-7 = 7.8e-3 even if every entry
# flipped, and read 1.3e-4 to 8.5e-4 on an H100.  Lost bf16 roundings read
# >= 2.2e-2 (the twins' f32 field against their bf16 field, printed), a
# detached gradient ~1.  The kernels' own roundings are held elementwise in
# phase 1b.
STEP_REPEATS = 8
F32_STEP_FRO = 1e-4
BF16_STEP_FRO = 5e-3


def require(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def cuda_ms(fn, reps=10):
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def make_trainer(dev):
    field = CPRadianceField(AABB, compute_dtype=torch.bfloat16)
    return NGPOccTrainer(field=field, aabb=AABB, device=dev)


def refreshed_state(trainer):
    state = trainer.init_state()
    for step in range(N_REFRESH):
        state = trainer.refresh_occ_grid(state, step)
    return state


@torch.inference_mode()
def phase_kernels(dev, trainer, state, ds):
    """Each kernel against its twin at the slice's shapes."""
    report = {}
    g = torch.Generator(device=dev).manual_seed(0)

    # G1: every level of the field, both compute dtypes
    worst, g1_ms, g1_plain_ms = 0.0, None, None
    u = torch.rand((G1_N, 3), generator=g, device=dev)
    for line in trainer.field.encoder.lines:
        R = line.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            out = cp_level_encode(u, line, dtype)
            ref = cp_level_encode_plain(u, line, dtype)
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            require(err <= 1e-5 * scale, f"G1 R={R} {dtype}: err {err} scale {scale}")
            ms = cuda_ms(lambda: cp_level_encode(u, line, dtype))
            plain = cuda_ms(lambda: cp_level_encode_plain(u, line, dtype))
            print(f"G1 cp_level R={R} {str(dtype)[6:]}: max_abs_err={err:.3g} "
                  f"(scale {scale:.3g}) kernel {ms:.4f} ms, twin {plain:.4f} ms")
            worst = max(worst, err)
            if R == 512 and dtype == torch.bfloat16:
                g1_ms, g1_plain_ms = ms, plain
    report["cp_level_fwd"] = (worst, g1_ms, g1_plain_ms)

    # G2: the middle 8192 rays of test view 0 on the refreshed grid, and on
    # that grid with half its cells cleared at random (an untrained field
    # can occupy every cell, which would leave the occupancy test unchecked)
    data = ds[0]
    n = data["rays_o"].shape[0]
    sl = slice(n // 2 - G2_RAYS // 2, n // 2 + G2_RAYS // 2)
    o, d = data["rays_o"][sl].contiguous(), data["rays_d"][sl].contiguous()
    occ = state.occ_state
    near = torch.zeros(G2_RAYS, device=dev)
    far = torch.full((G2_RAYS,), 1e10, device=dev)
    cleared = occ.binaries & (
        torch.rand(occ.binaries.shape, generator=g, device=dev) < 0.5
    )
    t_err = 0.0
    for name, binaries in (("refreshed", occ.binaries), ("half-cleared", cleared)):
        args = (o, d, binaries, occ.aabbs, near, far, trainer.render_step_size)
        out, ref = march(*args), march_plain(*args)
        differ = out.counts != ref.counts
        n_differ = int(differ.sum())
        print(f"G2 march, {name} grid ({float(binaries.float().mean()):.3f} "
              f"occupied): {out.ray_indices.shape[0]} samples over {G2_RAYS} "
              f"rays, {n_differ} rays differ in count")
        require(n_differ <= FLIP_ALLOWANCE * G2_RAYS, f"G2: {n_differ} rays differ")
        keep = ~differ[out.ray_indices.long()]
        keep_ref = ~differ[ref.ray_indices.long()]
        require(torch.equal(out.ray_indices[keep], ref.ray_indices[keep_ref]),
                "G2 ray ids")
        t_err = max(
            t_err,
            float((out.t_starts[keep] - ref.t_starts[keep_ref]).abs().max()),
            float((out.t_ends[keep] - ref.t_ends[keep_ref]).abs().max()),
        )
        require(t_err <= 1e-6, f"G2: t differs by {t_err}")
        term_err = float((out.termination_planes - ref.termination_planes).abs().max())
        require(term_err <= 1e-6, f"G2: termination planes differ by {term_err}")
    # timed on the refreshed grid, the one the slice marches
    args = (o, d, occ.binaries, occ.aabbs, near, far, trainer.render_step_size)
    out = march(*args)
    report["march"] = (
        t_err, cuda_ms(lambda: march(*args)), cuda_ms(lambda: march_plain(*args))
    )
    print(f"G2 march: t max_abs_err={t_err:.3g}, kernel "
          f"{report['march'][1]:.4f} ms, twin {report['march'][2]:.4f} ms")

    # G3: on that buffer, seeded densities and colours
    s = compact_samples(out)
    n_s = s.num_valid
    sigmas = 10.0 ** (torch.rand(n_s, generator=g, device=dev) * 4 - 1)
    rgbs = torch.rand((n_s, 3), generator=g, device=dev)
    cargs = (s.t_starts, s.t_ends, sigmas, rgbs, s.ray_indices, G2_RAYS,
             s.seg_starts, s.seg_ends)
    c, a, dep, _ = composite_sorted(*cargs)
    rc, ra, rdep, _ = composite_sorted_plain(*cargs)
    err = max(float((c - rc).abs().max()), float((a - ra).abs().max()))
    dep_err = float((dep - rdep).abs().max())
    require(err <= 1e-5, f"G3: rgb/opacity differ by {err}")
    require(dep_err <= 1e-4, f"G3: depth differs by {dep_err}")
    report["composite_fwd"] = (
        err,
        cuda_ms(lambda: composite_sorted(*cargs)),
        cuda_ms(lambda: composite_sorted_plain(*cargs)),
    )
    print(f"G3 composite: {n_s} samples, rgb/opacity max_abs_err={err:.3g}, "
          f"depth {dep_err:.3g}, kernel {report['composite_fwd'][1]:.4f} ms, "
          f"twin {report['composite_fwd'][2]:.4f} ms")

    # 1b. G4: every level at N = 2^18, both compute dtypes, seeded cotangent;
    # its sums run in atomic order, hence 1e-4 of the largest entry
    worst, g4_ms, g4_plain_ms = 0.0, None, None
    cot = torch.randn((G1_N, 32), generator=g, device=dev)
    for line in trainer.field.encoder.lines:
        R = line.shape[1]
        for dtype in (torch.float32, torch.bfloat16):
            out = cp_level_backward(u, cot, line, dtype)
            ref = cp_level_backward_plain(u, cot, line, dtype)
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            require(err <= 1e-4 * scale, f"G4 R={R} {dtype}: err {err} scale {scale}")
            ms = cuda_ms(lambda: cp_level_backward(u, cot, line, dtype))
            plain = cuda_ms(lambda: cp_level_backward_plain(u, cot, line, dtype))
            print(f"G4 cp_level_bwd R={R} {str(dtype)[6:]}: max_abs_err={err:.3g} "
                  f"(scale {scale:.3g}) kernel {ms:.4f} ms, twin {plain:.4f} ms")
            worst = max(worst, err)
            if R == 512 and dtype == torch.bfloat16:
                g4_ms, g4_plain_ms = ms, plain
    report["cp_level_bwd"] = (worst, g4_ms, g4_plain_ms)

    # G5: G3's buffer, seeded cotangents of the three per-ray sums
    cots = [torch.randn((G2_RAYS, c), generator=g, device=dev) for c in (3, 1, 1)]
    bargs = cargs + tuple(cots)
    out = composite_sorted_backward(*bargs)
    ref = composite_sorted_backward_plain(*bargs)
    err = 0.0
    for name, a, b in zip(("dsigma", "drgb"), out, ref):
        e, scale = float((a - b).abs().max()), float(b.abs().max())
        require(e <= 1e-5 * scale, f"G5 {name}: err {e} scale {scale}")
        err = max(err, e)
    report["composite_bwd"] = (
        err,
        cuda_ms(lambda: composite_sorted_backward(*bargs)),
        cuda_ms(lambda: composite_sorted_backward_plain(*bargs)),
    )
    print(f"G5 composite_bwd: {n_s} samples, max_abs_err={err:.3g}, kernel "
          f"{report['composite_bwd'][1]:.4f} ms, twin "
          f"{report['composite_bwd'][2]:.4f} ms")
    return report


def phase_slice(dev, ds):
    """The serving path through the user's entry points, launches counted."""
    cuda.reset_launches()
    t0 = time.perf_counter()
    trainer = make_trainer(dev)
    state = refreshed_state(trainer)
    torch.cuda.synchronize()
    t_refresh = time.perf_counter() - t0
    metrics = trainer.eval_metrics(state, ds)
    torch.cuda.synchronize()
    launches = dict(cuda.LAUNCHES)

    occupied = float(state.occ_state.binaries.float().mean())
    print(f"slice: init + {N_REFRESH} dense refreshes of the "
          f"{trainer.grid_resolution}^3 grid {t_refresh:.3f} s; occupied "
          f"share {occupied:.4f}")
    for i, v in enumerate(metrics["views"]):
        print(f"slice view {i}: {v['seconds']:.4f} s, "
              f"{v['n_samples'] / v['n_rays']:.2f} samples/ray, "
              f"{v['n_samples'] / v['seconds']:.4g} rendered samples/s, "
              f"psnr {v['psnr']:.3f}, opacity [{v['opacity_min']:.4g}, "
              f"{v['opacity_max']:.6g}]")
        require(v["finite"], f"view {i}: non-finite output")
        require(v["opacity_min"] >= 0.0 and v["opacity_max"] <= 1.0 + 1e-4,
                f"view {i}: opacity out of [0, 1]")
        require(v["n_rays"] == ds.WIDTH * ds.HEIGHT, f"view {i}: ray count")
    print(f"slice: psnr vs GT {metrics['psnr']:.3f} (random field), ssim "
          f"{metrics['ssim']:.4f}, launches {launches}")
    for name in ("cp_level_fwd", "march", "composite_fwd"):
        require(launches[name] > 0, f"kernel {name} never launched on the slice")
    return trainer, state, metrics["psnr"]


def render_through_twins(trainer, o, d, occ, near, level, composite, budget=None):
    """Rays rendered through the plain twins alone: march, CP levels (by
    ``level``), composite (by ``composite``).  Returns colours before the
    background blend, opacities and the packed samples."""
    field = trainer.field
    n = o.shape[0]
    far = torch.full((n,), trainer.far_plane, device=o.device)
    smp = compact_samples(
        march_plain(o, d, occ.binaries, occ.aabbs, near, far,
                    trainer.render_step_size, trainer.cone_angle),
        budget,
    )
    ids = smp.ray_indices.long()
    t_mid = 0.5 * (smp.t_starts + smp.t_ends)
    dirs = d[ids]
    u, selector = field.normalize(o[ids] + t_mid[:, None] * dirs)
    u = u.clamp(0.0, 1.0)
    feats = torch.cat(
        [level(u, line, field.compute_dtype) for line in field.encoder.lines], dim=-1
    )
    density, embedding = field.density_from_features(feats, selector, True)
    rgb = field.query_rgb(dirs, embedding)
    colors, opacities = composite(
        smp.t_starts, smp.t_ends, density[:, 0], rgb, smp.ray_indices, n,
        smp.seg_starts, smp.seg_ends,
    )[:2]
    return colors, opacities, smp


@torch.inference_mode()
def render_view_plain(trainer, state, data, chunk=8192):
    """View colours through the twins only."""
    trainer.field.load_state_dict(state.params)
    rays_o, rays_d = data["rays_o"], data["rays_d"]
    out = []
    for s in range(0, rays_o.shape[0], chunk):
        o, d = rays_o[s : s + chunk], rays_d[s : s + chunk]
        near = torch.full((o.shape[0],), trainer.near_plane, device=o.device)
        colors, opacities, _ = render_through_twins(
            trainer, o, d, state.occ_state, near, cp_level_encode_plain,
            composite_sorted_plain,
        )
        out.append(colors + data["color_bkgd"] * (1.0 - opacities))
    return torch.cat(out)


class PlainCPLevel(torch.autograd.Function):
    """The CP level through its plain twins, forward and backward."""

    @staticmethod
    def forward(ctx, u, lines, compute_dtype):
        ctx.save_for_backward(u, lines)
        ctx.compute_dtype = compute_dtype
        return cp_level_encode_plain(u, lines, compute_dtype)

    @staticmethod
    def backward(ctx, g):
        u, lines = ctx.saved_tensors
        return None, cp_level_backward_plain(u, g.contiguous(), lines, ctx.compute_dtype), None


class PlainComposite(torch.autograd.Function):
    """Compositing through its plain twins, forward and backward."""

    @staticmethod
    def forward(ctx, t0, t1, sigmas, rgbs, ids, n_rays, ss, se):
        ctx.save_for_backward(t0, t1, sigmas, rgbs, ids, ss, se)
        ctx.n_rays = n_rays
        return composite_sorted_plain(t0, t1, sigmas, rgbs, ids, n_rays, ss, se)[:3]

    @staticmethod
    def backward(ctx, gc, go, gd):
        t0, t1, sigmas, rgbs, ids, ss, se = ctx.saved_tensors
        n = ctx.n_rays
        cots = [torch.zeros((n, c), device=t0.device) if x is None else x.contiguous()
                for x, c in ((gc, 3), (go, 1), (gd, 1))]
        d_s, d_r = composite_sorted_backward_plain(t0, t1, sigmas, rgbs, ids, n, ss, se, *cots)
        return None, None, d_s, d_r, None, None, None, None


def train_loss_plain(trainer, params, occ, batch, near_jitter):
    """The train step's loss and gradients (no refresh, no update) through
    the plain twins alone."""
    field = trainer.field
    field.load_state_dict(params)
    field.zero_grad(set_to_none=True)
    o, d = batch["rays_o"], batch["rays_d"]
    n = o.shape[0]
    near = trainer.near_plane + near_jitter * trainer.render_step_size
    colors, opacities, smp = render_through_twins(
        trainer, o, d, occ, near, PlainCPLevel.apply, PlainComposite.apply,
        trainer.sample_budget,
    )
    colors = colors + batch["color_bkgd"] * (1.0 - opacities)
    ray_ok = (torch.arange(n, device=o.device) < smp.first_incomplete_ray)[:, None]
    n_ok = ray_ok.sum().clamp_min(1)
    diff = (colors - batch["rgb"]).abs() * ray_ok
    loss = torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5).sum() / (n_ok * 3)
    loss.backward()
    return float(loss.detach()), {k: p.grad for k, p in field.named_parameters()}


def phase_train(dev):
    """The training path through the user's entry points, launches counted."""
    t0 = time.perf_counter()
    ds = ProceduralSceneLoader(
        split="train", n_train=6, width=256, height=256, num_rays=TRAIN_RAYS,
        device=dev,
    )
    field = CPRadianceField(AABB, compute_dtype=torch.bfloat16)
    trainer = NGPOccTrainer(
        field=field, aabb=AABB, max_steps=TRAIN_STEPS, sample_budget=TRAIN_BUDGET,
        device=dev,
    )
    state = trainer.init_state()
    # batches drawn and staged on the card before the clock, as bench.py does
    batches = [ds[0] for _ in range(TRAIN_STEPS + 1)]
    torch.cuda.synchronize()
    print(f"train: {len(ds)} views {ds.WIDTH}x{ds.HEIGHT}, {TRAIN_RAYS} rays, "
          f"budget {TRAIN_BUDGET}, set-up {time.perf_counter() - t0:.2f} s")

    cuda.reset_launches()
    losses, n_samples, n_total, n_ok = [], 0, 0, []
    t0 = time.perf_counter()
    for i in range(TRAIN_STEPS):
        state, aux = trainer.train_step(state, batches[i])
        losses.append(aux["loss"])
        n_ok.append(aux["n_rays_ok"])
        n_samples += aux["n_rendering_samples"]
        n_total += aux["n_total_samples"]
        if i % 100 == 0 or i == TRAIN_STEPS - 1:
            print(f"train step {i}: loss {float(aux['loss']):.6f}, "
                  f"{aux['n_rendering_samples']} samples of {aux['n_total_samples']}, "
                  f"{int(aux['n_rays_ok'])} rays in the loss")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)

    losses = torch.stack(losses).cpu()
    require(bool(torch.isfinite(losses).all()), "train: non-finite loss")
    first, last = float(losses[:50].mean()), float(losses[-50:].mean())
    refreshes = -(-TRAIN_STEPS // trainer.update_interval)
    work = (n_samples * flops.cp_field_flops_per_sample(field)
            + refreshes * trainer.grid_resolution**3
            * flops.cp_density_query_flops_per_sample(field))
    masked = 1.0 - float(torch.stack(n_ok).sum()) / (TRAIN_RAYS * TRAIN_STEPS)
    print(f"train: {TRAIN_STEPS} steps in {seconds:.3f} s, "
          f"{1e3 * seconds / TRAIN_STEPS:.3f} ms/step, "
          f"{n_samples / seconds:.6g} train samples/s "
          f"({n_samples / TRAIN_STEPS:.1f} rendered, {n_total / TRAIN_STEPS:.1f} "
          f"demanded per step), {work / seconds / 1e12:.4f} TFLOP/s = "
          f"{100 * work / seconds / flops.H100_PEAK_BF16_FLOPS:.4f}% of 989 "
          f"bf16 TFLOP/s; {100 * masked:.2f}% of rays masked by the budget")
    print(f"train: mean loss of the first 50 steps {first:.6f}, of the last "
          f"50 {last:.6f}; launches {launches}")
    require(last < 0.5 * first, f"train: loss {first} -> {last} did not halve")
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched in training")
    return trainer, state, batches[TRAIN_STEPS], launches


def kernel_step_grads(trainer, state, batch, near):
    """One ``train_step`` through the kernels from a copy of ``state``: its
    loss and the parameters' gradients, each checked finite and nonzero."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.params.items()}
    st = TrainState(params, trainer.init_optimizer(params), state.occ_state, state.step)
    _, aux = trainer.train_step(st, batch, near_jitter=near)
    for name, p in params.items():
        require(torch.isfinite(p.grad).all() and float(p.grad.abs().max()) > 0,
                f"train step: gradient of {name} is zero or not finite")
    return float(aux["loss"]), {k: p.grad for k, p in params.items()}


def relative_fro(grads, ref):
    return {k: float(torch.linalg.norm(g - ref[k]) / torch.linalg.norm(ref[k]))
            for k, g in grads.items()}


def phase_train_twins(trainer, state, batch):
    """One train step through the kernels against the same step through the
    plain twins: the same state, batch and near-plane jitter, for the
    trained bf16 field and for the same parameters in an f32 field.  Each
    kernel step runs ``STEP_REPEATS`` times, since atomics reorder its sums
    from run to run."""
    require(state.step % trainer.update_interval != 0, "phase 5 step refreshes")
    gen = torch.Generator(device=trainer.device).manual_seed(5)
    near = torch.rand(TRAIN_RAYS, generator=gen, device=trainer.device)
    f32 = NGPOccTrainer(
        field=CPRadianceField(AABB, compute_dtype=torch.float32), aabb=AABB,
        max_steps=TRAIN_STEPS, sample_budget=TRAIN_BUDGET, device=trainer.device,
    )
    plain = {}
    for mode, tr, limit in (("f32", f32, F32_STEP_FRO), ("bf16", trainer, BF16_STEP_FRO)):
        loss_plain, grads_plain = train_loss_plain(
            tr, state.params, state.occ_state, batch, near
        )
        plain[mode] = grads_plain
        worst, rels = {}, []
        for _ in range(STEP_REPEATS):
            loss, grads = kernel_step_grads(tr, state, batch, near)
            rels.append(abs(loss - loss_plain) / abs(loss_plain))
            for k, v in relative_fro(grads, grads_plain).items():
                worst[k] = max(worst.get(k, 0.0), v)
        readings = sorted(worst.values())
        print(f"train step {mode}, kernels vs twins over {STEP_REPEATS} runs: "
              f"loss {loss:.7g} vs {loss_plain:.7g} (relative <= {max(rels):.3g}); "
              f"worst relative Frobenius per leaf (limit {limit:g}): "
              + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
        require(readings[-1] <= limit, f"train step {mode}: a gradient leaf off by "
                f"{readings[-1]} > {limit}")
        require(max(rels) <= 1e-5, f"train step {mode}: losses differ by {max(rels)}")
    contract = relative_fro(plain["f32"], plain["bf16"])
    print("train step, twins f32 field vs bf16 field (what lost bf16 roundings read): "
          + ", ".join(f"{k} {v:.3g}" for k, v in contract.items()))


def phase_serve_trained(trainer, state, ds, untrained_psnr):
    """The serving path on the trained field and its grid."""
    metrics = trainer.eval_metrics(state, ds)
    occupied = float(state.occ_state.binaries.float().mean())
    for i, v in enumerate(metrics["views"]):
        print(f"trained view {i}: {v['seconds']:.4f} s, "
              f"{v['n_samples'] / v['n_rays']:.2f} samples/ray, psnr "
              f"{v['psnr']:.3f}, ssim {v['ssim']:.4f}")
        require(v["finite"], f"trained view {i}: non-finite output")
    seconds = sum(v["seconds"] for v in metrics["views"]) / len(metrics["views"])
    print(f"trained field: {seconds:.4f} s/frame, occupied share {occupied:.4f}, "
          f"psnr {metrics['psnr']:.3f} (untrained {untrained_psnr:.3f}), ssim "
          f"{metrics['ssim']:.4f}")
    require(metrics["psnr"] >= untrained_psnr + 3.0,
            f"trained psnr {metrics['psnr']} not 3 dB above {untrained_psnr}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    cuda.load()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds} s) from {_build.library_path().name}")
    for line in _build.build_log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    ds = ProceduralSceneLoader(split="test", device=dev)
    torch.cuda.synchronize()
    print(f"scene: {len(ds)} test views {ds.WIDTH}x{ds.HEIGHT}, ground truth "
          f"rendered in {time.perf_counter() - t0:.2f} s")

    trainer = make_trainer(dev)
    report = phase_kernels(dev, trainer, refreshed_state(trainer), ds)
    trainer, state, untrained_psnr = phase_slice(dev, ds)

    with torch.inference_mode():
        main_colors = trainer.render_image(state, ds[0])
    plain_colors = render_view_plain(trainer, state, ds[0])
    diff = float((main_colors - plain_colors).abs().max())
    print(f"view 0, kernels vs twins: max colour difference {diff:.3g}")
    require(diff <= 2e-3, f"view 0: kernel and twin paths differ by {diff}")

    trainer, state, batch, launches = phase_train(dev)
    phase_train_twins(trainer, state, batch)
    phase_serve_trained(trainer, state, ds, untrained_psnr)

    sources = {
        "cp_level_fwd": ("nerfacc_tpu_torch/csrc/cp_level.cu",
                         "nerfacc_tpu/ops/cp_level.py:59"),
        "cp_level_bwd": ("nerfacc_tpu_torch/csrc/cp_level_bwd.cu",
                         "nerfacc_tpu/ops/cp_level.py:66"),
        "march": ("nerfacc_tpu_torch/csrc/march.cu", "nerfacc_tpu/grid.py:1333"),
        "composite_fwd": ("nerfacc_tpu_torch/csrc/composite.cu",
                          "nerfacc_tpu/volrend.py:60"),
        "composite_bwd": ("nerfacc_tpu_torch/csrc/composite.cu",
                          "nerfacc_tpu/ops/sorted_segments.py:238"),
    }
    kernels = []
    for name, (src, replaces) in sources.items():
        err, ms, plain_ms = report[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
