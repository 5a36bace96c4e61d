#!/usr/bin/env python3
"""Train the TiNeuVox path as ``chip_smoke.py``'s phase 12 does under several
draws of the trainer's per-step noise, and read phase 13's train step on each.

Run from the root of a checkout, on one GPU:

    python3 scripts/tineuvox_grad_noise.py [--noise default x4 1 2 3] [--out build/tineuvox_noise]

A noise draw is "default" (the trainer's own keying of a step's generators,
``step key * 3 + stream``), "x4" (``step key * 4 + stream``), or an integer
n (the default keying plus n * 2^45).  Every run starts from the parameters
of seed 42 and trains on the same batches; only the refresh's cell jitter,
the near-plane jitter and the refresh's frame draw change.  After
``chip_smoke.TRAIN_STEPS`` steps, phase 13's step (its next batch, its
near-plane jitter) runs through the kernels and through the plain versions,
in the bf16 field and in an f32 field on the same parameters, and the run
reports for each parameter leaf whether its gradient is finite and its
largest magnitude; and, on 2^16 points drawn in the box at the training
frames' times, for each hidden layer of the deformation MLP the share of
its units that fire on any point, the largest |raw| of its output
(``warp = tanh(raw) * deform_scale``) and the share of outputs whose
``1 - tanh(raw)^2`` is 0 in f32, where no gradient reaches the MLP.  One
JSON line a run, printed and appended to ``<out>/runs.jsonl``.
"""
import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from nerfacc_tpu_torch.models.ngp import _mlp_apply  # noqa: E402


def keyed(trainer, noise):
    """``trainer._generator`` under the noise draw ``noise``."""
    def generator(step, stream):
        key = trainer.seed * 1_000_003 + int(step)
        if noise == "x4":
            seed = key * 4 + stream
        else:
            seed = key * 3 + stream + (0 if noise == "default" else int(noise) << 45)
        gen = torch.Generator(device=trainer.device)
        gen.manual_seed(seed)
        return gen
    return generator


def leaf_readings(grads):
    return {
        k: None if g is None else {"finite": bool(torch.isfinite(g).all()),
                                   "max_abs": float(g.abs().max())}
        for k, g in grads.items()
    }


def step_grads(trainer, state, batch, near, plain):
    """Phase 13's step from a copy of ``state``: each leaf's gradient."""
    if plain:
        return cs.train_loss_plain(trainer, state.params, state.occ_state, batch, near)[1]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in state.params.items()}
    st = cs.TrainState(params, trainer.init_optimizer(params), state.occ_state, state.step)
    trainer.train_step(st, batch, near_jitter=near)
    return {k: p.grad for k, p in params.items()}


@torch.no_grad()
def deform_activity(trainer, state, times, dev):
    """On 2^16 points in the box: per hidden layer of the deformation MLP
    the share of its units that fire (ReLU output > 0) on any point, the
    largest |raw| and the share of raw outputs where tanh has saturated."""
    field = trainer._bind(state)
    g = torch.Generator(device=dev).manual_seed(0)
    lo = torch.tensor(cs.AABB[:3], device=dev)
    hi = torch.tensor(cs.AABB[3:], device=dev)
    x = lo + (hi - lo) * torch.rand((2**16, 3), generator=g, device=dev)
    t = times[torch.randint(times.shape[0], (2**16,), generator=g, device=dev)]
    h = torch.cat([field.posi_encoder(x), field.time_encoder(t)], dim=-1)
    raw = _mlp_apply(field.deform, h, field.compute_dtype)
    shares = []
    for w in list(field.deform)[:-1]:
        h = torch.relu(h @ w.float())
        shares.append(float((h > 0).any(dim=0).float().mean()))
    saturated = (1.0 - torch.tanh(raw) ** 2) == 0.0
    return {"active_share": shares, "raw_abs_max": float(raw.abs().max()),
            "saturated_share": float(saturated.float().mean())}


def run(dev, noise):
    t0 = time.perf_counter()
    ds = cs.train_loader(dev, "tineuvox")
    _, _, budget = cs.TRAIN["tineuvox"]
    trainer = cs.make_trainer(dev, "tineuvox", timestamps=ds.timestamps,
                              max_steps=cs.TRAIN_STEPS, sample_budget=budget)
    trainer._generator = keyed(trainer, noise)
    state = trainer.init_state()
    batches = [ds[0] for _ in range(cs.TRAIN_STEPS + 1)]
    losses = []
    for i in range(cs.TRAIN_STEPS):
        state, aux = trainer.train_step(state, batches[i])
        losses.append(aux["loss"])
    losses = torch.stack(losses).cpu()
    batch = batches[cs.TRAIN_STEPS]
    near = torch.rand(batch["rays_o"].shape[0], device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5))
    f32 = cs.make_trainer(dev, "tineuvox", torch.float32, timestamps=ds.timestamps,
                          max_steps=cs.TRAIN_STEPS, sample_budget=budget)
    steps = {}
    for mode, tr in (("f32", f32), ("bf16", trainer)):
        for route in ("kernels", "plain"):
            steps[f"{mode} {route}"] = leaf_readings(
                step_grads(tr, state, batch, near, route == "plain"))
    failed = sorted({f"{step}: {k}" for step, leaves in steps.items()
                     for k, r in leaves.items()
                     if r is None or not r["finite"] or r["max_abs"] == 0.0})
    return {
        "noise": noise, "steps": cs.TRAIN_STEPS, "finite_losses": bool(torch.isfinite(losses).all()),
        "loss_first50": float(losses[:50].mean()), "loss_last50": float(losses[-50:].mean()),
        "deform": deform_activity(trainer, state, ds.timestamps, dev),
        "deform_grads": {step: {k: r for k, r in leaves.items() if k.startswith("deform")}
                         for step, leaves in steps.items()},
        "zero_or_nonfinite": failed, "seconds": time.perf_counter() - t0,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--noise", nargs="+", default=["default", "x4", "1", "2", "3"])
    ap.add_argument("--out", default="build/tineuvox_noise")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tineuvox_grad_noise: torch.cuda.is_available() is false")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    head = {"card": cs.card(), "torch": torch.__version__, "cuda": torch.version.cuda}
    print(json.dumps(head), flush=True)
    for noise in args.noise:
        rec = run(dev, noise)
        print(json.dumps(rec), flush=True)
        with open(os.path.join(args.out, "runs.jsonl"), "a") as f:
            f.write(json.dumps({**head, **rec}) + "\n")


if __name__ == "__main__":
    main()
