"""Entry points of the distributed layer, and the rank bodies its checks run.

PyTorch twin of ``__graft_entry__.py``: :func:`entry` is the CP field's
forward over an occupancy grid (``entry``, ``__graft_entry__.py:5``);
:func:`dryrun_multichip` runs, on ``n`` ranks, two occupancy train steps on
a (n/2, 2) data x model mesh (``n >= 4`` and even; else data parallel
alone), a checkpoint round trip whose next step must give the live step's
loss within 1e-6, and one data-parallel proposal step, and prints JAX's
line (``dryrun_multichip``, ``:56-247``).  Run it as

    python -m nerfacc_tpu_torch.parallel.dryrun --n 4 [--device cpu]

The rank bodies that the CPU tests and ``chip_smoke.py`` share live here
too (:func:`run_cases`): each takes numpy inputs, builds its trainer on its
rank's device, runs its steps through ``make_dp_train_step``,
``make_dp_prop_step`` or ``make_tp_train_step``, and returns numpy
results, with the kernel launches a step on the card.
"""
from __future__ import annotations

import argparse
import importlib
import os
import shutil
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import cuda
from ..data.device_sampler import DeviceRaySampler
from ..data.procedural import ProceduralSceneLoader
from ..estimators.occ_grid import init_occ_grid, sampling
from ..models.cp_field import CPDensityField, CPRadianceField
from ..trainers.ngp_occ import NGPOccTrainer, TrainState
from ..trainers.ngp_prop import NGPPropTrainer, PropTrainState
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.jax_bridge import occ_train_state_from_numpy, prop_params_from_numpy
from ..utils.rendering import compact_samples, render_rays_with_occgrid
from .launch import RankInfo, spawn
from .mesh import Mesh, barrier, make_dp_prop_step, make_dp_train_step, make_mesh, shard_batch
from .tp import (
    copy_state,
    gather_state,
    gather_tensor,
    make_mesh_2d,
    make_tp_field,
    make_tp_train_step,
    permute_w1,
    shard_state,
    tp_w1_permutation,
)

AABB = (-1.5, -1.5, -1.5, 1.5, 1.5, 1.5)
# the JAX dry run's fields: CP (16, 64) x (8, 8), a one-level proposal field
DRY_FIELD = dict(aabb=AABB, resolutions=(16, 64), ranks=(8, 8))
DRY_PROP = dict(aabb=AABB, resolutions=(16,), ranks=(8,), hidden_dim=16)


def entry(device="cuda"):
    """``(fn, args)``: the CP radiance field (16, 64) x (8, 8) rendering 256
    rays through the occupancy grid (32^3, every cell occupied) at step 2e-2,
    packed into 4096 samples, composited: ``fn(params, rays_o, rays_d)`` ->
    (256, 3) colours.  On the card unless ``device`` says otherwise."""
    dev = torch.device(device)
    field = CPRadianceField(**DRY_FIELD).to(dev)
    field.init(torch.Generator().manual_seed(0))
    params = {k: v.detach() for k, v in field.state_dict().items()}
    occ = init_occ_grid(AABB, 32, 1, device=dev)
    occ.binaries = torch.ones_like(occ.binaries)
    rng = np.random.default_rng(1)
    rays_o = rng.normal(size=(256, 3)).astype(np.float32) * 0.1 + np.float32([3, 0, 0])
    rays_d = -rays_o / np.linalg.norm(rays_o, axis=-1, keepdims=True)
    rays_o, rays_d = (torch.tensor(a, device=dev) for a in (rays_o, rays_d))

    def forward(params, rays_o, rays_d):
        samples = compact_samples(
            sampling(occ, rays_o, rays_d, render_step_size=2e-2, max_samples=256), 4096
        )

        def rgb_sigma_fn(positions, dirs, _ray_indices):
            rgb, density = torch.func.functional_call(field, params, (positions, dirs))
            return rgb, density[..., 0]

        return render_rays_with_occgrid(
            rgb_sigma_fn, rays_o, rays_d, samples, torch.ones(3, device=dev)
        )[0]

    return forward, (params, rays_o, rays_d)


# -- the rank bodies ---------------------------------------------------------


def _mesh(info: RankInfo, shape) -> Mesh:
    """A 1-D mesh (``shape`` None) or a (n_data, n_model) one."""
    if shape is None:
        return make_mesh(info.world_size, info.rank, info.init_method, info.backend,
                         info.device)
    return make_mesh_2d(*shape, info.rank, info.init_method, info.backend, info.device)


def _singleton(mesh: Mesh) -> Mesh:
    """``mesh`` with each rank alone in its data group: a group of one, in
    which every collective is real and must change no bit.  Every rank
    creates every rank's group, in order."""
    groups = [dist.new_group([r]) for r in range(mesh.world_size)]
    return Mesh(mesh.group, mesh.rank, mesh.world_size, mesh.device, mesh.backend,
                groups[mesh.rank], 0, 1)


def _launches() -> Dict[str, int]:
    """The kernels launched since the counts were last reset."""
    return {k: v for k, v in cuda.LAUNCHES.items() if v}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _with_plain(swaps: Optional[Dict], fn):
    """``fn()`` with the kernels of ``swaps`` (``{kernel: [(module, attr,
    plain module, plain attr), ...]}``, modules under this package) on their
    plain versions, each restored after."""
    saved = []
    try:
        for entries in (swaps or {}).values():
            for mod, attr, plain_mod, plain_attr in entries:
                module = importlib.import_module(f"nerfacc_tpu_torch.{mod}")
                if hasattr(module, attr):
                    saved.append((module, attr, getattr(module, attr)))
                    plain = importlib.import_module(f"nerfacc_tpu_torch.{plain_mod}")
                    setattr(module, attr, getattr(plain, plain_attr))
        return fn()
    finally:
        for module, attr, value in reversed(saved):
            setattr(module, attr, value)


def _occ_trainer(spec: Dict, device) -> NGPOccTrainer:
    return NGPOccTrainer(field=CPRadianceField(**spec["field"]), aabb=spec["field"]["aabb"],
                         device=device, **spec["trainer"])


def _whole_occ_state(trainer: NGPOccTrainer, spec: Dict, device) -> TrainState:
    """The whole starting state: JAX's (numpy: parameters, grid, and
    optionally Adam's ``(count, mu, nu)`` and the step) when the spec has
    it, else the trainer's own draw."""
    if spec.get("params") is None:
        return trainer.init_state()
    return occ_train_state_from_numpy(trainer, spec["params"], spec["occ"], spec.get("adam"),
                                      spec.get("step", 0), device=device)


def _batches(spec: Dict, device, loaders: Dict):
    """``(global batch, sampler)``: the spec's numpy batch, or a
    :class:`DeviceRaySampler` of its ``num_rays`` over its procedural scene
    (rendered once a group of cases: ``loaders`` keeps each scene)."""
    if "scene" in spec:
        scene = dict(spec["scene"])
        num_rays = scene.pop("num_rays")
        key = tuple(sorted(scene.items()))
        if key not in loaders:
            loaders[key] = ProceduralSceneLoader(device=device, num_rays=num_rays, **scene)
        return None, DeviceRaySampler.from_loader(loaders[key], num_rays=num_rays)
    return {k: torch.tensor(v, device=device) for k, v in spec["batch"].items()}, None


def _occ_steps(trainer, state, steps, batch, sampler, mesh=None, step=None, cells=None,
               record=None):
    """``steps`` steps, single-process on the global ``batch`` (``mesh``
    None) or through ``step`` (a ``make_dp_train_step`` /
    ``make_tp_train_step`` step) on this rank's block; with a ``sampler``
    every step draws its global batch (``train_steps_sampled``).  ``cells``:
    the first step's cell jitter.  ``record``, a list, gets each step's
    whole gradients.  Returns the state, each step's aux and the last
    step's gradients."""
    auxs = []
    group = None if mesh is None else mesh.data_group
    for i in range(steps):
        kw = {"cell_jitter": cells} if i == 0 and cells is not None else {}
        if sampler is not None:
            state, aux = trainer.train_steps_sampled(state, sampler, 1, group=group)
            aux = {k: v[0] for k, v in aux.items()}
        elif mesh is None:
            state, aux = trainer.train_step(state, batch, **kw)
        else:
            state, aux = step(state, shard_batch(batch, mesh), **kw)
        auxs.append(aux)
        if record is not None:
            record.append({k: p.grad.clone() if mesh is None else
                           gather_tensor(k, p.grad, mesh).clone()
                           for k, p in state.params.items()})
    return state, auxs, {k: p.grad for k, p in state.params.items()}


def _snap(state, auxs, grads, record=None) -> Dict:
    return {
        "step_grads": record or [],
        "params": {k: v.detach().clone() for k, v in state.params.items()},
        "grads": {k: g.clone() for k, g in grads.items()},
        "occs": state.occ_state.occs.clone(),
        "binaries": state.occ_state.binaries.clone(),
        "aux": [{k: torch.as_tensor(v).cpu() for k, v in a.items()} for a in auxs],
        "step": int(state.step),
    }


def _collectives_ms(mesh: Mesh, n_floats: int, reps: int = 20) -> float:
    """Milliseconds of one step's collectives timed alone: the gradient
    buffer's f32 all-reduce, the 3-entry f64 and 5-entry int64 ones."""
    bufs = [torch.zeros(n_floats, device=mesh.device),
            torch.zeros(3, dtype=torch.float64, device=mesh.device),
            torch.zeros(5, dtype=torch.int64, device=mesh.device)]
    for buf in bufs:
        dist.all_reduce(buf, group=mesh.data_group)
    _sync(mesh.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        for buf in bufs:
            dist.all_reduce(buf, group=mesh.data_group)
    _sync(mesh.device)
    return (time.perf_counter() - t0) * 1e3 / reps


def case_occ(mesh: Mesh, spec: Dict, loaders: Dict) -> Dict:
    """Data-parallel occupancy steps (``make_dp_train_step``).

    Spec: ``field`` (CPRadianceField arguments), ``trainer``
    (NGPOccTrainer's), ``params`` / ``occ`` (JAX's, numpy) or neither,
    ``batch`` (a global numpy batch, every step) or ``scene``
    (ProceduralSceneLoader arguments: a drawn global batch a step),
    ``steps``, and optionally ``cell_jitter`` (step 0's refresh), ``group``
    ("self": each rank alone, a group of one), ``single`` (data rank 0 also
    runs the single-process steps on the global batch from the same
    state), ``record_grads`` (each step's gradients kept), ``timed``
    (ms/step, with ``single`` the single-process run's too, the other ranks
    waiting, and the collectives' ms), ``plain_swaps``
    (one more step through the kernels and one through these kernels' plain
    versions, from one state).
    Returns ``dp`` (and ``single``) snapshots and the DP steps' launches."""
    if spec.get("group") == "self":
        mesh = _singleton(mesh)
    dev = mesh.device
    trainer = _occ_trainer(spec, dev)
    state = _whole_occ_state(trainer, spec, dev)
    batch, sampler = _batches(spec, dev, loaders)
    cells = spec.get("cell_jitter")
    cells = None if cells is None else torch.tensor(cells, device=dev)
    out = {}
    records = ([], []) if spec.get("record_grads") else (None, None)
    if spec.get("single") and mesh.data_rank == 0:
        _sync(dev)
        t0 = time.perf_counter()
        out["single"] = _snap(*_occ_steps(trainer, copy_state(state, trainer), spec["steps"],
                                          batch, sampler, cells=cells, record=records[0]),
                              records[0])
        _sync(dev)
        out["single_ms_step"] = (time.perf_counter() - t0) * 1e3 / spec["steps"]
    step = make_dp_train_step(trainer, mesh)
    barrier(mesh)  # the single-process run above is not the other ranks' time
    cuda.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    state, auxs, grads = _occ_steps(trainer, state, spec["steps"], batch, sampler, mesh, step,
                                    cells, records[1])
    _sync(dev)
    seconds = time.perf_counter() - t0
    out["launches"] = _launches()
    out["dp"] = _snap(state, auxs, grads, records[1])
    if spec.get("timed"):
        out["ms_step"] = seconds * 1e3 / spec["steps"]
        n = sum(p.numel() for p in state.params.values()) + 2
        out["collectives_ms"] = _collectives_ms(mesh, n)
    if spec.get("plain_swaps"):
        kernel_state, plain_state = copy_state(state, trainer), copy_state(state, trainer)
        _, ak, gk = _occ_steps(trainer, kernel_state, 1, batch, sampler, mesh, step)
        _, ap, gp = _with_plain(spec["plain_swaps"], lambda: _occ_steps(
            trainer, plain_state, 1, batch, sampler, mesh, step))
        out["plain"] = {"loss": float(ak[0]["loss"]), "plain_loss": float(ap[0]["loss"]),
                        "fro": {k: float((gk[k] - gp[k]).norm() / gp[k].norm().clamp_min(1e-30))
                                for k in gk}}
    return out


def case_prop(mesh: Mesh, spec: Dict, loaders: Dict) -> Dict:
    """One data-parallel proposal step with ``requires_grad``
    (``make_dp_prop_step``).  Spec: ``field`` and ``prop`` (CPRadianceField
    and CPDensityField arguments), ``trainer`` (NGPPropTrainer's),
    ``params`` (JAX's ``{"field", "props"}`` tree, numpy) or None,
    ``batch`` or ``scene``, and optionally ``single`` as :func:`case_occ`.
    Returns ``dp`` (and ``single``): aux, gradients, parameters; and the
    DP step's launches."""
    dev = mesh.device
    trainer = NGPPropTrainer(field=CPRadianceField(**spec["field"]),
                             prop_fields=[CPDensityField(**spec["prop"])], device=dev,
                             **spec["trainer"])

    def start():
        state = trainer.init_state()
        if spec.get("params") is None:
            return state
        params = prop_params_from_numpy(spec["params"], dev)
        for p in NGPPropTrainer.leaves(params):
            p.requires_grad_(True)
        return PropTrainState(params, trainer.init_optimizer(params), 0)

    batch, sampler = _batches(spec, dev, loaders)

    def one(state, step):
        if sampler is not None:
            group = None if step is None else mesh.data_group
            state, aux = trainer.train_steps_sampled(state, sampler, [True], group=group)
            aux = {k: v[0] for k, v in aux.items()}
        elif step is None:
            state, aux = trainer.train_step(state, batch, True)
        else:
            state, aux = step(state, shard_batch(batch, mesh), True)
        leaves = NGPPropTrainer.leaves(state.params)
        return {"aux": {k: v.cpu() for k, v in aux.items()},
                "grads": [p.grad.clone() for p in leaves],
                "params": [p.detach().clone() for p in leaves]}

    out = {}
    if spec.get("single") and mesh.data_rank == 0:
        out["single"] = one(start(), None)
    cuda.reset_launches()
    out["dp"] = one(start(), make_dp_prop_step(trainer, mesh))
    out["launches"] = _launches()
    return out


def case_tp(mesh: Mesh, spec: Dict, loaders: Dict) -> Dict:
    """Data x model parallel occupancy steps (``make_tp_train_step``) on a
    2-D mesh, from a whole state (JAX's, numpy, or the whole field's own
    draw) with W1 permuted into shard-major order; then ``gather_state``
    and the checkpoint round trip (save from rank 0 in the gathered layout,
    load, ``shard_state``, one step from the live and one from the restored
    state).  Spec as :func:`case_occ` (``steps``, ``batch`` or ``scene``,
    ``cell_jitter``, ``single`` on rank 0, ``record_grads``; ``permuted``:
    the whole state's W1 is in shard-major order already).  Returns the
    local shapes of
    the parameters and their Adam moments, each step's aux, the gathered
    state (rank 0), the round trip's two losses, and the TP steps' launches."""
    dev = mesh.device
    whole_trainer = _occ_trainer(spec, dev)
    whole = _whole_occ_state(whole_trainer, spec, dev)
    batch, sampler = _batches(spec, dev, loaders)
    cells = spec.get("cell_jitter")
    cells = None if cells is None else torch.tensor(cells, device=dev)
    out = {}
    records = ([], []) if spec.get("record_grads") else (None, None)
    if spec.get("single") and mesh.rank == 0:
        out["single"] = _snap(*_occ_steps(whole_trainer, copy_state(whole, whole_trainer),
                                          spec["steps"], batch, sampler, cells=cells,
                                          record=records[0]), records[0])
    perm = tp_w1_permutation(whole_trainer.field.encoder.ranks, mesh.n_model)
    if not spec.get("permuted"):
        whole = whole._replace(params=permute_w1(whole.params, perm))
    trainer = NGPOccTrainer(field=make_tp_field(whole_trainer.field, mesh),
                            aabb=spec["field"]["aabb"], device=dev, **spec["trainer"])
    step, shard, _ = make_tp_train_step(trainer, mesh)
    state = shard(whole)
    # the sharded field draws the whole field's parameters and keeps its part
    init = whole_trainer.init_state()
    drawn = shard(init._replace(params=permute_w1(init.params, perm)))
    out["init_equal"] = all(torch.equal(trainer.init_state().params[k], v)
                            for k, v in drawn.params.items())
    cuda.reset_launches()
    state, auxs, grads = _occ_steps(trainer, state, spec["steps"], batch, sampler, mesh, step,
                                    cells, records[1])
    out["launches"] = _launches()
    adam = state.opt_state.optimizer
    out["shapes"] = {k: [tuple(p.shape)] + [tuple(adam.state[p][m].shape)
                                           for m in ("exp_avg", "exp_avg_sq")]
                     for k, p in state.params.items()}
    out["aux"] = [{k: torch.as_tensor(v).cpu() for k, v in a.items()} for a in auxs]
    gathered = gather_state(state, trainer, mesh)
    if mesh.rank == 0:
        out["gathered"] = _snap(gathered, auxs, {}, records[1])
        out["perm"] = perm
    out["roundtrip"] = _roundtrip(trainer, state, mesh, step, batch, sampler)
    return out


def _roundtrip(trainer, state, mesh: Mesh, step, batch, sampler):
    """(live loss, restored loss): the state saved from rank 0 (gathered
    when model-sharded), loaded and re-sharded, then one step from each."""
    path = [tempfile.mkdtemp() if mesh.rank == 0 else None]
    dist.broadcast_object_list(path, src=0, group=mesh.group)
    ckpt = os.path.join(path[0], "ckpt.pt")
    try:
        save_checkpoint(ckpt, state, trainer=trainer, mesh=mesh)
        like = gather_state(state, trainer, mesh)
        restored = shard_state(load_checkpoint(ckpt, like, device=mesh.device), trainer, mesh)
        losses = []
        for s in (state, restored):
            _, auxs, _ = _occ_steps(trainer, s, 1, batch, sampler, mesh, step)
            losses.append(float(auxs[0]["loss"]))
    finally:
        barrier(mesh)
        if mesh.rank == 0:
            shutil.rmtree(path[0], ignore_errors=True)
    return losses


def case_dryrun(info: RankInfo, n: int) -> Dict:
    """The dry run's body on this rank (see the module docstring); returns
    its line (printed by rank 0), the losses and the two occupancy steps'
    launches."""
    if info.world_size != n:
        raise ValueError(f"the dry run of {n} ranks runs on {info.world_size}")
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    n_data = n // n_model
    mesh = _mesh(info, (n_data, n_model) if n_model > 1 else None)
    dev = mesh.device
    field = CPRadianceField(**DRY_FIELD)
    trainer_kw = dict(grid_resolution=32, render_step_size=2e-2, sample_budget=2048,
                      warmup_steps=4, update_interval=2)
    whole_trainer = NGPOccTrainer(field=field, aabb=AABB, device=dev, **trainer_kw)
    state = whole_trainer.init_state()
    n_rays = 16 * n_data
    rng = np.random.default_rng(0)
    rays_o = rng.normal(size=(n_rays, 3)).astype(np.float32) * 0.1 + np.float32([3, 0, 0])
    raw = {"rays_o": rays_o, "rays_d": -rays_o / np.linalg.norm(rays_o, axis=-1, keepdims=True),
           "rgb": np.full((n_rays, 3), 0.5, np.float32), "color_bkgd": np.ones(3, np.float32)}
    raw = {k: torch.tensor(v, device=dev) for k, v in raw.items()}
    if n_model > 1:
        perm = tp_w1_permutation(DRY_FIELD["ranks"], n_model)
        state = state._replace(params=permute_w1(state.params, perm))
        trainer = NGPOccTrainer(field=make_tp_field(field, mesh), aabb=AABB, device=dev,
                                **trainer_kw)
        step_fn, shard, shard_tp_batch = make_tp_train_step(trainer, mesh)
        state, batch = shard(state), shard_tp_batch(raw)
    else:
        trainer = whole_trainer
        step_fn, batch = make_dp_train_step(trainer, mesh), shard_batch(raw, mesh)
    cuda.reset_launches()
    state, aux = step_fn(state, batch)
    state, aux = step_fn(state, batch)  # the second step updates the grid
    launches = _launches()
    loss = float(aux["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"dry run: loss {loss}")
    live, restored = _roundtrip(trainer, state, mesh, step_fn, raw, None)
    if not (np.isfinite(restored) and abs(restored - live) < 1e-6):
        raise RuntimeError(f"dry run: the step after the restore gave {restored}, live {live}")

    prop_mesh = make_mesh(n, info.rank, info.init_method, info.backend, info.device)
    prop = NGPPropTrainer(field=CPRadianceField(**DRY_FIELD),
                          prop_fields=[CPDensityField(**DRY_PROP)], prop_samples=[32],
                          num_samples=16, near_plane=2.0, far_plane=6.0,
                          sampling_type="uniform", stratified=False, device=dev)
    prop_state, prop_aux = make_dp_prop_step(prop, prop_mesh)(
        prop.init_state(), shard_batch(raw, prop_mesh), True)
    prop_loss = float(prop_aux["loss"])
    if not np.isfinite(prop_loss):
        raise RuntimeError(f"dry run: proposal loss {prop_loss}")
    line = (f"dryrun_multichip({n}): ok (occ mesh data={n_data} x model={n_model}, "
            f"prop DP x{n}, ckpt-roundtrip=ok), loss={loss:.4f}, "
            f"prop_loss={prop_loss:.4f}, samples={int(aux['n_rendering_samples'])}")
    if info.rank == 0:
        print(line, flush=True)
    return {"line": line, "loss": loss, "prop_loss": prop_loss, "live": live,
            "restored": restored, "launches": launches}


def run_cases(info: RankInfo, shape, cases) -> Dict:
    """One rank of a group that runs ``cases`` in order: ``shape`` None for
    a 1-D data-parallel mesh or (n_data, n_model); each case a (name, kind,
    spec) with kind "occ" (:func:`case_occ`), "prop" (:func:`case_prop`),
    "tp" (:func:`case_tp`) or "dryrun" (:func:`case_dryrun`, spec ``n``).
    Returns ``{name: result}``."""
    mesh = _mesh(info, shape)
    out, loaders = {}, {}
    for name, kind, spec in cases:
        if kind == "dryrun":
            out[name] = case_dryrun(info, spec)
            continue
        fn = {"occ": case_occ, "prop": case_prop, "tp": case_tp}[kind]
        out[name] = fn(mesh, spec, loaders)
    return out


def dryrun_rank(info: RankInfo, n: int) -> Dict:
    return case_dryrun(info, n)


def dryrun_multichip(n: int, backend: Optional[str] = None, device=None,
                     timeout: float = 600.0) -> List[Dict]:
    """The dry run on ``n`` new ranks (see the module docstring): returns
    each rank's result (rank 0 prints its ``line``); raises if any rank
    fails.  ``backend`` / ``device`` as ``make_mesh``'s: ranks that share a
    card need ``backend="gloo"``."""
    return spawn(n, dryrun_rank, n, backend=backend, device=device, timeout=timeout)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="The distributed layer's dry run.")
    ap.add_argument("--n", type=int, default=4, help="ranks")
    ap.add_argument("--device", default=None,
                    help="'cpu', or a card for every rank (default: cuda:(rank %% cards))")
    ap.add_argument("--backend", default=None,
                    help="'gloo' or 'nccl' (default: NCCL on the card, gloo on the CPU)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.device or "cuda")
    print("entry ok:", tuple(fn(*fargs).shape), flush=True)
    # under ``python -m`` this module is __main__: the ranks import it by name
    from nerfacc_tpu_torch.parallel.dryrun import dryrun_multichip as run

    run(args.n, args.backend, args.device)


if __name__ == "__main__":
    main()
