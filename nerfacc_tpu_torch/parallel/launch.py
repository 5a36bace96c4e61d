"""Start a group of ranks on this machine and collect their results.

:func:`spawn` picks a free port for the process group's ``init_method``,
starts ``world_size`` processes with the ``spawn`` start method, runs
``fn(info, *args)`` in each (``info`` a :class:`RankInfo`: rank, world
size, ``init_method``, backend and device, which ``fn`` hands to
``make_mesh`` / ``make_mesh_2d``), and returns each rank's result with
every tensor turned into a numpy array.  It fails, and stops every rank,
when a rank raises, exits without a result or outlives the timeout: no
hang and no rank's failure passes unseen.
"""
from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Union

import torch


class RankInfo(NamedTuple):
    rank: int
    world_size: int
    init_method: str
    backend: Optional[str]
    device: Optional[str]


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_numpy(tree: Any) -> Any:
    """``tree`` with every tensor as a numpy array (dicts, lists, tuples
    walked; other leaves as they are)."""
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return tree


def _run_rank(info: RankInfo, fn: Callable, args, results) -> None:
    try:
        if info.device == "cpu":
            # ranks share the machine's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * info.world_size)))
        out = to_numpy(fn(info, *args))
        results.put((info.rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((info.rank, False, traceback.format_exc()))
        raise SystemExit(1)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(
    world_size: int,
    fn: Callable,
    *args,
    backend: Optional[str] = None,
    device: Union[None, str, torch.device] = None,
    timeout: float = 120.0,
) -> List[Any]:
    """Run ``fn(RankInfo, *args)`` in ``world_size`` new processes; return
    their results in rank order, tensors as numpy arrays.

    Args:
        fn: a function of this package (a child imports it by its module
            path; it must not pull a test module, or JAX, into the ranks).
        backend / device: handed to every rank in its ``RankInfo`` (None:
            ``make_mesh``'s defaults, NCCL on the card).
        timeout: seconds for the whole group.

    On the card the kernel library is built here, once, before the ranks
    start.

    Raises:
        ValueError: ``fn`` lives outside this package.
        RuntimeError: a rank raised or exited without a result (its
            traceback is in the message); the other ranks are stopped.
        TimeoutError: the group outlived ``timeout``; every rank is stopped.
    """
    module = getattr(fn, "__module__", "") or ""
    if not module.startswith("nerfacc_tpu_torch."):
        raise ValueError(f"spawn runs functions of nerfacc_tpu_torch, not {module}.{fn.__name__}")
    device = None if device is None else str(device)
    if device != "cpu" and torch.cuda.is_available():
        from ..cuda import _build

        _build.build()
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [
        ctx.Process(target=_run_rank, daemon=True,
                    args=(RankInfo(r, world_size, init_method, backend, device), fn, args, results))
        for r in range(world_size)
    ]
    for p in procs:
        p.start()
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world_size:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in out]
                if dead:
                    # a rank's last result may still be in the pipe
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                            "and no result"
                        ) from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of {module}.{fn.__name__} outlived "
                        f"{timeout:.0f} s; ranks {sorted(set(range(world_size)) - set(out))} "
                        "had not finished"
                    )
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {module}.{fn.__name__} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        bad = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RuntimeError(f"ranks exited with (rank, code) {bad}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(world_size)]
