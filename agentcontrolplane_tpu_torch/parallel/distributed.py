"""The distributed runtime: one ``torch.distributed`` process per rank.

The counterpart of ``agentcontrolplane_tpu/parallel/distributed.py``. The
JAX package forms one global device set with ``jax.distributed`` and lets
XLA insert the collectives; the port runs one process per rank, each with
its own device, and issues the collectives itself (``parallel/mesh.py``).

- :func:`init_distributed` joins the process group with an explicit
  backend: ``nccl`` when every rank has a card of its own, ``gloo`` when
  ranks share one card (NCCL refuses two ranks on one device) or run on
  the CPU. Nothing here reads a cluster from the environment.
- :func:`run_ranks` starts ``world_size`` ranks on this machine with the
  ``spawn`` start method (forking a process that has initialised CUDA
  breaks), a ``file://`` rendezvous in a fresh temporary directory (no port
  to collide with), and a hard timeout: when it expires, or any rank fails,
  every child is killed and the call raises.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

_STATE: dict = {}  # this process's rank, world size, backend and device


def default_backend(world_size: int, device: str = "cuda") -> str:
    """``nccl`` when each of ``world_size`` ranks can have a card of its
    own, else ``gloo`` (ranks sharing one card, or the CPU)."""
    if device == "cuda" and torch.cuda.is_available() and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(rank: int, world_size: int, device: str = "cuda") -> torch.device:
    """The rank's device: ``cuda:{rank}`` when the machine has a card per
    rank, ``cuda:0`` shared otherwise, or the CPU."""
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run ranks on the CPU")
    n = torch.cuda.device_count()
    return torch.device("cuda", rank if n >= world_size else 0)


def init_distributed(
    rank: int,
    world_size: int,
    init_method: str,
    backend: str,
    device: str = "cuda",
    timeout_s: float = 600.0,
) -> dict:
    """Join the process group as ``rank`` of ``world_size`` and pin this
    process to its device. ``backend`` is explicit (``gloo`` or ``nccl``);
    ``timeout_s`` bounds every collective, so a lost rank ends the others'
    waits with an error instead of a hang. Returns :func:`runtime_info`."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be gloo or nccl, not {backend!r}")
    dev = rank_device(rank, world_size, device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs a CUDA device per rank")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=timedelta(seconds=timeout_s),
    )
    _STATE.update(rank=rank, world_size=world_size, backend=backend, device=dev)
    return runtime_info()


def is_primary() -> bool:
    """True on rank 0 (or outside any process group): the rank that runs
    singleton work such as the HTTP front door."""
    return _STATE.get("rank", 0) == 0


def runtime_info() -> dict:
    """This process's place in the run."""
    dev = _STATE.get("device", torch.device("cpu"))
    return {
        "rank": _STATE.get("rank", 0),
        "world_size": _STATE.get("world_size", 1),
        "backend": _STATE.get("backend"),
        "device": str(dev),
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "cuda_devices": torch.cuda.device_count() if torch.cuda.is_available() else 0,
    }


def _rank_main(fn, rank, world_size, init_method, backend, device, args, results) -> None:
    """A child: join the group, run ``fn(*args)``, report to the parent.
    The result is pickled here, whole: put on the queue as it is, a tensor
    in it would travel as a shared-memory handle that this process must
    stay alive to serve, and a rank that exits first resets the parent's
    connection."""
    try:
        init_distributed(rank, world_size, init_method, backend, device)
        results.put((rank, True, pickle.dumps(fn(*args))))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(
    fn: Callable[..., Any],
    world_size: int,
    args: tuple = (),
    timeout_s: Optional[float] = 120.0,
    backend: Optional[str] = None,
    device: str = "cuda",
) -> list:
    """Run ``fn(*args)`` in ``world_size`` spawned ranks of one process
    group on this machine and return their results, by rank.

    ``fn`` must be importable by name (spawn re-imports its module in every
    child) and its result picklable; inside, :func:`runtime_info` says which
    rank it is. ``backend`` defaults to :func:`default_backend`. The
    children are joined against one deadline of ``timeout_s`` seconds (None
    waits as long as the ranks run, for a server): when it passes, or when
    a rank raises or dies, every child is killed and this raises
    ``RuntimeError`` with what the ranks reported."""
    backend = backend or default_backend(world_size, device)
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="acp_ranks_")
    init_method = f"file://{os.path.join(tmp, 'rendezvous')}"
    results = ctx.Queue()
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(fn, r, world_size, init_method, backend, device, args, results),
            name=f"acp-rank-{r}", daemon=True,
        )
        for r in range(world_size)
    ]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    done: dict[int, Any] = {}
    failure = None
    try:
        for p in procs:
            p.start()
        while len(done) < world_size and failure is None:
            if deadline is not None and time.monotonic() > deadline:
                failure = f"timed out after {timeout_s} s with ranks {sorted(done)} done"
                break
            try:
                rank, ok, out = results.get(timeout=0.2)
            except queue.Empty:
                silent = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
                if not silent:
                    continue
                try:  # a report sent just before exiting may still be in flight
                    rank, ok, out = results.get(timeout=2.0)
                except queue.Empty:
                    codes = {r: procs[r].exitcode for r in silent}
                    failure = f"ranks exited without a report (exit codes {codes})"
                    break
            if ok:
                done[rank] = pickle.loads(out)
            else:
                failure = f"rank {rank} failed:\n{out}"
    finally:
        if failure is not None or len(done) < world_size:  # failed, or interrupted
            for p in procs:
                if p.is_alive():
                    p.kill()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failure is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__name__', fn)}): {failure}")
    return [done[r] for r in range(world_size)]
