"""Spawn a group of ranks on this host and collect what each returns.

``run_ranks(fn, world, *args)`` starts ``world`` processes with the
``spawn`` method, each joining one process group over
``tcp://localhost:<free port>``, pinned to one intra-op thread, and
calls ``fn(rank, *args)`` in each; it returns the ranks' return
values in rank order, or raises with the traceback of the first rank
that failed.  A spawned child imports ``fn``'s module afresh, so ``fn``
lives in a module that imports only what a rank needs.

Return values travel pickled: numpy arrays and Python objects, not
tensors (a tensor sent through a queue shares memory with a process that
is about to exit).  The arguments are Python objects, numpy arrays and
CPU tensors, in dicts, lists and tuples: the tensors are shared with the
children through shared memory while the parent waits.  A CUDA tensor
among them raises (it would travel as a CUDA IPC handle to the parent's
card): move it to the CPU first, and let each rank place its own share.
"""

from __future__ import annotations

import queue
import socket
import traceback
from typing import Any, Callable

# a rank that has not answered after this long is taken as hung
DEFAULT_TIMEOUT_S = 1800.0


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable, rank: int, world: int, port: int, backend: str, out: Any,
               args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank)
        try:
            out.put((rank, True, fn(rank, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))
        raise


def _check_host_args(x: Any, where: str = "args") -> None:
    """Raise on a tensor off the CPU anywhere in ``x`` (dicts, lists,
    tuples)."""
    import torch

    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"run_ranks: {where} is a {x.device} tensor; the ranks take CPU "
                             "tensors (move it to the CPU and let each rank place its share)")
    elif isinstance(x, dict):
        for k, v in x.items():
            _check_host_args(v, f"{where}[{k!r}]")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            _check_host_args(v, f"{where}[{i}]")


def run_ranks(fn: Callable, world: int, *args: Any, backend: str = "gloo",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in a spawned
    rank of a ``world``-rank process group on ``backend``."""
    import torch.multiprocessing as mp

    _check_host_args(args)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, r, world, port, backend, out, args),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, Any] = {}
    failures: dict[int, str] = {}
    waited = 0.0
    try:
        # drain the queue before joining (a writer blocks on a full pipe)
        while len(results) + len(failures) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                waited += 1.0
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode is not None and r not in results and r not in failures]
                if dead:
                    failures.update({r: f"rank {r} exited with code {procs[r].exitcode} "
                                        "before it answered" for r in dead})
                    break
                if waited > timeout_s:
                    failures[-1] = f"no answer from every rank after {timeout_s:.0f} s"
                    break
                continue
            (results if ok else failures)[rank] = value
            if not ok:
                break
    finally:
        for p in procs:
            p.join(timeout=30.0 if not failures else 5.0)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failures:
        r = min(failures)
        raise RuntimeError(f"rank {r} of {world} failed:\n{failures[r]}")
    return [results[r] for r in range(world)]
