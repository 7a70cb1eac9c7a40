"""Collectives over one named mesh axis (the port's counterparts of the
``psum`` / ``all_gather`` / ``ppermute`` that GSPMD and ``shard_map``
insert in the JAX package).

Each op runs over ``mesh.group(axis)``; an axis of size 1 is the
identity and issues nothing.  A gloo group moves host memory: on a gloo
group a CUDA tensor is staged through the host (copied out, reduced or
exchanged, copied back), which is how several ranks share one card.  The
choice follows the group's backend (``Mesh.backend``), never a caught
error, and an op that fails raises.  NCCL groups take the CUDA tensors
as they are.

Every op counts its calls (``all_reduce.calls``, ...) and the calls it
staged (``.staged``), per process: each rank reads its own.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from llm_np_cp_tpu_torch.parallel.sharding import Mesh


def _staged(mesh: Mesh, x: torch.Tensor) -> bool:
    return x.is_cuda and mesh.backend == "gloo"


def _count(fn, staged: bool) -> None:
    fn.calls += 1
    fn.staged += int(staged)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the maximum) of ``x`` over ``axis``'s ranks
    (a new tensor, or ``x`` reduced in place when it is contiguous and
    not staged)."""
    if mesh.size(axis) == 1:
        return x
    staged = _staged(mesh, x)
    buf = x.cpu() if staged else x.contiguous()
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group(axis))
    _count(all_reduce, staged)
    return buf.to(x.device) if staged else buf


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """``axis``'s ranks' ``x`` concatenated along ``dim`` in rank order
    (every rank's ``x`` has the same shape)."""
    n = mesh.size(axis)
    if n == 1:
        return x
    staged = _staged(mesh, x)
    src = x.cpu() if staged else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=mesh.group(axis))
    _count(all_gather, staged)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The ring shift over ``axis``: index ``i`` sends ``x`` to ``i + 1``
    and returns what ``i - 1`` sent (``lax.ppermute`` with ``perm = [(j,
    (j + 1) % n)]``), as one batch of isend / irecv."""
    n = mesh.size(axis)
    if n == 1:
        return x
    group = mesh.group(axis)
    ranks = dist.get_process_group_ranks(group)
    i = mesh.index(axis)
    staged = _staged(mesh, x)
    src = x.cpu() if staged else x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(i + 1) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - 1) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _count(ppermute, staged)
    return out.to(x.device) if staged else out


def counts() -> dict[str, dict[str, int]]:
    """``{op: {"calls": n, "staged": m}}`` of this process."""
    return {fn.__name__: {"calls": fn.calls, "staged": fn.staged}
            for fn in (all_reduce, all_gather, ppermute)}


def reset_counts() -> None:
    for fn in (all_reduce, all_gather, ppermute):
        fn.calls = fn.staged = 0


reset_counts()
