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

Gradients (training, ``train.py``).  Every rank computes the loss from
the same replicated values, as GSPMD's programs do, so a replicated
value's gradient is the same on every rank of its axis.  On a tensor
that requires a gradient (under ``torch.is_grad_enabled()``) the ops
are ``torch.autograd.Function``s whose backward keeps that invariant:
the sum ``all_reduce`` passes its gradient through unchanged (every
summand gets the sum's gradient), ``all_gather`` keeps this rank's
slice of it, ``ppermute`` shifts it back the other way round the ring,
and ``copy_to`` (the identity forward) all-reduces it over the axis:
it marks where a replicated value enters work that each rank does on
its own share (column-parallel products, a pipeline's first stage), so
that the partial gradients of the shares add up.  Everywhere else (the
inference paths, ``torch.no_grad``) the ops issue exactly the calls
they issue without autograd, and ``copy_to`` issues none.
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


def _grad_path(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x.clone(), mesh, axis, "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.dim, ctx.n, ctx.i = dim, mesh.size(axis), mesh.index(axis)
        return _all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.i], None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _ppermute(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.mesh, ctx.axis, "sum"), None, None


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """The sum (``op="max"``: the maximum) of ``x`` over ``axis``'s ranks
    (a new tensor, or ``x`` reduced in place when it is contiguous and
    not staged).  On the gradient path (a sum only): a new tensor, whose
    gradient passes to ``x`` unchanged."""
    if mesh.size(axis) == 1:
        return x
    if op == "sum" and _grad_path(x):
        return _AllReduceSum.apply(x, mesh, axis)
    return _all_reduce(x, mesh, axis, op)


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str, op: str) -> torch.Tensor:
    staged = _staged(mesh, x)
    buf = x.cpu() if staged else x.contiguous()
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group(axis))
    _count(all_reduce, staged)
    return buf.to(x.device) if staged else buf


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """``axis``'s ranks' ``x`` concatenated along ``dim`` in rank order
    (every rank's ``x`` has the same shape).  On the gradient path ``x``
    gets this rank's slice of the result's gradient."""
    if mesh.size(axis) == 1:
        return x
    if _grad_path(x):
        return _AllGather.apply(x, mesh, axis, dim)
    return _all_gather(x, mesh, axis, dim)


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    n = mesh.size(axis)
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
    (j + 1) % n)]``), as one batch of isend / irecv.  On the gradient
    path the gradient takes the reverse shift (``i`` sends to ``i - 1``)."""
    if mesh.size(axis) == 1:
        return x
    if _grad_path(x):
        return _Ppermute.apply(x, mesh, axis, 1)
    return _ppermute(x, mesh, axis, 1)


def _ppermute(x: torch.Tensor, mesh: Mesh, axis: str, shift: int) -> torch.Tensor:
    n = mesh.size(axis)
    group = mesh.group(axis)
    ranks = dist.get_process_group_ranks(group)
    i = mesh.index(axis)
    staged = _staged(mesh, x)
    src = x.cpu() if staged else x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, ranks[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, ranks[(i - shift) % n], group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _count(ppermute, staged)
    return out.to(x.device) if staged else out


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` itself, for work that each rank of ``axis`` does on its own
    share of a replicated ``x``: on the gradient path the gradient that
    reaches ``x`` is all-reduced (summed) over ``axis``.  Issues nothing
    off the gradient path or on an axis of size 1."""
    if mesh.size(axis) == 1 or not _grad_path(x):
        return x
    return _CopyTo.apply(x, mesh, axis)


def counts() -> dict[str, dict[str, int]]:
    """``{op: {"calls": n, "staged": m}}`` of this process."""
    return {fn.__name__: {"calls": fn.calls, "staged": fn.staged}
            for fn in (all_reduce, all_gather, ppermute)}


def reset_counts() -> None:
    for fn in (all_reduce, all_gather, ppermute):
        fn.calls = fn.staged = 0


reset_counts()
