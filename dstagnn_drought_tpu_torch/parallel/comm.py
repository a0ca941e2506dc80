"""Autograd-aware collectives of the port's partitioned regions.

In JAX, GSPMD and ``shard_map`` place the collectives of a sharded program
and derive their transposes. Here each rank's share is explicit, so every
collective is a ``torch.autograd.Function`` whose backward is its
conjugate:

  ==================  =========================  ==========================
  function            forward                    backward
  ==================  =========================  ==========================
  :func:`enter`       this rank's rows           all-gather
  :func:`leave`       all-gather                 this rank's rows
  :func:`gather_rows` all-gather                 reduce-scatter (sum)
  :func:`copy_to`     identity                   all-reduce (sum)
  :func:`reduce_from` all-reduce (sum)           identity
  :func:`exchange`    all-to-all                 all-to-all (reverse route)
  ==================  =========================  ==========================

``enter`` and ``leave`` bracket a partitioned region whose input and output
are whole and the same on every rank of the group: ``enter``'s backward
gathers the rows' gradients back into a whole, replicated gradient,
``leave``'s backward keeps the rows of this rank, since every rank computes
the same whole gradient downstream. ``gather_rows`` feeds *partitioned*
consumers (each rank reads every row for its own targets), so its rows'
gradients are summed over the group. ``copy_to``/``reduce_from`` are the
Megatron pair: a whole tensor used by every rank's share (its gradient
sums the shares), and the sum of the shares. ``torch.distributed.nn``'s
``all_reduce`` does not serve here: its backward all-reduces the gradient
again, which is the group size times too large for consumers that are
replicated.

A group of ``None`` (one rank on that axis) makes every function the
identity. Every collective runs on the tensors' own device: gloo takes each
of them on CUDA tensors as well as on the CPU (all five probed with torch
2.11 on an H100; :data:`GLOO_CUDA` names them), so nothing is staged
through host memory and no error is caught and retried another way.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# the collectives the port issues; gloo runs each on CUDA tensors itself
GLOO_CUDA = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all_single",
             "all_to_all_single(async_op=True)")


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group (a new tensor); not differentiable."""
    if group is None:
        return t
    buf = t.contiguous().clone()
    dist.all_reduce(buf, group=group)
    return buf


def all_gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order."""
    if group is None:
        return t
    src = t.contiguous()
    parts = [torch.empty_like(src) for _ in range(group_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def reduce_scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's chunk along ``dim`` of the group's sum."""
    if group is None:
        return t
    chunks = [c.contiguous() for c in t.chunk(group_size(group), dim=dim)]
    out = torch.empty_like(chunks[0])
    dist.reduce_scatter(out, chunks, group=group)
    return out


def own_rows(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's equal chunk of ``t`` along ``dim``."""
    if group is None:
        return t
    return t.chunk(group_size(group), dim=dim)[group_rank(group)].contiguous()


class Pending:
    """An all-to-all in flight (:func:`exchange_start`)."""

    def __init__(self, send: torch.Tensor, group):
        self.group = group
        self.send = send.contiguous()  # kept alive until the work is done
        self.recv = torch.empty_like(self.send)
        self.work = dist.all_to_all_single(self.recv, self.send, group=group, async_op=True)

    def wait(self) -> torch.Tensor:
        self.work.wait()
        return self.recv


def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    return Pending(t, group).wait()


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return own_rows(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return own_rows(g, ctx.dim, ctx.group), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.dim, ctx.group), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Exchange(torch.autograd.Function):
    """Forward: the received rows of a started all-to-all; backward: the
    gradient routed back by the reverse all-to-all."""

    @staticmethod
    def forward(ctx, send, pending):
        ctx.group = pending.group
        return pending.wait()

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _apply(fn, x, *args):
    group = args[-1]
    return x if group is None else fn.apply(x, *args)


def enter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's rows of a whole tensor (backward: all-gather)."""
    return _apply(_Enter, x, dim, group)


def leave(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole tensor from every rank's rows (backward: own rows)."""
    return _apply(_Leave, x, dim, group)


def gather_rows(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's rows for partitioned consumers (backward: reduce-scatter)."""
    return _apply(_GatherRows, x, dim, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """A whole tensor used by every rank's share (backward: all-reduce)."""
    return _apply(_CopyTo, x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's share (backward: identity)."""
    return _apply(_ReduceFrom, x, group)


def exchange_start(send: torch.Tensor, group) -> Pending | None:
    """Start the all-to-all of ``send`` (P, ...): ``send[r]`` goes to group
    rank r. Work that does not read the result runs until
    :func:`exchange_finish` waits on it."""
    return None if group is None else Pending(send, group)


def exchange_finish(send: torch.Tensor, pending: Pending | None) -> torch.Tensor:
    """recv (P, ...), ``recv[o]`` = what group rank o sent here; its
    backward is the reverse routing."""
    return send if pending is None else _Exchange.apply(send, pending)


def exchange(send: torch.Tensor, group) -> torch.Tensor:
    """The targeted all-to-all, started and waited on at once."""
    return exchange_finish(send, exchange_start(send, group))


def reduce_gradients(params, group) -> None:
    """Sum the gradients of ``params`` over ``group`` in one flat buffer
    (the data axis: each rank's loss is its rows' share of the global mean,
    so the sum is the gradient of the global batch)."""
    if group is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
