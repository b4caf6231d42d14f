"""The mesh's collectives over ``torch.distributed``, counted, and their
autograd forms.

:class:`Transport` issues every collective the port's mesh code makes
(``all_reduce``, ``all_gather``, ``reduce_scatter``, ``all_to_all``) on
one axis's process group, and counts the payload bytes this rank hands to
each op.  The ranks of the one-card phase of ``chip_smoke.py`` share
``cuda:0``, where NCCL refuses two ranks of one communicator, so they talk
through gloo; :mod:`repro_torch.dist.gloo_probe` found that gloo takes
CUDA tensors for every op used here on the card's torch (2.11), so no
payload is staged through host memory.

The autograd forms come in two kinds, by what the rank's loss is across
the axis:

* the loss differs from rank to rank (tokens split over the axis, as in
  expert parallelism, or the batch over the data axes): :func:`all_gather`
  (backward: reduce-scatter of the cotangents), :func:`all_to_all`
  (backward: the inverse exchange) and :func:`all_reduce` (backward:
  all-reduce), so the gradients are those of the sum of the ranks' losses;
* the loss is the same on every rank of the axis (tensor parallelism
  over ``model``): :func:`copy_to` (forward identity, backward all-reduce)
  where a replicated value enters rank-local work, :func:`reduce_from`
  (forward all-reduce, backward identity) where partial results are
  summed, :func:`gather_from` (forward all-gather, backward this rank's
  chunk) and its inverse :func:`split_to` (forward this rank's chunk,
  backward all-gather), so every rank's gradients are the whole gradient.

The sequence-parallel pair moves the residual stream between a rank's
stretch of the sequence and the whole sequence over ``model``:
:func:`all_gather` (backward: reduce-scatter) gathers the stretches
where a layer needs the whole sequence, and :func:`reduce_scatter`
(backward: all-gather) sums the ranks' partial outputs and leaves each
rank its stretch.

``torch.distributed.nn.functional`` has the first kind only, its
``all_to_all_single`` warns that it is deprecated on torch 2.13, and it
calls ``torch.distributed`` directly, past this module's byte count; hence
these small :class:`torch.autograd.Function` s over :class:`Transport`.
"""
from __future__ import annotations

import collections
from typing import Sequence, Union

import torch
import torch.distributed as dist

__all__ = ["Transport", "copy_to", "reduce_from", "gather_from", "split_to",
           "all_gather", "reduce_scatter", "all_to_all", "all_reduce"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Transport:
    """Collectives on a process group, with the payload bytes this rank
    hands to each op counted in :attr:`bytes` (by op name) and the calls in
    :attr:`calls`.  Every op returns a new tensor and leaves its input as
    it was."""

    def __init__(self):
        self.bytes = collections.Counter()
        self.calls = collections.Counter()

    def reset(self) -> None:
        self.bytes.clear()
        self.calls.clear()

    def _count(self, op: str, x: torch.Tensor) -> None:
        self.bytes[op] += x.numel() * x.element_size()
        self.calls[op] += 1

    def all_reduce(self, x: torch.Tensor, group, op: str = "sum"
                   ) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        self._count("all_reduce", out)
        dist.all_reduce(out, op=_OPS[op], group=group)
        return out

    def all_gather(self, x: torch.Tensor, group, dim: int = 0
                   ) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order."""
        n = dist.get_world_size(group)
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + src.shape[1:])
        self._count("all_gather", src)
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, group, dim: int = 0
                       ) -> torch.Tensor:
        """The sum over ranks of ``x``, of which this rank keeps its
        chunk along ``dim`` (``x.shape[dim]`` divisible by the ranks)."""
        n = dist.get_world_size(group)
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
        self._count("reduce_scatter", src)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, group) -> torch.Tensor:
        """Chunk ``i`` of ``x`` along dim 0 goes to rank ``i``; chunk ``j``
        of the result came from rank ``j``."""
        src = x.contiguous()
        out = torch.empty_like(src)
        self._count("all_to_all", src)
        dist.all_to_all_single(out, src, group=group)
        return out


Axes = Union[str, Sequence[str]]


def _axes(axis: Axes):
    return (axis,) if isinstance(axis, str) else tuple(axis)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.transport.all_reduce(
            g, ctx.mesh.group(ctx.axis)), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.transport.all_reduce(x, mesh.group(axis))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.rank, ctx.n, ctx.dim = (mesh.index(axis), mesh.shape[axis], dim)
        return mesh.transport.all_gather(x, mesh.group(axis), dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, ctx.dim)[ctx.rank], None, None, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return x.chunk(mesh.shape[axis], dim)[mesh.index(axis)].clone(
            memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.transport.all_gather(
            g, ctx.mesh.group(ctx.axis), ctx.dim), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.transport.all_gather(x, mesh.group(axis), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.transport.reduce_scatter(
            g, ctx.mesh.group(ctx.axis), ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return mesh.transport.reduce_scatter(x, mesh.group(axis), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.transport.all_gather(
            g, ctx.mesh.group(ctx.axis), ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.transport.all_to_all(x, mesh.group(axis))

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.transport.all_to_all(
            g, ctx.mesh.group(ctx.axis)), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.transport.all_reduce(x, mesh.group(axis))

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.transport.all_reduce(
            g, ctx.mesh.group(ctx.axis)), None, None


def copy_to(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """Identity; the backward sums the cotangents over ``axis``."""
    for ax in _axes(axis):
        x = _CopyTo.apply(x, mesh, ax)
    return x


def reduce_from(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """Sum over ``axis``; the backward passes the cotangent through."""
    for ax in _axes(axis):
        x = _ReduceFrom.apply(x, mesh, ax)
    return x


def gather_from(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim``; the backward keeps this
    rank's chunk of the cotangent."""
    return _GatherFrom.apply(x, mesh, axis, dim)


def split_to(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's chunk along ``dim`` of ``x``, the same on every rank of
    ``axis``; the backward all-gathers the chunks' cotangents."""
    return _SplitTo.apply(x, mesh, axis, dim)


def all_gather(x: torch.Tensor, mesh, axis: Axes, dim: int) -> torch.Tensor:
    """Concatenate the ranks' ``x`` along ``dim`` in the row-major order
    of ``axis`` (JAX's tiled ``all_gather`` over a tuple of axes); the
    backward reduce-scatters the cotangents."""
    for ax in reversed(_axes(axis)):
        x = _AllGather.apply(x, mesh, ax, dim)
    return x


def reduce_scatter(x: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """Sum the ranks' ``x`` over ``axis`` and keep this rank's chunk along
    ``dim``; the backward all-gathers the chunks' cotangents."""
    return _ReduceScatter.apply(x, mesh, axis, dim)


def all_to_all(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Exchange the chunks of dim 0 over ``axis``; the backward sends the
    cotangents back."""
    return _AllToAll.apply(x, mesh, axis)


def all_reduce(x: torch.Tensor, mesh, axis: Axes) -> torch.Tensor:
    """Sum over ``axis``; the backward sums the cotangents too."""
    for ax in _axes(axis):
        x = _AllReduce.apply(x, mesh, ax)
    return x
