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

__all__ = ["Transport", "MetaTransport", "copy_to", "reduce_from",
           "gather_from", "split_to", "all_gather", "reduce_scatter",
           "all_to_all", "all_reduce"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Transport:
    """Collectives on a process group, with the payload bytes this rank
    hands to each op counted in :attr:`bytes` (by op name) and the calls in
    :attr:`calls`, and both again by op and axis in :attr:`axis_bytes` and
    :attr:`axis_calls` (keyed ``(op, axis)``).  Every op returns a new
    tensor and leaves its input as it was.

    The payload is the JAX package's operand convention
    (``repro/roofline/analysis.py:_parse_collective_line``): an all-gather
    counts its shard, a reduce-scatter its whole input, an all-reduce and
    an all-to-all their input.  A group's axis is the name a
    :class:`~repro_torch.launch.mesh.Mesh` gave it (:meth:`name_group`);
    where two axes share one group (every other axis of one rank), the
    first named with 2 or more ranks keeps it."""

    def __init__(self):
        self.bytes = collections.Counter()
        self.calls = collections.Counter()
        self.axis_bytes = collections.Counter()
        self.axis_calls = collections.Counter()
        self._axes = {}

    def reset(self) -> None:
        for c in (self.bytes, self.calls, self.axis_bytes, self.axis_calls):
            c.clear()

    def name_group(self, group, axis: str) -> None:
        """Count the ops on ``group`` under ``axis`` (the first name
        stays)."""
        self._axes.setdefault(id(group), (group, axis))

    def axis_of(self, group) -> str:
        return self._axes.get(id(group), (None, "?"))[1]

    def _count(self, op: str, x: torch.Tensor, group) -> None:
        n = x.numel() * x.element_size()
        axis = self.axis_of(group)
        self.bytes[op] += n
        self.calls[op] += 1
        self.axis_bytes[op, axis] += n
        self.axis_calls[op, axis] += 1

    def all_reduce(self, x: torch.Tensor, group, op: str = "sum"
                   ) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        self._count("all_reduce", out, group)
        dist.all_reduce(out, op=_OPS[op], group=group)
        return out

    def all_gather(self, x: torch.Tensor, group, dim: int = 0
                   ) -> torch.Tensor:
        """The ranks' ``x`` concatenated along ``dim`` in rank order."""
        n = dist.get_world_size(group)
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + src.shape[1:])
        self._count("all_gather", src, group)
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    def reduce_scatter(self, x: torch.Tensor, group, dim: int = 0
                       ) -> torch.Tensor:
        """The sum over ranks of ``x``, of which this rank keeps its
        chunk along ``dim`` (``x.shape[dim]`` divisible by the ranks)."""
        n = dist.get_world_size(group)
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
        self._count("reduce_scatter", src, group)
        dist.reduce_scatter_tensor(out, src, group=group)
        return out.movedim(0, dim)

    def all_to_all(self, x: torch.Tensor, group) -> torch.Tensor:
        """Chunk ``i`` of ``x`` along dim 0 goes to rank ``i``; chunk ``j``
        of the result came from rank ``j``."""
        src = x.contiguous()
        out = torch.empty_like(src)
        self._count("all_to_all", src, group)
        dist.all_to_all_single(out, src, group=group)
        return out


def split_len(length: int, n: int, op: str) -> int:
    """``length`` over ``n`` ranks, the length an ``op`` leaves each rank;
    raises ``ValueError`` where ``n`` does not divide it, as the live op
    does."""
    if length % n:
        raise ValueError(f"{op}: a length of {length} does not split "
                         f"over {n} ranks")
    return length // n


class MetaTransport(Transport):
    """A :class:`Transport` that counts and moves nothing, for one rank's
    program traced on meta tensors (:class:`~repro_torch.launch.mesh.
    MeshView`): its groups are axis names, ``sizes`` gives each axis's
    ranks, and every op counts what the live one would and returns an
    empty tensor of the live result's shape and dtype, calling nothing in
    ``torch.distributed``; a ``reduce_scatter`` or ``all_to_all`` of a
    length the axis's ranks do not divide raises, as the live one does."""

    def __init__(self, sizes):
        super().__init__()
        self.sizes = dict(sizes)

    def axis_of(self, group) -> str:
        return group

    def all_reduce(self, x, group, op="sum"):
        self._count("all_reduce", x, group)
        return torch.empty_like(x, memory_format=torch.contiguous_format)

    def all_gather(self, x, group, dim=0):
        self._count("all_gather", x, group)
        shape = list(x.shape)
        shape[dim] *= self.sizes[group]
        return x.new_empty(shape)

    def reduce_scatter(self, x, group, dim=0):
        shape = list(x.shape)
        shape[dim] = split_len(shape[dim], self.sizes[group],
                               "reduce_scatter")
        self._count("reduce_scatter", x, group)
        return x.new_empty(shape)

    def all_to_all(self, x, group):
        split_len(x.shape[0], self.sizes[group], "all_to_all")
        self._count("all_to_all", x, group)
        return torch.empty_like(x, memory_format=torch.contiguous_format)


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
