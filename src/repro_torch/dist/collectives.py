"""§7's reconfiguration tree lifted to mesh axes: radix-4 collectives.

Counterpart of ``repro/dist/collectives.py`` over ``torch.distributed``.
A flat all-reduce over an N-rank axis is the cross-device analogue of the
paper's "conventional two operand adder" chain; the §7 alternative is a
*planned* radix-4 tree.  :func:`make_tree_mesh` reshapes one mesh axis
into its :func:`~repro_torch.dist.plan.factor_radix4` stage axes (``data``
-> ``data_t0, data_t1, ...``), a process group each; :func:`tree_psum`
then reduces stage by stage — ceil(log4 N) stages of 4-wide reductions
instead of one N-wide one, exactly the ReductionPlan shape the
in-register and kernel tiers execute.

For integer payloads the Theorem (carry <= N-1) makes the staged sum
*exact* whenever the flat sum is: every stage partial is bounded by the
final total, so the :class:`~repro_torch.core.accum.AccumPlan` width
check covers the whole tree.  For floats the tree is the log-depth
summation order.

Every function runs on every rank of the mesh with the rank's own tensor
(what a JAX ``shard_map`` body sees) and takes the mesh whose axes
``axis_names`` name (``mesh=``: there is no ambient mesh in PyTorch).
These are forward collectives, for gradients and payloads outside
autograd; :mod:`repro_torch.dist.transport` has the autograd forms.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.dist.plan import (ReductionPlan, factor_radix4,
                                   make_reduction_plan, stage_count)
from repro_torch.launch.mesh import Mesh, device_mesh
from repro_torch.tree import leaves, map_tree

__all__ = [
    "factor_radix4",
    "stage_count",
    "tree_mesh_layout",
    "make_tree_mesh",
    "tree_psum",
    "tree_pmean",
    "tree_pmax",
    "tree_reduce_scatter_gather",
]


def tree_mesh_layout(shape: Sequence[int], axis_names: Sequence[str],
                     axis: str, plan: Optional[ReductionPlan] = None
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...],
                                Tuple[str, ...]]:
    """``(shape, axis_names, sub_axes)`` of the tree mesh that
    :func:`make_tree_mesh` builds: ``axis`` replaced by its radix-4 stage
    axes, the ranks kept in row-major order, so a block split over
    ``sub_axes`` lands where a split over ``axis`` did.  A single-stage
    (or size-1) axis comes back unchanged."""
    axis_names = tuple(axis_names)
    if axis not in axis_names:
        raise ValueError(f"axis {axis!r} not in mesh axes {axis_names}")
    idx = axis_names.index(axis)
    size = shape[idx]
    plan = plan or make_reduction_plan(size)
    if plan.n != size:
        raise ValueError(f"plan is for N={plan.n}, mesh axis {axis!r} has "
                         f"size {size}")
    if len(plan.stages) <= 1:
        return tuple(shape), axis_names, (axis,)
    sub = plan.sub_axis_names(axis)
    new_shape = tuple(shape[:idx]) + plan.stages + tuple(shape[idx + 1:])
    return new_shape, axis_names[:idx] + sub + axis_names[idx + 1:], sub


def make_tree_mesh(mesh: Mesh, axis: str,
                   plan: Optional[ReductionPlan] = None
                   ) -> Tuple[Mesh, Tuple[str, ...]]:
    """Reshape one mesh axis into its radix-4 stage axes.

    Returns ``(tree_mesh, sub_axes)`` where ``sub_axes`` replaces ``axis``
    (e.g. ``"data"`` over 8 ranks -> ``("data_t0", "data_t1")`` of sizes
    (4, 2)), with a process group a stage axis.  Rank order along the
    factored axes is row-major (:func:`tree_mesh_layout`).  A size-1 (or
    single-stage) axis is returned unchanged as a single stage.  Every
    rank must call it (it builds process groups); the tree mesh shares the
    mesh's device and transport."""
    new_shape, new_names, sub = tree_mesh_layout(
        tuple(mesh.shape.values()), mesh.axis_names, axis, plan)
    if sub == (axis,):
        return mesh, sub
    ranks = mesh.device_mesh.mesh.reshape(new_shape)
    return device_mesh(new_shape, new_names, mesh.device, mesh.transport,
                       ranks), sub


def _check_int_payload(x: torch.Tensor, n: int,
                       plan: Optional[ReductionPlan]) -> None:
    if plan is None or plan.accum is None:
        return
    if not x.dtype.is_floating_point and not x.dtype.is_complex:
        acc_bits = torch.iinfo(x.dtype).bits
        if plan.accum.spill_bits > acc_bits:
            raise ValueError(
                f"summing {n} x int{plan.accum.operand_bits + 1} payloads "
                f"needs {plan.accum.spill_bits} bits; the int{acc_bits} "
                f"carrier overflows — widen the carrier or shard the "
                f"reduction")


def tree_psum(x: Any, axis_names: Sequence[str],
              plan: Optional[ReductionPlan] = None, *, mesh: Mesh) -> Any:
    """Radix-4 staged sum over the stage axes of one tree mesh.

    Equals a flat all-reduce over ``axis_names`` together — the tree fixes
    the reduction schedule to the §7 stage plan.  ``x`` is a tensor or a
    tree of them (dicts, lists).  ``plan`` (with an ``accum`` width plan)
    checks before any collective that an integer payload cannot overflow
    its carrier anywhere in the tree: the Theorem bounds every stage
    partial by the final total's width."""
    axis_names = tuple(axis_names)
    n = mesh.size(axis_names)
    if plan is not None:
        if plan.n != n:
            raise ValueError(f"plan is for N={plan.n}, but the "
                             f"{axis_names} axes reduce {n} shards")
        for leaf in leaves(x):
            _check_int_payload(leaf, n, plan)
    t = mesh.transport
    for ax in axis_names:
        g = mesh.group(ax)
        x = map_tree(lambda v: t.all_reduce(v, g), x)
    return x


def tree_pmean(x: Any, axis_names: Sequence[str], *, mesh: Mesh) -> Any:
    """Staged mean: :func:`tree_psum` / the product of the stage sizes."""
    n = mesh.size(tuple(axis_names))
    return map_tree(lambda v: v / n, tree_psum(x, axis_names, mesh=mesh))


def tree_pmax(x: Any, axis_names: Sequence[str], *, mesh: Mesh) -> Any:
    """Staged max over the stage axes (``jax.lax.pmax`` axis by axis)."""
    t = mesh.transport
    for ax in tuple(axis_names):
        g = mesh.group(ax)
        x = map_tree(lambda v: t.all_reduce(v, g, op="max"), x)
    return x


def tree_reduce_scatter_gather(x: torch.Tensor, axis_names: Sequence[str],
                               axis: int = 0,
                               plan: Optional[ReductionPlan] = None, *,
                               mesh: Mesh) -> torch.Tensor:
    """Sum as reduce-scatter down the stage tree + all-gather back up.

    Each stage's reduce-scatter leaves this rank holding ``1/stage`` of the
    partial sums (the bandwidth-optimal schedule); the matching
    all-gathers run in reverse stage order so chunks reassemble in their
    original positions.  Requires ``x.shape[axis]`` divisible by the
    product of stage sizes."""
    axis_names = tuple(axis_names)
    n = mesh.size(axis_names)
    if x.shape[axis] % n:
        raise ValueError(
            f"dim {axis} of {tuple(x.shape)} not divisible by the {n}-device "
            f"tree; use tree_psum for unscatterable payloads")
    if plan is not None and plan.n != n:
        raise ValueError(f"plan is for N={plan.n}, but the {axis_names} "
                         f"axes reduce {n} shards")
    _check_int_payload(x, n, plan)
    t = mesh.transport
    for ax in axis_names:
        x = t.reduce_scatter(x, mesh.group(ax), axis)
    for ax in reversed(axis_names):
        x = t.all_gather(x, mesh.group(ax), axis)
    return x
