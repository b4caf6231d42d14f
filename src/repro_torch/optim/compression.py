"""int8 gradient compression with exact integer tree reduction.

Counterpart of ``repro/optim/compression.py`` over ``torch.distributed``.
The gradient reduction across pods is the bandwidth-starved one (the slow
links between pods, against the fast ones inside a pod); compressing it to
int8 cuts its bytes 4x against fp32 gradients.  The sum itself stays
**exact** by the paper's Theorem: N_pods int8 payloads need 8 +
ceil(log2 N_pods) bits, so an int32 carrier admits up to 2^24 pods —
:func:`repro_torch.core.accum.plan_gradient_reduction` checks this before
any collective.  The quantization error is carried per pod with error
feedback (the residual is added to the next step's gradient).

The reduction over the pod axis uses the §7 radix-4 stage tree
(:func:`repro_torch.dist.collectives.tree_psum`).
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from repro_torch.dist.collectives import tree_pmax, tree_psum
from repro_torch.dist.plan import make_reduction_plan
from repro_torch.launch.mesh import Mesh
# the shared implementation (also used by quantized KV pages), re-exported
from repro_torch.models.quant_kv import dequantize_int8, quantize_int8
from repro_torch.tree import map_tree

__all__ = ["quantize_int8", "dequantize_int8", "compressed_psum_mean",
           "init_error_state"]


def init_error_state(params: Any, n_shards: int) -> Any:
    """Per-shard error-feedback residual: a leading ``(n_shards,)`` axis,
    split over the reduction axis (a rank holds its block of 1)."""
    return map_tree(lambda p: torch.zeros((n_shards,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum_mean(grads: Any, err: Any, sub_axes: Sequence[str],
                         n_shards: int, *, mesh: Mesh,
                         shard_axes: Sequence[str] = ()) -> Tuple[Any, Any]:
    """Mean-reduce ``grads`` over the (factored) reduction axis with int8
    payloads, exact integer accumulation, and error feedback.

    Args:
      grads: this rank's gradient tree (fp32/bf16 leaves).
      err: this rank's residual tree (same shapes, fp32).
      sub_axes: radix-4 stage axes of ``mesh``, from
        :func:`~repro_torch.dist.collectives.make_tree_mesh`.
      n_shards: total shards being reduced (for the exactness check and
        the mean).
      shard_axes: axes of ``mesh`` that split every leaf into blocks (the
        leaves are this rank's blocks): the max-abs is taken over them
        too, so a leaf keeps one scale however it is split.

    Returns (mean grads fp32, new err): one shared scale, the max over the
    stage axes (and ``shard_axes``) of ``|g + e|`` / 127 (at least 1e-12); the int8 codes summed
    in int32 through :func:`tree_psum` under
    ``make_reduction_plan(n_shards, payload_bits=8, acc_bits=32)``;
    dequantized and divided by ``n_shards``; the new residual ``g + e -
    dequantize(q)``."""
    plan = make_reduction_plan(n_shards, payload_bits=8, acc_bits=32)
    if plan.accum.spill_bits > 32:
        raise ValueError(f"{n_shards} int8 payloads need "
                         f"{plan.accum.spill_bits} bits: more than the int32 "
                         f"carrier holds")

    def leaf(g, e):
        g32 = g.float() + e
        amax = tree_pmax(torch.amax(torch.abs(g32)),
                         tuple(shard_axes) + tuple(sub_axes), mesh=mesh)
        scale = torch.clamp(amax / 127.0, min=1e-12)
        q = quantize_int8(g32, scale)
        new_e = g32 - dequantize_int8(q, scale)      # residual feedback
        # exact integer multi-operand sum (int32 carrier; Theorem-checked)
        total = tree_psum(q.to(torch.int32), sub_axes, plan=plan, mesh=mesh)
        return dequantize_int8(total, scale) / n_shards, new_e

    pairs = map_tree(leaf, grads, err)
    return (map_tree(lambda _, pr: pr[0], grads, pairs),
            map_tree(lambda _, pr: pr[1], grads, pairs))
