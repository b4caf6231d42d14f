"""Value-and-grad, and gradient accumulation over microbatches.

The counterpart of ``repro/optim/grad_accum.py``: the paper's *serial*
multi-operand adder applied to microbatches.  The accumulation loop is
Algorithm 2: one fp32 carry buffer (the running gradient) swept across the
microbatch "columns" and drained into the optimizer at the end as a mean.
:func:`value_and_grad` stands in for ``jax.value_and_grad``.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.tree import index_tree, leaves, map_tree

__all__ = ["value_and_grad", "accumulated_value_and_grad"]


def _rebuild(tree: Any, flat: list) -> Any:
    it = iter(flat)
    return map_tree(lambda _: next(it), tree)


def value_and_grad(loss_fn: Callable) -> Callable:
    """``fn(params, batch) -> (loss, grads)``: grads of ``loss_fn(params,
    batch)`` w.r.t. every leaf of ``params``, in the same tree.

    Each leaf enters the loss as a detached leaf that shares its storage,
    so a leaf that is a view (one layer of a stacked tensor) gets its own
    gradient tensor, not a full-size one.  A leaf the loss does not use
    gets zeros, as in JAX."""
    def fn(params: Any, batch: Any) -> Tuple[torch.Tensor, Any]:
        flat = [t.detach().requires_grad_(True) for t in leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(_rebuild(params, flat), batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(flat, grads)]
        return loss.detach(), _rebuild(params, grads)
    return fn


def accumulated_value_and_grad(loss_fn: Callable, num_micro: int
                               ) -> Callable:
    """Wrap ``loss_fn(params, microbatch)`` into an accumulated
    value-and-grad over a leading microbatch axis of the batch.

    Returns ``fn(params, stacked_batch) -> (mean_loss, mean_grads)``.  The
    carry is fp32 whatever the compute dtype (the Theorem's carry-width
    discipline: the carry buffer must be wider than the operands)."""
    vg = value_and_grad(loss_fn)

    def fn(params: Any, stacked_batch: Any) -> Tuple[torch.Tensor, Any]:
        loss_sum = None
        gsum = map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), params)
        for i in range(num_micro):
            loss, grads = vg(params, index_tree(stacked_batch, i))
            for a, g in zip(leaves(gsum), leaves(grads)):
                a.add_(g.float())
            loss = loss.float()
            loss_sum = loss if loss_sum is None else loss_sum + loss
        inv = 1.0 / num_micro
        return loss_sum * inv, map_tree(lambda g: g.mul_(inv), gsum)

    return fn
