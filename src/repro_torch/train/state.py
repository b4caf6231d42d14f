"""Train state: params + AdamW moments, and the train step.

The counterpart of ``repro/train/state.py`` on one card.  The state is a
dict ``{"params", "m", "v", "step"}``: fp32 master params in the JAX
tree's layout (``blocks`` stacked on a leading layers axis), fp32 AdamW
moments of the same layout, and an int32 step, all on one device.

:func:`build_train_step` returns ``step(state, batch) -> (state,
metrics)``.  It hands the loss each layer's params as views
(:func:`split_layers`), so every layer gets its own gradient tensor and no
full-size stacked gradient is built per layer, then updates params, ``m``
and ``v`` in place (:func:`repro_torch.optim.adamw.adamw_update`).  The
gradients are dropped when the step returns.  Modes: standard, and
``grad_accum > 1`` (serial fp32 accumulation over a leading microbatch
axis of the batch).  The pod-compressed mode needs the mesh work of
``ROADMAP.md`` queue 1 item 11.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamSpec, init_params
from repro_torch.models.registry import get_api
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update
from repro_torch.optim.grad_accum import (accumulated_value_and_grad,
                                          value_and_grad)
from repro_torch.tree import index_tree, leaves, map_tree

__all__ = ["train_state_specs", "init_train_state", "build_train_step",
           "split_layers"]


def train_state_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """ParamSpec trees for the full train state."""
    pspecs = get_api(cfg).param_specs(cfg)
    opt = lambda s: ParamSpec(s.shape, s.axes, dtype=torch.float32,
                              init="zeros")
    return {
        "params": pspecs,
        "m": map_tree(opt, pspecs),
        "v": map_tree(opt, pspecs),
        "step": ParamSpec((), (), dtype=torch.int32, init="zeros"),
    }


def init_train_state(cfg: ModelConfig, generator: torch.Generator
                     ) -> Dict[str, Any]:
    """Random fp32 params (fan-in scaled normals from ``generator``), zero
    moments and step, on the generator's device.  The JAX package draws
    from ``jax.random``, so the two packages' states differ for one seed;
    parity tests convert the JAX state with
    :func:`repro_torch.convert.train_state_from_numpy`."""
    return init_params(train_state_specs(cfg), generator, generator.device)


def split_layers(tree: Dict[str, Any]) -> Dict[str, Any]:
    """``tree`` with its stacked ``blocks`` replaced by a list of per-layer
    dicts of views (the other entries as they are)."""
    if "blocks" not in tree:
        return tree
    blocks = tree["blocks"]
    n = leaves(blocks)[0].shape[0]
    return {**tree, "blocks": [index_tree(blocks, i) for i in range(n)]}


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     lr_schedule: Optional[Callable] = None,
                     grad_accum: int = 1, pod_compressed: bool = False
                     ) -> Callable:
    """Return ``step(state, batch) -> (state, metrics)``.

    ``batch`` maps names to numpy arrays or tensors (with a leading
    microbatch axis when ``grad_accum > 1``); they are moved to the state's
    device.  The returned state is the same dict, its tensors updated in
    place and its ``step`` advanced; metrics are 0-d device tensors
    ``loss``, ``grad_norm`` and ``lr``."""
    if pod_compressed:
        raise NotImplementedError(
            "pod_compressed (int8 radix-4 gradient reduction across pods) "
            "needs the port's mesh work: ROADMAP.md queue 1 item 11")
    api = get_api(cfg)

    def loss_fn(params, batch):
        return api.train_loss(params, batch, cfg)

    vg = (accumulated_value_and_grad(loss_fn, grad_accum) if grad_accum > 1
          else value_and_grad(loss_fn))

    def step(state: Dict[str, Any], batch: Dict[str, Any]):
        device = state["step"].device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        params = split_layers(state["params"])
        loss, grads = vg(params, batch)
        lr = lr_schedule(state["step"]) if lr_schedule else None
        opt = AdamWState(step=state["step"], m=split_layers(state["m"]),
                         v=split_layers(state["v"]))
        _, opt, metrics = adamw_update(opt_cfg, params, grads, opt, lr)
        metrics["loss"] = loss
        return {**state, "step": opt.step}, metrics

    return step
