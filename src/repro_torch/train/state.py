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
axis of the batch).

On a device mesh (:class:`repro_torch.launch.mesh.Mesh`) every rank holds
the whole state and takes its rows of the batch (split over the ``pod``
and ``data`` axes); the model splits its attention heads and experts over
``model`` (:func:`repro_torch.models.lm.forward`).  The standard step
means the gradients over the ``pod`` x ``data`` ranks, so every rank
applies the same update.  The pod-compressed step means them over
``data`` only, then across pods through
:func:`repro_torch.optim.compression.compressed_psum_mean` (int8 payloads,
an exact int32 radix-4 tree sum, error feedback in the state's ``err``:
on a rank, its pod's block of 1), a stacked ``blocks`` leaf as one
payload with one scale over its layers, as the JAX step compresses it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist.collectives import make_tree_mesh, tree_pmean
from repro_torch.models.common import ParamSpec, init_params
from repro_torch.models.registry import get_api
from repro_torch.optim import compression
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update
from repro_torch.optim.grad_accum import (accumulated_value_and_grad,
                                          value_and_grad)
from repro_torch.tree import index_tree, leaves, map_tree

__all__ = ["train_state_specs", "init_train_state", "build_train_step",
           "split_layers"]


def train_state_specs(cfg: ModelConfig, pod_compressed: bool = False,
                      n_pods: int = 1) -> Dict[str, Any]:
    """ParamSpec trees for the full train state; with ``pod_compressed``
    also ``err``, each param's fp32 error-feedback residual with a leading
    ``(n_pods,)`` axis (split over ``pod``)."""
    pspecs = get_api(cfg).param_specs(cfg)
    opt = lambda s: ParamSpec(s.shape, s.axes, dtype=torch.float32,
                              init="zeros")
    out = {
        "params": pspecs,
        "m": map_tree(opt, pspecs),
        "v": map_tree(opt, pspecs),
        "step": ParamSpec((), (), dtype=torch.int32, init="zeros"),
    }
    if pod_compressed:
        out["err"] = map_tree(
            lambda s: ParamSpec((n_pods,) + tuple(s.shape),
                                ("err_pod",) + tuple(s.axes),
                                dtype=torch.float32, init="zeros"), pspecs)
    return out


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     pod_compressed: bool = False, n_pods: int = 1
                     ) -> Dict[str, Any]:
    """Random fp32 params (fan-in scaled normals from ``generator``), zero
    moments and step, on the generator's device; with ``pod_compressed``
    zero ``err`` leaves of ``n_pods`` blocks (a rank of a pod mesh holds
    its pod's one: ``n_pods=1``).  The base state is drawn first, so the
    params do not depend on ``pod_compressed``.  The JAX package draws
    from ``jax.random``, so the two packages' states differ for one seed;
    parity tests convert the JAX state with
    :func:`repro_torch.convert.train_state_from_numpy`."""
    out = init_params(train_state_specs(cfg), generator, generator.device)
    if pod_compressed:
        full = train_state_specs(cfg, True, n_pods)
        out["err"] = init_params(full["err"], generator, generator.device)
    return out


def split_layers(tree: Dict[str, Any]) -> Dict[str, Any]:
    """``tree`` with its stacked ``blocks`` replaced by a list of per-layer
    dicts of views (the other entries as they are)."""
    if "blocks" not in tree:
        return tree
    blocks = tree["blocks"]
    n = leaves(blocks)[0].shape[0]
    return {**tree, "blocks": [index_tree(blocks, i) for i in range(n)]}


def _rank_rows(batch: Dict[str, Any], mesh, axes, row_dim: int
               ) -> Dict[str, Any]:
    """This rank's block of every batch leaf along ``row_dim``, split
    row-major over ``axes``."""
    n, r = mesh.size(axes), mesh.flat_index(axes)
    return {k: v.chunk(n, row_dim)[r] for k, v in batch.items()}


def build_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                     lr_schedule: Optional[Callable] = None,
                     grad_accum: int = 1, pod_compressed: bool = False,
                     mesh=None) -> Callable:
    """Return ``step(state, batch) -> (state, metrics)``.

    ``batch`` maps names to numpy arrays or tensors (with a leading
    microbatch axis when ``grad_accum > 1``); they are moved to the state's
    device.  The returned state is the same dict, its tensors updated in
    place and its ``step`` advanced; metrics are 0-d device tensors
    ``loss``, ``grad_norm`` and ``lr``.

    On a ``mesh`` every rank calls the step with the whole batch and takes
    its rows; ``loss`` is the mean over the ranks.  ``pod_compressed``
    needs a mesh with a ``pod`` axis (raises ``ValueError`` otherwise) and
    a state with ``err`` leaves; there the MoE FFN takes the dense
    dispatch, as the JAX step turns ``use_ep`` off."""
    if pod_compressed and (mesh is None or "pod" not in mesh.shape):
        raise ValueError("pod_compressed needs a mesh with a 'pod' axis "
                         "(a multi-pod device mesh)")
    if pod_compressed:
        cfg = dataclasses.replace(cfg, use_ep=False)
    api = get_api(cfg)

    def loss_fn(params, batch):
        return api.train_loss(params, batch, cfg, mesh)

    vg = (accumulated_value_and_grad(loss_fn, grad_accum) if grad_accum > 1
          else value_and_grad(loss_fn))
    batch_axes = () if mesh is None else tuple(
        a for a in ("pod", "data") if a in mesh.shape)
    if pod_compressed:
        tree, sub_axes = make_tree_mesh(mesh, "pod")
        n_pods = mesh.shape["pod"]
    mean_axes = tuple(a for a in batch_axes
                      if not (pod_compressed and a == "pod"))

    def step(state: Dict[str, Any], batch: Dict[str, Any]):
        device = state["step"].device
        batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
        if batch_axes:
            batch = _rank_rows(batch, mesh, batch_axes,
                               1 if grad_accum > 1 else 0)
        params = split_layers(state["params"])
        loss, grads = vg(params, batch)
        if mean_axes:
            grads = tree_pmean(grads, mean_axes, mesh=mesh)
            loss = tree_pmean(loss, mean_axes, mesh=mesh)
        if pod_compressed:
            # leaf by leaf, into the gradient and the residual in place:
            # whole new trees of means and residuals would hold two more
            # copies of the params' bytes at once
            def reduce(g, e):
                mean, new_e = compression.compressed_psum_mean(
                    g, e, sub_axes, n_pods, mesh=tree)
                e.copy_(new_e)
                return mean

            def reduce_layers(e, *layers):
                # the stacked leaf is one payload: one scale over its layers
                for g, mean in zip(layers, reduce(torch.stack(layers), e)):
                    g.copy_(mean)

            err = map_tree(lambda e: e[0], state["err"])
            for k, g in grads.items():
                if k == "blocks" and isinstance(g, list):
                    map_tree(reduce_layers, err[k], *g)
                else:
                    map_tree(lambda gl, e: gl.copy_(reduce(gl, e)), g, err[k])
            loss = tree_pmean(loss, sub_axes, mesh=tree)
        lr = lr_schedule(state["step"]) if lr_schedule else None
        opt = AdamWState(step=state["step"], m=split_layers(state["m"]),
                         v=split_layers(state["v"]))
        _, opt, metrics = adamw_update(opt_cfg, params, grads, opt, lr)
        metrics["loss"] = loss
        return {**state, "step": opt.step}, metrics

    return step
