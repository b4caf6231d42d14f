"""Input specs per (architecture x shape cell) (``repro/launch/inputs.py``).

:func:`batch_spec_shapes` is what the data pipeline reads;
:func:`input_specs` and :func:`decode_state_structs` give the dry run meta
tensors (shapes, no storage) where the JAX package gives
``ShapeDtypeStruct`` stand-ins; :func:`make_batch` builds the same tree as
real deterministic tensors, equal in value to the JAX package's.  Modality
frontends are stubs: their entries carry precomputed patch/frame
embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.common import shape_structs
from repro_torch.models.registry import get_api

__all__ = ["batch_spec_shapes", "batch_logical_axes", "input_specs",
           "decode_state_structs", "make_batch"]


def batch_spec_shapes(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, Tuple[Tuple[int, ...], Any]]:
    """{name: (shape, torch dtype)} for the step input batch."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "audio_stub":
            out = {"frames": ((b, s, cfg.frontend_dim), torch.bfloat16)}
            if shape.kind == "train":
                out["labels"] = ((b, s), torch.int32)
            return out
        if cfg.frontend == "vision_stub":
            nft = cfg.n_frontend_tokens
            out = {
                "vision_embeds": ((b, nft, cfg.frontend_dim), torch.bfloat16),
                "tokens": ((b, s - nft), torch.int32),
            }
            if shape.kind == "train":
                out["labels"] = ((b, s - nft), torch.int32)
            return out
        out = {"tokens": ((b, s), torch.int32)}
        if shape.kind == "train":
            out["labels"] = ((b, s), torch.int32)
        return out
    # decode: one new token against a seq_len-deep cache
    return {"tokens": ((b, 1), torch.int32), "index": ((), torch.int32)}


def batch_logical_axes(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Dict[str, Tuple[Any, ...]]:
    """Logical sharding axes for each batch entry: the leading axis over
    "batch", the rest replicated; the 0-d decode index has none."""
    return {k: () if k == "index" else ("batch",) + (None,) * (len(shp) - 1)
            for k, (shp, _) in batch_spec_shapes(cfg, shape).items()}


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> Dict[str, torch.Tensor]:
    """Meta tensors for the step inputs (batch only)."""
    return {k: torch.empty(shp, dtype=dt, device="meta")
            for k, (shp, dt) in batch_spec_shapes(cfg, shape).items()}


def decode_state_structs(cfg: ModelConfig, shape: ShapeConfig):
    """(state meta tensors, state ParamSpecs) for decode cells: a
    ``seq_len``-deep cache for ``global_batch`` slots."""
    specs = get_api(cfg).decode_state_specs(cfg, shape.global_batch,
                                            shape.seq_len)
    return shape_structs(specs), specs


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0
               ) -> Dict[str, torch.Tensor]:
    """Deterministic CPU batch matching :func:`input_specs`: integers and
    normals drawn in entry order from ``np.random.default_rng(seed)``, the
    normals rounded to float32 before bf16 (as the JAX package casts
    them), and the decode index at ``seq_len // 2``."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, dt) in batch_spec_shapes(cfg, shape).items():
        if k == "index":
            out[k] = torch.tensor(shape.seq_len // 2, dtype=torch.int32)
        elif dt == torch.int32:
            out[k] = torch.from_numpy(
                rng.integers(0, cfg.vocab, shp).astype(np.int32))
        else:
            out[k] = torch.from_numpy(
                rng.standard_normal(shp).astype(np.float32)).to(dt)
    return out
