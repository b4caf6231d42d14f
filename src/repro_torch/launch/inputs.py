"""Input shapes per (architecture x shape cell) (``repro/launch/inputs.py``).

Only :func:`batch_spec_shapes`, which the data pipeline reads; the JAX
package's ``ShapeDtypeStruct`` stand-ins for AOT lowering have no
counterpart (PyTorch runs eagerly).  Modality frontends are stubs: their
entries carry precomputed patch/frame embeddings.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["batch_spec_shapes"]


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
