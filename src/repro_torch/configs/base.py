"""Architecture and shape config schemas, with a torch dtype.

Field for field the same as ``repro/configs/base.py:ModelConfig`` except
that ``dtype`` holds a ``torch.dtype`` (the JAX config holds a ``jnp`` one);
``tests/test_torch_config.py`` holds the two equal for every arch and its
``reduced()`` form.  Fields the port does not read yet (MoE, SSM, MLA,
training knobs) are kept so one config describes one model in both
packages.  :data:`SHAPES` and :func:`cells_for` are the dry run's shape
cells, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "cells_for"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    causal: bool = True
    encoder_only: bool = False
    # --- attention variant -------------------------------------------------
    attn_kind: str = "gqa"         # gqa | mla | none
    q_lora_rank: int = 0           # MLA
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    renorm_topk: bool = True
    router_aux_coef: float = 0.01
    use_ep: bool = True            # shard_map all-to-all expert parallelism
    use_tp_shardmap: bool = True   # manual vocab-parallel embed (vs auto)
    # --- SSM ----------------------------------------------------------------
    ssm_variant: str = ""          # mamba1 | mamba2
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64         # mamba2
    ssm_dt_rank: int = 0           # mamba1 (0 -> ceil(d_model/16))
    # --- hybrid (zamba2) ----------------------------------------------------
    shared_attn_period: int = 0    # shared attn+MLP block every k SSM layers
    shared_lora_rank: int = 64
    # --- modality frontend stubs --------------------------------------------
    frontend: str = ""             # "" | vision_stub | audio_stub
    frontend_dim: int = 0          # raw embedding dim provided by the stub
    n_frontend_tokens: int = 0     # stub tokens per training sequence
    # --- compute ------------------------------------------------------------
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    attn_chunk: int = 512
    ssm_chunk: int = 256
    use_moa_reduce: bool = True    # fused multi-operand combine kernels
    use_flash_attn: bool = True    # Pallas streaming-softmax attention (TPU)
    # serve-engine paged split-K decode: KV pages combined via the shared
    # radix-4 ReductionPlan (0 = dense cache-attend decode)
    decode_page_size: int = 0

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        small = dict(
            n_layers=max(2, self.shared_attn_period + 2
                         if self.shared_attn_period else 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab=97,
            head_dim=16,
            q_lora_rank=24 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            # drop-free capacity so prefill and decode route identically
            capacity_factor=(float(min(self.n_experts, 4))
                             if self.n_experts else self.capacity_factor),
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_variant == "mamba2" else 64,
            shared_attn_period=2 if self.shared_attn_period else 0,
            shared_lora_rank=8 if self.shared_attn_period else 0,
            frontend_dim=32 if self.frontend_dim else 0,
            n_frontend_tokens=8 if self.n_frontend_tokens else 0,
            attn_chunk=16,
            ssm_chunk=8,
            use_ep=False,
            remat=False,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One step's input shape (``repro/configs/base.py:ShapeConfig``)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

#: archs with O(S^2)-only attention: their long_500k decode is skipped
_FULL_ATTENTION = {
    "internvl2-26b", "glm4-9b", "minicpm3-4b", "qwen2.5-14b", "llama3.2-3b",
    "hubert-xlarge", "llama4-scout-17b-a16e", "phi3.5-moe-42b-a6.6b",
}


def cells_for(arch_id: str, encoder_only: bool) -> Tuple[str, ...]:
    """The runnable shape cells for an architecture: an encoder has no
    decode cell, and a full-attention arch no 500k-token decode."""
    names = ["train_4k", "prefill_32k"]
    if not encoder_only:
        names.append("decode_32k")
        if arch_id not in _FULL_ATTENTION:
            names.append("long_500k")
    return tuple(names)
