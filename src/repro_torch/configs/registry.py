"""The 10 assigned architectures (copy of ``repro/configs/registry.py``).

Sources are noted per entry; where a public config leaves a knob unstated
(e.g. rope theta) we pick the family default and mark it ``# approx``.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import ModelConfig

__all__ = ["get_config", "list_archs", "ARCHS"]


def _internvl2_26b() -> ModelConfig:
    # InternViT-6B frontend (stub) + InternLM2-20B backbone [arXiv:2404.16821]
    return ModelConfig(
        arch_id="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=16384, vocab=92553, head_dim=128,
        rope_theta=1_000_000.0,
        frontend="vision_stub", frontend_dim=3200,   # InternViT-6B width
        n_frontend_tokens=256,                       # tokens per image tile
    )


def _glm4_9b() -> ModelConfig:
    # [hf:THUDM/glm-4-9b] RoPE, GQA kv=2, qkv bias
    return ModelConfig(
        arch_id="glm4-9b", family="dense",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=151552, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,       # approx
    )


def _minicpm3_4b() -> ModelConfig:
    # [hf:openbmb/MiniCPM3-4B] MLA attention
    return ModelConfig(
        arch_id="minicpm3-4b", family="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=6400, vocab=73448, head_dim=96,
        attn_kind="mla",
        q_lora_rank=768, kv_lora_rank=256,
        qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
        rope_theta=1_000_000.0,                       # approx
    )


def _qwen25_14b() -> ModelConfig:
    # [hf:Qwen/Qwen2.5-*] GQA kv=8, QKV bias
    return ModelConfig(
        arch_id="qwen2.5-14b", family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab=152064, head_dim=128,
        qkv_bias=True, rope_theta=1_000_000.0,
    )


def _llama32_3b() -> ModelConfig:
    # small llama3 [hf:meta-llama/Llama-3.2-*]
    return ModelConfig(
        arch_id="llama3.2-3b", family="dense",
        n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
        d_ff=8192, vocab=128256, head_dim=128,
        rope_theta=500_000.0,
    )


def _hubert_xlarge() -> ModelConfig:
    # encoder-only audio [arXiv:2106.07447]; conv-stem stub provides frames
    return ModelConfig(
        arch_id="hubert-xlarge", family="audio",
        n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
        d_ff=5120, vocab=504, head_dim=80,
        causal=False, encoder_only=True,
        frontend="audio_stub", frontend_dim=512,      # conv stem output
        rope_theta=10_000.0,
    )


def _llama4_scout() -> ModelConfig:
    # [hf:meta-llama/Llama-4-Scout-17B-16E] MoE 16e top-1 + shared expert
    return ModelConfig(
        arch_id="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202048, head_dim=128,
        n_experts=16, top_k=1, n_shared_experts=1,
        rope_theta=500_000.0,
    )


def _phi35_moe() -> ModelConfig:
    # [hf:microsoft/Phi-3.5-MoE-instruct] 16 experts top-2
    return ModelConfig(
        arch_id="phi3.5-moe-42b-a6.6b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=6400, vocab=32064, head_dim=128,
        n_experts=16, top_k=2, n_shared_experts=0,
        rope_theta=10_000.0,
    )


def _zamba2_12b() -> ModelConfig:
    # [arXiv:2411.15242] Mamba2 backbone + shared attention blocks
    return ModelConfig(
        arch_id="zamba2-1.2b", family="hybrid",
        n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=32000, head_dim=64,
        ssm_variant="mamba2", ssm_state=64, ssm_conv=4, ssm_expand=2,
        ssm_head_dim=64,
        shared_attn_period=6, shared_lora_rank=64,
        rope_theta=10_000.0,
    )


def _falcon_mamba_7b() -> ModelConfig:
    # [arXiv:2410.05355] pure mamba1, attention-free
    return ModelConfig(
        arch_id="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=65024, head_dim=64,
        attn_kind="none",
        ssm_variant="mamba1", ssm_state=16, ssm_conv=4, ssm_expand=2,
    )


ARCHS: Dict[str, ModelConfig] = {
    c.arch_id: c for c in [
        _internvl2_26b(), _glm4_9b(), _minicpm3_4b(), _qwen25_14b(),
        _llama32_3b(), _hubert_xlarge(), _llama4_scout(), _phi35_moe(),
        _zamba2_12b(), _falcon_mamba_7b(),
    ]
}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch '{arch_id}'; have {sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_archs() -> List[str]:
    return sorted(ARCHS)
