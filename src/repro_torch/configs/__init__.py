"""Architecture registry: the ten assigned configs + reduced smoke variants."""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (
    jamba_v0_1_52b,
    llama4_maverick_400b_a17b,
    moonshot_v1_16b_a3b,
    musicgen_large,
    pixtral_12b,
    qwen2_0_5b,
    qwen2_72b,
    qwen3_0_6b,
    rwkv6_7b,
    stablelm_12b,
)
from repro_torch.configs.shapes import SHAPES, ShapeSpec, runnable
from repro_torch.models.config import ModelConfig

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        pixtral_12b, musicgen_large, qwen2_72b, stablelm_12b, qwen2_0_5b,
        qwen3_0_6b, rwkv6_7b, moonshot_v1_16b_a3b,
        llama4_maverick_400b_a17b, jamba_v0_1_52b,
    )
}

ARCH_NAMES = tuple(REGISTRY)


def get_config(name: str, *, reduced: bool = False, **overrides) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    cfg = REGISTRY[name]
    if reduced:
        cfg = reduce_config(cfg)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Same-family tiny variant for CPU smoke tests (one fwd/train step)."""
    period = len(cfg.mixer_pattern)
    n_layers = max(2, period) if period > 1 else 2
    if cfg.moe_experts:
        n_layers = max(n_layers, 2 * cfg.moe_period)
    heads = 4 if cfg.n_heads else 0
    kv = 0
    if cfg.n_heads:
        kv = max(1, (cfg.n_kv_heads * heads) // cfg.n_heads)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers, d_model=64,
        n_heads=heads, n_kv_heads=kv, head_dim=16,
        d_ff=128, vocab_size=512,
        moe_experts=min(cfg.moe_experts, 4) if cfg.moe_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        # cf = E/k makes cap == T (drop-free): decode then agrees with the
        # full forward (capacity-MoE is otherwise batch-size dependent).
        moe_capacity_factor=(min(cfg.moe_experts, 4) / max(1, min(cfg.moe_top_k, 2))
                             if cfg.moe_experts else 1.25),
        ssm_state_dim=8, ssm_dt_rank=8,
        rwkv_head_dim=16, rwkv_lora_r=8, rwkv_chunk=8,
        max_seq_len=128,
    )
