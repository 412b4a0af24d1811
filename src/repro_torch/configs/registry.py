"""Architecture registry: --arch <id> -> ModelConfig, plus reduced smoke
configs (same family, tiny dims) for CPU tests."""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig
from . import (
    glm4_9b, llama3_2_3b, mistral_nemo_12b, mixtral_8x22b, moonshot_v1_16b_a3b,
    phi3_vision_4_2b, qwen2_7b, rwkv6_3b, serve_moe, whisper_small,
    zamba2_2_7b,
)

ARCHS = {
    "qwen2-7b": qwen2_7b.config,
    "llama3.2-3b": llama3_2_3b.config,
    "mistral-nemo-12b": mistral_nemo_12b.config,
    "glm4-9b": glm4_9b.config,
    "moonshot-v1-16b-a3b": moonshot_v1_16b_a3b.config,
    "mixtral-8x22b": mixtral_8x22b.config,
    "rwkv6-3b": rwkv6_3b.config,
    "whisper-small": whisper_small.config,
    "zamba2-2.7b": zamba2_2_7b.config,
    "phi-3-vision-4.2b": phi3_vision_4_2b.config,
}

# auxiliary configs: resolvable by name but outside the assigned-arch sweep
# registry (ARCHS drives the benchmark matrix; these drive demos/serving)
AUX_CONFIGS = {
    "serve-moe": serve_moe.config,
}


def get_config(arch: str) -> ModelConfig:
    if arch in ARCHS:
        return ARCHS[arch]()
    if arch in AUX_CONFIGS:
        return AUX_CONFIGS[arch]()
    raise KeyError(
        f"unknown arch {arch!r}; choose from "
        f"{sorted([*ARCHS, *AUX_CONFIGS])}"
    )


def reduced_config(arch: str, dtype: str = "float32") -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: few layers, small width,
    few experts, tiny vocab — structure preserved."""
    cfg = get_config(arch)
    hd = 32
    heads = 4
    kv = max(1, min(cfg.num_kv_heads * heads // cfg.num_heads, heads))
    upd: dict = dict(
        num_layers=2, d_model=128, num_heads=heads, num_kv_heads=kv,
        d_ff=256, vocab_size=512, head_dim=hd, dtype=dtype, remat=False,
        ssm_chunk=16,
    )
    if cfg.family == "ssm":  # rwkv: d_model must be a multiple of 64
        upd.update(num_heads=2, num_kv_heads=2, head_dim=64)
    if cfg.family == "hybrid":
        upd.update(num_layers=4, shared_attn_period=2, ssm_state=16, head_dim=32)
    if cfg.is_moe:
        upd.update(num_experts=4, experts_per_token=2, moe_d_ff=64)
    if cfg.family == "encdec":
        upd.update(encoder_layers=2, encoder_frames=16)
    if cfg.family == "vlm":
        upd.update(num_patches=8)
    if cfg.sliding_window:
        upd.update(sliding_window=16)
    return dataclasses.replace(cfg, **upd)
