"""Architecture config: one dataclass covers all 10 assigned families."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None

    # attention variants
    qkv_bias: bool = False  # qwen2
    rope_theta: float = 1_000_000.0
    rope_fraction: float = 1.0  # glm4/phi3 partial rotary
    sliding_window: int | None = None  # mixtral SWA
    norm_eps: float = 1e-5
    act: str = "swiglu"  # swiglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    pos_emb: str = "rope"  # rope | sinusoidal (whisper)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int | None = None
    capacity_factor: float = 1.25
    moe_dispatch: str | None = None  # ep_push | ep_pull | tp | None=auto

    # SSM / RWKV
    ssm_state: int = 0  # mamba2 state size N / rwkv head size
    ssm_heads: int = 0
    ssm_chunk: int = 256  # chunked-scan block for training shapes

    # hybrid (zamba2): one shared attention block applied every period layers
    shared_attn_period: int = 0

    # enc-dec (whisper): encoder backbone + stub frame frontend
    encoder_layers: int = 0
    encoder_frames: int = 0  # precomputed frame embeddings (stub conv frontend)

    # vlm (phi3v): stub patch embeddings prepended to the token stream
    num_patches: int = 0

    dtype: str = "bfloat16"
    remat: bool = True  # activation checkpointing of each block under grad (training)
    # padded-head tensor parallelism of the JAX package's mesh path; the port
    # has no mesh, so nothing reads it here (kept so both packages' configs
    # have the same fields)
    tp_pad_heads: bool = False
    # attention backend at prefill: "reference" (plain PyTorch, dense or
    # q-chunked) or "flash" (the CUDA kernel csrc/flash_attn.cu on the card,
    # its plain blockwise version on the CPU)
    attn_impl: str = "reference"

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def param_count(self) -> int:
        """Non-embedding parameter count (for MODEL_FLOPS accounting)."""
        d, hd = self.d_model, self.hd
        if self.family == "ssm":  # rwkv6
            per_layer = (
                4 * d * d  # r,k,v,g (time-mix)
                + d * d  # output
                + 2 * d * self.d_ff // 2 + self.d_ff // 2 * 0  # placeholder
                + d * self.d_ff + self.d_ff * d + d * d  # channel-mix k,v,r
            )
            return self.num_layers * per_layer
        att = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) + (self.num_heads * hd) * d
        if self.is_moe:
            fe = self.moe_d_ff or self.d_ff
            ffn = self.num_experts * 3 * d * fe + d * self.num_experts
        else:
            n_mats = 3 if self.act == "swiglu" else 2
            ffn = n_mats * d * self.d_ff
        layers = self.num_layers * (att + ffn)
        if self.family == "encdec":
            layers += self.encoder_layers * (att + ffn) + self.num_layers * att  # cross-attn
        if self.family == "hybrid" and self.shared_attn_period:
            layers += att  # the single shared attention block
        return layers

    @property
    def active_param_count(self) -> int:
        """Active (per-token) params — MoE uses experts_per_token of num_experts."""
        if not self.is_moe:
            return self.param_count
        d = self.d_model
        hd = self.hd
        att = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) + (self.num_heads * hd) * d
        fe = self.moe_d_ff or self.d_ff
        ffn = self.experts_per_token * 3 * d * fe + d * self.num_experts
        return self.num_layers * (att + ffn)
