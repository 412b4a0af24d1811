"""serve-moe [moe]: compact single-block MoE decode-serving config — the
parameterization behind the engine's ``moe_decode`` op and the serving
walkthrough (DESIGN.md §1g). Dimensions small enough to serve on CPU in
tests and demos; float32 + no remat so served decode is bit-comparable to
the single-process oracle. 8 experts top-2 over up to 8 nodelets (ep
modes need experts % nodelets == 0)."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="serve-moe", family="moe", num_layers=1, d_model=32,
        num_heads=1, num_kv_heads=1, d_ff=64, vocab_size=256, head_dim=32,
        num_experts=8, experts_per_token=2, moe_d_ff=48,
        capacity_factor=1.5, dtype="float32", remat=False,
    )
