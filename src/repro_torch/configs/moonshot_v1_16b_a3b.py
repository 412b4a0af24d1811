"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 experts top-6
[hf:moonshotai/Moonlight-16B-A3B; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe", num_layers=48, d_model=2048,
        num_heads=16, num_kv_heads=16, d_ff=1408, vocab_size=163840,
        head_dim=128, rope_theta=5e4,
        num_experts=64, experts_per_token=6, moe_d_ff=1408,
    )
