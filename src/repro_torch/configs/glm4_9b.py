"""glm4-9b [dense]: RoPE (partial rotary), GQA kv=2 [hf:THUDM/glm-4-9b; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="glm4-9b", family="dense", num_layers=40, d_model=4096,
        num_heads=32, num_kv_heads=2, d_ff=13696, vocab_size=151552,
        head_dim=128, qkv_bias=True, rope_theta=1e4, rope_fraction=0.5,
    )
