"""qwen2-7b [dense]: GQA kv=4, QKV bias [arXiv:2407.10671; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense", num_layers=28, d_model=3584,
        num_heads=28, num_kv_heads=4, d_ff=18944, vocab_size=152064,
        head_dim=128, qkv_bias=True, rope_theta=1e6,
    )
