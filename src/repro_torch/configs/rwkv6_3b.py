"""rwkv6-3b [ssm]: Finch — data-dependent decay, attention-free
[arXiv:2404.05892; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm", num_layers=32, d_model=2560,
        num_heads=40, num_kv_heads=40, d_ff=8960, vocab_size=65536,
        head_dim=64, ssm_chunk=128,
    )
