"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
        num_heads=32, num_kv_heads=32, d_ff=10240, vocab_size=32000,
        head_dim=80, ssm_state=64, ssm_chunk=256, shared_attn_period=6,
    )
