"""phi-3-vision-4.2b [vlm]: phi3-mini backbone + CLIP patch STUB
[hf:microsoft/Phi-3-vision-128k-instruct; hf]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b", family="vlm", num_layers=32, d_model=3072,
        num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=32064,
        head_dim=96, rope_theta=1e4, num_patches=576,
    )
