"""whisper-small [audio]: enc-dec, conv frontend STUB (precomputed frame
embeddings) [arXiv:2212.04356; unverified]."""
from ..models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec", num_layers=12, d_model=768,
        num_heads=12, num_kv_heads=12, d_ff=3072, vocab_size=51865,
        head_dim=64, norm="layernorm", act="gelu", pos_emb="sinusoidal",
        encoder_layers=12, encoder_frames=1500,
    )
