"""The LM families for serving and training: config, layers, the MoE
sublayer, the decoder-only transformer (dense, MoE, VLM), RWKV-6 (SSM),
Mamba-2 and Zamba2 (hybrid), Whisper (encoder-decoder) and the
family-dispatching API."""
from . import api
from .config import ModelConfig
from .layers import Ctx
