"""The decoder-only LM (dense and MoE families) for serving: config,
layers, the MoE sublayer, transformer and the family-dispatching API."""
from . import api
from .config import ModelConfig
from .layers import Ctx
