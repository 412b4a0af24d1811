"""The decoder-only LM (dense family) for serving: config, layers,
transformer and the family-dispatching API."""
from . import api
from .config import ModelConfig
from .layers import Ctx
