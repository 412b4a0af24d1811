from .registry import ARCHS, AUX_CONFIGS, get_config, reduced_config
