from .pipeline import DataConfig, SyntheticTokens
