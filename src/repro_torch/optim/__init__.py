from .adamw import AdamWConfig, AdamWState, apply_updates, global_norm, init, schedule
