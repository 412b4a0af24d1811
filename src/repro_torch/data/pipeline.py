"""Deterministic, index-based, host-sharded synthetic token pipeline.

The JAX package's ``data/pipeline.py`` in numpy, kept here so that the port
imports nothing of it; every batch is bit-identical to the JAX package's for
the same ``(seed, step, row, host_id, num_hosts)``.

- **index-based determinism**: batch ``i`` is a pure function of (seed, i),
  so a restarted run replays the exact token stream from its checkpointed
  step;
- **host sharding**: each host materializes only its slice of the global
  batch (``host_id``/``num_hosts``);
- **packing**: documents of random length packed into fixed-length rows with
  EOS separators (so the LM sees realistic discontinuities).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 0
    mean_doc_len: int = 256
    # zipfian unigram skew — gives the loss something learnable
    zipf_a: float = 1.3


class SyntheticTokens:
    """Infinite deterministic stream of packed LM batches."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, num_hosts: int = 1):
        if cfg.global_batch % num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not split over {num_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts

    def _row(self, step: int, row: int) -> np.ndarray:
        """One packed (seq_len + 1,) row — pure function of (seed, step, row)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 0x9E3779B1 + step * 0x85EBCA77 + row) % (2**63)
        )
        out = np.empty(cfg.seq_len + 1, dtype=np.int32)
        pos = 0
        while pos < len(out):
            doc_len = max(1, int(rng.exponential(cfg.mean_doc_len)))
            n = min(doc_len, len(out) - pos)
            # zipf unigrams + a deterministic bigram structure (learnable)
            toks = rng.zipf(cfg.zipf_a, size=n) % (cfg.vocab_size - 1) + 1
            toks[1:] = np.where(
                rng.random(n - 1) < 0.5,
                (toks[:-1] * 31 + 7) % (cfg.vocab_size - 1) + 1,
                toks[1:],
            )
            out[pos : pos + n] = toks
            pos += n
            if pos < len(out):
                out[pos] = cfg.eos_id
                pos += 1
        return out

    def batch(self, step: int) -> np.ndarray:
        """Host-local slice of global batch ``step``: (local_batch, S + 1)."""
        rows = range(
            self.host_id * self.local_batch, (self.host_id + 1) * self.local_batch
        )
        return np.stack([self._row(step, r) for r in rows])

    def torch_batch(self, step: int, device) -> dict:
        """``{"tokens": (local_batch, S + 1) int32}`` on ``device``."""
        return {"tokens": torch.as_tensor(self.batch(step), device=device)}

    def global_batch_all_hosts(self, step: int) -> np.ndarray:
        """Testing helper: the full global batch (what all hosts union to)."""
        return np.stack([self._row(step, r) for r in range(self.cfg.global_batch)])
