"""Continuous-batched MoE decode serving over the engine.

:class:`DecodeServer` drives the ``moe_decode`` op as a serving loop with a
fixed batch capacity of B slots (static shapes, one plan for the whole
session). Sequences join a free slot mid-session and leave when finished;
per-slot KV caches (tensors on the server's device) and position cursors
(host numpy, like the tokens, until each step's request is built) are
carried across submits, so each :meth:`step` is one engine request for the
*current* batch composition — the continuous-batching contract.

Prefill is served through the decode path: a sequence's prompt tokens are
fed one per step ("forced" tokens) before greedy argmax takes over. That
keeps every step a single uniform ``moe_decode`` submit, which is what makes
oracle parity checkable: an oracle-mode server fed the same join/leave
schedule replays identical padded batches, so served tokens must match
token-for-token in every dispatch mode.

Execution routes per construction:

- ``service=EngineService(...)``: each step submits one
  :class:`~repro_torch.engine.request.Request` (batch mode drains per step;
  worker mode blocks on the future; on the card the step runs on a worker's
  own stream) — the production path, with the service's QoS/SLO accounting.
- ``service=None``: one direct ``engine.run`` call per step.
- ``oracle=True``: :func:`~repro_torch.engine.decode_op.moe_decode_reference`
  on the caller's stream — the parity baseline.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any

import numpy as np
import torch

from ..core.strategies import MigratoryStrategy
from ..device import resolve_device, to_numpy
from ..models.layers import dtype_of
from .decode_op import MoEDecodeInputs, moe_decode_reference
from .request import Request
from .substrate import Substrate, substrate_classes


@dataclasses.dataclass
class _Sequence:
    id: int
    slot: int
    first_token: int
    forced: list  # remaining prompt tokens to feed before sampling
    forced_idx: int
    max_new_tokens: int
    generated: list


class DecodeServer:
    """Serve greedy decode for concurrent sequences over one engine op.

    ``capacity`` is the fixed batch width B (must divide by ``nodelets``);
    ``max_len`` the per-slot KV length. ``add()`` joins a sequence (queued
    FIFO when all slots are busy), ``step()`` advances every active slot by
    one token, ``run_until_drained()`` loops until everything finished.
    Finished outputs land in ``results[seq_id]``. The caches live on
    ``device`` (default the card; ``params`` must lie there too), and a
    substrate given by name is built there.
    """

    def __init__(
        self,
        cfg,
        params: dict,
        *,
        capacity: int = 8,
        max_len: int = 32,
        nodelets: int = 1,
        strategy: "MigratoryStrategy | str | None" = None,
        substrate: "Substrate | str" = "local",
        service: Any = None,
        oracle: bool = False,
        qos: "float | None" = None,
        timeout: "float | None" = None,
        device: "str | torch.device" = "cuda",
    ) -> None:
        if capacity % nodelets != 0:
            raise ValueError(f"capacity must divide by nodelets, got {capacity} % {nodelets}")
        if oracle and isinstance(strategy, str):
            raise ValueError(
                "oracle mode needs a concrete strategy (or None), not "
                f"{strategy!r} — the oracle has no autotuner"
            )
        self.device = resolve_device(device)
        if isinstance(substrate, str):
            classes = substrate_classes()
            if substrate not in classes:
                raise ValueError(f"unknown substrate {substrate!r}; registered: {sorted(classes)}")
            substrate = classes[substrate](self.device)
        self.cfg = cfg
        self.params = params
        self.capacity = capacity
        self.max_len = max_len
        self.nodelets = nodelets
        self.strategy = strategy
        self.substrate = substrate
        self.service = service
        self.oracle = oracle
        self.qos = qos
        self.timeout = timeout
        shape = (capacity, max_len, int(cfg.d_model))
        self._k = torch.zeros(shape, dtype=dtype_of(cfg), device=self.device)
        self._v = torch.zeros(shape, dtype=dtype_of(cfg), device=self.device)
        # padded slots decode token 0 at position 0 deterministically
        self._tokens = np.zeros((capacity,), np.int32)
        self._positions = np.zeros((capacity,), np.int32)
        self._slots: "list[_Sequence | None]" = [None] * capacity
        self._waiting: deque = deque()
        self._next_id = 0
        self.results: dict[int, list[int]] = {}
        self.steps = 0

    # -- admission -------------------------------------------------------------

    def add(self, prompt: "list[int]", max_new_tokens: int = 8) -> int:
        """Join a sequence: first prompt token becomes the slot's current
        token, the rest are forced through the decode path. Returns seq id."""
        if not prompt:
            raise ValueError("prompt must be non-empty")
        if len(prompt) + max_new_tokens > self.max_len:
            raise ValueError(
                f"prompt+generation ({len(prompt)}+{max_new_tokens}) exceeds "
                f"max_len {self.max_len}"
            )
        seq = _Sequence(
            id=self._next_id, slot=-1, first_token=int(prompt[0]),
            forced=[int(t) for t in prompt[1:]], forced_idx=0,
            max_new_tokens=max_new_tokens, generated=[],
        )
        self._next_id += 1
        self._waiting.append(seq)
        self._admit()
        return seq.id

    def _admit(self) -> None:
        for slot in range(self.capacity):
            if not self._waiting:
                return
            if self._slots[slot] is None:
                seq = self._waiting.popleft()
                seq.slot = slot
                self._slots[slot] = seq
                self._tokens[slot] = seq.first_token
                self._positions[slot] = 0

    @property
    def active(self) -> int:
        return sum(s is not None for s in self._slots)

    @property
    def pending(self) -> int:
        return self.active + len(self._waiting)

    # -- the serving loop ------------------------------------------------------

    def step(self) -> "list[tuple[int, int]]":
        """One decode step for the whole batch. Returns the (seq_id, token)
        pairs *sampled* this step (prefill-forced steps emit nothing)."""
        if self.active == 0:
            return []
        inputs = MoEDecodeInputs(
            params=self.params,
            tokens=torch.tensor(self._tokens, device=self.device),
            k_cache=self._k,
            v_cache=self._v,
            positions=torch.tensor(self._positions, device=self.device),
            nodelets=self.nodelets,
            experts_per_token=self.cfg.experts_per_token,
            capacity_factor=self.cfg.capacity_factor,
            norm_eps=self.cfg.norm_eps,
        )
        logits, self._k, self._v = self._execute(inputs)
        logits = to_numpy(logits.float())
        emitted: list[tuple[int, int]] = []
        for seq in [s for s in self._slots if s is not None]:
            slot = seq.slot
            self._positions[slot] += 1
            if seq.forced_idx < len(seq.forced):
                nxt = seq.forced[seq.forced_idx]
                seq.forced_idx += 1
            else:
                nxt = int(np.argmax(logits[slot]))
                seq.generated.append(nxt)
                emitted.append((seq.id, nxt))
            self._tokens[slot] = nxt
            done = len(seq.generated) >= seq.max_new_tokens
            if done or int(self._positions[slot]) >= self.max_len - 1:
                self._retire(seq)
        self._admit()
        self.steps += 1
        return emitted

    def run_until_drained(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        steps = 0
        while self.pending > 0:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"decode did not drain in {max_steps} steps")
        return self.results

    def _retire(self, seq: _Sequence) -> None:
        self.results[seq.id] = seq.generated
        self._slots[seq.slot] = None
        self._tokens[seq.slot] = 0
        self._positions[seq.slot] = 0

    # -- execution routes ------------------------------------------------------

    def _execute(self, inputs: MoEDecodeInputs) -> tuple:
        if self.oracle:
            return moe_decode_reference(inputs, self.strategy)
        request = Request(
            "moe_decode", inputs, strategy=self.strategy,
            substrate=self.substrate, qos=self.qos, timeout=self.timeout,
        )
        if self.service is None:
            from .runner import run

            result, _ = run(request, iters=1, warmup=0)
            return result
        out = self.service.submit(request)
        if isinstance(out, int):  # batch mode: ticket + drain
            for resp in self.service.drain():
                if resp.ticket == out:
                    return resp.result
            raise RuntimeError(f"drain lost ticket {out}")
        return out.result().result  # worker mode: future -> ServiceResponse
