"""Fault-tolerant training supervisor: checkpoint/restart, simulated failure
injection, straggler accounting.

The supervisor owns the loop:

  run -> [failure] -> restore latest checkpoint -> rebuild the model and
  optimizer -> replay the deterministic data stream from the restored step
  -> continue.

Failures are simulated by raising at a chosen step. The JAX package's
elastic re-meshing (``runtime/elastic.py``) needs a mesh, which the port does
not have yet. :class:`ProcessSupervisor` is the same restart policy over OS
processes, host-only.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable

from ..checkpoint import store

log = logging.getLogger("repro_torch.supervisor")


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3
    max_restarts: int = 3
    total_steps: int = 200


@dataclasses.dataclass
class RunResult:
    final_step: int
    restarts: int
    losses: list
    step_times: list  # per-step wall time (straggler accounting)


class Failure(RuntimeError):
    """Injected node failure."""


def run_supervised(
    cfg: SupervisorConfig,
    *,
    build: Callable[[], tuple[Any, Any, Callable]],
    data_for_step: Callable[[int], dict],
    fail_at: int | None = None,
) -> RunResult:
    """Run the training loop under supervision.

    ``build()`` -> (params, opt_state, step_fn); called fresh after every
    restart, and the latest checkpoint is restored into what it returns.
    ``step_fn(params, opt_state, batch)`` -> (params, opt_state, metrics)
    with ``metrics["loss"]``, which is read to the host each step (the
    step's synchronization, so the step time is the device's).
    ``fail_at``: inject a Failure the first time that step is reached.
    """
    restarts = 0
    losses: list[float] = []
    times: list[float] = []
    failed_once = False
    while True:
        params, opt_state, step_fn = build()
        start = store.latest_step(cfg.ckpt_dir)
        step = 0
        if start is not None:
            params, opt_state = store.restore(
                cfg.ckpt_dir, start, (params, opt_state)
            )
            step = start + 1
            log.info("restored checkpoint step=%d", start)
        ckpt = store.AsyncCheckpointer(cfg.ckpt_dir, keep=cfg.keep)
        try:
            while step < cfg.total_steps:
                if fail_at is not None and step == fail_at and not failed_once:
                    failed_once = True
                    raise Failure(f"injected failure at step {step}")
                t0 = time.perf_counter()
                batch = data_for_step(step)
                params, opt_state, metrics = step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])  # waits for the step
                times.append(time.perf_counter() - t0)
                losses.append(loss)
                if step % cfg.ckpt_every == 0 and step > 0:
                    ckpt.save(step, (params, opt_state))
                step += 1
            ckpt.save(cfg.total_steps - 1, (params, opt_state))
            ckpt.wait()
            return RunResult(
                final_step=step - 1, restarts=restarts, losses=losses,
                step_times=times,
            )
        except Failure as e:
            restarts += 1
            log.warning("failure: %s (restart %d)", e, restarts)
            ckpt.wait()
            if restarts > cfg.max_restarts:
                raise
        except Exception:
            ckpt.wait()
            raise


@dataclasses.dataclass
class ProcessEvent:
    """One supervision observation: a watched process exited."""

    name: str
    returncode: "int | None"
    restarted: bool
    restarts: int


class ProcessSupervisor:
    """The restart half of the supervisor, generalized to OS processes.

    :func:`run_supervised` supervises a training loop in-process; a
    cluster launcher needs the same policy —
    bounded restarts, audible exits — over worker *subprocesses*. The
    supervisor stays transport-agnostic: ``watch()`` takes the process
    handle plus ``alive``/``restart`` callables (the launch backend's),
    and :meth:`poll` reports exits as :class:`ProcessEvent`\\ s, invoking
    ``restart`` while the per-process budget (``max_restarts``) lasts.
    ``max_restarts=0`` is pure exit detection — the cluster coordinator's
    failover handles the work; the supervisor handles the *process*.
    """

    def __init__(self, max_restarts: int = 0):
        self.max_restarts = max_restarts
        self._watched: dict[str, dict] = {}

    def watch(
        self,
        name: str,
        handle: Any,
        *,
        alive: Callable[[Any], bool],
        restart: "Callable[[], Any] | None" = None,
    ) -> None:
        self._watched[name] = {
            "handle": handle, "alive": alive, "restart": restart,
            "restarts": 0, "down": False,
        }

    def handles(self) -> "dict[str, Any]":
        return {name: w["handle"] for name, w in self._watched.items()}

    def poll(self) -> "list[ProcessEvent]":
        """Check every watched process once; restart the dead within
        budget. Idempotent on processes already seen down."""
        events: list[ProcessEvent] = []
        for name, w in self._watched.items():
            if w["down"] or w["alive"](w["handle"]):
                continue
            returncode = getattr(w["handle"], "returncode", None)
            can_restart = (
                w["restart"] is not None and w["restarts"] < self.max_restarts
            )
            if can_restart:
                w["restarts"] += 1
                w["handle"] = w["restart"]()
                log.warning(
                    "process %s exited (rc=%s); restarted (%d/%d)",
                    name, returncode, w["restarts"], self.max_restarts,
                )
            else:
                w["down"] = True
                log.warning(
                    "process %s exited (rc=%s); restart budget exhausted",
                    name, returncode,
                )
            events.append(
                ProcessEvent(name, returncode, can_restart, w["restarts"])
            )
        return events


def straggler_report(step_times: list, threshold: float = 1.5) -> dict:
    """Flag steps slower than threshold x median — the metric a straggler
    mitigation (re-balance/evict) loop watches."""
    if not step_times:
        return {"median": 0.0, "stragglers": 0, "worst_ratio": 0.0}
    s = sorted(step_times)
    med = s[len(s) // 2]
    worst = max(step_times) / max(med, 1e-9)
    count = sum(1 for t in step_times if t > threshold * med)
    return {"median": med, "stragglers": count, "worst_ratio": worst}
