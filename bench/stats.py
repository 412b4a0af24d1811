"""Window statistics over every request of a run: no chunking, no sampling.

Each request is a :class:`Sample` on the host clock. A rate is all the useful
bytes the window completed over all of its time; a percentile is taken over
all requests, failed ones included (a failed request counts as missing any
latency limit, so it is given an infinite latency).
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Sample:
    """One request: ``t0``/``t1`` on ``time.perf_counter`` from the call to
    its return, ``service_s`` the ``RunReport.seconds`` the program reported
    for it (None when it failed), ``tag`` which of the cell's inputs it
    carried (the useful bytes are a function of the inputs alone)."""

    client: int
    tag: int
    t0: float
    t1: float
    service_s: "float | None"
    ok: bool

    @property
    def latency_s(self) -> float:
        return self.t1 - self.t0 if self.ok else math.inf


def percentile(values: "list[float]", q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default), over every value given."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    if v[hi] == math.inf:
        return math.inf if pos > lo or v[lo] == math.inf else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def window_seconds(samples: "list[Sample]", t_start: float) -> float:
    """From the window's start to the return of its last request: the
    clients stop issuing at the deadline and every request issued before it
    is waited for, so the window holds all the work and all its time."""
    return max(s.t1 for s in samples) - t_start


def useful_gbps(samples: "list[Sample]", t_start: float, bytes_of: "dict[int, int]") -> float:
    """Useful bytes of every completed request over the window, in GB/s;
    ``bytes_of`` maps a tag to its inputs' frozen byte count."""
    total = sum(bytes_of[s.tag] for s in samples if s.ok)
    return total / window_seconds(samples, t_start) / 1e9


def p95_ms(samples: "list[Sample]") -> float:
    return percentile([s.latency_s for s in samples], 95.0) * 1e3


def median_ms(samples: "list[Sample]") -> float:
    return percentile([s.latency_s for s in samples], 50.0) * 1e3


def host_overhead_ms(samples: "list[Sample]") -> "float | None":
    """Median over completed requests of the client's latency less the
    program's own ``RunReport.seconds``: in a closed loop over ``engine.run``
    the entry's host work, through the service the serving plane's wait."""
    gaps = [(s.t1 - s.t0 - s.service_s) * 1e3 for s in samples if s.ok and s.service_s is not None]
    return percentile(gaps, 50.0) if gaps else None
