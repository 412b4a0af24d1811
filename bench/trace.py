"""The traced run's reduction: ``torch.profiler`` events of the window to
device busy time, kernel totals and named idle gaps.

The window is the benchmark's own ``bench.window`` annotation; every device
operation (kernel, copy, set) that overlaps it counts, clipped to it. The
device is busy where at least one operation runs (the union of their
intervals, so operations overlapping on several streams count once).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "bench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_op_s: float  # sum of every device op's duration (overlaps counted each)
    device_ops: "list[list]"  # [name, seconds] summed by name, largest first
    idle_gaps: "list[list]"  # [host activity, idle seconds under it], largest first
    n_device_ops: int


def _union(intervals: "list[tuple[float, float]]") -> "list[tuple[float, float]]":
    """Sorted (start, end) rows -> merged, disjoint intervals."""
    merged: "list[tuple[float, float]]" = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1] = (merged[-1][0], e)
        else:
            merged.append((s, e))
    return merged


def _innermost(names, starts, ends, t: float, reach: int = 256) -> str:
    """The name of the latest-starting host event that still runs at ``t``
    (the innermost, where events nest), looking back ``reach`` events."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - reach), -1):
        if ends[j] >= t:
            return names[j]
    return "host"


def _columns(events) -> "tuple[list, list, list]":
    """(names, starts, ends) of events sorted by start."""
    ev = sorted(events, key=lambda h: h[1])
    return [h[0] for h in ev], [h[1] for h in ev], [h[2] for h in ev]


def reduce_events(window: "tuple[float, float]", device: "list[tuple[str, float, float]]",
                  host: "list[tuple[str, float, float]]",
                  spans: "list[tuple[str, float, float]]" = (), top: int = 10) -> Trace:
    """``window`` (start, end) and events (name, start, end), all in seconds
    on one clock. Every idle gap of the window takes the name of the
    innermost host operation under its midpoint, else of the benchmark's
    innermost span there (``spans``: the program's Python between its
    operations), else "host"; ``idle_gaps`` sums the idle seconds by that
    name, largest first."""
    w0, w1 = window
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    totals: "collections.Counter[str]" = collections.Counter()
    for n, s, e in dev:
        totals[n] += e - s
    merged = _union(sorted((s, e) for _, s, e in dev))
    busy = sum(e - s for s, e in merged)
    edges = [w0] + [t for se in merged for t in se] + [w1]
    ops = _columns(host)
    marks = _columns(spans)
    idle: "collections.Counter[str]" = collections.Counter()
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 > g0:
            mid = (g0 + g1) / 2
            name = _innermost(*ops, mid)
            if name == "host":
                name = _innermost(*marks, mid, reach=8)
            idle[name] += g1 - g0
    return Trace(
        window_s=w1 - w0, busy_s=busy, device_op_s=float(sum(totals.values())),
        device_ops=[[n, s] for n, s in totals.most_common(top)],
        idle_gaps=[[n, s] for n, s in idle.most_common(top)], n_device_ops=len(dev),
    )


def reduce_profile(prof) -> "Trace | None":
    """Reduce a finished ``torch.profiler.profile``; None when it holds no
    window annotation or no device operation (the profiler saw no card)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    window = None
    device, host, spans = [], [], []
    for e in events:
        s, t = e.start_ns() * 1e-9, e.end_ns() * 1e-9
        if e.device_type() != DeviceType.CPU:
            if not e.name().startswith("bench."):  # not the GPU shadow of an annotation
                device.append((e.name(), s, t))
        elif e.name() == WINDOW:
            window = (s, t)
        elif e.name().startswith("bench."):
            spans.append((e.name(), s, t))
        else:
            host.append((e.name(), s, t))
    if window is None or not device:
        return None
    return reduce_events(window, device, host, spans)
