"""One module per op of the program: ``bench/ops/<op>.py`` holds a ``Cell``
class that builds a configuration's inputs on a device from a seed, makes
the requests of the window, counts their frozen useful and roofline bytes,
and checks sampled results against ``bench/reference/<op>.py``.

A ``Cell`` has ``tags`` (how many distinct inputs its requests cycle
through), ``substrate`` (set by the harness), ``request(client, i) ->
(Request, tag)``, ``useful_bytes(tag)``, ``roofline_bytes(tag)``,
``check([(tag, result)]) -> {name: number}``, ``control(tag) -> result``,
``lines(median_ms_by_tag) -> [str]`` and ``baseline_ms()``; optionally
``roofline_ops(tag)``, the least float32 operations a request must do,
counted by a function of the op's module as its roofline bytes are, and
counted as ``bench/peaks.json``'s peak counts them: 2 for every float32 lane
instruction, an add, min, multiply or compare as well as an FMA. A ``Cell``
without it is bound by bytes alone.
"""
from __future__ import annotations

from repro_torch.core.strategies import Comm, Layout, MigratoryStrategy, Scheme

_ENUMS = {"comm": Comm, "layout": Layout, "scheme": Scheme}


def strategy(fields: dict) -> MigratoryStrategy:
    """A configuration's ``strategy`` object as the program's type."""
    return MigratoryStrategy(**{k: _ENUMS[k](v) if k in _ENUMS else v for k, v in fields.items()})
