"""Percentiles and rates over every request of a synthetic window."""
import math

import pytest

from bench import stats
from bench.stats import Sample


def window(lat_ms):
    """Back-to-back requests of one client from t = 0, all tagged 0, each
    reporting half its latency as the program's own seconds."""
    out, t = [], 0.0
    for ms in lat_ms:
        d = ms * 1e-3
        out.append(Sample(0, 0, t, t + d, d * 0.5, True))
        t += d
    return out


def test_percentile_interpolates_like_numpy():
    v = [float(x) for x in range(1, 101)]
    assert stats.percentile(v, 50) == pytest.approx(50.5)
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0


def test_rate_and_tail_over_all_requests():
    s = window([1.0] * 100)
    assert stats.useful_gbps(s, 0.0, {0: 10**6}) == pytest.approx(100 * 1e6 / 0.1 / 1e9)
    assert stats.p95_ms(s) == pytest.approx(1.0)
    assert stats.host_overhead_ms(s) == pytest.approx(0.5)


def test_a_stall_moves_both_rate_and_tail():
    calm = window([1.0] * 100)
    # a 300 ms stall of the host, spread over six consecutive requests
    stalled = window([1.0] * 50 + [51.0] * 6 + [1.0] * 44)
    assert stats.useful_gbps(stalled, 0.0, {0: 1}) < stats.useful_gbps(calm, 0.0, {0: 1}) / 3
    assert stats.p95_ms(stalled) > 50.0 > 1.0 == pytest.approx(stats.p95_ms(calm))


def test_a_failed_request_counts_as_missing_every_limit():
    s = window([1.0] * 19) + [Sample(0, 0, 1.0, 1.001, None, False)]
    assert stats.p95_ms(s) == math.inf
    assert stats.useful_gbps(s, 0.0, {0: 1}) == pytest.approx(19 / 1.001 / 1e9)


def test_trace_reduction_unions_clips_and_names_idle_time():
    from bench.trace import reduce_events

    device = [("k", 1.0, 2.0), ("k", 1.5, 3.0), ("m", 5.0, 6.0), ("m", 9.5, 11.0)]
    host = [("a", 0.0, 4.0), ("b", 3.2, 3.8), ("c", 6.0, 9.0)]
    t = reduce_events((0.0, 10.0), device, host)
    # busy: [1, 3] and [5, 6] and [9.5, 10] (clipped): 3.5 s of 10
    assert t.busy_s == pytest.approx(3.5) and t.window_s == 10.0
    assert t.device_op_s == pytest.approx(1.0 + 1.5 + 1.0 + 0.5)
    assert t.device_ops[0] == ["k", pytest.approx(2.5)]
    # gaps [0, 1] and [3, 5] under "a"; [6, 9.5] under "c"
    assert dict((n, s) for n, s in t.idle_gaps) == {"a": pytest.approx(3.0), "c": pytest.approx(3.5)}
    # a gap under no operation takes the benchmark's span there, else "host"
    t = reduce_events((0.0, 10.0), device, [("c", 6.0, 9.0)], [("bench.request", 0.0, 4.5)])
    assert dict((n, s) for n, s in t.idle_gaps) == {
        "bench.request": pytest.approx(3.0), "c": pytest.approx(3.5)}
