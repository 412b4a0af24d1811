"""``roofline_percent`` over a synthetic traced run: an op that counts no
operations reads the bytes-only bound; operations bind a request where their
time at the float32 peak is the longer; and the share never passes 100 where
the device time covers the bound."""
import random
import types

import pytest

from bench import harness
from bench.stats import Sample

BW, FLOPS = 3.35e12, 6.7e13
TAGS = (0, 1, 0, 1, 0)


def traced(roofline_bytes, roofline_ops, device_op_s, flops=FLOPS):
    """Five requests done within the traced part (tags ``TAGS``), one that
    failed there and one that returned after it: neither of the last two counts."""
    samples = [Sample(0, tag, 0.1 * i, 0.1 * i + 0.05, 0.04, True) for i, tag in enumerate(TAGS)]
    samples += [Sample(0, 1, 0.6, 0.65, None, False), Sample(0, 0, 0.9, 2.0, 1.0, True)]
    return harness.Run(op="op", mix={}, cell=None, samples=samples, t_start=0.0, setup_s=1.0,
                       bytes_of=roofline_bytes, roofline_bytes_of=roofline_bytes,
                       roofline_ops_of=roofline_ops, trace=types.SimpleNamespace(device_op_s=device_op_s),
                       trace_end=1.0, peak_bytes_per_s=BW, peak_flops_per_s=flops)


def bytes_only(roofline_bytes, device_op_s):
    """The expression the harness used before it had an operations bound."""
    return 100.0 * (sum(roofline_bytes[t] for t in TAGS) / BW) / device_op_s


@pytest.mark.parametrize("ops", [{}, {0: 0, 1: 0}], ids=["no_ops", "zero_ops"])
@pytest.mark.parametrize("flops", [FLOPS, None], ids=["fp32_peak", "no_fp32_peak"])
def test_no_operations_read_the_bytes_only_share(ops, flops):
    # the per-request sum may round otherwise than the bytes' sum over the peak, by an ulp or so
    nbytes = {0: 14_242_315_104, 1: 276_822_000}
    for device_op_s in (0.0013381, 0.0097, 3.1e-3):
        got = harness.roofline_percent(traced(nbytes, ops, device_op_s, flops), "op")
        assert got == pytest.approx(bytes_only(nbytes, device_op_s), rel=1e-12)
    # a card without a float32 peak keeps the bytes-only bound whatever the op counts
    got = harness.roofline_percent(traced(nbytes, {0: 10**12, 1: 10**12}, 0.0097, None), "op")
    assert got == pytest.approx(bytes_only(nbytes, 0.0097), rel=1e-12)


def test_operations_bind_where_their_time_is_the_longer():
    # tag 0 like GSANA's sigma: 7.8 G lane instructions, counted 2 each (0.233 ms), over
    # 50 MB (0.015 ms); tag 1 bytes-bound
    nbytes, ops = {0: 50_000_000, 1: 50_000_000}, {0: 15_600_000_000, 1: 1000}
    got = harness.roofline_percent(traced(nbytes, ops, 0.001), "op")
    assert got == pytest.approx(100.0 * (3 * 15.6e9 / FLOPS + 2 * 5e7 / BW) / 0.001, rel=1e-12)
    assert got > 5 * bytes_only(nbytes, 0.001)


def test_the_share_never_passes_100_where_device_time_covers_the_bound():
    rng = random.Random(31)
    for _ in range(200):
        nbytes = {t: rng.randrange(1, 10**9) for t in (0, 1)}
        ops = {t: rng.choice((0, rng.randrange(1, 10**11))) for t in (0, 1)}
        bound = sum(max(nbytes[t] / BW, ops[t] / FLOPS) for t in TAGS)
        # at the bound itself, 100 up to the rounding of 100 * bound / time
        at = harness.roofline_percent(traced(nbytes, ops, bound), "op")
        assert at == pytest.approx(100.0, rel=1e-15)
        for over in (1.0 + 1e-9, 1.5, 40.0):
            assert harness.roofline_percent(traced(nbytes, ops, bound * over), "op") <= 100.0


def test_another_op_or_an_untraced_run_reads_nothing():
    run = traced({0: 1, 1: 1}, {}, 0.001)
    assert harness.roofline_percent(run, "other") is None
    run.trace = None
    assert harness.roofline_percent(run, "op") is None
