"""The port's calibration plane against the JAX package's, on the CPU:
the machine file's lifecycle, alpha-beta fits, the performance model's
arithmetic, the predicted-seconds contract of the autotuner and the
runner, the probe store, and a quick calibration of this host's CPU.

Every test points both packages' machine and probe paths at files it owns
(an autouse fixture), so a calibration left on this host changes nothing.
"""
import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

import repro.engine as RE
import repro.machine as RM
from repro_torch.engine import (
    CudaSubstrate, LocalSubstrate, PlanCache, ProbeStore, Request, SpMVOp, autotune,
    build_plan, rank_strategies, run,
)
from repro_torch.machine import (
    COMM_CLASS,
    DEFAULT_PROFILE,
    AlphaBeta,
    MachineProfile,
    Peaks,
    PerformanceModel,
    SubstrateProfile,
    calibrate,
    default_machine,
    fingerprint_key,
    fit_latency_rate,
    load_machine,
    machine_fingerprint,
    reset_default_machine_cache,
)
from repro_torch.machine import microbench
from test_torch_autotune import SCENARIOS, bfs_inputs, inputs_for, spmv_inputs

CPU = "cpu"
KEY = ("spmv", ("local", "cpu"), ("remote_write", True, "hcb", "pair", None), (), "sig")


@pytest.fixture(autouse=True)
def _isolated_files(tmp_path, monkeypatch):
    """Both packages' machine and probe paths point at files that do not exist."""
    from repro_torch.engine import probes

    monkeypatch.setenv("REPRO_TORCH_MACHINE_PATH", str(tmp_path / "absent_machine.json"))
    monkeypatch.setenv("REPRO_TORCH_PROBES_PATH", str(tmp_path / "absent_probes.json"))
    monkeypatch.setenv("REPRO_MACHINE_PATH", str(tmp_path / "absent_ref_machine.json"))
    monkeypatch.setattr(probes, "_default_store", None)
    reset_default_machine_cache()
    RM.reset_default_machine_cache()
    yield
    reset_default_machine_cache()
    RM.reset_default_machine_cache()


def calibrated_profile(fingerprint=None) -> MachineProfile:
    """A synthetic calibrated profile (no measurement): plausible sustained
    rates, fingerprinted to this host unless told otherwise."""
    sub = SubstrateProfile(
        stream_bw=10e9,
        dispatch_overhead=20e-6,
        collectives={
            "all_gather": AlphaBeta(alpha=50e-6, beta=1.0 / 5e9),
            "all_to_all": AlphaBeta(alpha=40e-6, beta=1.0 / 6e9),
            "psum": AlphaBeta(alpha=50e-6, beta=1.0 / 5e9),
        },
        source="measured",
        gather_bw=3e9,
        scatter_bw=0.5e9,
    )
    return MachineProfile(
        fingerprint=fingerprint if fingerprint is not None else machine_fingerprint(),
        peaks=Peaks(flops=1e12, hbm_bw=10e9, ici_bw=5e9),
        substrates={"local": sub, "cuda": sub},
        host_parallel_capacity=1.8,
        calibrated=True,
        created="2026-08-09T00:00:00",
    )


@pytest.fixture
def calibrated_machine(tmp_path, monkeypatch):
    """A calibrated machine file installed as the port's process default."""
    path = calibrated_profile().save(tmp_path / "machine.json")
    monkeypatch.setenv("REPRO_TORCH_MACHINE_PATH", str(path))
    reset_default_machine_cache()
    return path


# -- machine file lifecycle ----------------------------------------------------


def test_machine_file_roundtrip(tmp_path):
    profile = calibrated_profile()
    loaded = load_machine(profile.save(tmp_path / "machine.json"))
    assert loaded == profile
    assert loaded.substrate("cuda").collective("all_to_all") == AlphaBeta(alpha=40e-6,
                                                                        beta=1.0 / 6e9)
    # the schema is the JAX package's: its loader reads the port's file
    ref = RM.MachineProfile.from_dict(json.loads((tmp_path / "machine.json").read_text()))
    assert ref.to_dict() == profile.to_dict()


def test_absent_machine_file_is_silent_none(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert load_machine(tmp_path / "never_written.json") is None


@pytest.mark.parametrize("payload", ['{"peaks": {', '{"peaks": null}', "{}", "null"])
def test_corrupt_machine_file_warns_and_falls_back(tmp_path, payload):
    path = tmp_path / "machine.json"
    path.write_text(payload)
    with pytest.warns(RuntimeWarning, match="corrupt machine file"):
        assert load_machine(path) is None


def test_newer_schema_machine_file_warns(tmp_path):
    blob = calibrated_profile().to_dict()
    blob["version"] = 999
    path = tmp_path / "machine.json"
    path.write_text(json.dumps(blob))
    with pytest.warns(RuntimeWarning, match="schema v999"):
        assert load_machine(path) is None


@pytest.mark.parametrize("foreign", [
    {"backend": "cuda", "device_count": 1, "device_kinds": ["NVIDIA H100 80GB HBM3"]},
    {"device_count": 424242},
])
def test_stale_fingerprint_rejected_unless_allowed(tmp_path, foreign):
    """A file measured on a card is never read on a host without one (and
    any other topology is refused alike)."""
    fp = dict(machine_fingerprint(), **foreign)
    path = calibrated_profile(fingerprint=fp).save(tmp_path / "machine.json")
    with pytest.warns(RuntimeWarning, match="different topology"):
        assert load_machine(path) is None
    assert load_machine(path, allow_stale=True) is not None


def test_fingerprint_names_backend_cards_and_cores(monkeypatch):
    fp = machine_fingerprint(CPU)
    assert set(fp) == {"backend", "device_count", "device_kinds", "cpu_count"}
    assert fp["backend"] == "cpu" and fp["cpu_count"] >= 1
    assert fingerprint_key(fp) == json.dumps(fp, sort_keys=True) and fingerprint_key(None) is None
    # on a host with a card, the host's own backend is the card's, so a CPU
    # calibration there is stale for it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "NVIDIA H100 80GB HBM3")
    card = machine_fingerprint()
    assert card["backend"] == "cuda" and card["device_kinds"] == ["NVIDIA H100 80GB HBM3"]
    assert machine_fingerprint(CPU)["backend"] == "cpu"
    assert calibrated_profile(fingerprint=machine_fingerprint(CPU)).stale()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        machine_fingerprint("cuda")


def test_default_profile_is_uncalibrated_with_h100_peaks():
    profile = default_machine()
    assert profile is DEFAULT_PROFILE and profile.calibrated is False
    assert profile.stale() is False  # the bundled default claims no topology
    assert DEFAULT_PROFILE.peaks == Peaks(flops=67e12, hbm_bw=3.35e12, ici_bw=900e9)
    assert set(DEFAULT_PROFILE.substrates) == {"local", "cuda"}
    assert profile.substrate("tpu-pod") == profile.substrate("local")


def test_default_machine_cache_tracks_mtime(tmp_path, monkeypatch):
    path = tmp_path / "machine.json"
    monkeypatch.setenv("REPRO_TORCH_MACHINE_PATH", str(path))
    reset_default_machine_cache()
    assert default_machine().calibrated is False
    calibrated_profile().save(path)
    assert default_machine().calibrated is True  # picked up without a reset


def test_port_never_reads_the_reference_machine_file(tmp_path, monkeypatch):
    path = calibrated_profile().save(tmp_path / "machine.json")
    monkeypatch.setenv("REPRO_MACHINE_PATH", str(path))
    reset_default_machine_cache()
    assert default_machine().calibrated is False


# -- alpha-beta fitting --------------------------------------------------------


def test_fit_latency_rate_recovers_synthetic_model():
    alpha, beta = 2e-4, 1.0 / 5e9
    sizes = [1e4, 1e5, 1e6, 1e7]
    fit = fit_latency_rate(sizes, [alpha + beta * n for n in sizes])
    assert fit.alpha == pytest.approx(alpha + beta * 1e4, rel=1e-9)  # the smallest's time
    assert fit.beta == pytest.approx(beta, rel=1e-6)
    assert fit.seconds(1e6, launches=2.0) == pytest.approx(2 * fit.alpha + beta * 1e6)


@pytest.mark.parametrize("sizes,times,beta", [
    ([1e4, 1e5, 1e6, 1e7], [3e-4, 2.5e-4, 4e-4, 2.1e-3], None),
    ([1e3, 1e4, 1e5], [1e-4, 1e-4, 1e-4], 0.0),  # pure latency
    ([1e3, 1e6], [5e-4, 1e-4], 0.0),  # decreasing: the rate clamped
    ([1e6, 1e3, 1e5], [2e-3, 1e-4, 3e-4], None),  # sizes in any order
    # large messages slowed far past the line, as gloo's on a loaded host:
    # the least-squares intercept of the JAX package's fit goes negative
    ([1 << 10, 1 << 16, 1 << 20, 1 << 22], [5e-5, 6e-5, 2e-3, 2.5e-2], None),
])
def test_fit_latency_rate_keeps_the_latency_and_stays_nonnegative(sizes, times, beta):
    fit = fit_latency_rate(sizes, times)
    assert fit.alpha == times[int(np.argmin(sizes))] > 0
    assert fit.beta >= 0.0 and (beta is None or fit.beta == beta)
    if beta is None:
        assert fit.beta > 0.0


def test_fit_latency_rate_needs_two_sizes_and_departs_from_the_reference_fit():
    for sizes in ([], [1024]):
        with pytest.raises(ValueError, match="two sizes"):
            fit_latency_rate(sizes, [1e-4] * len(sizes))
    sizes, slowed = [1 << 10, 1 << 16, 1 << 20, 1 << 22], [5e-5, 6e-5, 2e-3, 2.5e-2]
    assert RM.fit_alpha_beta(sizes, slowed).alpha == 0.0  # clamped: no latency left
    assert fit_latency_rate(sizes, slowed).alpha == 5e-5


# -- the performance model against the reference's ----------------------------


@pytest.mark.parametrize("op,case", SCENARIOS)
def test_predict_parts_equal_reference(op, case):
    """The same profile dict and the same inputs give the same prediction
    terms, to 1e-12 relative, for every candidate on ``local``; the ranking
    in predicted seconds is the reference's."""
    ref_in, port_in = inputs_for(op, case)
    profile = calibrated_profile()
    ref_profile = RM.MachineProfile.from_dict(profile.to_dict())
    model, ref_model = PerformanceModel(profile), RM.PerformanceModel(ref_profile)
    ranked = rank_strategies(op, port_in, substrate=LocalSubstrate(CPU), machine=profile)
    ref_ranked = RE.rank_strategies(op, ref_in, substrate="local", machine=ref_profile)
    assert [e.strategy.cache_key() for e in ranked] == [e.strategy.cache_key() for e in ref_ranked]
    for est, ref_est in zip(ranked, ref_ranked):
        parts = model.predict_parts(est, "local", bytes_moved=1e6, flops=1e9)
        ref_parts = ref_model.predict_parts(ref_est, "local", bytes_moved=1e6, flops=1e9)
        assert parts.keys() == ref_parts.keys()
        for name in parts:
            assert parts[name] == pytest.approx(ref_parts[name], rel=1e-12, abs=0), name
        assert est.predicted_seconds == pytest.approx(ref_est.predicted_seconds, rel=1e-12)
        assert sum(model.predict_parts(est, "local").values()) == pytest.approx(
            est.predicted_seconds, rel=1e-12)


def test_cuda_prediction_charges_the_kernels_declared_bytes():
    """On ``cuda`` the memory term is the kernel's own declaration (launches
    x bytes at its access class's rate), not the generic sweep."""
    profile = calibrated_profile()
    model = PerformanceModel(profile)
    for op, inputs in (("spmv", spmv_inputs("skewed")[1]), ("bfs", bfs_inputs("rmat")[1])):
        for est in rank_strategies(op, inputs, substrate=CudaSubstrate(CPU), machine=profile):
            mem = est.detail["substrate_memory"]["cuda"]
            launches = max(1.0, float(mem.get("launches", est.detail["collective_launches"])))
            assert op != "bfs" or launches == 1  # the whole search in one launch
            rate = profile.substrate("cuda").access_bw(mem["access"])
            parts = model.predict_parts(est, "cuda")
            assert parts["memory"] == pytest.approx(
                launches * mem["bytes_per_launch"] / rate, rel=1e-12)
            alpha = profile.substrate("cuda").collective(COMM_CLASS[est.strategy.comm]).alpha
            assert parts["collective_latency"] == pytest.approx(launches * alpha, rel=1e-12)
            assert model.predict_parts(est, "local")["memory"] == pytest.approx(
                max(1.0, float(est.detail["collective_launches"]))
                * est.detail["memory_bytes_per_launch"]
                / profile.substrate("local").access_bw(est.detail["memory_access"]), rel=1e-12)


# -- calibrated and uncalibrated engine behavior --------------------------------


def test_calibrated_auto_ranks_in_predicted_seconds(calibrated_machine):
    inputs, sub = spmv_inputs("laplacian")[1], LocalSubstrate(CPU)
    tuned = autotune("spmv", inputs, sub)
    assert tuned.ranked_by == "predicted_seconds"
    assert all(c.predicted_seconds is not None for c in tuned.candidates)
    assert "predicted_seconds" in tuned.table()[0]
    _, rep = run(Request("spmv", inputs, "auto", sub), cache=PlanCache())
    assert rep.strategy["replicate_x"] is True  # same pick, now in seconds
    assert rep.predicted_seconds is not None and rep.predicted_seconds > 0
    assert rep.model_error == pytest.approx(rep.predicted_seconds / rep.seconds)
    plan = build_plan("spmv", inputs, "auto", sub)
    assert rep.predicted_seconds == PerformanceModel().predict_plan_seconds(SpMVOp(), plan)
    row = rep.to_dict()
    assert row["predicted_seconds"] == rep.predicted_seconds
    assert row["model_error"] == rep.model_error


def test_uncalibrated_fallback_is_bit_identical():
    """No machine file: rankings are the traffic units', reports carry no
    prediction columns, exactly as before the calibration plane."""
    ref_in, inputs = bfs_inputs("er")
    sub = LocalSubstrate(CPU)
    ranked = rank_strategies("bfs", inputs, substrate=sub)
    assert all(e.predicted_seconds is None for e in ranked)
    keys = [e.rank_key() for e in ranked]
    assert keys == sorted(keys)
    assert keys == [e.rank_key() for e in RE.rank_strategies("bfs", ref_in, substrate="local")]
    tuned = autotune("bfs", inputs, sub)
    assert tuned.ranked_by == "traffic_bytes"
    assert "predicted_seconds" not in tuned.table()[0]
    _, rep = run(Request("bfs", inputs, "auto", sub), cache=PlanCache())
    assert rep.predicted_seconds is None and rep.model_error is None
    row = rep.to_dict()
    assert "predicted_seconds" not in row and "model_error" not in row


# -- probe store ----------------------------------------------------------------


def test_probe_store_roundtrip_carries_this_machine(tmp_path):
    path = tmp_path / "probes.json"
    store = ProbeStore(path)
    assert store.get(KEY) is None
    store.record(KEY, 0.125)
    store.save()
    entry = next(iter(json.loads(path.read_text())["probes"].values()))
    assert entry == {"seconds": 0.125, "machine": fingerprint_key(machine_fingerprint())}
    fresh = ProbeStore(path)
    assert fresh.get(KEY) == 0.125 and fresh.reused == 1 and len(fresh) == 1


def test_probe_store_ignores_and_prunes_foreign_fingerprints(tmp_path):
    path = tmp_path / "probes.json"
    foreign = fingerprint_key(dict(machine_fingerprint(), device_count=424242))
    path.write_text(json.dumps({
        "version": 2,
        "probes": {
            ProbeStore.encode_key(KEY): {"seconds": 0.25, "machine": foreign},
            "legacy-v1-entry": 0.125,  # schema v1: no provenance
        },
    }))
    store = ProbeStore(path)
    assert len(store) == 2  # loaded, but...
    assert store.get(KEY) is None  # ...foreign entries read as absent
    assert store.stale == 1
    store.record(KEY, 0.5)  # re-measured here
    store.save()
    assert store.pruned == 1  # the legacy v1 entry; KEY was overwritten
    saved = json.loads(path.read_text())
    assert saved["version"] == 2
    assert list(saved["probes"]) == [ProbeStore.encode_key(KEY)]
    assert ProbeStore(path).get(KEY) == 0.5


def test_missing_probe_store_is_silent(tmp_path):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert len(ProbeStore(tmp_path / "never_written.json")) == 0


@pytest.mark.parametrize("payload", [
    b'{"probes": {', b'{"probes": {"k": {}}}', b'{"probes": {"k": null}}',
    b'{"probes": [1, 2]}', b"null", b"\x00\x01binary-garbage", b"\xff\xfe\x00garbage",
])
def test_corrupt_probe_store_degrades_to_empty_with_warning(tmp_path, payload):
    path = tmp_path / "probes.json"
    path.write_bytes(payload)
    store = ProbeStore(path)
    with pytest.warns(RuntimeWarning, match="corrupt probe store"):
        assert len(store) == 0
    store.record(KEY, 0.5)
    store.save()
    assert json.loads(path.read_text())["probes"]
    assert ProbeStore(path).get(KEY) == 0.5


def test_default_probe_store_honours_its_override(tmp_path, monkeypatch):
    from repro_torch.engine import default_probe_store, probes

    assert probes.DEFAULT_PROBES_PATH.name == "torch_autotune_probes.json"
    monkeypatch.setenv("REPRO_TORCH_PROBES_PATH", str(tmp_path / "mine.json"))
    assert default_probe_store().path == tmp_path / "mine.json"


# -- calibration ----------------------------------------------------------------


def test_quick_calibration_of_the_cpu(tmp_path):
    profile = calibrate(device=CPU, quick=True)
    assert profile.calibrated and profile.quick
    assert profile.fingerprint == machine_fingerprint(CPU) and not profile.stale()
    assert set(profile.substrates) == {"local", "cuda", "mesh"}
    local = profile.substrate("local")
    assert profile.substrate("cuda") == local  # measured on the same device
    # no mesh on the CPU: the mesh's terms are derived, as on a one-device host
    assert profile.substrate("mesh") == dataclasses.replace(local, source="derived")
    rates = [local.stream_bw, local.gather_bw, local.scatter_bw, local.dispatch_overhead,
             profile.peaks.flops, profile.host_parallel_capacity]
    assert all(np.isfinite(v) and v > 0 for v in rates)
    assert local.collective("all_gather") == AlphaBeta(alpha=local.dispatch_overhead,
                                                      beta=2.0 / local.stream_bw)
    assert load_machine(profile.save(tmp_path / "machine.json")) == profile


def test_microbench_cli_writes_the_file(tmp_path, capsys):
    out = tmp_path / "machine.json"
    microbench.main(["--device", CPU, "--out", str(out)])
    assert load_machine(out).calibrated
    assert "stream" in capsys.readouterr().out


def test_calibrating_the_card_without_one_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate(device="cuda", quick=True)
