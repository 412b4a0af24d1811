"""The port's wire codec (``repro_torch/engine/wire.py``) against the JAX
package's (``repro/engine/wire.py``), on the CPU.

Pinned here: bit-exact round trips (a decoded array is a CPU tensor of the
same dtype, shape and bytes; enums come back as members; dataclasses
rebuild through the ``repro_torch.*``-only class allowlist); canonical bytes
that are deterministic and equal to the reference's — a tensor leaf encodes
to the reference's bytes for the numpy array of the same values (float32,
int32, int64, bool, bfloat16), and a whole ``Request`` to the reference's
bytes once the class paths are mapped ``repro_torch.`` -> ``repro.``; the
segment and blob forms; and a ``repro.*`` payload refused before anything
is imported.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.engine as J
import repro.engine.wire as RW
import repro_torch.core as T
from repro_torch.engine import (
    WIRE_VERSION, LocalSubstrate, PlanCache, Request, SegmentTable, SpMVOp,
    Substrate, WireError, canonical_bytes, collect_blob_digests, content_digest, decode_value,
    encode_value, run,
)
from repro_torch.engine.service import _content_hash
from repro_torch.engine.wire import array_nbytes, host_array, to_device
from torch_serving_inputs import CPU, assert_equal_results, bfs_pair, gsana_pair, signatures, spmv_pair

ROOT = Path(__file__).resolve().parents[1]


def _roundtrip(value):
    return decode_value(json.loads(json.dumps(encode_value(value))))


def _attach(encoded, segments):
    """Attach segment ``i`` to every ``ndref`` node naming it, as a receiver
    of an out-of-band frame does before decoding."""
    if isinstance(encoded, dict):
        if encoded.get("__wire__") == "ndref":
            encoded["data"] = bytes(segments[encoded["seg"]])
        for v in encoded.values():
            _attach(v, segments)
    elif isinstance(encoded, list):
        for v in encoded:
            _attach(v, segments)
    return encoded


def _as_reference(port_bytes: bytes) -> bytes:
    return port_bytes.replace(b'"repro_torch.', b'"repro.')


# -- scalar / container round trips -------------------------------------------


@pytest.mark.parametrize("value", [
    None, True, False, 0, -7, 3.25, "text", "",
    (1, 2, 3), [1.5, None, "x"], {"a": 1, "b": (2, 3)},
    {"nested": {"t": (1, [2, {"deep": True}])}},
])
def test_json_values_roundtrip_and_match_reference(value):
    assert _roundtrip(value) == value
    assert canonical_bytes(value) == RW.canonical_bytes(value)


def test_tuple_list_distinction_survives():
    assert _roundtrip((1, 2)) == (1, 2)
    assert isinstance(_roundtrip((1, 2)), tuple)
    assert isinstance(_roundtrip([1, 2]), list)
    assert isinstance(_roundtrip(((1,), [2])), tuple)


def test_nan_and_inf_roundtrip():
    assert _roundtrip([float("inf"), float("-inf")]) == [float("inf"), float("-inf")]
    assert np.isnan(_roundtrip(float("nan")))


# -- tensors: dtype/shape/bit-exactness, bytes equal to the reference's --------


DTYPES = ["float32", "int32", "int64", "bool", "bfloat16"]


def _values(dtype: str) -> np.ndarray:
    """(5, 7) values of ``dtype`` from a seed; bfloat16 as float32 values
    that bfloat16 holds exactly."""
    v = np.random.default_rng(3).standard_normal((5, 7)) * 100
    if dtype == "bfloat16":
        return np.asarray(jnp.asarray(v, jnp.bfloat16)).astype(np.float32)
    return v.astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tensor_canonical_bytes_equal_reference_numpy(dtype):
    v = _values(dtype)
    if dtype == "bfloat16":
        t = torch.from_numpy(v).to(torch.bfloat16)
        ref = np.asarray(jnp.asarray(v, jnp.bfloat16))  # an ml_dtypes array
    else:
        t, ref = torch.from_numpy(v.copy()), v
    assert canonical_bytes(t) == RW.canonical_bytes(ref)
    assert encode_value(t)["dtype"] == dtype
    # the reference decodes the port's bytes to the same values, and back
    back_ref = RW.decode_value(json.loads(canonical_bytes(t)))
    assert back_ref.dtype == ref.dtype and back_ref.tobytes() == ref.tobytes()
    back = decode_value(json.loads(RW.canonical_bytes(ref)))
    assert isinstance(back, torch.Tensor) and back.device.type == "cpu"
    assert back.dtype == t.dtype and torch.equal(back, t)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tensor_roundtrip_preserves_dtype_and_bits(dtype):
    t = torch.from_numpy(_values(dtype))
    t = t.to(torch.bfloat16) if dtype == "bfloat16" else t
    back = _roundtrip(t)
    assert isinstance(back, torch.Tensor) and back.dtype == t.dtype and back.shape == t.shape
    assert torch.equal(back.view(torch.uint8) if dtype != "bool" else back,
                       t.view(torch.uint8) if dtype != "bool" else t)
    back[0, 0] = 1  # decoded tensors are fresh and writable


def test_numpy_array_decodes_as_tensor_of_its_dtype():
    arr = np.arange(12, dtype=np.float64).reshape(3, 4)
    back = _roundtrip(arr)
    assert isinstance(back, torch.Tensor) and back.dtype == torch.float64
    np.testing.assert_array_equal(back.numpy(), arr)


def test_noncontiguous_tensor_encodes_c_order():
    t = torch.arange(24, dtype=torch.int32).reshape(4, 6).T  # a transposed view
    assert not t.is_contiguous()
    assert torch.equal(_roundtrip(t), t)
    assert canonical_bytes(t) == RW.canonical_bytes(t.numpy())


def test_zero_dim_and_empty_tensors():
    # 0-d values travel as shape (1,), as the reference's do
    assert canonical_bytes(torch.tensor(2.5)) == RW.canonical_bytes(np.float32(2.5))
    assert canonical_bytes(torch.tensor(2.5, dtype=torch.bfloat16)) == RW.canonical_bytes(
        np.asarray(jnp.asarray(2.5, jnp.bfloat16)))
    assert _roundtrip(torch.tensor(2.5)).tolist() == [2.5]
    back = _roundtrip(torch.empty((0, 3), dtype=torch.int64))
    assert back.shape == (0, 3) and back.dtype == torch.int64


def test_object_dtype_refused():
    with pytest.raises(WireError, match="object-dtype"):
        encode_value(np.array([object()], dtype=object))


# -- enums and dataclasses ----------------------------------------------------


@pytest.mark.parametrize("member", [
    T.Comm.MIGRATE, T.Comm.REMOTE_WRITE, T.Layout.HCB, T.Scheme.PAIR,
])
def test_str_mixin_enums_roundtrip_as_members(member):
    assert _roundtrip(member) is member
    assert isinstance(encode_value(member), dict)  # tagged, not a bare scalar


def test_strategy_dataclass_roundtrip_and_reference_bytes():
    st = T.MigratoryStrategy(comm=T.Comm.MIGRATE, replicate_x=False, layout=T.Layout.BLK,
                             scheme=T.Scheme.ALL, grain=64)
    back = _roundtrip(st)
    assert back == st and back.cache_key() == st.cache_key() and isinstance(back.comm, T.Comm)
    import repro.core as R

    ref = R.MigratoryStrategy(comm=R.Comm.MIGRATE, replicate_x=False, layout=R.Layout.BLK,
                              scheme=R.Scheme.ALL, grain=64)
    assert _as_reference(canonical_bytes(st)) == RW.canonical_bytes(ref)


@pytest.mark.parametrize("path", ["subprocess:Popen", "repro.engine.ops:SpMVInputs", "repro:engine",
                                  "repro_torchx.evil:Thing"])
def test_classes_outside_the_port_refused_on_decode(path):
    payload = {"__wire__": "dc", "cls": path, "fields": {"args": ["true"]}}
    with pytest.raises(WireError, match="only repro_torch"):
        decode_value(payload)


def test_reference_payload_refused_without_importing_jax():
    """Decoding a payload that names the JAX package's classes raises
    WireError before any import: neither ``jax`` nor ``repro`` is loaded."""
    code = (
        "import json, sys\n"
        "from repro_torch.engine import WireError, decode_value\n"
        "payload = {'__wire__': 'dc', 'cls': 'repro.engine.ops:SpMVInputs', 'fields': {}}\n"
        "enum = {'__wire__': 'enum', 'cls': 'repro.core.strategies:Comm', 'value': 'migrate'}\n"
        "for p in (payload, enum):\n"
        "    try:\n"
        "        decode_value(p)\n"
        "    except WireError:\n"
        "        pass\n"
        "    else:\n"
        "        raise SystemExit('decoded a repro.* class')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))\n"
        "assert not bad, bad\n"
        "print('REFUSED-OK')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0 and "REFUSED-OK" in proc.stdout, proc.stderr


def test_repr_fallback_hashes_but_refuses_decode():
    class Opaque:
        pass

    encoded = encode_value(Opaque())
    assert encoded["__wire__"] == "repr"
    canonical_bytes(Opaque())
    with pytest.raises(WireError, match="hash-only"):
        decode_value(encoded)


def test_unknown_tag_refused():
    with pytest.raises(WireError, match="unknown wire tag"):
        decode_value({"__wire__": "no-such-tag"})


# -- canonical bytes ----------------------------------------------------------


def test_canonical_bytes_insertion_order_independent():
    a = {"x": 1, "y": (2, 3), "z": torch.arange(3)}
    b = {"z": torch.arange(3), "y": (2, 3), "x": 1}
    assert canonical_bytes(a) == canonical_bytes(b)


def test_canonical_bytes_distinguish_values_and_dtypes():
    assert canonical_bytes(torch.tensor(1.0)) != canonical_bytes(torch.tensor(1.0, dtype=torch.float64))
    assert canonical_bytes(torch.tensor(1.0)) != canonical_bytes(torch.tensor(1.0, dtype=torch.bfloat16))
    assert canonical_bytes((1, 2)) != canonical_bytes([1, 2])
    assert canonical_bytes({"a": 1}) != canonical_bytes({"a": 2})


# -- Request wire form --------------------------------------------------------


def _requests():
    sub = LocalSubstrate(CPU)
    return [Request(op, inputs, st, sub) for op, inputs, st in signatures("port")] + [
        Request("bfs", bfs_pair()[1], qos=2.0, timeout=30.0),
    ]


@pytest.mark.parametrize("idx", range(6))
def test_request_bytes_equal_reference(idx):
    """A whole Request's wire bytes equal the reference's for the same
    numpy-built inputs, once the class paths are mapped."""
    op, ref_inputs, ref_st = signatures("ref")[idx]
    _, port_inputs, port_st = signatures("port")[idx]
    ref = J.Request(op, ref_inputs, ref_st, "local", qos=2.0, timeout=5.0)
    port = Request(op, port_inputs, port_st, LocalSubstrate(CPU), qos=2.0, timeout=5.0)
    ref_bytes = json.dumps(ref.to_wire(), sort_keys=True, separators=(",", ":")).encode()
    port_bytes = json.dumps(port.to_wire(), sort_keys=True, separators=(",", ":")).encode()
    assert _as_reference(port_bytes) == ref_bytes


@pytest.mark.parametrize("idx", range(7))
def test_request_roundtrip_bit_exact_and_same_result(idx):
    request = _requests()[idx]
    payload = request.to_wire()
    rebuilt = Request.from_wire(json.loads(json.dumps(payload)), device=CPU)
    assert rebuilt.qos == request.qos and rebuilt.timeout == request.timeout
    assert rebuilt.to_wire() == payload  # bit-exact: the same bytes again
    assert canonical_bytes(rebuilt.inputs) == canonical_bytes(request.inputs)
    if request.substrate is None:
        assert rebuilt.substrate is None
        return
    assert isinstance(rebuilt.substrate, LocalSubstrate) and rebuilt.substrate.device.type == "cpu"
    y0, _ = run(request, iters=1, warmup=0, cache=PlanCache())
    y1, _ = run(rebuilt, iters=1, warmup=0, cache=PlanCache())
    assert_equal_results(y1, y0)


def test_from_wire_builds_on_the_requested_device(monkeypatch):
    payload = Request("spmv", spmv_pair()[1], None, "cuda").to_wire()
    rebuilt = Request.from_wire(payload, device=CPU)
    assert rebuilt.substrate.name == "cuda" and rebuilt.substrate.device.type == "cpu"
    assert rebuilt.inputs.x.device.type == "cpu" and rebuilt.inputs.a.cols.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Request.from_wire(payload)  # the default device is the card
    assert to_device((torch.ones(2), [3, "x"]), CPU)[1] == [3, "x"]


def test_request_wire_version_checked():
    payload = _requests()[0].to_wire()
    payload["v"] = WIRE_VERSION + 998
    with pytest.raises(WireError, match="version"):
        Request.from_wire(payload, device=CPU)


def test_request_op_instance_travels_by_name():
    assert Request(SpMVOp(), spmv_pair()[1]).to_wire()["op"] == "spmv"
    with pytest.raises(WireError, match="registry name"):
        Request(object(), spmv_pair()[1]).to_wire()


def test_request_unregistered_substrate_refused():
    class Rogue(Substrate):
        name = "never-registered"

    with pytest.raises(WireError, match="registered substrate"):
        Request("spmv", spmv_pair()[1], substrate=Rogue(CPU)).to_wire()
    payload = Request("spmv", spmv_pair()[1]).to_wire()
    payload["substrate"] = "pallas"  # the reference's, not the port's
    with pytest.raises(WireError, match="unknown substrate"):
        Request.from_wire(payload, device=CPU)


def test_dedup_hash_shared_with_wire_identity():
    """A request that crossed the wire hashes as the original did."""
    request = _requests()[0]
    rebuilt = Request.from_wire(json.loads(json.dumps(request.to_wire())), device=CPU)
    h0 = _content_hash(request.op, request.inputs, request.strategy, request.substrate)
    h1 = _content_hash(rebuilt.op, rebuilt.inputs, rebuilt.strategy, rebuilt.substrate)
    assert h0 == h1
    other = _requests()[2]
    assert _content_hash(other.op, other.inputs, other.strategy, other.substrate) != h0


# -- segment / blobref modes ----------------------------------------------------


def test_segment_mode_emits_ndref_and_roundtrips_bit_identically():
    table = SegmentTable()
    t = torch.arange(24, dtype=torch.int64).reshape(4, 6)
    encoded = encode_value({"a": t, "k": 3}, segments=table)
    assert len(table) == 1 and table.nbytes() == t.numel() * 8
    flat = json.dumps(encoded)
    assert "ndref" in flat and "data" not in flat
    out = decode_value(_attach(json.loads(flat), table.segments))
    assert torch.equal(out["a"], t) and out["k"] == 3
    out["a"][0, 0] = -1  # a fresh writable tensor, not a view of the frame


def test_unattached_ndref_is_refused():
    encoded = encode_value(torch.ones(3), segments=SegmentTable())
    with pytest.raises(WireError, match="not attached"):
        decode_value(json.loads(json.dumps(encoded)))


def test_blob_sink_emits_blobref_and_resolver_decodes():
    big, small = torch.arange(64, dtype=torch.float32), torch.ones(2)
    store = {}

    def sink(original):
        if array_nbytes(original) < 64:
            return None
        arr, _ = host_array(original)
        digest = content_digest(arr)
        store[digest] = torch.from_numpy(arr.copy())
        return digest

    table = SegmentTable()
    encoded = encode_value((big, small), segments=table, blob_sink=sink)
    assert len(store) == 1 and len(table) == 1
    assert collect_blob_digests(encoded) == list(store)
    _attach(encoded, table.segments)
    out = decode_value(encoded, blob_resolver=store.__getitem__)
    assert torch.equal(out[0], big) and torch.equal(out[1], small)
    with pytest.raises(WireError, match="blob store"):
        decode_value(encoded, blob_resolver=None)


def test_canonical_bytes_ignore_transport_encoding():
    value = spmv_pair()[1]
    baseline = canonical_bytes(value)
    encode_value(value, segments=SegmentTable())
    encode_value(value, blob_sink=content_digest)
    assert canonical_bytes(value) == baseline
    table = SegmentTable()
    encoded = _attach(json.loads(json.dumps(encode_value(value, segments=table))), table.segments)
    assert canonical_bytes(decode_value(encoded)) == baseline


def test_request_to_wire_threads_segments_and_blobs():
    request = Request("gsana", gsana_pair()[1], T.MigratoryStrategy(), LocalSubstrate(CPU))
    blobs = {}

    def sink(original):
        if array_nbytes(original) < 4096:
            return None
        arr, _ = host_array(original)
        digest = content_digest(arr)
        blobs[digest] = torch.from_numpy(arr.copy())
        return digest

    table = SegmentTable()
    payload = request.to_wire(segments=table, blob_sink=sink)
    digests = collect_blob_digests(payload)
    assert digests and set(digests) == set(blobs) and len(table) > 0
    parsed = _attach(json.loads(json.dumps(payload)), table.segments)
    rebuilt = Request.from_wire(parsed, blob_resolver=blobs.__getitem__, device=CPU)
    assert canonical_bytes(rebuilt.inputs) == canonical_bytes(request.inputs)
    want, _ = run(request, iters=1, warmup=0, cache=PlanCache())
    got, _ = run(rebuilt, iters=1, warmup=0, cache=PlanCache())
    assert_equal_results(got, want)
