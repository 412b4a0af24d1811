"""The port's cluster data plane (``repro_torch.cluster``): v2 framing, blob
store, pipelining, against the JAX package where the two must agree.

Counterparts of the reference's ``tests/test_data_plane.py``, test for test
(the same names where the behaviour is the same), plus what only the port
has:

- **protocol v2** (socketpair units) — envelope + out-of-band segments
  round-trip; a torn frame raises ``ProtocolError("truncated frame...")``;
  a v1 peer is refused; oversized frames raise :class:`FrameTooLarge`. The
  port's frames are byte for byte the reference's, and each side reads the
  other's.
- **blob store** (process-free units) — digest-verified admission, LRU at a
  byte budget, ``ensure``'s miss negotiation, transient tombstones; digests
  equal to the reference's for every dtype the wire carries; a blob being
  verified is waited for, not asked for again; every entry is the store's
  own copy (the port's counterpart of the reference's read-only entries).
- **coordinator units** (socketpair, no processes) — ``blob_gone`` drops
  the belief; a tensor written in place re-hashes (its ``_version``); a
  memoized digest ships without a host copy; the writer flushes an
  isolated submit at once and coalesces a queued burst.
- **cluster integration** (two live CPU workers) — blobs ship once; a tiny
  worker budget forces eviction and ``need_blob``; bursts coalesce; wire
  and blob counters reach the rows; SIGKILL failover re-ships blobs.

Importing ``repro_torch.cluster`` registers the ``cluster`` substrate
process-wide; other files' tests read the registry's contents, so this
file holds the registration only while its own tests run.
"""
import json
import os
import signal
import socket
import struct
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import repro.cluster.blobs as RB
import repro.cluster.protocol as RP
import repro_torch.cluster as C
import repro_torch.core as T
import repro_torch.sparse as TS
from repro_torch.cluster.blobs import (
    BlobDigestMismatch, BlobError, BlobMissing, BlobStore, blob_digest,
)
from repro_torch.cluster.coordinator import Coordinator, WorkerHandle
from repro_torch.cluster.protocol import Channel, FrameTooLarge, ProtocolError, _recv_exact, max_frame_bytes
from repro_torch.engine import CudaSubstrate, PlanCache, Request, SegmentTable, SpMVInputs, run
from repro_torch.engine import substrate as substrates
from repro_torch.engine.wire import content_digest, encode_value
from torch_serving_inputs import CPU, assert_equal_results, spmv_pair

WAIT = 120  # seconds any one wait may take before it fails its test

substrates._REGISTRY.pop(C.ClusterSubstrate.name, None)


@pytest.fixture(scope="module", autouse=True)
def cluster_substrate_registered():
    # the worker processes inherit the environment: one intra-op thread each
    # instead of one a core, so they do not starve other files' tests that
    # run beside them under pytest-xdist
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        substrates.register_substrate(C.ClusterSubstrate)
        yield
        substrates._REGISTRY.pop(C.ClusterSubstrate.name, None)


# -- protocol v2 framing (socketpair, no processes) ---------------------------


@pytest.fixture()
def channel_pair():
    left, right = socket.socketpair()
    right.settimeout(WAIT)
    a, b = Channel(left), Channel(right)
    yield a, b
    a.close()
    b.close()


def test_envelope_and_segments_roundtrip(channel_pair):
    a, b = channel_pair
    payload = np.arange(1000, dtype=np.float64).tobytes()
    a.send({"kind": "submit", "x": {"__wire__": "ndref", "seg": 0}}, [payload])
    message = b.recv()
    assert message["kind"] == "submit"
    assert bytes(message["x"]["data"]) == payload  # attached in place
    assert a.bytes_sent == b.bytes_received > len(payload)
    assert a.frames_sent == b.frames_received == 1


def test_multi_segment_frame_attaches_by_index(channel_pair):
    a, b = channel_pair
    segs = [bytes([i]) * (i + 1) for i in range(5)]
    refs = [{"__wire__": "ndref", "seg": i} for i in range(5)]
    a.send({"kind": "submit", "items": refs}, segs)
    message = b.recv()
    for i, node in enumerate(message["items"]):
        assert bytes(node["data"]) == segs[i]


def test_clean_eof_between_frames_returns_none(channel_pair):
    a, b = channel_pair
    a.send({"kind": "ping"})
    assert b.recv()["kind"] == "ping"
    a.close()
    assert b.recv() is None


def test_truncated_frame_raises_not_eof(channel_pair):
    """EOF after partial bytes must raise, not look like a disconnect."""
    a, b = channel_pair
    a._sock.sendall(b"\x02\x00")  # two bytes of a 13-byte prefix, then gone
    a.close()
    with pytest.raises(ProtocolError, match="truncated frame"):
        b.recv()


def test_truncated_envelope_raises(channel_pair):
    a, b = channel_pair
    header = struct.pack(">BIQ", 2, 0, 1000)  # promises 1000 envelope bytes
    a._sock.sendall(header + b'{"kind":')  # ...delivers 8
    a.close()
    with pytest.raises(ProtocolError, match="truncated frame"):
        b.recv()


def test_oserror_mid_frame_raises_truncated_frame():
    """An OSError under a partial read is a torn frame, not a clean EOF:
    failover treats the two differently."""
    left, right = socket.socketpair()
    try:
        left.sendall(b"\x02\x00\x00")  # partial prefix...

        def reset_soon():
            # SO_LINGER(0) makes close() send RST: the reader gets
            # ECONNRESET (an OSError), not an orderly EOF
            left.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
            left.close()

        timer = threading.Timer(0.05, reset_soon)
        timer.start()
        right.settimeout(5.0)
        with pytest.raises(ProtocolError, match="truncated frame"):
            _recv_exact(right, 13, at_boundary=False)
        timer.join(timeout=WAIT)
        assert not timer.is_alive()
    finally:
        right.close()


def test_v1_peer_is_refused_with_version_mismatch(channel_pair):
    a, b = channel_pair
    # a v1 frame: bare 8-byte big-endian length + JSON. Its first byte is
    # 0x00, which the v2 reader reads as "protocol version 0".
    body = json.dumps({"kind": "hello"}).encode()
    a._sock.sendall(struct.pack(">Q", len(body)) + body)
    with pytest.raises(ProtocolError, match="version mismatch"):
        b.recv()


def test_frame_cap_is_env_overridable(channel_pair, monkeypatch):
    a, b = channel_pair
    monkeypatch.delenv("REPRO_MAX_FRAME_BYTES", raising=False)
    assert max_frame_bytes() == 1 << 30  # the 1 GiB default
    monkeypatch.setenv("REPRO_MAX_FRAME_BYTES", "64")
    assert max_frame_bytes() == 64
    with pytest.raises(FrameTooLarge, match="REPRO_MAX_FRAME_BYTES"):
        a.send({"kind": "submit"}, [b"x" * 128])
    # receive side enforces the cap too (corrupt/hostile headers)
    monkeypatch.delenv("REPRO_MAX_FRAME_BYTES")
    a.send({"kind": "submit", "pad": "y" * 128})
    monkeypatch.setenv("REPRO_MAX_FRAME_BYTES", "64")
    with pytest.raises(FrameTooLarge, match="REPRO_MAX_FRAME_BYTES"):
        b.recv()


def test_concurrent_sends_interleave_whole_frames(channel_pair):
    a, b = channel_pair
    n_threads, per_thread = 4, 25
    seg = bytes(range(256))

    def sender(t):
        for i in range(per_thread):
            a.send({"kind": "submit", "t": t, "i": i, "x": {"__wire__": "ndref", "seg": 0}}, [seg])

    threads = [threading.Thread(target=sender, args=(t,)) for t in range(n_threads)]
    for th in threads:
        th.start()
    got = [b.recv() for _ in range(n_threads * per_thread)]
    for th in threads:
        th.join(timeout=WAIT)
        assert not th.is_alive()
    assert all(bytes(m["x"]["data"]) == seg for m in got)
    assert len({(m["t"], m["i"]) for m in got}) == n_threads * per_thread  # no torn frames


def _submit_envelope():
    """A submit frame's envelope and segments: the port's SpMV request in
    segment mode, plus the reference's message fields."""
    table = SegmentTable()
    request = Request("spmv", spmv_pair()[1], T.MigratoryStrategy(replicate_x=False), "cuda")
    return {"kind": "submit", "ticket": 7, "request": request.to_wire(segments=table)}, table.segments


def _frame_bytes(channel_cls, message, segments) -> bytes:
    left, right = socket.socketpair()
    try:
        channel_cls(left).send(message, segments)
        left.shutdown(socket.SHUT_WR)
        right.settimeout(WAIT)
        chunks = []
        while chunk := right.recv(1 << 16):
            chunks.append(chunk)
        return b"".join(chunks)
    finally:
        left.close()
        right.close()


def test_frames_are_byte_identical_to_the_reference():
    message, segments = _submit_envelope()
    for msg, segs in ((message, segments), ({"kind": "ping"}, []),
                      ({"kind": "put_blob", "digest": "d" * 64,
                        "blob": {"__wire__": "ndref", "seg": 0}}, [bytes(range(256)) * 3])):
        port = _frame_bytes(Channel, msg, segs)
        assert port == _frame_bytes(RP.Channel, msg, segs)
        assert port[0] == RP.PROTOCOL_VERSION == 2


@pytest.mark.parametrize("sender,receiver", [(Channel, RP.Channel), (RP.Channel, Channel)],
                         ids=["port-to-reference", "reference-to-port"])
def test_each_side_reads_the_others_frames(sender, receiver):
    message, segments = _submit_envelope()
    left, right = socket.socketpair()
    right.settimeout(WAIT)
    try:
        sender(left).send(message, segments)
        got = receiver(right).recv()
    finally:
        left.close()
        right.close()
    assert got["kind"] == "submit" and got["ticket"] == 7
    rebuilt = Request.from_wire(got["request"], device=CPU)
    want, _ = run(Request("spmv", spmv_pair()[1], T.MigratoryStrategy(replicate_x=False),
                          CudaSubstrate(CPU)), iters=1, warmup=0, cache=PlanCache())
    have, _ = run(rebuilt, iters=1, warmup=0, cache=PlanCache())
    assert_equal_results(have, want)


# -- blob store (process-free) ------------------------------------------------


def _blob(fill, kib=1):
    return np.full(kib * 256, fill, dtype=np.float32)  # kib KiB per blob


def test_put_verifies_digest_and_refuses_corruption():
    store = BlobStore(budget_bytes=1 << 20)
    arr = _blob(1.0)
    digest = blob_digest(arr)
    store.put(digest, arr)
    np.testing.assert_array_equal(store.resolve(digest).numpy(), arr)
    with pytest.raises(BlobDigestMismatch, match="refusing"):
        store.put(digest, _blob(2.0))  # claimed digest, different bytes
    assert store.stats()["blobs"] == 1  # the corrupt shipment never landed


def test_resolve_miss_raises_and_counts():
    store = BlobStore(budget_bytes=1 << 20)
    with pytest.raises(BlobMissing):
        store.resolve("no-such-digest")
    arr = _blob(3.0)
    store.put(blob_digest(arr), arr)
    store.resolve(blob_digest(arr))
    assert store.stats()["hits"] == 1


def test_lru_eviction_at_byte_budget():
    store = BlobStore(budget_bytes=3 * 1024)  # room for three 1 KiB blobs
    blobs = [_blob(float(i)) for i in range(4)]
    digests = [blob_digest(b) for b in blobs]
    for digest, arr in zip(digests[:3], blobs[:3]):
        store.put(digest, arr)
    store.get(digests[0])  # touch: 0 is now MRU, 1 is LRU
    store.put(digests[3], blobs[3])
    assert store.missing(digests) == [digests[1]]  # LRU went, touched stayed
    assert store.stats()["evictions"] == 1
    assert store.stats()["bytes_stored"] <= 3 * 1024


def test_single_over_budget_blob_is_admitted_alone():
    store = BlobStore(budget_bytes=1024)
    small = _blob(1.0)
    store.put(blob_digest(small), small)
    huge = _blob(2.0, kib=8)
    store.put(blob_digest(huge), huge)  # evicts everything else, stays
    assert blob_digest(huge) in store
    assert blob_digest(small) not in store


def test_ensure_requests_missing_once_and_wakes_on_put():
    store = BlobStore(budget_bytes=1 << 20)
    arr = _blob(7.0)
    digest = blob_digest(arr)
    asked = []

    def request_missing(missing):
        asked.append(list(missing))
        threading.Timer(0.05, lambda: store.put(digest, arr)).start()

    store.ensure([digest], request_missing, timeout=10.0)
    assert asked == [[digest]]
    assert store.stats()["misses"] == 1
    store.ensure([digest], request_missing, timeout=10.0)  # present: no ask
    assert asked == [[digest]]


def test_ensure_fails_fast_on_blob_gone_and_times_out_otherwise():
    store = BlobStore(budget_bytes=1 << 20)

    def mark(missing):
        threading.Timer(0.05, lambda: store.mark_gone(missing[0])).start()

    with pytest.raises(BlobError, match="gone"):
        store.ensure(["dead-digest"], mark, timeout=10.0)
    with pytest.raises(BlobError, match="timed out"):
        store.ensure(["slow-digest"], lambda missing: None, timeout=0.1)


def test_stored_blobs_are_read_only():
    """The port's counterpart: torch has no read-only tensors, so every
    entry is the store's own copy. Writing the array that was put leaves
    the stored blob (and its digest) as it was, for every later resolve."""
    store = BlobStore(budget_bytes=1 << 20)
    arr = _blob(4.0)
    digest = blob_digest(arr)
    stored = store.put(digest, arr)
    arr[0] = 99.0
    assert stored.data_ptr() != arr.ctypes.data
    assert float(store.resolve(digest)[0]) == 4.0 and blob_digest(store.resolve(digest)) == digest
    t = torch.full((256,), 5.0)
    copy = store.put(blob_digest(t), t, verify=False)
    t.add_(1)
    assert float(copy[0]) == 5.0


def test_put_never_freezes_the_callers_array():
    """Admitting an array (the coordinator sink path, ``verify=False``)
    leaves the caller's own object writable: in-place updates between
    submits keep working."""
    store = BlobStore(budget_bytes=1 << 20)
    arr = _blob(5.0)
    store.put(blob_digest(arr), arr, verify=False)
    assert arr.flags.writeable, "put() froze the caller's own array"
    arr[0] = 99.0  # must not raise "assignment destination is read-only"


def test_blob_gone_tombstone_is_transient():
    """``blob_gone`` fails the waits that saw it and is then forgotten — a
    later submit re-pins the blob coordinator-side, so a later ensure()
    must be allowed to re-ask instead of failing instantly forever."""
    store = BlobStore(budget_bytes=1 << 20)
    arr = _blob(6.0)
    digest = blob_digest(arr)

    def mark(missing):
        threading.Timer(0.02, lambda: store.mark_gone(digest)).start()

    with pytest.raises(BlobError, match="gone"):
        store.ensure([digest], mark, timeout=10.0)

    def ship(missing):
        threading.Timer(0.02, lambda: store.put(digest, arr)).start()

    store.ensure([digest], ship, timeout=10.0)  # no stale tombstone
    np.testing.assert_array_equal(store.resolve(digest).numpy(), arr)


def test_expected_blob_is_waited_for_not_asked_again():
    """A ``put_blob`` frame being verified off the reader thread: a submit
    that refers to it waits, sends no ``need_blob``; a refused one is
    asked for again."""
    store = BlobStore(budget_bytes=1 << 20)
    arr = _blob(8.0)
    digest = blob_digest(arr)
    store.expect(digest)
    threading.Timer(0.05, lambda: store.put(digest, arr)).start()
    asked = []
    store.ensure([digest], asked.append, timeout=10.0)
    assert asked == [] and store.stats()["misses"] == 0
    other = _blob(9.0)
    store.expect(blob_digest(other))
    with pytest.raises(BlobDigestMismatch):
        store.put(blob_digest(other), arr)  # the shipment was corrupt
    threading.Timer(0.05, lambda: store.put(blob_digest(other), other)).start()
    store.ensure([blob_digest(other)], asked.append, timeout=10.0)
    assert asked == [[blob_digest(other)]]


def test_device_store_holds_tensors_and_reports_verify_time():
    store = BlobStore(budget_bytes=1 << 20, device=CPU)
    big, small = _blob(1.0, kib=16), _blob(2.0)
    store.put(blob_digest(big), big)
    store.put(blob_digest(small), small)
    got = store.resolve(blob_digest(big))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    stats = store.stats()
    assert stats["largest_verified_bytes"] == big.nbytes and stats["largest_verify_ms"] >= 0


def test_worker_reuses_decoded_inputs_of_equal_payloads():
    """A worker decodes equal encoded inputs (the same blob digests, small
    arrays of the same bytes in any segment slot) to one object, so the
    engine's identity-keyed memos hit across requests; other bytes, or a
    blob the store evicted, decode anew."""
    from repro_torch.cluster.worker import _InputsCache

    store = BlobStore(budget_bytes=1 << 20)
    blob = _blob(1.0)
    digest = blob_digest(blob)
    store.put(digest, blob)
    small = np.arange(4, dtype=np.int32).tobytes()

    def encoded(seg, data):
        return {"__wire__": "tuple", "items": [
            {"__wire__": "blobref", "digest": digest, "dtype": "float32", "shape": [256]},
            {"__wire__": "ndref", "seg": seg, "dtype": "int32", "shape": [4], "data": data}, 3]}

    cache = _InputsCache(capacity=2)
    key = cache.key(encoded(0, small))
    assert cache.key(encoded(5, bytes(small))) == key
    assert cache.key(encoded(0, small[::-1])) != key
    obj = object()
    cache.put(key, obj, [digest])
    assert cache.get(cache.key(encoded(1, small)), store) is obj
    store.put(blob_digest(_blob(2.0, kib=1024)), _blob(2.0, kib=1024))  # evicts the blob
    assert digest not in store and cache.get(key, store) is None


def _bf16(rng, shape):
    ref = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    return ref, torch.from_numpy(ref.view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("kind", ["float32", "int32", "int64", "bool", "bfloat16", "0-d",
                                  "past-one-step"])
def test_blob_digest_equals_the_reference(kind):
    rng = np.random.default_rng(3)
    if kind == "bfloat16":
        ref, port = _bf16(rng, (17, 9))
    elif kind == "0-d":
        ref = np.float32(2.5)
        port = torch.tensor(2.5)
    elif kind == "bool":
        ref = rng.random((5, 7)) > 0.5
        port = torch.from_numpy(ref.copy())
    elif kind == "past-one-step":  # more raw bytes than one step of the streamed hash
        ref = rng.standard_normal(300_001).astype(np.float32)
        port = torch.from_numpy(ref.copy())
    else:
        ref = rng.integers(-1000, 1000, (13, 6)).astype(kind)
        port = torch.from_numpy(ref.copy())
    assert blob_digest(port) == RB.blob_digest(ref) == content_digest(port)
    assert blob_digest(ref) == RB.blob_digest(ref)


# -- coordinator units (socketpair, no processes) -----------------------------


@pytest.fixture()
def coordinator_worker():
    left, right = socket.socketpair()
    right.settimeout(10.0)
    coordinator = Coordinator(flush_window=1.0)
    worker = WorkerHandle(1, Channel(left), {"pid": 0})
    coordinator._workers[1] = worker
    peer = Channel(right)
    yield coordinator, worker, peer
    worker.send_queue.put(None)
    worker.channel.close()
    peer.close()


def test_blob_gone_forgets_the_coordinator_belief(coordinator_worker):
    """Answering ``blob_gone`` must drop the digest from the worker's
    belief set, so the next submit referencing it re-ships the bytes
    instead of trusting a pin the coordinator just failed to honor."""
    coordinator, worker, peer = coordinator_worker
    worker.blob_digests.add("deadbeef")
    coordinator._on_message(worker, {"kind": "need_blob", "digests": ["deadbeef"]})
    assert peer.recv() == {"kind": "blob_gone", "digest": "deadbeef"}
    assert "deadbeef" not in worker.blob_digests


def test_writable_arrays_rehash_on_resubmit():
    """A tensor written in place (``t.add_(1)``: its ``_version`` moves) and
    resubmitted hashes anew and ships its *new* bytes; an untouched one is
    hashed once. Writable numpy arrays recompute every time; read-only ones
    are memoized."""
    coordinator = Coordinator(blob_min_bytes=1024)
    t = torch.arange(512, dtype=torch.float64)
    blobs = {}
    sink = coordinator._make_blob_sink(blobs)
    first = sink(t)
    assert sink(t) == first and coordinator._digest_cache[id(t)][2] == first
    t.add_(1)
    second = sink(t)
    assert second != first and second == content_digest(t)
    assert torch.equal(blobs[second], t) and not torch.equal(blobs[first], t)
    arr = np.arange(512, dtype=np.float64)
    before = coordinator._array_digest(arr)
    arr[0] = -1.0
    assert coordinator._array_digest(arr) == content_digest(arr) != before
    assert id(arr) not in coordinator._digest_cache
    frozen = np.arange(512, dtype=np.float64)
    frozen.setflags(write=False)
    assert coordinator._array_digest(frozen) == coordinator._array_digest(frozen)
    assert id(frozen) in coordinator._digest_cache


def test_memoized_blob_ships_without_a_host_copy(monkeypatch):
    """The sink is asked before ``encode_value`` copies an array to the
    host: a tensor whose digest is memoized and whose bytes the coordinator
    store holds costs neither a hash nor a copy (a meta tensor, which has no
    bytes at all, shows it)."""
    import repro_torch.cluster.coordinator as coord_mod

    claimed = encode_value(torch.empty(1 << 20, device="meta"), blob_sink=lambda t: "d" * 64)
    assert claimed == {"__wire__": "blobref", "digest": "d" * 64, "dtype": "float32",
                       "shape": [1 << 20]}
    coordinator = Coordinator(blob_min_bytes=1024)
    t = torch.arange(4096, dtype=torch.float32)
    table = SegmentTable()
    first = encode_value(t, segments=table, blob_sink=coordinator._make_blob_sink({}))
    hashed, copied = [], []
    monkeypatch.setattr(coord_mod, "blob_digest", lambda a: hashed.append(a))
    monkeypatch.setattr(coordinator._blob_store, "put", lambda *a, **k: copied.append(a))
    again = encode_value(t, segments=table, blob_sink=coordinator._make_blob_sink({}))
    assert again == first and first["__wire__"] == "blobref" and not hashed and not copied
    assert len(table) == 0


def test_isolated_submit_flushes_without_window_latency(coordinator_worker):
    """An isolated submit must go out immediately — the 1 s flush window
    only lingers when a burst is already queued."""
    coordinator, worker, peer = coordinator_worker
    writer = threading.Thread(target=coordinator._writer_loop, args=(worker,), daemon=True)
    writer.start()
    start = time.monotonic()
    worker.send_queue.put(({"kind": "submit", "ticket": 1}, []))
    message = peer.recv()
    elapsed = time.monotonic() - start
    assert message["kind"] == "submit" and message["ticket"] == 1
    assert elapsed < 0.5, f"isolated submit waited {elapsed:.3f}s on the window"


def test_queued_burst_still_coalesces_into_submit_many(coordinator_worker):
    coordinator, worker, peer = coordinator_worker
    coordinator.flush_window = 0.01
    for ticket in range(3):  # queued before the writer even starts
        worker.send_queue.put(({"kind": "submit", "ticket": ticket}, []))
    writer = threading.Thread(target=coordinator._writer_loop, args=(worker,), daemon=True)
    writer.start()
    message = peer.recv()
    assert message["kind"] == "submit_many"
    assert [item["ticket"] for item in message["items"]] == [0, 1, 2]
    deadline = time.monotonic() + 5.0  # counter lands just after the send
    while coordinator._submits_coalesced < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert coordinator._submits_coalesced == 3


# -- cluster integration (live workers) ---------------------------------------


def _large_requests(n, grids=(48,), seed=3):
    """Requests sharing the ``grids``' large operands round-robin, with a
    fresh small vector each — the blobref traffic shape. grid=48 puts
    cols/vals (~45 KiB each) above the test-time 16 KiB blob threshold.
    Distinct grid sizes give distinct blob digests."""
    rng = np.random.default_rng(seed)
    mats = [T.partition_ell(TS.laplacian_2d(g, device=CPU), 8, device=CPU) for g in grids]
    sub = CudaSubstrate(CPU)
    return [
        Request("spmv", SpMVInputs(
            mats[i % len(grids)],
            torch.from_numpy(rng.standard_normal(grids[i % len(grids)] ** 2).astype(np.float32)),
        ), None, sub)
        for i in range(n)
    ]


def _oracle(request):
    return run(request, iters=1, warmup=0, cache=PlanCache())[0]


@pytest.fixture(scope="module")
def dp_cluster():
    """One 2-worker cluster for the data-plane tests: a deliberately tiny
    worker-side blob budget (holds any single matrix's cols/vals pair but
    never two pairs, inherited through the environment) and a low blob
    threshold so eviction + need_blob happen at test sizes."""
    os.environ["REPRO_BLOB_BUDGET_BYTES"] = str(160 * 1024)
    try:
        with C.launch_cluster(
            n_workers=2, service_workers=1, device=CPU, activate=False,
            blob_min_bytes=16 * 1024, flush_window=0.01, wait_timeout=WAIT,
        ) as c:
            yield c
    finally:
        os.environ.pop("REPRO_BLOB_BUDGET_BYTES", None)


def test_blobs_ship_once_then_serve_by_reference(dp_cluster):
    requests = _large_requests(6)
    before = dp_cluster.stats()
    responses = [f.result(timeout=WAIT) for f in [dp_cluster.submit(r) for r in requests]]
    for request, response in zip(requests, responses):
        assert torch.equal(response.result, _oracle(request))
    stats = dp_cluster.stats()
    # the shared operand's two arrays shipped at most once per worker...
    assert stats["blob_misses"] - before["blob_misses"] <= 2 * 2
    # ...and later submits referenced them by digest
    assert stats["blob_hits"] - before["blob_hits"] > 0


def test_eviction_triggers_need_blob_refetch_with_parity(dp_cluster):
    # 3 distinct matrices x 2 blobs x 45-61 KiB = about 320 KiB of distinct
    # blobs against a 160 KiB worker budget (one pair fits, two never do):
    # serving the stream requires eviction, and revisiting an evicted
    # matrix requires a need_blob re-fetch. Sequential submits keep the
    # evict/re-fetch cycle deterministic.
    requests = _large_requests(12, grids=(48, 52, 56), seed=5)
    responses = [dp_cluster.submit(r).result(timeout=WAIT) for r in requests]
    for request, response in zip(requests, responses):
        assert torch.equal(response.result, _oracle(request))
    worker_rows = [
        dp_cluster.coordinator.worker_stats(w["worker_id"])
        for w in dp_cluster.stats()["workers"] if w["state"] == "healthy"
    ]
    evictions = sum(r["blob_store"]["evictions"] for r in worker_rows)
    refetches = sum(r["blob_misses"] for r in worker_rows)
    assert evictions > 0, "budget never forced an eviction"
    assert refetches > 0, "no worker ever re-fetched via need_blob"


def test_submit_burst_coalesces_into_submit_many(dp_cluster):
    before = dp_cluster.stats()
    requests = _large_requests(8, seed=9)
    responses = [f.result(timeout=WAIT) for f in [dp_cluster.submit(r) for r in requests]]
    assert len(responses) == len(requests)
    stats = dp_cluster.stats()
    assert stats["submits_coalesced"] > before["submits_coalesced"], (
        "a same-worker burst under flush_window never produced submit_many"
    )
    for request, response in zip(requests, responses):
        assert torch.equal(response.result, _oracle(request))


def test_wire_counters_reach_coordinator_rows_and_service_stats(dp_cluster):
    dp_cluster.submit(_large_requests(1)[0]).result(timeout=WAIT)
    stats = dp_cluster.stats()
    assert stats["wire_bytes_sent"] > 0 and stats["wire_bytes_received"] > 0
    for row in stats["workers"]:
        for key in ("bytes_sent", "bytes_received", "blob_hits", "blob_misses",
                    "frames_sent", "frames_received"):
            assert key in row, key
    worker_row = dp_cluster.coordinator.worker_stats(stats["workers"][0]["worker_id"])
    # the worker merges transport + blob-store counters into its
    # ServiceStats.to_dict() row, with its kernels' launch counts
    assert worker_row["wire_bytes_sent"] > 0
    assert worker_row["wire_bytes_received"] > 0
    assert "blob_hits" in worker_row and "blob_misses" in worker_row
    assert worker_row["blob_store"]["blobs"] >= 0
    assert set(worker_row["kernel_launches"]) >= {"spmv_ell", "bfs_expand", "topk_sim"}
    assert all(n == 0 for n in worker_row["kernel_launches"].values())  # plain versions here


def test_sigkill_failover_reships_blobs_and_stays_bit_identical():
    with C.launch_cluster(
        n_workers=2, service_workers=1, device=CPU, activate=False,
        heartbeat_interval=0.2, heartbeat_timeout=3.0, blob_min_bytes=16 * 1024,
        wait_timeout=WAIT,
    ) as cluster:
        requests = _large_requests(10, seed=11)
        # warm the pinned worker (and its blob belief set), then kill it
        # with a burst in flight: retries must re-ship the pinned blobs to
        # the survivor before replaying
        first = cluster.submit(requests[0]).result(timeout=WAIT)
        victim = first.worker_id
        futures = [cluster.submit(r) for r in requests[1:]]
        cluster.kill_worker(victim, sig=signal.SIGKILL)
        responses = [f.result(timeout=WAIT) for f in futures]
        for request, response in zip(requests[1:], responses):
            assert torch.equal(response.result, _oracle(request))
        stats = cluster.stats()
        assert stats["failovers"] == 1 and stats["n_healthy"] == 1
        survivor = [w for w in stats["workers"]
                    if w["worker_id"] != victim and w["state"] == "healthy"]
        assert survivor and survivor[0]["served"] > 0
        # the survivor holds the re-shipped blobs (belief set non-empty)
        assert survivor[0]["blobs_shipped"] > 0


def test_service_stats_has_data_plane_fields_in_process():
    from repro_torch.engine import ServiceStats

    row = ServiceStats().to_dict()
    for key in ("wire_bytes_sent", "wire_bytes_received", "blob_hits", "blob_misses"):
        assert row[key] == 0  # present, zero when no cluster is involved
