"""Binary framing v2 for the cluster data plane.

The frames are byte for byte those of the JAX package's cluster plane: a
port peer and a reference peer read each other's frames.

One frame = a fixed 13-byte prefix, a per-segment length table, a UTF-8
JSON **envelope**, and zero or more raw **payload segments** appended
verbatim:

    offset  size  field
    ------  ----  -----------------------------------------------
    0       1     protocol version (``PROTOCOL_VERSION`` = 2)
    1       4     u32 segment count
    5       8     u64 envelope length (bytes)
    13      8*n   u64 length of each segment
    ...           envelope (JSON object with a ``"kind"``)
    ...           segments, concatenated C-order buffers

The envelope is the *message*: a dict with a ``"kind"`` discriminator and
plain JSON fields; engine values inside it are pre-encoded with
:mod:`repro_torch.engine.wire`. Tensor payloads do **not** ride the envelope:
in segment mode an array encodes as ``{"__wire__": "ndref", "seg": i,
"dtype", "shape"}`` and its raw buffer becomes segment ``i`` — no base64
(a flat ~33% tax in v1), and ``json.loads`` never parses tensor bytes.
:meth:`Channel.recv` re-attaches each segment to its ndref in place
(:func:`attach_segments`), so ``decode_value`` sees a buffer, not an
index. Content-addressed arrays cross as ``blobref`` envelopes with *no*
segment at all — see :mod:`repro_torch.cluster.blobs`.

**v1 interop is refused, cleanly.** v1 framed with a bare 8-byte length
prefix, so the first byte a v1 peer sends is 0x00 (the high byte of any
sane length); a v2 reader sees version 0 ≠ 2 and raises
:class:`ProtocolError` naming the mismatch instead of misparsing. In the
other direction a v2 frame's leading 0x02 byte makes a v1 reader decode a
huge bogus length and trip its frame cap. Both sides fail fast at the
first frame — a mixed-version cluster cannot half-work.

Message kinds:

======================  =========  ==========================================
kind                    direction  fields
======================  =========  ==========================================
``hello``               w -> c     ``worker_id, pid, token, substrate, slots``
``fatal``               w -> c     ``worker_id, token, etype, error`` (could
                                   not start; sent instead of ``hello``)
``pong``                w -> c     ``inflight`` (reply to ``ping``)
``result``              w -> c     ``ticket, result, report`` (wire-encoded)
``error``               w -> c     ``ticket, etype, error`` (repr strings)
``stats_reply``         w -> c     ``ticket, stats`` (plain dict)
``log``                 w -> c     ``level, logger, msg`` (forwarded record)
``need_blob``           w -> c     ``digests`` (blobref misses to re-ship)
``ping``                c -> w     (heartbeat; reader answers while busy)
``submit``              c -> w     ``ticket, request`` (``Request.to_wire()``)
``submit_many``         c -> w     ``items`` (coalesced submits, one frame)
``kernel_call``         c -> w     ``ticket, op, args, kwargs`` (wire-encoded)
``put_blob``            c -> w     ``digest, blob`` (+ one raw segment)
``blob_gone``           c -> w     ``digest`` (a need_blob that cannot be met)
``stats``               c -> w     ``ticket``
``shutdown``            c -> w     (drain and exit)
======================  =========  ==========================================
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
from typing import Any, Iterable

PROTOCOL_VERSION = 2

_PREFIX = struct.Struct(">BIQ")  # version, segment count, envelope length
_SEGLEN = struct.Struct(">Q")

#: frame-size guard default: 1 GiB. Large enough for any real request or
#: blob shipment, small enough that a corrupt header cannot trigger a
#: giant allocation. Override with ``REPRO_MAX_FRAME_BYTES``.
DEFAULT_MAX_FRAME_BYTES = 1 << 30
#: segment-count sanity cap (a frame with more segments than this is junk)
MAX_FRAME_SEGMENTS = 1 << 16


def max_frame_bytes() -> int:
    """The active frame-size cap: ``REPRO_MAX_FRAME_BYTES`` or 1 GiB."""
    raw = os.environ.get("REPRO_MAX_FRAME_BYTES")
    if not raw:
        return DEFAULT_MAX_FRAME_BYTES
    try:
        return max(1, int(raw))
    except ValueError:
        return DEFAULT_MAX_FRAME_BYTES


class ProtocolError(RuntimeError):
    """A malformed frame (oversized, truncated, wrong version, or not a
    JSON message object)."""


class FrameTooLarge(ProtocolError):
    """A legitimate frame exceeded the configured cap. The message names
    the knob so the fix is one environment variable away."""

    def __init__(self, nbytes: int, cap: int):
        super().__init__(
            f"frame of {nbytes} bytes exceeds the {cap}-byte cap; raise "
            "REPRO_MAX_FRAME_BYTES if this payload is legitimate"
        )
        self.nbytes = nbytes
        self.cap = cap


def _recv_exact(
    sock: socket.socket, n: int, *, at_boundary: bool = False
) -> "bytes | None":
    """Read exactly ``n`` bytes. A clean EOF (zero bytes read) at a frame
    boundary returns None — the peer closed between frames. *Anything*
    else that cuts the read short — EOF after partial bytes, EOF mid-frame
    (``at_boundary=False``), or an ``OSError`` under the read — raises
    :class:`ProtocolError`: a torn frame must never masquerade as a
    graceful disconnect (failover treats them very differently)."""
    chunks: "list[bytes]" = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except OSError as exc:
            if got == 0 and at_boundary:
                return None  # peer reset between frames == EOF
            raise ProtocolError(
                f"truncated frame: socket error after {got} of {n} bytes "
                f"({exc})"
            ) from exc
        if not chunk:
            if got == 0 and at_boundary:
                return None
            raise ProtocolError(f"truncated frame: got {got} of {n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def attach_segments(message: Any, segments: "list[bytes]") -> None:
    """Attach each raw segment to its ``ndref`` envelope node (in place,
    under ``"data"``) so :func:`repro_torch.engine.wire.decode_value` reads the
    buffer directly — the decode path never sees a segment index."""
    if isinstance(message, dict):
        if message.get("__wire__") == "ndref" and "seg" in message:
            idx = message["seg"]
            if not isinstance(idx, int) or not 0 <= idx < len(segments):
                raise ProtocolError(
                    f"ndref segment index {idx!r} outside the frame's "
                    f"{len(segments)} segment(s)"
                )
            message["data"] = segments[idx]
            return
        for value in message.values():
            attach_segments(value, segments)
    elif isinstance(message, list):
        for value in message:
            attach_segments(value, segments)


class Channel:
    """A message channel over one connected socket.

    ``send`` is serialized by an internal lock (any thread may reply);
    ``recv`` is single-reader by convention (each side runs one reader
    thread). ``recv`` returns ``None`` on EOF — the peer is gone.

    Wire-traffic counters (``bytes_sent``/``bytes_received``/
    ``frames_sent``/``frames_received``) count everything including frame
    overhead; they feed the per-worker observability rows.
    """

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._send_lock = threading.Lock()
        self._closed = False
        self.bytes_sent = 0
        self.bytes_received = 0
        self.frames_sent = 0
        self.frames_received = 0

    def send(
        self, message: "dict[str, Any]", segments: "Iterable[Any]" = ()
    ) -> None:
        """Frame and send one message. ``segments`` are raw bytes-like
        payload buffers (what a :class:`~repro_torch.engine.wire.SegmentTable`
        collected); they are written verbatim after the envelope — large
        tensors never pass through ``json.dumps`` or base64."""
        envelope = json.dumps(message, separators=(",", ":")).encode("utf-8")
        segs = list(segments)
        total = len(envelope) + sum(len(s) for s in segs)
        cap = max_frame_bytes()
        if total > cap:
            raise FrameTooLarge(total, cap)
        header = _PREFIX.pack(PROTOCOL_VERSION, len(segs), len(envelope))
        if segs:
            header += b"".join(_SEGLEN.pack(len(s)) for s in segs)
        with self._send_lock:
            # header + envelope in one write (small); big segments
            # straight from their buffers — no joining copy
            self._sock.sendall(header + envelope)
            for seg in segs:
                self._sock.sendall(seg)
            self.bytes_sent += len(header) + total
            self.frames_sent += 1

    def recv(self) -> "dict[str, Any] | None":
        prefix = _recv_exact(self._sock, _PREFIX.size, at_boundary=True)
        if prefix is None:
            return None
        version, n_segments, envelope_len = _PREFIX.unpack(prefix)
        if version != PROTOCOL_VERSION:
            raise ProtocolError(
                f"wire protocol version mismatch: peer sent v{version}, "
                f"this side speaks v{PROTOCOL_VERSION} (v1 JSON-frame peers "
                "must be upgraded — mixed-version clusters are refused)"
            )
        if n_segments > MAX_FRAME_SEGMENTS:
            raise ProtocolError(
                f"frame claims {n_segments} segments (cap {MAX_FRAME_SEGMENTS})"
            )
        received = _PREFIX.size
        seg_lens: "list[int]" = []
        if n_segments:
            raw = _recv_exact(self._sock, n_segments * _SEGLEN.size)
            received += len(raw)
            seg_lens = [
                _SEGLEN.unpack_from(raw, i * _SEGLEN.size)[0]
                for i in range(n_segments)
            ]
        total = envelope_len + sum(seg_lens)
        cap = max_frame_bytes()
        if total > cap:
            raise FrameTooLarge(total, cap)
        envelope = _recv_exact(self._sock, envelope_len)
        segments = [_recv_exact(self._sock, n) for n in seg_lens]
        received += total
        message = json.loads(envelope.decode("utf-8"))
        if not isinstance(message, dict) or "kind" not in message:
            raise ProtocolError("frame is not a message object with a 'kind'")
        if segments:
            attach_segments(message, segments)
        self.bytes_received += received
        self.frames_received += 1
        return message

    def wire_stats(self) -> "dict[str, int]":
        return {
            "bytes_sent": self.bytes_sent,
            "bytes_received": self.bytes_received,
            "frames_sent": self.frames_sent,
            "frames_received": self.frames_received,
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
