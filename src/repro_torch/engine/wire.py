"""Stable wire serialization for engine values.

One canonical, JSON-compatible encoding shared by two consumers that must
agree on request identity:

- the **wire form of a request** (``Request.to_wire()`` /
  ``Request.from_wire()``): dtype/shape-preserving, bit-exact array round
  trips;
- the **dedup content hash** (:func:`~repro_torch.engine.service._content_hash`):
  the sha256 of :func:`canonical_bytes` over the same encoding, so "two
  requests are the same computation" means exactly "they serialize to the
  same wire bytes".

The bytes are those of the JAX package's wire format: a tensor encodes to
exactly what a numpy array with the same values and dtype encodes to, and a
dataclass to the same fields under its ``repro_torch.*`` class path.

Encoding rules (``encode_value``):

- JSON scalars (``None``/bool/int/float/str) pass through.
- Tensors and array-likes (anything with ``shape``+``dtype``) have three
  wire forms, each carrying numpy's dtype string (``"float32"``,
  ``"int32"``, ``"int64"``, ``"bool"``) and the shape:

  * inline ``{"__wire__": "nd", "dtype", "shape", "data"}`` with ``data``
    the base64 of the C-order buffer — the *canonical* form, what
    :func:`canonical_bytes` always emits (dedup identity is pinned to it);
  * out-of-band ``{"__wire__": "ndref", "seg", "dtype", "shape"}`` when a
    :class:`SegmentTable` is passed — the raw C-order buffer is appended
    as segment ``seg`` instead of being base64-inflated into the envelope;
  * content-addressed ``{"__wire__": "blobref", "digest", "dtype",
    "shape"}`` when a ``blob_sink`` claims the array — the bytes do not
    travel with the envelope; the receiver resolves the digest through
    ``blob_resolver`` on decode. The sink is asked before any host copy is
    made: a card-resident tensor whose digest the sink already knows
    crosses as a blobref without leaving the card.

  A tensor's host copy is ``t.detach().cpu().contiguous()``. ``bfloat16``
  has no numpy dtype: its raw 2-byte buffer travels under the dtype string
  ``"bfloat16"``, which is what the JAX package writes for an ``ml_dtypes``
  array. Every form decodes to a **CPU tensor**; :func:`to_device` moves a
  decoded value's tensors onto a device.
- Dataclasses become ``{"__wire__": "dc", "cls": "module:qualname",
  "fields": {...}}``. Decoding imports the class, **restricted to
  ``repro_torch.*`` modules** — a payload naming any other module (the JAX
  package's ``repro.*`` included) is refused before anything is imported.
- Enums (``{"__wire__": "enum"}``) and tuples (``{"__wire__": "tuple"}``)
  are tagged so they survive JSON's list/str flattening; dicts are tagged
  with sorted items so plain mappings can't collide with wire tags and the
  canonical bytes are order-independent.
- Anything else falls back to ``{"__wire__": "repr"}`` — good enough to
  *hash* but refused by ``decode_value``.

``canonical_bytes`` is ``json.dumps(encode_value(v), sort_keys=True)``
encoded UTF-8: deterministic across processes and Python hash seeds, and
never in segment or blobref form.
"""
from __future__ import annotations

import base64
import dataclasses
import enum
import hashlib
import importlib
import json
from typing import Any, Callable

import numpy as np
import torch

WIRE_VERSION = 1

_TAG = "__wire__"
_PACKAGE = "repro_torch"
_BF16 = "bfloat16"


class WireError(ValueError):
    """A value cannot be encoded for, or decoded from, the wire."""


class SegmentTable:
    """Out-of-band payload collector: passed to :func:`encode_value` as
    ``segments=``, every array's raw C-order buffer lands in
    :attr:`segments` and the envelope carries only an ``ndref`` with the
    segment index. A receiver attaches segment ``i`` to its ``ndref`` node
    under ``"data"`` before decoding."""

    def __init__(self):
        self.segments: "list[Any]" = []  # bytes-like: memoryview | bytes

    def add(self, buf: Any) -> int:
        self.segments.append(buf)
        return len(self.segments) - 1

    def nbytes(self) -> int:
        return sum(len(s) for s in self.segments)

    def __len__(self) -> int:
        return len(self.segments)


def host_array(value: Any) -> "tuple[np.ndarray, str]":
    """``(C-contiguous host array, wire dtype string)`` of a tensor or
    array-like. A bfloat16 tensor's array holds its raw 2-byte words. As in
    the JAX package, a 0-d value comes out with shape ``(1,)``
    (``np.ascontiguousarray``), so its bytes are the reference's."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return np.ascontiguousarray(t.view(torch.int16).numpy()), _BF16
        arr = np.ascontiguousarray(t.numpy())
    else:
        arr = np.ascontiguousarray(np.asarray(value))
    if arr.dtype == object:
        raise WireError("object-dtype arrays cannot cross the wire")
    return arr, str(arr.dtype)


def wire_meta(value: Any) -> "tuple[str, list[int]]":
    """``(wire dtype string, shape)`` of a tensor or array-like, as
    :func:`host_array` would give them, without copying a tensor to the
    host (a 0-d value has shape ``[1]``)."""
    if isinstance(value, torch.Tensor):
        if value.dtype == torch.bfloat16:
            return _BF16, list(value.shape) or [1]
        return str(torch.empty(0, dtype=value.dtype).numpy().dtype), list(value.shape) or [1]
    arr, dtype = host_array(value)
    return dtype, list(arr.shape)


def array_nbytes(value: Any) -> int:
    """Bytes of a tensor's or array-like's buffer, without a host copy."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return int(np.asarray(value).nbytes)


def _byte_view(arr: np.ndarray) -> Any:
    """A flat byte view of a C-contiguous array (no copy when the buffer
    protocol allows it; ``tobytes`` otherwise)."""
    try:
        return memoryview(arr).cast("B")
    except (TypeError, ValueError):
        return arr.tobytes()


def _tensor_from_bytes(raw: Any, dtype: str, shape: list) -> torch.Tensor:
    """A fresh, writable CPU tensor from a raw C-order buffer."""
    if dtype == _BF16:
        words = np.frombuffer(raw, dtype=np.int16).copy()
        return torch.from_numpy(words).view(torch.bfloat16).reshape(tuple(shape))
    arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(tuple(shape)).copy()
    return torch.from_numpy(arr)


def _class_path(cls: type) -> str:
    return f"{cls.__module__}:{cls.__qualname__}"


def _resolve_class(path: str) -> type:
    module, _, qualname = path.partition(":")
    if not (module == _PACKAGE or module.startswith(_PACKAGE + ".")):
        raise WireError(
            f"refusing to resolve wire class {path!r}: only {_PACKAGE}.* types "
            "may cross the wire"
        )
    obj: Any = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    if not isinstance(obj, type):
        raise WireError(f"wire class path {path!r} is not a class")
    return obj


def encode_value(
    value: Any,
    *,
    segments: "SegmentTable | None" = None,
    blob_sink: "Callable[[Any, np.ndarray], str | None] | None" = None,
) -> Any:
    """Encode ``value`` into the JSON-compatible wire form (module doc).

    ``segments`` switches arrays to out-of-band ``ndref`` form (raw buffer
    appended to the table, no base64). ``blob_sink(original)`` is consulted
    first for every array, before its host copy is made: returning a digest
    string emits a ``blobref`` (dtype and shape from :func:`wire_meta`);
    returning ``None`` falls through to the segment/inline path. Neither
    affects :func:`canonical_bytes`, which always encodes inline.
    """
    if isinstance(value, enum.Enum):
        # before the scalar pass-through: str/int-mixin enums (Comm, Layout,
        # Scheme) must round-trip as enum members, not bare scalars
        return {
            _TAG: "enum",
            "cls": _class_path(type(value)),
            "value": encode_value(value.value),
        }
    if value is None or isinstance(value, (bool, int, str, float)):
        return value  # json round-trips NaN/Infinity via its literals
    if hasattr(value, "shape") and hasattr(value, "dtype"):
        if blob_sink is not None:
            digest = blob_sink(value)
            if digest is not None:
                dtype, shape = wire_meta(value)
                return {_TAG: "blobref", "digest": digest, "dtype": dtype, "shape": shape}
        arr, dtype = host_array(value)
        shape = list(arr.shape)
        if segments is not None:
            return {_TAG: "ndref", "seg": segments.add(_byte_view(arr)), "dtype": dtype,
                    "shape": shape}
        return {
            _TAG: "nd",
            "dtype": dtype,
            "shape": shape,
            "data": base64.b64encode(arr.tobytes()).decode("ascii"),
        }
    sub = dict(segments=segments, blob_sink=blob_sink)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return {
            _TAG: "dc",
            "cls": _class_path(type(value)),
            "fields": {
                f.name: encode_value(getattr(value, f.name), **sub)
                for f in dataclasses.fields(value)
            },
        }
    if isinstance(value, (tuple, list)):
        tag = "tuple" if isinstance(value, tuple) else "list"
        return {_TAG: tag, "items": [encode_value(v, **sub) for v in value]}
    if isinstance(value, dict):
        items = [[encode_value(k), encode_value(v, **sub)] for k, v in value.items()]
        items.sort(key=lambda kv: json.dumps(kv[0], sort_keys=True, default=str))
        return {_TAG: "dict", "items": items}
    # hash-only fallback: identity for dedup, but not reconstructable
    return {_TAG: "repr", "repr": repr(value), "cls": _class_path(type(value))}


def decode_value(
    value: Any,
    *,
    blob_resolver: "Callable[[str], Any] | None" = None,
) -> Any:
    """Rebuild a value from its wire form; arrays come back as fresh,
    writable CPU tensors. Raises :class:`WireError` for hash-only
    (``repr``) payloads, unattached ``ndref`` segments, ``blobref`` values
    without a ``blob_resolver``, and classes outside ``repro_torch.*``.
    A resolved blob comes back as the resolver gives it, a numpy array as
    a CPU tensor (a copy: a store's entries stay its own)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, list):  # bare lists never appear, but be lenient
        return [decode_value(v, blob_resolver=blob_resolver) for v in value]
    if not isinstance(value, dict):
        raise WireError(f"unexpected wire value of type {type(value).__name__}")
    tag = value.get(_TAG)
    sub = dict(blob_resolver=blob_resolver)
    if tag == "nd":
        return _tensor_from_bytes(base64.b64decode(value["data"]), value["dtype"], value["shape"])
    if tag == "ndref":
        raw = value.get("data")
        if raw is None:
            raise WireError(
                f"ndref segment {value.get('seg')!r} was not attached — "
                "ndref values decode only with their segment attached under 'data'"
            )
        return _tensor_from_bytes(raw, value["dtype"], value["shape"])
    if tag == "blobref":
        if blob_resolver is None:
            raise WireError(
                f"blobref {value.get('digest')!r} cannot be decoded without "
                "a blob store (pass blob_resolver=)"
            )
        blob = blob_resolver(value["digest"])
        return torch.from_numpy(np.array(blob)) if isinstance(blob, np.ndarray) else blob
    if tag == "enum":
        return _resolve_class(value["cls"])(decode_value(value["value"]))
    if tag == "dc":
        cls = _resolve_class(value["cls"])
        return cls(**{k: decode_value(v, **sub) for k, v in value["fields"].items()})
    if tag == "tuple":
        return tuple(decode_value(v, **sub) for v in value["items"])
    if tag == "list":
        return [decode_value(v, **sub) for v in value["items"]]
    if tag == "dict":
        return {decode_value(k): decode_value(v, **sub) for k, v in value["items"]}
    if tag == "repr":
        raise WireError(
            f"value of type {value.get('cls')!r} was encoded hash-only "
            "(repr fallback) and cannot be decoded"
        )
    raise WireError(f"unknown wire tag {tag!r}")


def to_device(value: Any, device: "str | torch.device") -> Any:
    """``value`` with every tensor inside it (dataclass fields, tuples,
    lists, dict values) moved to ``device``; other leaves stay as they
    are."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return type(value)(**{
            f.name: to_device(getattr(value, f.name), device) for f in dataclasses.fields(value)
        })
    if isinstance(value, (tuple, list)):
        return type(value)(to_device(v, device) for v in value)
    if isinstance(value, dict):
        return {k: to_device(v, device) for k, v in value.items()}
    return value


def collect_blob_digests(encoded: Any) -> "list[str]":
    """Every ``blobref`` digest reachable in an *encoded* wire structure,
    in first-appearance order (deduplicated): a receiver pre-scans a
    payload with this to fetch missing blobs before decoding it."""
    out: "list[str]" = []
    seen: "set[str]" = set()

    def walk(obj: Any) -> None:
        if isinstance(obj, dict):
            if obj.get(_TAG) == "blobref":
                digest = obj.get("digest")
                if digest not in seen:
                    seen.add(digest)
                    out.append(digest)
                return
            for v in obj.values():
                walk(v)
        elif isinstance(obj, list):
            for v in obj:
                walk(v)

    walk(encoded)
    return out


def canonical_bytes(value: Any) -> bytes:
    """Deterministic byte encoding of ``value`` — the dedup-hash payload.
    Stable across processes and Python hash seeds: sorted keys, no
    whitespace, UTF-8, and always the inline (base64) array form, so
    identity does not depend on transport."""
    return json.dumps(encode_value(value), sort_keys=True, separators=(",", ":")).encode("utf-8")


def content_digest(value: Any) -> str:
    """sha256 hex digest of :func:`canonical_bytes`: the one
    content-addressed identity (dedup hashes whole requests with it; a
    blob store addresses single arrays with it)."""
    return hashlib.sha256(canonical_bytes(value)).hexdigest()


# raw bytes one step of array_digest base64-encodes: a multiple of 3, so the
# steps' texts concatenate to the whole buffer's, and small enough that a
# thread verifying a large blob lets the others run between steps
_DIGEST_STEP = 3 << 18


def array_digest(value: Any) -> str:
    """:func:`content_digest` of one tensor or array-like, computed without
    building its canonical bytes: the base64 text is hashed in steps of
    :data:`_DIGEST_STEP` raw bytes between the JSON around it, so a blob of
    hundreds of MB needs no text of its size and never holds the
    interpreter lock for long."""
    arr, dtype = host_array(value)
    text = json.dumps({_TAG: "nd", "data": "", "dtype": dtype, "shape": list(arr.shape)},
                      sort_keys=True, separators=(",", ":"))
    head, tail = text.split('"data":""')
    h = hashlib.sha256(f'{head}"data":"'.encode("utf-8"))
    flat = _byte_view(arr)
    for i in range(0, len(flat), _DIGEST_STEP):
        h.update(base64.b64encode(flat[i:i + _DIGEST_STEP]))
    h.update(f'"{tail}'.encode("utf-8"))
    return h.hexdigest()


def dumps(value: Any) -> bytes:
    """Wire bytes for a message body (canonical form, so equal values
    produce equal bytes)."""
    return canonical_bytes(value)


def loads(data: bytes) -> Any:
    return decode_value(json.loads(data.decode("utf-8")))
