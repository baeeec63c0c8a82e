"""``paddle-tpu/wire/v1`` — the fleet's framed binary codec, the port of
``paddle_tpu/serving/wire.py``.

It turns :class:`~.kv_cache.SpilledPage` (content-index key, chain
serial, per-layer codes and scales, as host tensors), gossip digest sets
and re-home records into self-describing byte frames and back, bit
exactly. Everything that crosses a replica boundary in :mod:`.fleet`
passes through here. A frame is byte for byte the reference's for the
same float32 or int8 page, digest set or re-home record, and each
package decodes the other's frames.

bfloat16 pools (the card's serving dtype) take dtype tag 2, which the
port adds: the reference refuses to encode a bfloat16 page, and its
decoder reads a tag-2 frame as a ``corrupt`` WireError. The planes travel
as their raw bits, so a bfloat16 round trip is bit exact too.

Frame layout (all integers little-endian)::

    magic   4 bytes  b"PTWR"
    version u8       1
    type    u8       1=page  2=digests  3=rehome
    length  u32      payload byte count
    payload length bytes
    crc32   u32      over magic..payload (header corruption is caught
                     the same as payload corruption)

Error taxonomy — every decode failure is a typed :class:`WireError`
(``truncated`` / ``corrupt`` / ``bad_version``) and **never** anything
else: the transport layer (serving/channel.py) catches ``WireError``,
counts it by kind, and retries; a raised exception escaping a decode
would turn one flipped bit into a dead replica. ``decode_frame`` is
therefore total over arbitrary byte strings (fuzz-pinned by tests).

Payload schemas:

- **page**: key parent serial (u64) + token count (u16) + tokens (i64
  each) + chain serial (u64) + dtype tag (u8: 0=float32, 1=int8,
  2=bfloat16) +
  k/v shape ``[num_layers, page_size, heads, head_dim]`` (4 x u32) +
  raw k bytes + raw v bytes + scales flag (u8; 1 adds the
  ``[num_layers, heads]`` f32 scale planes for quantized pools).
  Round-trip preserves key, serial, dtype, shape, and every byte of
  KV — the restore on the far side is as bit-exact as a local one.
- **digests**: count (u32) + sorted u64 chain digests (sorted so one
  digest set has ONE encoding — a gossip frame is reproducible).
- **rehome**: rid (u64) + max_new_tokens (u32) + deadline flag/f64 +
  tenant (u16 length + utf-8) + prompt length (u32) + tokens (i64
  each) — the record a dead replica's clean waiter travels in.

Span extension (v1-compatible): every payload may end with an optional
tail of ``flag`` (u8, 1) + ``span`` (u64) — the fleetscope span id the
exchange travels under. Encoders emit it only when ``span=`` is
passed, so a frame without a span is byte-identical to the pre-
extension encoding (the codec goldens hold for readers without the
field). ``decode_frame`` ignores the tail; ``decode_frame_span``
returns it as the third element (None when absent).
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from .kv_cache import SpilledPage

__all__ = ["WIRE_SCHEMA", "WIRE_ERROR_KINDS", "WireError",
           "WireTruncatedError",
           "WireCorruptError", "WireVersionError", "RehomeRecord",
           "encode_page", "encode_digests", "encode_rehome",
           "decode_frame", "decode_frame_span"]

WIRE_SCHEMA = "paddle-tpu/wire/v1"

#: the metrics label values of serving_wire_corrupt_total{kind=} — the
#: taxonomy below, in declared order (the router pre-seeds these)
WIRE_ERROR_KINDS = ("truncated", "corrupt", "bad_version")

_MAGIC = b"PTWR"
_VERSION = 1
_HEADER = struct.Struct("<4sBBI")   # magic, version, type, payload len
_TRAILER = struct.Struct("<I")      # crc32

FRAME_PAGE = 1
FRAME_DIGESTS = 2
FRAME_REHOME = 3
_FRAME_KINDS = {FRAME_PAGE: "page", FRAME_DIGESTS: "digests",
                FRAME_REHOME: "rehome"}

# dtype tag <-> the KV planes' dtype (the reference's two, and bfloat16)
_DTYPES = {0: torch.float32, 1: torch.int8, 2: torch.bfloat16}
_DTYPE_TAGS = {v: k for k, v in _DTYPES.items()}


class WireError(ValueError):
    """Base of the decode-failure taxonomy. ``kind`` is the metrics
    label (``serving_wire_corrupt_total{kind=}``); the transport layer
    catches this type and nothing narrower escapes a decode."""
    kind = "corrupt"


class WireTruncatedError(WireError):
    """The buffer ends before the frame does (a cut transfer)."""
    kind = "truncated"


class WireCorruptError(WireError):
    """Checksum or structural mismatch — bytes arrived, but not the
    bytes that left."""
    kind = "corrupt"


class WireVersionError(WireError):
    """A well-formed frame from a protocol this decoder does not
    speak (wrong magic or version byte)."""
    kind = "bad_version"


@dataclass(frozen=True, eq=False)  # ndarray field: identity semantics
class RehomeRecord:
    """A dead replica's clean waiter in transit: everything the router
    needs to re-submit it to a survivor under its original rid.
    ``deadline`` is the ABSOLUTE engine-clock deadline (or None)."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    deadline: float | None
    tenant: str


# ------------------------------------------------------------- framing
def _frame(ftype: int, payload: bytes) -> bytes:
    head = _HEADER.pack(_MAGIC, _VERSION, ftype, len(payload))
    body = head + payload
    return body + _TRAILER.pack(zlib.crc32(body) & 0xFFFFFFFF)


class _Reader:
    """Bounds-checked cursor over a payload — every read raises
    WireTruncatedError instead of IndexError/struct.error."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.at = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.at + n > len(self.buf):
            raise WireTruncatedError(
                f"payload needs {n} bytes at offset {self.at}, "
                f"has {len(self.buf) - self.at}")
        out = self.buf[self.at:self.at + n]
        self.at += n
        return out

    def unpack(self, fmt: struct.Struct):
        return fmt.unpack(self.take(fmt.size))

    def done(self) -> None:
        if self.at != len(self.buf):
            raise WireCorruptError(
                f"{len(self.buf) - self.at} trailing payload bytes")


_U8 = struct.Struct("<B")
_U16 = struct.Struct("<H")
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")


def _span_tail(span) -> bytes:
    """The optional span extension: empty (byte-identical v1 frame)
    when no span rides the exchange."""
    if span is None:
        return b""
    return _U8.pack(1) + _U64.pack(int(span) & 0xFFFFFFFFFFFFFFFF)


def _read_span_tail(r: _Reader):
    """Consume the optional span tail, then enforce payload-exhausted.
    Returns the span id or None."""
    if r.at == len(r.buf):
        return None
    (flag,) = r.unpack(_U8)
    if flag != 1:
        raise WireCorruptError(f"unknown payload extension flag {flag}")
    (span,) = r.unpack(_U64)
    r.done()
    return int(span)


def _pack_tokens(tokens) -> bytes:
    return b"".join(_I64.pack(int(t)) for t in tokens)


def _read_tokens(r: _Reader, n: int) -> tuple:
    return tuple(_I64.unpack(r.take(8))[0] for _ in range(n))


# ---------------------------------------------------------------- pages
def _plane_bytes(t: torch.Tensor) -> bytes:
    """A host tensor's raw bytes in C order (little-endian, as numpy's
    ``tobytes``)."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _plane(buf: bytes, dtype: torch.dtype, shape) -> torch.Tensor:
    return torch.frombuffer(bytearray(buf), dtype=torch.uint8) \
        .view(dtype).reshape(shape).clone()


def encode_page(page: SpilledPage, *, span=None) -> bytes:
    """One :class:`SpilledPage` as a wire frame — key, serial, dtype,
    shape, and the raw KV bytes (plus scale planes when quantized)."""
    parent, block = page.key
    k, v = page.k, page.v
    if k.dtype not in _DTYPE_TAGS:
        raise ValueError(f"unsupported page dtype {k.dtype}")
    if k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"page k/v shapes disagree: {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    out = [_U64.pack(int(parent)), _U16.pack(len(block)),
           _pack_tokens(block), _U64.pack(int(page.serial)),
           _U8.pack(_DTYPE_TAGS[k.dtype])]
    out += [_U32.pack(d) for d in k.shape]
    out += [_plane_bytes(k), _plane_bytes(v)]
    if page.k_scale is not None:
        out += [_U8.pack(1), _plane_bytes(page.k_scale.float()),
                _plane_bytes(page.v_scale.float())]
    else:
        out.append(_U8.pack(0))
    out.append(_span_tail(span))
    return _frame(FRAME_PAGE, b"".join(out))


def _decode_page(r: _Reader) -> SpilledPage:
    (parent,) = r.unpack(_U64)
    (ntok,) = r.unpack(_U16)
    block = _read_tokens(r, ntok)
    (serial,) = r.unpack(_U64)
    (tag,) = r.unpack(_U8)
    dtype = _DTYPES.get(tag)
    if dtype is None:
        raise WireCorruptError(f"unknown page dtype tag {tag}")
    shape = tuple(r.unpack(_U32)[0] for _ in range(4))
    n = int(np.prod(shape)) * dtype.itemsize
    if n > len(r.buf):  # cheap sanity before two big takes
        raise WireTruncatedError(
            f"page plane of {n} bytes exceeds payload")
    k = _plane(r.take(n), dtype, shape)
    v = _plane(r.take(n), dtype, shape)
    (has_scales,) = r.unpack(_U8)
    ks = vs = None
    if has_scales:
        sshape = (shape[0], shape[2])  # [num_layers, heads]
        sn = int(np.prod(sshape)) * 4
        ks = _plane(r.take(sn), torch.float32, sshape)
        vs = _plane(r.take(sn), torch.float32, sshape)
    span = _read_span_tail(r)
    return SpilledPage(key=(int(parent), block), serial=int(serial),
                       k=k, v=v, k_scale=ks, v_scale=vs), span


# -------------------------------------------------------------- digests
def encode_digests(digests, *, span=None) -> bytes:
    """A gossip digest set as a wire frame (sorted — one set, one
    encoding)."""
    ds = sorted(int(d) for d in digests)
    return _frame(FRAME_DIGESTS,
                  _U32.pack(len(ds)) + b"".join(_U64.pack(d) for d in ds)
                  + _span_tail(span))


def _decode_digests(r: _Reader):
    (n,) = r.unpack(_U32)
    out = frozenset(r.unpack(_U64)[0] for _ in range(n))
    return out, _read_span_tail(r)


# --------------------------------------------------------------- rehome
def encode_rehome(rid: int, prompt, max_new_tokens: int,
                  deadline: float | None, tenant: str, *,
                  span=None) -> bytes:
    """A dead replica's clean waiter as a wire frame."""
    tb = tenant.encode("utf-8")
    prompt = np.asarray(prompt)
    out = [_U64.pack(int(rid)), _U32.pack(int(max_new_tokens)),
           _U8.pack(0 if deadline is None else 1),
           _F64.pack(0.0 if deadline is None else float(deadline)),
           _U16.pack(len(tb)), tb,
           _U32.pack(prompt.shape[0]), _pack_tokens(prompt),
           _span_tail(span)]
    return _frame(FRAME_REHOME, b"".join(out))


def _decode_rehome(r: _Reader):
    (rid,) = r.unpack(_U64)
    (mnt,) = r.unpack(_U32)
    (has_deadline,) = r.unpack(_U8)
    (deadline,) = r.unpack(_F64)
    (tlen,) = r.unpack(_U16)
    try:
        tenant = r.take(tlen).decode("utf-8")
    except UnicodeDecodeError as e:
        raise WireCorruptError(f"tenant not utf-8: {e}") from e
    (plen,) = r.unpack(_U32)
    prompt = np.frombuffer(r.take(8 * plen), dtype="<i8") \
        .astype(np.int32)
    span = _read_span_tail(r)
    return RehomeRecord(rid=int(rid), prompt=prompt,
                        max_new_tokens=int(mnt),
                        deadline=float(deadline) if has_deadline else None,
                        tenant=tenant), span


# --------------------------------------------------------------- decode
_PAYLOAD_DECODERS = {FRAME_PAGE: _decode_page,
                     FRAME_DIGESTS: _decode_digests,
                     FRAME_REHOME: _decode_rehome}


def decode_frame(buf: bytes):
    """Decode one frame into ``(kind, value)`` — ``("page",
    SpilledPage)``, ``("digests", frozenset)`` or ``("rehome",
    RehomeRecord)``. Total over arbitrary bytes: every failure is a
    :class:`WireError` subclass, nothing narrower ever escapes."""
    kind, value, _ = decode_frame_span(buf)
    return (kind, value)


def decode_frame_span(buf: bytes):
    """:func:`decode_frame` plus the span extension: ``(kind, value,
    span)`` where ``span`` is the fleetscope span id the frame carried
    (None for a plain v1 frame). Same totality guarantee."""
    if not isinstance(buf, (bytes, bytearray, memoryview)):
        raise WireCorruptError(f"frame must be bytes, "
                               f"got {type(buf).__name__}")
    buf = bytes(buf)
    if len(buf) < _HEADER.size + _TRAILER.size:
        raise WireTruncatedError(
            f"frame of {len(buf)} bytes is shorter than the "
            f"{_HEADER.size + _TRAILER.size}-byte envelope")
    magic, version, ftype, plen = _HEADER.unpack_from(buf)
    if magic != _MAGIC:
        raise WireVersionError(f"bad magic {magic!r}")
    if version != _VERSION:
        raise WireVersionError(f"wire version {version} "
                               f"(this decoder speaks {_VERSION})")
    total = _HEADER.size + plen + _TRAILER.size
    if len(buf) < total:
        raise WireTruncatedError(
            f"frame declares {total} bytes, got {len(buf)}")
    if len(buf) > total:
        raise WireCorruptError(
            f"{len(buf) - total} bytes past the frame trailer")
    (crc,) = _TRAILER.unpack_from(buf, total - _TRAILER.size)
    body = buf[:total - _TRAILER.size]
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise WireCorruptError("crc32 mismatch")
    decoder = _PAYLOAD_DECODERS.get(ftype)
    if decoder is None:
        raise WireCorruptError(f"unknown frame type {ftype}")
    try:
        value, span = decoder(
            _Reader(buf[_HEADER.size:total - _TRAILER.size]))
    except WireError:
        raise
    except Exception as e:  # noqa: BLE001 — taxonomy totality: a frame
        # that passed the CRC but still breaks its payload schema is a
        # codec disagreement, which IS corruption to the transport
        raise WireCorruptError(
            f"payload decode failed: {type(e).__name__}: {e}") from e
    return (_FRAME_KINDS[ftype], value, span)
