"""Wire framing — the codec layer every bus backend shares.

The seed wire framed every control head as ``json.dumps(head)`` with the
ndarray blob riding a separate multipart frame. On loopback — where every
bench arm in this repo runs — that JSON round-trip IS the dominant cost
of a frame (ROADMAP item 5): text-encoding per-leg int lists (acks,
seqs, svU block tables, clock vectors) and re-parsing them on the
receive thread costs more than the memcpy the frame exists to move.

This module defines the wire format ONCE, for all backends (zmq, native,
shm):

- **Binary head** (default, ``MINIPS_WIRE_FMT=bin``): a fixed
  struct-packed prefix (magic, version, stream flags, sender, seq, kind)
  followed by a compact TLV tail for the payload dict. Homogeneous int
  lists — the hot fields — pack as raw little-endian int64 arrays
  (one C-speed ``struct.pack`` call, no text). ndarray payloads never
  enter the head at all: they ride the blob slot as raw bytes views
  (``memoryview``/``np.frombuffer`` — no base64, no copy).
- **JSON head** (``MINIPS_WIRE_FMT=json``): the seed codec, kept
  selectable for A/B honesty drills and byte-level debugging.

Receivers never need to know the sender's format: :func:`decode_head`
sniffs the first byte (binary frames open with ``MAGIC``; JSON heads
open with ``{``), so a mixed fleet — one rank on the seed codec —
decodes per frame instead of dying on the first foreign head. TLV
additionally carries raw ``bytes`` values (JSON cannot), which the
reliable channel's retransmit wrapper uses to re-ship binary heads
verbatim.

The TLV decode mirrors JSON's semantic quirks on purpose so handlers
see identical objects whichever codec framed the wire: dict keys are
coerced to ``str`` on encode (``json.dumps`` does this silently) and
tuples decode as lists.

Head-key contract: payload keys ride the TLV tail VERBATIM — there is
no fixed key table to extend, which is what lets a protocol layer add
a stamp without a codec version bump. The per-frame config stamp
(``ws``/``nr``/``dm``/``rb``, train/sharded_ps._cfg_header) grew the
tenancy field ``tb`` this way (tenant/registry.py: the owning table's
1-based tenant id; absent = tenancy off, so an off fleet's frames are
byte-identical to pre-tenancy builds and the small-int TLV path makes
the armed stamp cost three bytes).

A copy of ``minips_tpu/comm/framing.py``, which imports no JAX.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional, Union

__all__ = ["MAGIC", "wire_fmt_from_env", "encode_head", "encode_head_bin",
           "decode_head", "decode_head_bytes", "dup_msg", "rt_wrap"]

MAGIC = 0xB6  # first byte of every binary head; != ord("{") (0x7B)
_VER = 1

# magic u8 | version u8 | flags u8 (1=bs, 2=ds) | sender i32 | seq i64
# | kind_len u16  — then kind utf8, then the TLV payload
_PRE = struct.Struct("<BBBiqH")
_U32 = struct.Struct("<I")
_I64 = struct.Struct("<q")
_F64 = struct.Struct("<d")
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_QPACK: dict[int, struct.Struct] = {}  # int-list packers, keyed by count


def _qstruct(n: int) -> struct.Struct:
    """Count-keyed ``<I{n}q`` codec for the int64-list fast path,
    shared by encode and decode — struct's own format cache holds only
    100 entries and clears wholesale when full, and ack/seq list
    lengths vary enough to thrash it. Bounded the same way."""
    s = _QPACK.get(n)
    if s is None:
        if len(_QPACK) >= 1024:
            _QPACK.clear()
        s = _QPACK[n] = struct.Struct(f"<I{n}q")
    return s


def wire_fmt_from_env() -> str:
    """Resolve ``$MINIPS_WIRE_FMT`` (``bin`` default, ``json`` = seed)."""
    fmt = os.environ.get("MINIPS_WIRE_FMT", "bin").strip() or "bin"
    if fmt not in ("bin", "json"):
        raise ValueError(f"MINIPS_WIRE_FMT={fmt!r} (expected bin|json)")
    return fmt


# ------------------------------------------------------------------ encode
_pU32, _pI64, _pF64 = _U32.pack, _I64.pack, _F64.pack


def _enc(out: bytearray, v) -> None:
    t = type(v)
    if t is int:             # the common case first (seqs/reqs/clocks)
        if _I64_MIN <= v <= _I64_MAX:
            out += b"i" + _pI64(v)
        else:                # arbitrary precision: decimal text
            b = str(v).encode()
            out += b"n" + _pU32(len(b)) + b
    elif t is str:
        b = v.encode()
        out += b"s" + _pU32(len(b)) + b
    elif t is bool:          # bool is an int subclass, but type() is exact
        out += b"T" if v else b"F"
    elif t is float:
        out += b"f" + _pF64(v)
    elif v is None:
        out += b"Z"
    elif t is dict:
        out += b"d" + _pU32(len(v))
        for k, item in v.items():
            kb = (k if type(k) is str else _json_key(k)).encode()
            out += _pU32(len(kb)) + kb
            _enc(out, item)
    elif t in (list, tuple):
        n = len(v)
        if n and all(type(x) is int and _I64_MIN <= x <= _I64_MAX
                     for x in v):
            # the hot fast path: acks/seqs/clock vectors pack as one
            # raw int64 array — this is where JSON paid per digit
            # (type() not isinstance(): bool must keep its JSON shape)
            out += b"q" + _qstruct(n).pack(n, *v)
        else:
            out += b"l" + _U32.pack(n)
            for item in v:
                _enc(out, item)
    elif t in (bytes, bytearray, memoryview):
        b = bytes(v)
        out += b"b" + _U32.pack(len(b)) + b
    else:
        raise TypeError(
            f"frame payload value of type {t.__name__} is not wire-"
            "encodable (JSON types + bytes only)")


def _json_key(k) -> str:
    """Match ``json.dumps`` key coercion so both codecs deliver the same
    payload shape to handlers."""
    if k is True:
        return "true"
    if k is False:
        return "false"
    if k is None:
        return "null"
    if isinstance(k, (int, float)):
        return json.dumps(k)
    raise TypeError(f"frame payload dict key {k!r} is not wire-encodable")


def encode_head_bin(head: dict) -> bytes:
    flags, seq = 0, 0
    if "bs" in head:
        flags, seq = 1, int(head["bs"])
    elif "ds" in head:
        flags, seq = 2, int(head["ds"])
    kind = str(head.get("kind", "")).encode()
    out = bytearray(_PRE.pack(MAGIC, _VER, flags,
                              int(head.get("sender", -1)), seq,
                              len(kind)))
    out += kind
    _enc(out, head.get("payload", {}))
    return bytes(out)


def encode_head(head: dict, fmt: str = "bin") -> bytes:
    """Encode a control head on the chosen wire format. The head shape
    is fixed by the backends' ``_emit``: kind, sender, payload, and at
    most one of bs/ds."""
    if fmt == "json":
        return json.dumps(head).encode()
    return encode_head_bin(head)


# ------------------------------------------------------------------ decode
def _dec(buf, off: int):
    tag = buf[off:off + 1]
    off += 1
    if tag == b"i":
        return _I64.unpack_from(buf, off)[0], off + 8
    if tag == b"s":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        return bytes(buf[off:off + n]).decode(), off + n
    if tag == b"q":
        n = _U32.unpack_from(buf, off)[0]
        # the shared cached struct covers count + values; skip the count
        return (list(_qstruct(n).unpack_from(buf, off)[1:]),
                off + 4 + 8 * n)
    if tag == b"d":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        d = {}
        for _ in range(n):
            kl = _U32.unpack_from(buf, off)[0]
            off += 4
            k = bytes(buf[off:off + kl]).decode()
            off += kl
            d[k], off = _dec(buf, off)
        return d, off
    if tag == b"l":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        items = []
        for _ in range(n):
            v, off = _dec(buf, off)
            items.append(v)
        return items, off
    if tag == b"f":
        return _F64.unpack_from(buf, off)[0], off + 8
    if tag == b"T":
        return True, off
    if tag == b"F":
        return False, off
    if tag == b"Z":
        return None, off
    if tag == b"b":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        return bytes(buf[off:off + n]), off + n
    if tag == b"n":
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        return int(bytes(buf[off:off + n])), off + n
    raise ValueError(f"bad TLV tag {tag!r} at offset {off - 1}")


def decode_head_bytes(raw: Union[bytes, bytearray, memoryview]
                      ) -> Optional[dict]:
    """Decode a BINARY head; None on any structural damage (the caller
    counts it malformed, like torn JSON)."""
    try:
        magic, ver, flags, sender, seq, klen = _PRE.unpack_from(raw, 0)
        if magic != MAGIC or ver != _VER:
            return None
        off = _PRE.size
        kind = bytes(raw[off:off + klen]).decode()
        off += klen
        payload, off = _dec(raw, off)
        if off != len(raw) or not isinstance(payload, dict):
            return None
        head = {"kind": kind, "sender": sender, "payload": payload}
        if flags == 1:
            head["bs"] = seq
        elif flags == 2:
            head["ds"] = seq
        return head
    except (struct.error, ValueError, UnicodeDecodeError, IndexError):
        return None


def decode_head(raw) -> Optional[dict]:
    """Backend-shared head decode, format-sniffed per frame: binary
    heads open with ``MAGIC``, JSON heads with ``{``. ``str`` input
    (a journaled JSON head re-shipped through a retransmit wrapper)
    decodes as JSON. Returns None for malformed frames — the caller
    counts them (``frames_malformed``) instead of raising on the
    receive thread."""
    if isinstance(raw, str):
        try:
            msg = json.loads(raw)
        except json.JSONDecodeError:
            return None
        return msg if isinstance(msg, dict) else None
    if isinstance(raw, memoryview):
        raw = bytes(raw)
    if raw[:1] == b"{":
        try:
            msg = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None
        return msg if isinstance(msg, dict) else None
    return decode_head_bytes(raw)


# --------------------------------------------------------------- utilities
def rt_wrap(msg: Union[bytes, bytearray, memoryview]) -> dict:
    """The reliable channel's ``__rt`` retransmit payload for a
    journaled encoded head: JSON heads ride as text (``"m"``), binary
    heads as raw bytes (``"m2"`` — TLV carries bytes natively, JSON
    cannot). Defined HERE because two layers must agree on its exact
    shape: comm/reliable.py ships it on NACK, and comm/shm_bus.py's
    record-cap pre-check sizes the very same wrapper so a frame that
    fits at first send can never become unretransmittable."""
    msg = bytes(msg) if not isinstance(msg, bytes) else msg
    return {"m": msg.decode()} if msg[:1] == b"{" else {"m2": msg}


def dup_msg(msg: dict) -> dict:
    """Codec-agnostic deep copy of a decoded head — what the chaos
    injector's duplicate op needs (handlers receive the payload dict
    itself and may mutate it, so the dup must not alias). The seed did
    ``json.loads(json.dumps(msg))``, which double-pays the codec on
    every dup AND raises on binary-only values (bytes in a retransmit
    wrapper). This walks the decoded object instead: no re-encode, any
    wire-encodable value."""
    return {k: _dup(v) for k, v in msg.items()}


def _dup(v):
    t = type(v)
    if t is dict:
        return {k: _dup(x) for k, x in v.items()}
    if t is list:
        return [_dup(x) for x in v]
    if t is tuple:
        return [_dup(x) for x in v]  # JSON parity: tuples decode as lists
    if t is bytearray or t is memoryview:
        return bytes(v)
    return v  # str/int/float/bool/None/bytes: immutable
