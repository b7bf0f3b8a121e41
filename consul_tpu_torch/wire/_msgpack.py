"""The msgpack subset the wire codec speaks, in pure Python.

memberlist frames its messages as go-msgpack bodies. The reference
encodes them with the ``msgpack`` package (``packb(obj,
use_bin_type=False)``) and decodes them with ``unpackb(raw=False,
unicode_errors="surrogateescape")``. The port carries its own encoder and
decoder for that subset and always uses them, so that every machine runs
the same code whether or not ``msgpack`` is installed.

:func:`packb` writes exactly the bytes of ``msgpack.packb(obj,
use_bin_type=False)`` for None, bool, int, float, str, bytes, lists and
dicts (keys in insertion order): the legacy raw family (fixraw, raw16,
raw32) for both str and bytes, never str8 or bin; the smallest int form,
signed and unsigned; float64. Other types raise ``TypeError``, ints out
of the 64-bit range ``OverflowError``, strings that are not valid UTF-8
``UnicodeEncodeError``, as ``msgpack`` does.

:func:`unpackb` returns what ``msgpack.unpackb(data, raw=False,
unicode_errors="surrogateescape")`` returns, or raises ``ValueError``
where that raises: it reads every format of the spec (str8 and the bin
family included, which an agent may send) except the ext family, which
memberlist never uses and which raises ``ValueError`` here (``msgpack``
returns an ``ExtType`` for it); a map key that is not str or bytes
raises (``strict_map_key``), trailing bytes raise, and containers nest at
most 1,024 deep (``msgpack``'s stack). :class:`Unpacker` reads a buffer
value by value and reports its offset (:meth:`Unpacker.tell`), as the
streaming ``msgpack.Unpacker`` does for push-pull payloads.
"""

from __future__ import annotations

import struct

# msgpack's unpacker stack: at most this many open containers.
MAX_DEPTH = 1024

_F64 = struct.Struct(">d")
_F32 = struct.Struct(">f")
_INT_FORMS = ((0xd0, ">b", 1), (0xd1, ">h", 2), (0xd2, ">i", 4),
              (0xd3, ">q", 8))
_UINT_FORMS = ((0xcc, ">B", 1), (0xcd, ">H", 2), (0xce, ">I", 4),
               (0xcf, ">Q", 8))


# ----------------------------------------------------------------------
# Encoder
# ----------------------------------------------------------------------

def _pack_int(x: int, out: bytearray):
    if 0 <= x < 128 or -32 <= x < 0:
        out += struct.pack(">b" if x < 0 else ">B", x)
        return
    forms = _UINT_FORMS if x >= 0 else _INT_FORMS
    for code, fmt, size in forms:
        lo, hi = ((0, 1 << (8 * size)) if x >= 0
                  else (-(1 << (8 * size - 1)), 1 << (8 * size - 1)))
        if lo <= x < hi:
            out.append(code)
            out += struct.pack(fmt, x)
            return
    raise OverflowError("Integer value out of range")


def _pack_len(n: int, small: int, small_max: int, c16: int, c32: int,
              out: bytearray, what: str):
    if n <= small_max:
        out.append(small | n)
    elif n <= 0xFFFF:
        out.append(c16)
        out += struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out.append(c32)
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"{what} is too large")


def _pack(obj, out: bytearray, depth: int):
    if depth > 511:
        raise ValueError("recursion limit exceeded.")
    if obj is None:
        out.append(0xc0)
    elif obj is True:
        out.append(0xc3)
    elif obj is False:
        out.append(0xc2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += _F64.pack(obj)
    elif isinstance(obj, (str, bytes, bytearray, memoryview)):
        raw = obj.encode("utf-8") if isinstance(obj, str) else bytes(obj)
        _pack_len(len(raw), 0xa0, 31, 0xda, 0xdb, out, "raw")
        out += raw
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, 0xdc, 0xdd, out, "list")
        for x in obj:
            _pack(x, out, depth + 1)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, 0xde, 0xdf, out, "dict")
        for k, v in obj.items():
            _pack(k, out, depth + 1)
            _pack(v, out, depth + 1)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=False)``."""
    out = bytearray()
    _pack(obj, out, 0)
    return bytes(out)


# ----------------------------------------------------------------------
# Decoder
# ----------------------------------------------------------------------

class _Container:
    __slots__ = ("value", "left", "key", "has_key")

    def __init__(self, value, left):
        self.value = value
        self.left = left
        self.key = None
        self.has_key = False


def _decode_one(buf: bytes, pos: int):
    """One value from ``buf[pos:]``: ``(value, end offset)``. Raises
    ValueError on malformed or incomplete input."""
    end = len(buf)
    stack: list[_Container] = []

    def need(k):
        if pos + k > end:
            raise ValueError("Unpack failed: incomplete input")

    while True:
        need(1)
        b = buf[pos]
        pos += 1
        container = None
        if b <= 0x7f:
            value = b
        elif b >= 0xe0:
            value = b - 0x100
        elif 0xa0 <= b <= 0xbf or b in (0xd9, 0xda, 0xdb):
            if b <= 0xbf:
                n = b & 0x1f
            else:
                size = {0xd9: 1, 0xda: 2, 0xdb: 4}[b]
                need(size)
                n = int.from_bytes(buf[pos:pos + size], "big")
                pos += size
            need(n)
            value = bytes(buf[pos:pos + n]).decode("utf-8", "surrogateescape")
            pos += n
        elif b in (0xc4, 0xc5, 0xc6):
            size = {0xc4: 1, 0xc5: 2, 0xc6: 4}[b]
            need(size)
            n = int.from_bytes(buf[pos:pos + size], "big")
            pos += size
            need(n)
            value = bytes(buf[pos:pos + n])
            pos += n
        elif 0x90 <= b <= 0x9f or b in (0xdc, 0xdd):
            if b <= 0x9f:
                n = b & 0x0f
            else:
                size = 2 if b == 0xdc else 4
                need(size)
                n = int.from_bytes(buf[pos:pos + size], "big")
                pos += size
            value = []
            container = _Container(value, n) if n else None
        elif 0x80 <= b <= 0x8f or b in (0xde, 0xdf):
            if b <= 0x8f:
                n = b & 0x0f
            else:
                size = 2 if b == 0xde else 4
                need(size)
                n = int.from_bytes(buf[pos:pos + size], "big")
                pos += size
            value = {}
            container = _Container(value, 2 * n) if n else None
        elif b == 0xc0:
            value = None
        elif b == 0xc2:
            value = False
        elif b == 0xc3:
            value = True
        elif b == 0xca:
            need(4)
            value = _F32.unpack_from(buf, pos)[0]
            pos += 4
        elif b == 0xcb:
            need(8)
            value = _F64.unpack_from(buf, pos)[0]
            pos += 8
        elif 0xcc <= b <= 0xcf or 0xd0 <= b <= 0xd3:
            _, fmt, size = (_UINT_FORMS if b <= 0xcf else _INT_FORMS)[b & 0x3]
            need(size)
            value = struct.unpack_from(fmt, buf, pos)[0]
            pos += size
        elif 0xc7 <= b <= 0xc9 or 0xd4 <= b <= 0xd8:
            raise ValueError(f"msgpack ext type {b:#04x} is not part of "
                             "memberlist's wire format")
        else:  # 0xc1, never used
            raise ValueError(f"Unpack failed: reserved byte {b:#04x}")

        if isinstance(value, (list, dict)) and len(stack) >= MAX_DEPTH:
            raise ValueError("Unpack failed: nesting deeper than "
                             f"{MAX_DEPTH} containers")
        if container is not None:
            stack.append(container)
            continue
        # Hand the finished value up the stack.
        while True:
            if not stack:
                return value, pos
            top = stack[-1]
            if isinstance(top.value, list):
                top.value.append(value)
            elif not top.has_key:
                if not isinstance(value, (str, bytes)):
                    raise ValueError(f"{type(value).__name__} is not allowed "
                                     "for map key when strict_map_key=True")
                top.key, top.has_key = value, True
            else:
                top.value[top.key] = value
                top.has_key = False
            top.left -= 1
            if top.left:
                break
            value = stack.pop().value


def unpackb(data) -> object:
    """``msgpack.unpackb(data, raw=False, unicode_errors="surrogateescape")``
    with ValueError for every malformation (ext types included)."""
    buf = bytes(data)
    value, pos = _decode_one(buf, 0)
    if pos != len(buf):
        raise ValueError("unpack(b) received extra data.")
    return value


class Unpacker:
    """Value-by-value reads of one buffer: :meth:`feed`, :meth:`unpack`
    (ValueError when the buffer holds no whole value), :meth:`tell` (the
    offset after the last value read)."""

    def __init__(self):
        self._buf = b""
        self._pos = 0

    def feed(self, data):
        self._buf += bytes(data)

    def unpack(self):
        value, self._pos = _decode_one(self._buf, self._pos)
        return value

    def tell(self) -> int:
        return self._pos
