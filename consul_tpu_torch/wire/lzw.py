"""LZW (LSB, 8-bit literals) — memberlist's payload compression.

Mirrors Go's ``compress/lzw`` as used by the reference
(memberlist/util.go:221-275: ``lzw.NewWriter(buf, lzw.LSB,
lzwLitWidth=8)``): 9→12-bit codes, CLEAR=256/EOF=257, table reset via
CLEAR when code 4095 is reached.

Two implementations with identical output (the port's copy of
``consul_tpu/wire/lzw.py``): the native C++ codec (``native/lzw.cpp``,
built on first use with g++ into the kernels' build directory,
``utils/compile_cache.build_dir()``, by default ``build/consul_tpu_torch/``,
and loaded through ctypes), and the pure-Python version below, used
where no compiler exists and the cross-check in tests. The library's
file name carries a hash of the source; two processes that build at
once each compile to a temporary name and rename it into place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

from consul_tpu_torch.utils import compile_cache

_CLEAR, _EOF, _FIRST, _MAX_CODE = 256, 257, 258, (1 << 12) - 1

# ----------------------------------------------------------------------
# Pure-Python reference implementation
# ----------------------------------------------------------------------


def compress_py(data: bytes) -> bytes:
    out = bytearray()
    acc = 0
    nbits = 0

    def put(code: int, width: int):
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table: dict[int, int] = {}
    hi, width, overflow = _EOF, 9, 1 << 9
    if data:
        saved = data[0]
        for x in data[1:]:
            key = (saved << 8) | x
            nxt = table.get(key)
            if nxt is not None:
                saved = nxt
                continue
            put(saved, width)
            saved = x
            hi += 1
            if hi == overflow:
                width += 1
                overflow <<= 1
            if hi == _MAX_CODE:
                put(_CLEAR, width)
                hi, width, overflow = _EOF, 9, 1 << 9
                table.clear()
            else:
                table[key] = hi
        put(saved, width)
        hi += 1
        if hi == overflow:
            width += 1
            overflow <<= 1
    put(_EOF, width)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def decompress_py(data: bytes) -> bytes:
    pos = acc = nbits = 0

    def get(width: int) -> Optional[int]:
        nonlocal pos, acc, nbits
        while nbits < width:
            if pos >= len(data):
                return None
            acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        code = acc & ((1 << width) - 1)
        acc >>= width
        nbits -= width
        return code

    prefix = [0] * (1 << 12)
    suffix = bytearray(1 << 12)
    out = bytearray()
    hi, width, overflow, last = _EOF, 9, 1 << 9, None
    while True:
        code = get(width)
        if code is None:
            raise ValueError("truncated LZW stream")
        if code == _EOF:
            return bytes(out)
        if code == _CLEAR:
            hi, width, overflow, last = _EOF, 9, 1 << 9, None
            continue
        kwkwk = False
        expand = code
        if code < _CLEAR:
            pass
        elif code == hi and last is not None:
            kwkwk, expand = True, last
        elif not (_FIRST <= code < hi):
            raise ValueError(f"corrupt LZW stream (code {code}, hi {hi})")
        chunk = bytearray()
        c = expand
        while c >= _FIRST:
            chunk.append(suffix[c])
            c = prefix[c]
        chunk.append(c)
        first_byte = chunk[-1]
        if kwkwk:
            chunk.insert(0, first_byte)
        out.extend(reversed(chunk))
        if last is not None and hi < _MAX_CODE:
            prefix[hi] = last
            suffix[hi] = first_byte
        last = code
        hi += 1
        if hi >= overflow:
            if width < 12:
                width += 1
                overflow <<= 1
            else:
                hi -= 1


# ----------------------------------------------------------------------
# Native codec (ctypes over native/lzw.cpp)
# ----------------------------------------------------------------------

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                      "lzw.cpp")
_lib = None
_lock = threading.Lock()


def library_path() -> str:
    """Where the native codec is (or will be) built: the kernels' build
    directory, under a name keyed by a hash of the source."""
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(compile_cache.build_dir(), f"liblzw_{tag}.so")


def _load_native():
    """Build (once) and load the native codec; None when unavailable.
    Failure is cached so a compiler-less host pays the probe once."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib if _lib is not False else None
        out = library_path()
        if not os.path.exists(out):
            tmp = f"{out}.{os.getpid()}.tmp"
            try:
                os.makedirs(os.path.dirname(out), exist_ok=True)
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
                     "-o", tmp, SOURCE],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, out)
            except (OSError, subprocess.SubprocessError):
                _lib = False
                return None
        try:
            lib = ctypes.CDLL(out)
        except OSError:
            _lib = False
            return None
        for fn in (lib.lzw_compress, lib.lzw_decompress):
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long,
                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_long]
        _lib = lib
        return lib


def native_available() -> bool:
    return _load_native() is not None


def _call_native(fn, data: bytes, cap: int) -> bytes:
    while True:
        buf = (ctypes.c_uint8 * cap)()
        n = fn(data, len(data), buf, cap)
        if n == -2:
            cap *= 4
            continue
        if n < 0:
            raise ValueError("corrupt LZW stream (native)")
        return bytes(buf[:n])


def compress(data: bytes) -> bytes:
    lib = _load_native()
    if lib is None:
        return compress_py(data)
    return _call_native(lib.lzw_compress, data, 2 * len(data) + 1024)


def decompress(data: bytes) -> bytes:
    lib = _load_native()
    if lib is None:
        return decompress_py(data)
    return _call_native(lib.lzw_decompress, data, 8 * len(data) + 1024)
