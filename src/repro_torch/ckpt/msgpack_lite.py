"""A MessagePack codec for the subset a checkpoint's ``meta`` uses: maps,
strings, ints, floats, bools, nil and lists (tuples pack as lists).
``packb`` writes the bytes ``msgpack.packb`` writes for these (the
smallest encoding of each int and length; floats as 64-bit; strings
as str8/16/32), and ``unpackb`` reads them back as ``msgpack.unpackb``
does (also 32-bit floats and bin). The card's machine has no
``msgpack``, so the port keeps this one."""
from __future__ import annotations

import struct
from typing import Any, Tuple


def _int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack("b", n)
    if n >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)),
                               (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)),
                               (0xd3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit 64 bits")


def _head(n: int, fix: int, fix_max: int, codes) -> bytes:
    """A length header: the fix form below ``fix_max``, else the first
    of ``codes`` ((code, struct format, limit), ...) that holds n."""
    if n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large")


_STR = ((0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32))
_ARR = ((0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32))
_MAP = ((0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32))


def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out += b"\xc0"
    elif obj is True:
        out += b"\xc3"
    elif obj is False:
        out += b"\xc2"
    elif isinstance(obj, int):
        out += _int(obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out += _head(len(data), 0xa0, 32, _STR) + data
    elif isinstance(obj, (list, tuple)):
        out += _head(len(obj), 0x90, 16, _ARR)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out += _head(len(obj), 0x80, 16, _MAP)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def unpackb(data: bytes) -> Any:
    obj, end = _unpack(memoryview(data), 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the object")
    return obj


def _take(buf, at: int, fmt: str) -> Tuple[Any, int]:
    size = struct.calcsize(fmt)
    if at + size > len(buf):
        raise ValueError("truncated MessagePack data")
    return struct.unpack_from(fmt, buf, at)[0], at + size


_FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
          0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}
_LEN = {0xd9: ">B", 0xda: ">H", 0xdb: ">I", 0xc4: ">B", 0xc5: ">H",
        0xc6: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I"}


def _unpack(buf, at: int) -> Tuple[Any, int]:
    if at >= len(buf):
        raise ValueError("truncated MessagePack data")
    b = buf[at]
    at += 1
    if b < 0x80:
        return b, at
    if b >= 0xe0:
        return b - 0x100, at
    if b == 0xc0:
        return None, at
    if b in (0xc2, 0xc3):
        return b == 0xc3, at
    if b in _FIXED:
        return _take(buf, at, _FIXED[b])
    if 0xa0 <= b <= 0xbf or b in (0xd9, 0xda, 0xdb, 0xc4, 0xc5, 0xc6):
        n, at = ((b & 0x1f, at) if b <= 0xbf else _take(buf, at, _LEN[b]))
        if at + n > len(buf):
            raise ValueError("truncated MessagePack data")
        raw = bytes(buf[at:at + n])
        return (raw if b in (0xc4, 0xc5, 0xc6) else raw.decode("utf-8"),
                at + n)
    if 0x90 <= b <= 0x9f or b in (0xdc, 0xdd):
        n, at = (b & 0x0f, at) if b <= 0x9f else _take(buf, at, _LEN[b])
        items = []
        for _ in range(n):
            item, at = _unpack(buf, at)
            items.append(item)
        return items, at
    if 0x80 <= b <= 0x8f or b in (0xde, 0xdf):
        n, at = (b & 0x0f, at) if b <= 0x8f else _take(buf, at, _LEN[b])
        out = {}
        for _ in range(n):
            k, at = _unpack(buf, at)
            out[k], at = _unpack(buf, at)
        return out, at
    raise ValueError(f"MessagePack type byte 0x{b:02x} is not supported")
