"""MessagePack for the checkpoint metadata, without the ``msgpack`` package.

``packb`` writes what ``msgpack.packb`` writes by default (``use_bin_type``
on: str as str8/16/32, bytes as bin) for the types a checkpoint's metadata
holds: dict, list and tuple, str, bytes, int, float (always float 64), bool
and None, each in its shortest form. ``unpackb`` reads those back (dicts,
lists, str) and also float 32. So a checkpoint of either package reads in
the other.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                               (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if n < top:
                return bytes([code]) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                               (0xd2, ">i", -(1 << 31)), (0xd3, ">q", -(1 << 63))):
            if n >= low:
                return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit MessagePack")


def _head(n: int, fix: int, fix_max: int, codes) -> bytes:
    """The header of a str/bin/array/map of ``n`` items: the fix form
    ``fix | n`` below ``fix_max``, else the first of ``codes`` that holds n."""
    if n < fix_max:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} items do not fit MessagePack")


_STR = (0xd9, ">B", 1 << 8), (0xda, ">H", 1 << 16), (0xdb, ">I", 1 << 32)
_BIN = (0xc4, ">B", 1 << 8), (0xc5, ">H", 1 << 16), (0xc6, ">I", 1 << 32)
_ARRAY = (0xdc, ">H", 1 << 16), (0xdd, ">I", 1 << 32)
_MAP = (0xde, ">H", 1 << 16), (0xdf, ">I", 1 << 32)


def packb(obj: Any) -> bytes:
    out = bytearray()

    def put(x):
        if x is None:
            out.append(0xc0)
        elif x is True or x is False:
            out.append(0xc3 if x else 0xc2)
        elif isinstance(x, int):
            out.extend(_int(int(x)))
        elif isinstance(x, float):
            out.append(0xcb)
            out.extend(struct.pack(">d", x))
        elif isinstance(x, str):
            raw = x.encode("utf-8")
            out.extend(_head(len(raw), 0xa0, 32, _STR))
            out.extend(raw)
        elif isinstance(x, (bytes, bytearray)):
            out.extend(_head(len(x), 0, 0, _BIN))
            out.extend(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_head(len(x), 0x90, 16, _ARRAY))
            for v in x:
                put(v)
        elif isinstance(x, dict):
            out.extend(_head(len(x), 0x80, 16, _MAP))
            for k, v in x.items():
                put(k)
                put(v)
        else:
            raise TypeError(f"can not serialize {type(x).__name__!r} object")

    put(obj)
    return bytes(out)


def unpackb(data: bytes) -> Any:
    buf = memoryview(data)

    def take(pos: int, fmt: str) -> Tuple[Any, int]:
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, pos)[0], pos + size

    def seq(pos: int, n: int, is_map: bool):
        if is_map:
            out = {}
            for _ in range(n):
                k, pos = get(pos)
                out[k], pos = get(pos)
            return out, pos
        items = []
        for _ in range(n):
            v, pos = get(pos)
            items.append(v)
        return items, pos

    def raw(pos: int, n: int, text: bool):
        b = bytes(buf[pos:pos + n])
        if len(b) != n:
            raise ValueError("truncated MessagePack data")
        return (b.decode("utf-8") if text else b), pos + n

    sized = {0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
             0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
             0xdc: (">H", "array"), 0xdd: (">I", "array"),
             0xde: (">H", "map"), 0xdf: (">I", "map")}
    scalars = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
               0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}

    def get(pos: int):
        if pos >= len(buf):
            raise ValueError("truncated MessagePack data")
        b = buf[pos]
        pos += 1
        if b < 0x80:
            return b, pos
        if b >= 0xe0:
            return b - 0x100, pos
        if 0xa0 <= b < 0xc0:
            return raw(pos, b & 0x1f, True)
        if 0x90 <= b < 0xa0:
            return seq(pos, b & 0x0f, False)
        if 0x80 <= b < 0x90:
            return seq(pos, b & 0x0f, True)
        if b == 0xc0:
            return None, pos
        if b in (0xc2, 0xc3):
            return b == 0xc3, pos
        if b in scalars:
            return take(pos, scalars[b])
        if b in sized:
            fmt, kind = sized[b]
            n, pos = take(pos, fmt)
            if kind in ("str", "bin"):
                return raw(pos, n, kind == "str")
            return seq(pos, n, kind == "map")
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")

    obj, end = get(0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} bytes of extra data after the MessagePack object")
    return obj
