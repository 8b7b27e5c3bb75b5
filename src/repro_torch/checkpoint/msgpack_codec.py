"""A small MessagePack codec: the subset the checkpoint payload uses.

Packs maps, arrays (lists and tuples), str, bin (bytes-like), nil, bool,
ints of every width and floats (float64) into the bytes that
``msgpack.packb(obj, use_bin_type=True)`` writes for the same object: the
shortest header for each length or value (fixmap/map16/map32,
fixarray/array16/array32, fixstr/str8/str16/str32, bin8/bin16/bin32,
fixint, uint8..uint64, int8..int64).  Unpacks what such a packer writes
(float32 too) as ``msgpack.unpackb(data, raw=False)`` returns it: lists,
dicts, str, bytes.  Extension types are refused.

:func:`pack` streams: it hands each piece to ``write`` as it goes, and a
bin's payload is passed as the caller's own buffer, never copied, so a
large array reaches a file (and a hash) without a second host copy.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, Tuple

Write = Callable[[Any], Any]

_U8, _U16, _U32, _U64 = (struct.Struct(f">{c}") for c in "BHIQ")
_I8, _I16, _I32, _I64 = (struct.Struct(f">{c}") for c in "bhiq")
_F32, _F64 = struct.Struct(">f"), struct.Struct(">d")
# type byte -> the struct of its fixed-width value (floats, ints) ...
_FIXED = {0xCA: _F32, 0xCB: _F64, 0xCC: _U8, 0xCD: _U16, 0xCE: _U32,
          0xCF: _U64, 0xD0: _I8, 0xD1: _I16, 0xD2: _I32, 0xD3: _I64}
# ... or of the length that follows it (bin, str, array, map)
_LENGTH = {0xC4: _U8, 0xC5: _U16, 0xC6: _U32, 0xD9: _U8, 0xDA: _U16,
           0xDB: _U32, 0xDC: _U16, 0xDD: _U32, 0xDE: _U16, 0xDF: _U32}


def _sized(n: int, small_tag: int, small_max: int, tags) -> bytes:
    """A length header: ``small_tag | n`` below ``small_max``, else the
    first of ``tags`` (tag, width struct) whose width holds ``n``."""
    if small_tag is not None and n < small_max:
        return bytes((small_tag | n,))
    for tag, fmt in tags:
        if n <= (1 << (8 * fmt.size)) - 1:
            return bytes((tag,)) + fmt.pack(n)
    raise ValueError(f"length {n} exceeds MessagePack's 2^32 - 1")


def map_header(n: int) -> bytes:
    return _sized(n, 0x80, 16, ((0xDE, _U16), (0xDF, _U32)))


def array_header(n: int) -> bytes:
    return _sized(n, 0x90, 16, ((0xDC, _U16), (0xDD, _U32)))


def str_header(n: int) -> bytes:
    return _sized(n, 0xA0, 32, ((0xD9, _U8), (0xDA, _U16), (0xDB, _U32)))


def bin_header(n: int) -> bytes:
    return _sized(n, None, 0, ((0xC4, _U8), (0xC5, _U16), (0xC6, _U32)))


def pack_int(v: int) -> bytes:
    if -32 <= v < 0x80:  # positive and negative fixint
        return _I8.pack(v) if v < 0 else _U8.pack(v)
    if v >= 0:
        for tag, fmt in ((0xCC, _U8), (0xCD, _U16), (0xCE, _U32),
                         (0xCF, _U64)):
            if v <= (1 << (8 * fmt.size)) - 1:
                return bytes((tag,)) + fmt.pack(v)
    else:
        for tag, fmt in ((0xD0, _I8), (0xD1, _I16), (0xD2, _I32),
                         (0xD3, _I64)):
            if v >= -(1 << (8 * fmt.size - 1)):
                return bytes((tag,)) + fmt.pack(v)
    raise OverflowError(f"int {v} outside MessagePack's 64-bit range")


def pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return str_header(len(b)) + b


def pack(obj, write: Write) -> None:
    """Stream ``obj`` as MessagePack pieces into ``write``."""
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        write(pack_int(obj))
    elif isinstance(obj, float):
        write(b"\xcb" + _F64.pack(obj))
    elif isinstance(obj, str):
        write(pack_str(obj))
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = obj.nbytes if isinstance(obj, memoryview) else len(obj)
        write(bin_header(n))
        write(obj)
    elif isinstance(obj, dict):
        write(map_header(len(obj)))
        for k, v in obj.items():
            pack(k, write)
            pack(v, write)
    elif isinstance(obj, (list, tuple)):
        write(array_header(len(obj)))
        for v in obj:
            pack(v, write)
    else:
        raise TypeError(f"cannot MessagePack-encode {type(obj).__name__}")


def packb(obj) -> bytes:
    """``obj`` as one bytes object (``msgpack.packb(obj,
    use_bin_type=True)``)."""
    parts = []
    pack(obj, parts.append)
    return b"".join(bytes(p) for p in parts)


def _take(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    if pos + n > len(buf):
        raise ValueError("truncated MessagePack data")
    return buf[pos:pos + n], pos + n


def _unpack(buf: memoryview, pos: int, bin_view: bool):
    """(object, next position) of the value at ``pos``."""
    raw, pos = _take(buf, pos, 1)
    b = raw[0]
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _unpack_map(buf, pos, b & 0x0F, bin_view)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(buf, pos, b & 0x0F, bin_view)
    if 0xA0 <= b <= 0xBF:
        raw, pos = _take(buf, pos, b & 0x1F)
        return str(raw, "utf-8"), pos
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        raw, pos = _take(buf, pos, _FIXED[b].size)
        return _FIXED[b].unpack(raw)[0], pos
    if b not in _LENGTH:
        raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")
    raw, pos = _take(buf, pos, _LENGTH[b].size)
    n = _LENGTH[b].unpack(raw)[0]
    if b in (0xDC, 0xDD):
        return _unpack_array(buf, pos, n, bin_view)
    if b in (0xDE, 0xDF):
        return _unpack_map(buf, pos, n, bin_view)
    raw, pos = _take(buf, pos, n)
    if b >= 0xD9:
        return str(raw, "utf-8"), pos
    return (raw if bin_view else bytes(raw)), pos


def _unpack_array(buf, pos, n, bin_view):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos, bin_view)
        out.append(v)
    return out, pos


def _unpack_map(buf, pos, n, bin_view):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos, bin_view)
        out[k], pos = _unpack(buf, pos, bin_view)
    return out, pos


def unpackb(data, *, bin_view: bool = False):
    """The object of one MessagePack value filling ``data`` (bytes-like).

    ``bin_view`` returns each bin as a ``memoryview`` into ``data`` (no
    copy) instead of ``bytes``.
    """
    buf = memoryview(data).cast("B")
    obj, pos = _unpack(buf, 0, bin_view)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} bytes of extra data after the "
                         "MessagePack value")
    return obj
