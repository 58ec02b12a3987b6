"""The subset of MessagePack that checkpoint metadata uses, written out
so the port needs no ``msgpack`` package.

``packb`` encodes as ``msgpack.packb(obj, use_bin_type=True)`` does:
maps, arrays (lists and tuples), str, bin (bytes, bytearray,
memoryview), ints in their smallest encoding (positive and negative
fixint, uint 8-64 for non-negative values, int 8-64 for negative ones),
Python floats as float64, bool and None. ``unpackb`` decodes every
encoding of those types, float32 included, as
``msgpack.unpackb(data, raw=False)`` does (arrays as lists, str as
UTF-8). Any other type, on either side, raises ``ValueError``.
"""

from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]

# (largest length, header byte, struct format of the length) per family;
# the fixed-size header (fixstr, fixarray, fixmap) comes first where the
# family has one
_STR = ((31, 0xA0, None), (0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"),
        (0xFFFFFFFF, 0xDB, ">I"))
_BIN = ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"), (0xFFFFFFFF, 0xC6, ">I"))
_ARRAY = ((15, 0x90, None), (0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I"))
_MAP = ((15, 0x80, None), (0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I"))
_UINT = ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I"),
         (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"))
_INT = ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"),
        (-0x80000000, 0xD2, ">i"), (-0x8000000000000000, 0xD3, ">q"))


def _header(n: int, family, what: str) -> bytes:
    for top, byte, fmt in family:
        if n <= top:
            if fmt is None:
                return bytes([byte | n])
            return bytes([byte]) + struct.pack(fmt, n)
    raise ValueError(f"{what} of length {n} is too long for msgpack")


def _int(n: int) -> bytes:
    if 0 <= n <= 0x7F:
        return bytes([n])
    if -32 <= n < 0:
        return struct.pack(">b", n)
    for bound, byte, fmt in (_UINT if n > 0 else _INT):
        if (n <= bound) if n > 0 else (n >= bound):
            return bytes([byte]) + struct.pack(fmt, n)
    raise OverflowError(f"int {n} is out of msgpack's 64-bit range")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False:
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_header(len(data), _STR, "str") + data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_header(len(data), _BIN, "bin") + data)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), _ARRAY, "array"))
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        out.append(_header(len(obj), _MAP, "map"))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise ValueError(f"cannot serialize {type(obj).__name__!r} to "
                         f"msgpack")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack data is truncated")
        chunk = bytes(self.data[self.pos:end])
        self.pos = end
        return chunk

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# type byte -> (kind, struct format of its value or length)
_FIXED = {0xC0: ("nil", None), 0xC2: ("false", None), 0xC3: ("true", None),
          0xCA: ("num", ">f"), 0xCB: ("num", ">d"),
          **{byte: ("num", fmt) for _, byte, fmt in _UINT + _INT},
          **{byte: ("str", fmt) for _, byte, fmt in _STR[1:]},
          **{byte: ("bin", fmt) for _, byte, fmt in _BIN},
          **{byte: ("array", fmt) for _, byte, fmt in _ARRAY[1:]},
          **{byte: ("map", fmt) for _, byte, fmt in _MAP[1:]}}


def _unpack(r: _Reader):
    byte = r.take(1)[0]
    if byte <= 0x7F:
        return byte
    if byte >= 0xE0:
        return byte - 0x100
    if 0xA0 <= byte <= 0xBF:
        kind, n = "str", byte & 0x1F
    elif 0x90 <= byte <= 0x9F:
        kind, n = "array", byte & 0x0F
    elif 0x80 <= byte <= 0x8F:
        kind, n = "map", byte & 0x0F
    elif byte in _FIXED:
        kind, fmt = _FIXED[byte]
        if kind in ("nil", "false", "true"):
            return {"nil": None, "false": False, "true": True}[kind]
        n = r.num(fmt)
        if kind == "num":
            return n
    else:
        raise ValueError(f"msgpack type byte 0x{byte:02x} is not supported")
    if kind == "str":
        return r.take(n).decode("utf-8")
    if kind == "bin":
        return r.take(n)
    if kind == "array":
        return [_unpack(r) for _ in range(n)]
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data) -> object:
    """The one object that MessagePack ``data`` encodes."""
    r = _Reader(bytes(data))
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of extra data after "
                         f"the msgpack object")
    return obj
