"""The msgpack subset that flax's serialization writes, in pure Python.

A ``.tpu_speech`` archive stores its weight trees as
``flax.serialization.to_bytes`` output (``tpu_speech/utils/archive.py:185``):
msgpack maps of ``str`` keys whose leaves are arrays packed as msgpack
extension types. The port reads and writes them with this module, so it needs
neither flax nor the ``msgpack`` package.

Handled: maps with ``str`` keys, nil, bools, ints, floats, ``str``, ``bin``
and arrays; ext code 1, an ndarray packed as the msgpack array ``(shape,
dtype name, C-order bytes)``; ext code 3, a numpy scalar packed the same way.
``bfloat16`` (which numpy lacks) is read through a ``uint16`` view into a
``torch.bfloat16`` tensor, and such a tensor is written the same way; every
other array decodes to a numpy array. Refused by name: other ext codes
(flax's ext 2, a Python complex, included), and flax's chunked leaves (an
array past ``MAX_CHUNK_SIZE`` bytes, which flax splits into a
``__msgpack_chunked_array__`` map).

``packb`` chooses the smallest encoding of each int, string, binary, array,
map and ext header as msgpack-python's packer does, and packs Python floats
as float64 (its default), so a tree of the same leaves gives the bytes flax
gives.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30  # flax chunks array leaves above this many bytes
_CHUNKED = "__msgpack_chunked_array__"


# ---- decoding ----------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _array_payload(data: bytes, name: str):
    shape, dtype_name, buffer = unpackb(data)
    if not isinstance(dtype_name, str) or not isinstance(buffer, bytes):
        raise ValueError(f"msgpack: malformed {name} payload")
    shape = tuple(shape)
    if dtype_name == "bfloat16":
        raw = np.frombuffer(buffer, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_payload(data, "ndarray")
    if code == EXT_NPSCALAR:
        arr = _array_payload(data, "numpy scalar")
        return arr if torch.is_tensor(arr) else arr[()]
    raise ValueError(f"msgpack: ext code {code} is not handled (only 1, ndarray, and 3, "
                     "numpy scalar)")


def _read(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _read_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_read(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
             0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
    if b in fixed:
        return r.unpack(fixed[b])
    lengths = {0: ">B", 1: ">H", 2: ">I"}
    if 0xC4 <= b <= 0xC6:  # bin 8/16/32
        return bytes(r.take(r.unpack(lengths[b - 0xC4])))
    if 0xC7 <= b <= 0xC9:  # ext 8/16/32
        n = r.unpack(lengths[b - 0xC7])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(1 << (b - 0xD4))))
    if 0xD9 <= b <= 0xDB:  # str 8/16/32
        return str(r.take(r.unpack(lengths[b - 0xD9])), "utf-8")
    if b in (0xDC, 0xDD):
        return [_read(r) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):
        return _read_map(r, r.unpack(">H" if b == 0xDE else ">I"))
    raise ValueError(f"msgpack: type byte 0x{b:02x} is not handled")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        if not isinstance(k, str):
            raise ValueError(f"msgpack: map key {k!r} is not a str")
        out[k] = _read(r)
    if _CHUNKED in out:
        raise ValueError("msgpack: flax's chunked array leaves (arrays past "
                         f"{MAX_CHUNK_SIZE} bytes) are not handled")
    return out


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills ``data``."""
    r = _Reader(data)
    out = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} trailing bytes")
    return out


# ---- encoding ----------------------------------------------------------------

def _header(out: bytearray, n: int, fix_base: int, fix_max: int, codes, what: str):
    if n <= fix_max:
        out.append(fix_base | n)
        return
    for code, fmt, limit in codes:
        if code is not None and n <= limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: {what} of {n} is too long")


_LEN8 = (0xFF, 0xFFFF, 0xFFFFFFFF)


def _int(out: bytearray, v: int):
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack(">b", v)
    elif 0x80 <= v <= 0xFF:
        out += b"\xcc" + struct.pack(">B", v)
    elif -0x80 <= v < 0:
        out += b"\xd0" + struct.pack(">b", v)
    elif 0xFF < v <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", v)
    elif -0x8000 <= v < -0x80:
        out += b"\xd1" + struct.pack(">h", v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", v)
    elif -0x80000000 <= v < -0x8000:
        out += b"\xd2" + struct.pack(">i", v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += b"\xd3" + struct.pack(">q", v)
    else:
        raise ValueError(f"msgpack: int {v} out of range")


def _array_bytes(x) -> bytes:
    """(shape, dtype name, C-order bytes) of an ndarray or a tensor, packed
    as flax's ``_ndarray_to_bytes`` packs it."""
    if torch.is_tensor(x):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            shape, name = tuple(x.shape), "bfloat16"
            data = x.view(torch.int16).numpy().tobytes()
            return packb([list(shape), name, data])
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("msgpack: object and structured dtypes are not handled")
    return packb([list(x.shape), x.dtype.name, x.tobytes("C")])


def _ext_out(out: bytearray, code: int, data: bytes):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    elif n <= 0xFF:
        out += b"\xc7" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xc8" + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += b"\xc9" + struct.pack(">I", n)
    else:
        raise ValueError("msgpack: ext payload too long")
    out += struct.pack(">b", code)
    out += data


def _write(out: bytearray, obj: Any):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, np.generic):  # before float: np.float64 is a float
        _ext_out(out, EXT_NPSCALAR, _array_bytes(np.asarray(obj)))
    elif isinstance(obj, int):
        _int(out, obj)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 31, ((0xD9, ">B", _LEN8[0]), (0xDA, ">H", _LEN8[1]),
                                            (0xDB, ">I", _LEN8[2])), "str")
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _header(out, len(data), 0, -1, ((0xC4, ">B", _LEN8[0]), (0xC5, ">H", _LEN8[1]),
                                         (0xC6, ">I", _LEN8[2])), "bin")
        out += data
    elif isinstance(obj, dict):
        _header(out, len(obj), 0x80, 15, ((0xDE, ">H", _LEN8[1]), (0xDF, ">I", _LEN8[2])),
                "map")
        for k, v in obj.items():
            if not isinstance(k, str):
                raise ValueError(f"msgpack: map key {k!r} is not a str")
            _write(out, k)
            _write(out, v)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 15, ((0xDC, ">H", _LEN8[1]), (0xDD, ">I", _LEN8[2])),
                "array")
        for v in obj:
            _write(out, v)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        nbytes = (obj.numel() * obj.element_size() if torch.is_tensor(obj) else obj.nbytes)
        if nbytes > MAX_CHUNK_SIZE:
            raise ValueError(f"msgpack: an array of {nbytes} bytes would need flax's chunked "
                             f"leaves (past {MAX_CHUNK_SIZE} bytes), which are not handled")
        _ext_out(out, EXT_NDARRAY, _array_bytes(obj))
    else:
        raise ValueError(f"msgpack: {type(obj).__name__} is not handled")


def packb(obj: Any) -> bytes:
    """Encode ``obj`` (see the module doc for what is handled)."""
    out = bytearray()
    _write(out, obj)
    return bytes(out)
