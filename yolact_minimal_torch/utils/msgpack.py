"""A pure-Python msgpack codec for flax checkpoints.

The JAX package writes its `.ckpt` files with `flax.serialization
.msgpack_serialize`: a msgpack tree of dicts (str keys), lists, Python
scalars and arrays. Arrays travel as msgpack ext types whose payload is
itself msgpack:

- ext 1, ndarray: `(shape, dtype name, C-order bytes)`;
- ext 3, numpy scalar: the same, 0-d;
- ext 2, complex: `(real, imag)`.

flax writes an array over 2^30 bytes as a dict `{'__msgpack_chunked_array__':
True, 'shape': {'0': ...}, 'chunks': {'0': ..., ...}}` of flat chunks;
`unpackb` joins them back. numpy has no bfloat16, so a bfloat16 array
decodes to a torch.bfloat16 tensor.

`unpackb` reads every msgpack type (nil, bool, all int widths, float32 and
float64, the str and bin families, arrays, maps, ext and fixext); `packb`
writes what a checkpoint holds: dicts, lists, None, bool, int, str, bytes
and numpy arrays (no array of these models reaches flax's chunk size). Neither
imports msgpack or flax.
"""
from __future__ import annotations

import struct
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

NDARRAY, COMPLEX, NPSCALAR = 1, 2, 3
CHUNKED = '__msgpack_chunked_array__'


class ExtType(NamedTuple):
    """An ext value of a type code this codec does not interpret."""
    code: int
    data: bytes


# --- decode -------------------------------------------------------------------

# fixed-width scalars: first byte -> (struct format, size)
_SCALARS = {0xca: ('>f', 4), 0xcb: ('>d', 8),
            0xcc: ('>B', 1), 0xcd: ('>H', 2), 0xce: ('>I', 4), 0xcf: ('>Q', 8),
            0xd0: ('>b', 1), 0xd1: ('>h', 2), 0xd2: ('>i', 4), 0xd3: ('>q', 8)}
# length-prefixed families: first byte -> (kind, width of the length)
_SIZED = {0xc4: ('bin', 1), 0xc5: ('bin', 2), 0xc6: ('bin', 4),
          0xc7: ('ext', 1), 0xc8: ('ext', 2), 0xc9: ('ext', 4),
          0xd9: ('str', 1), 0xda: ('str', 2), 0xdb: ('str', 4),
          0xdc: ('array', 2), 0xdd: ('array', 4),
          0xde: ('map', 2), 0xdf: ('map', 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_LENGTH = {1: '>B', 2: '>H', 4: '>I'}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError('msgpack data ends inside a value')
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return bytes(self.take(b & 0x1f)).decode('utf-8')
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self.unpack(*_SCALARS[b])
        if b in _FIXEXT:
            code = self.unpack('>b', 1)
            return _ext(code, bytes(self.take(_FIXEXT[b])))
        if b in _SIZED:
            kind, width = _SIZED[b]
            n = self.unpack(_LENGTH[width], width)
            if kind == 'bin':
                return bytes(self.take(n))
            if kind == 'str':
                return bytes(self.take(n)).decode('utf-8')
            if kind == 'array':
                return [self.value() for _ in range(n)]
            if kind == 'map':
                return self._map(n)
            code = self.unpack('>b', 1)
            return _ext(code, self.take(n))
        raise ValueError(f'byte 0x{b:02x} starts no msgpack value')

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _loads(data) -> Any:
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f'{len(reader.buf) - reader.pos} bytes after the msgpack value')
    return out


def _array(payload) -> Any:
    """(shape, dtype name, C-order bytes) -> numpy array, or a torch.bfloat16
    tensor for 'bfloat16'."""
    shape, name, data = _loads(payload)
    shape = tuple(shape)
    if name == 'bfloat16':
        bits = np.frombuffer(data, dtype=np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, payload) -> Any:
    if code == NDARRAY:
        return _array(payload)
    if code == NPSCALAR:
        a = _array(payload)
        return a[()] if isinstance(a, np.ndarray) else a
    if code == COMPLEX:
        real, imag = _loads(payload)
        return complex(real, imag)
    return ExtType(code, bytes(payload))


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(CHUNKED) is True:
            shape = tuple(tree['shape'][str(i)] for i in range(len(tree['shape'])))
            chunks = [tree['chunks'][str(i)] for i in range(len(tree['chunks']))]
            if isinstance(chunks[0], torch.Tensor):
                return torch.cat(chunks).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data: bytes) -> Any:
    """msgpack bytes (as `flax.serialization.msgpack_serialize` writes them)
    -> the tree: dicts, lists, Python scalars, read-only numpy arrays,
    torch.bfloat16 tensors; chunked arrays joined."""
    return _unchunk(_loads(data))


# --- encode -------------------------------------------------------------------

def _int(x: int) -> bytes:
    if 0 <= x <= 0x7f:
        return bytes([x])
    if -32 <= x < 0:
        return bytes([x + 0x100])
    if x >= 0:
        for code, fmt, hi in ((0xcc, '>B', 0xff), (0xcd, '>H', 0xffff),
                              (0xce, '>I', 0xffffffff), (0xcf, '>Q', 2 ** 64 - 1)):
            if x <= hi:
                return bytes([code]) + struct.pack(fmt, x)
    else:
        for code, fmt, lo in ((0xd0, '>b', -2 ** 7), (0xd1, '>h', -2 ** 15),
                              (0xd2, '>i', -2 ** 31), (0xd3, '>q', -2 ** 63)):
            if x >= lo:
                return bytes([code]) + struct.pack(fmt, x)
    raise OverflowError(f'{x} does not fit msgpack\'s 64-bit ints')


def _header(n: int, fix: Tuple[Optional[int], int], codes: Tuple[Optional[int], ...]) -> bytes:
    """Type byte and length: the fix form below fix[1], else the narrowest
    of codes (8-, 16-, 32-bit lengths; None where the family has none)."""
    base, limit = fix
    if base is not None and n < limit:
        return bytes([base | n])
    for code, width in zip(codes, (1, 2, 4)):
        if code is not None and n < 2 ** (8 * width):
            return bytes([code]) + struct.pack(_LENGTH[width], n)
    raise ValueError(f'msgpack length {n} over 2^32 - 1')


def _dumps(x, out: list):
    if x is None:
        out.append(b'\xc0')
    elif isinstance(x, bool):
        out.append(b'\xc3' if x else b'\xc2')
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, str):
        data = x.encode('utf-8')
        out.append(_header(len(data), (0xa0, 32), (0xd9, 0xda, 0xdb)) + data)
    elif isinstance(x, bytes):
        out.append(_header(len(x), (None, 0), (0xc4, 0xc5, 0xc6)) + x)
    elif isinstance(x, dict):
        out.append(_header(len(x), (0x80, 16), (None, 0xde, 0xdf)))
        for k, v in x.items():
            _dumps(k, out)
            _dumps(v, out)
    elif isinstance(x, (list, tuple)):
        out.append(_header(len(x), (0x90, 16), (None, 0xdc, 0xdd)))
        for v in x:
            _dumps(v, out)
    elif isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.fields is not None:
            raise ValueError(f'cannot serialize an array of dtype {x.dtype}')
        payload = packb([list(x.shape), x.dtype.name, x.tobytes('C')])
        fixext = {v: k for k, v in _FIXEXT.items()}.get(len(payload))
        head = bytes([fixext]) if fixext else _header(len(payload), (None, 0), (0xc7, 0xc8, 0xc9))
        out.append(head + struct.pack('>b', NDARRAY) + payload)
    else:
        raise TypeError(f'cannot serialize {type(x).__name__}')


def packb(tree) -> bytes:
    """The tree as msgpack bytes, arrays as flax's ext 1: what
    `flax.serialization.msgpack_restore` reads."""
    out: list = []
    _dumps(tree, out)
    return b''.join(out)
