# Reader and writer of flax's msgpack checkpoints (pure Python + numpy).
#
# flax.serialization.msgpack_restore and msgpack_serialize, so that the port
# reads the checkpoints the JAX package writes (utils/checkpoint.py) and
# writes ones the JAX package reads, without flax or the msgpack package.
# pack() gives the bytes msgpack_serialize gives for the same tree.  The
# format:
#   * msgpack (https://github.com/msgpack/msgpack/blob/master/spec.md):
#     maps, arrays, str, bin, nil, bool, ints of every width, float32/64;
#     lengths and numbers big-endian;
#   * ext type 1, an ndarray: its payload is itself msgpack, the triple
#     (shape, dtype name as bytes, C-order buffer);
#   * ext type 3, a numpy scalar, packed as a 0-d ndarray; ext type 2, a
#     Python complex, packed as the pair (real, imag);
#   * arrays above flax's chunk limit are stored as
#     {'__msgpack_chunked_array__': True, 'shape': {...}, 'chunks': {...}},
#     tuples written as dicts keyed '0', '1', ...; they are joined again.
# Array payloads are np.frombuffer views over the one buffer of the file
# (read-only, no copy), so decoding costs a walk over the keys, not over the
# values.  bfloat16, which numpy lacks, is widened to float32 by shifting its
# 16 bits into the high half of a 32-bit word, which is exact.  Input that is
# not such a stream raises ValueError.  The writer packs each value in the
# shortest msgpack form, as the msgpack package does, floats as float64.

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = '__msgpack_chunked_array__'
MAX_CHUNK_SIZE = 2 ** 30             # bytes; flax chunks larger arrays

_FIXED = {                       # code -> (struct format, size)
    0xca: ('>f', 4), 0xcb: ('>d', 8),
    0xcc: ('>B', 1), 0xcd: ('>H', 2), 0xce: ('>I', 4), 0xcf: ('>Q', 8),
    0xd0: ('>b', 1), 0xd1: ('>h', 2), 0xd2: ('>i', 4), 0xd3: ('>q', 8),
}
_LENGTH = {1: '>B', 2: '>H', 4: '>I'}


class _Reader:
    """One pass over a msgpack stream held in a memoryview."""

    def __init__(self, buf: memoryview, raw: bool):
        self.buf = buf
        self.pos = 0
        self.raw = raw           # str as bytes (flax's ndarray payloads)

    def take(self, n: int) -> Tuple[int, int]:
        """Claim the next n bytes; returns their (start, end)."""
        start, end = self.pos, self.pos + n
        if end > len(self.buf):
            raise ValueError(f'msgpack: truncated at byte {start} '
                             f'({n} more wanted, {len(self.buf) - start} '
                             'left)')
        self.pos = end
        return start, end

    def number(self, fmt: str, size: int):
        start, end = self.take(size)
        return struct.unpack(fmt, self.buf[start:end])[0]

    def length(self, size: int) -> int:
        return self.number(_LENGTH[size], size)

    def value(self) -> Any:
        code = self.number('>B', 1)
        if code <= 0x7f:
            return code
        if code >= 0xe0:
            return code - 0x100
        if code <= 0x8f:
            return self.mapping(code & 0x0f)
        if code <= 0x9f:
            return [self.value() for _ in range(code & 0x0f)]
        if code <= 0xbf:
            return self.string(code & 0x1f)
        if code == 0xc0:
            return None
        if code in (0xc2, 0xc3):
            return code == 0xc3
        if code in (0xc4, 0xc5, 0xc6):
            start, end = self.take(self.length(1 << (code - 0xc4)))
            return bytes(self.buf[start:end])
        if code in (0xc7, 0xc8, 0xc9):
            return self.ext(self.length(1 << (code - 0xc7)))
        if code in _FIXED:
            return self.number(*_FIXED[code])
        if 0xd4 <= code <= 0xd8:
            return self.ext(1 << (code - 0xd4))
        if code in (0xd9, 0xda, 0xdb):
            return self.string(self.length(1 << (code - 0xd9)))
        if code in (0xdc, 0xdd):
            n = self.length(2 if code == 0xdc else 4)
            return [self.value() for _ in range(n)]
        if code in (0xde, 0xdf):
            return self.mapping(self.length(2 if code == 0xde else 4))
        raise ValueError(f'msgpack: byte 0x{code:02x} at {self.pos - 1} '
                         'starts no object')

    def string(self, n: int):
        start, end = self.take(n)
        if self.raw:
            return bytes(self.buf[start:end])
        try:
            return str(self.buf[start:end], 'utf-8')
        except UnicodeDecodeError as e:
            raise ValueError(f'msgpack: bad utf-8 string at {start}') from e

    def mapping(self, n: int):
        out = {}
        for _ in range(n):
            key = self.value()
            if isinstance(key, (dict, list)):
                raise ValueError('msgpack: a map key is a container')
            out[key] = self.value()
        if CHUNKED in out:
            return _unchunk(out)
        return out

    def ext(self, n: int):
        kind = self.number('>b', 1)
        start, end = self.take(n)
        if kind == EXT_NDARRAY:
            return _ndarray(self.buf, start, end)
        if kind == EXT_NPSCALAR:
            return _ndarray(self.buf, start, end)[()]
        if kind == EXT_COMPLEX:
            pair = _decode_span(self.buf, start, end, raw=False)
            if not (isinstance(pair, list) and len(pair) == 2):
                raise ValueError('msgpack: a complex ext is not a pair')
            return complex(pair[0], pair[1])
        raise ValueError(f'msgpack: unknown ext type {kind}')


def _decode_span(buf: memoryview, start: int, end: int, raw: bool):
    """Decode exactly one object filling buf[start:end]."""
    reader = _Reader(buf[start:end], raw)
    out = reader.value()
    if reader.pos != end - start:
        raise ValueError(f'msgpack: {end - start - reader.pos} bytes after '
                         'the object')
    return out


def _ndarray(buf: memoryview, start: int, end: int) -> np.ndarray:
    """flax's ndarray ext payload (shape, dtype name, C-order buffer) ->
    a read-only view over `buf` (a float32 copy for bfloat16)."""
    reader = _Reader(buf[start:end], raw=True)
    code = reader.number('>B', 1)
    if code != 0x93:                        # fixarray of 3
        raise ValueError(f'msgpack: ndarray payload at {start} is not a '
                         'triple')
    shape, name = reader.value(), reader.value()
    code = reader.number('>B', 1)
    if code not in (0xc4, 0xc5, 0xc6):
        raise ValueError(f'msgpack: ndarray buffer at {start} is not bin')
    lo, hi = reader.take(reader.length(1 << (code - 0xc4)))
    if reader.pos != end - start:
        raise ValueError('msgpack: bytes after an ndarray payload')
    if not (isinstance(shape, list)
            and all(isinstance(d, int) and d >= 0 for d in shape)
            and isinstance(name, bytes)):
        raise ValueError(f'msgpack: bad ndarray header {shape!r} {name!r}')
    bf16 = name == b'bfloat16'
    try:
        dtype = np.dtype(np.uint16 if bf16 else name.decode('ascii'))
    except (TypeError, UnicodeDecodeError) as e:
        raise ValueError(f'msgpack: unknown dtype {name!r}') from e
    if dtype.hasobject:
        raise ValueError(f'msgpack: object dtype {name!r}')
    count = int(np.prod(shape, dtype=np.int64))
    if count * dtype.itemsize != hi - lo:
        raise ValueError(f'msgpack: {hi - lo} bytes for {name!r} '
                         f'{tuple(shape)}')
    arr = np.frombuffer(buf, dtype, count, offset=start + lo).reshape(shape)
    if bf16:
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


def _unchunk(data: dict) -> np.ndarray:
    """flax's chunked form of a large array -> the array."""
    try:
        shape = tuple(data['shape'][str(i)] for i in range(len(data['shape'])))
        chunks = [data['chunks'][str(i)] for i in range(len(data['chunks']))]
        return np.concatenate(chunks).reshape(shape)
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f'msgpack: malformed chunked array: {e}') from e


def restore(data) -> Any:
    """Bytes of flax.serialization.to_bytes / msgpack_serialize -> the tree
    msgpack_restore gives: nested dicts and lists with numpy leaves (bfloat16
    as float32)."""
    buf = memoryview(data).cast('B')
    return _decode_span(buf, 0, len(buf), raw=False)


def read(path: str) -> Any:
    """restore() of a checkpoint file."""
    with open(path, 'rb') as f:
        return restore(f.read())


# ------------------------------------------------------------------ writer
def _header(out: list, n: int, fix: int, fix_max: int, codes) -> None:
    """A length-prefixed type: fix form when n <= fix_max, else the 8/16/32
    bit forms `codes` (None where the type has none)."""
    if n <= fix_max:
        out.append(struct.pack('>B', fix | n))
    elif codes[0] is not None and n < 1 << 8:
        out.append(struct.pack('>BB', codes[0], n))
    elif n < 1 << 16:
        out.append(struct.pack('>BH', codes[1], n))
    elif n < 1 << 32:
        out.append(struct.pack('>BI', codes[2], n))
    else:
        raise ValueError(f'msgpack: a length of {n} does not fit')


def _pack_int(out: list, v: int) -> None:
    if 0 <= v <= 0x7f:
        out.append(struct.pack('>B', v))
    elif -32 <= v < 0:
        out.append(struct.pack('>b', v))
    elif v >= 0:
        for code, fmt, top in ((0xcc, '>B', 8), (0xcd, '>H', 16),
                               (0xce, '>I', 32), (0xcf, '>Q', 64)):
            if v < 1 << top:
                out.append(struct.pack('>B', code) + struct.pack(fmt, v))
                return
        raise ValueError(f'msgpack: integer {v} does not fit')
    else:
        for code, fmt, top in ((0xd0, '>b', 7), (0xd1, '>h', 15),
                               (0xd2, '>i', 31), (0xd3, '>q', 63)):
            if v >= -(1 << top):
                out.append(struct.pack('>B', code) + struct.pack(fmt, v))
                return
        raise ValueError(f'msgpack: integer {v} does not fit')


def _pack_ext(out: list, kind: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(struct.pack('>Bb', fixed[n], kind))
    elif n < 1 << 8:
        out.append(struct.pack('>BBb', 0xc7, n, kind))
    elif n < 1 << 16:
        out.append(struct.pack('>BHb', 0xc8, n, kind))
    else:
        out.append(struct.pack('>BIb', 0xc9, n, kind))
    out.append(payload)


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """flax's _ndarray_to_bytes: msgpack of (shape, dtype name, C bytes)."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f'msgpack: cannot write dtype {arr.dtype}')
    out: list = [b'\x93']
    _pack(out, list(arr.shape))
    _pack(out, arr.dtype.name)
    _pack(out, np.ascontiguousarray(arr).tobytes())
    return b''.join(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax's chunked form of an array above MAX_CHUNK_SIZE bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    return {CHUNKED: True,
            'shape': {str(i): d for i, d in enumerate(arr.shape)},
            'chunks': {str(i): flat[k:k + size] for i, k in
                       enumerate(range(0, flat.size, size))}}


def _pack(out: list, v: Any, sort: bool = True) -> None:
    if v is None:
        out.append(b'\xc0')
    elif v is True or v is False:
        out.append(b'\xc3' if v else b'\xc2')
    elif isinstance(v, np.ndarray):
        if v.size * v.dtype.itemsize > MAX_CHUNK_SIZE:
            _pack(out, _chunk(v), sort=False)   # flax chunks after its copy
        else:
            _pack_ext(out, EXT_NDARRAY, _ndarray_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(v)))
    elif isinstance(v, int):
        _pack_int(out, v)
    elif isinstance(v, float):
        out.append(struct.pack('>Bd', 0xcb, v))
    elif isinstance(v, complex):
        payload: list = [b'\x92']
        _pack(payload, v.real)
        _pack(payload, v.imag)
        _pack_ext(out, EXT_COMPLEX, b''.join(payload))
    elif isinstance(v, str):
        data = v.encode('utf-8')
        _header(out, len(data), 0xa0, 31, (0xd9, 0xda, 0xdb))
        out.append(data)
    elif isinstance(v, (bytes, bytearray, memoryview)):
        data = bytes(v)
        _header(out, len(data), 0, -1, (0xc4, 0xc5, 0xc6))
        out.append(data)
    elif isinstance(v, dict):
        _header(out, len(v), 0x80, 15, (None, 0xde, 0xdf))
        for key in (sorted(v) if sort else v):  # as flax's pytree copy
            _pack(out, key)
            _pack(out, v[key], sort)
    elif isinstance(v, (list, tuple)):
        _header(out, len(v), 0x90, 15, (None, 0xdc, 0xdd))
        for value in v:
            _pack(out, value, sort)
    else:
        raise ValueError(f'msgpack: cannot write a {type(v).__name__}')


def pack(tree: Any) -> bytes:
    """A tree of dicts, lists, Python scalars and numpy arrays -> the bytes
    flax.serialization.msgpack_serialize gives for it: map keys sorted, as
    its pytree copy sorts them, arrays above 1 GiB chunked as flax chunks
    them."""
    out: list = []
    _pack(out, tree)
    return b''.join(out)


def write(path: str, tree: Any) -> None:
    """pack(tree) into a file."""
    data = pack(tree)
    with open(path, 'wb') as f:
        f.write(data)
