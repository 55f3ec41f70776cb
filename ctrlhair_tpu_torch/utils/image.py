# Host-side image I/O and normalisation helpers.
#
# Port of ctrlhair_tpu/utils/image.py: PNG read/write (files and bytes),
# uint8 <-> [-1,1] float conversion, label-map colouring and the grid
# canvas.  The PNG codec is the standard library's zlib plus numpy (the JAX
# package reads and writes through PIL):
# 8-bit greyscale, RGB and RGBA, not interlaced, all five scanline filters
# (PNG spec, section 9); anything else raises.
# (ref counterparts: util/imutil.py:13-24, util/canvas_grid.py:15-34,
#  util/mask_color_util.py:15-64)

from __future__ import annotations

import struct
import zlib

import numpy as np

from ctrlhair_tpu_torch.constants import (
    HAIR_IDX, MASK_VIS_COLOR, UNKNOWN_LABEL)


PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> samples a pixel


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError('not a PNG file')
    pos = 8
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError('PNG: truncated chunk')
        n, kind = struct.unpack('>I4s', data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or \
                struct.unpack('>I', crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f'PNG: chunk {kind!r} is truncated or corrupt')
        yield kind, body
        pos += 12 + n
        if kind == b'IEND':
            return
    raise ValueError('PNG: no IEND chunk')


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters -> [height, stride] uint8."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f'PNG: {len(raw)} bytes of scanlines, expected '
                         f'{height * (stride + 1)}')
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:                                     # None
            cur = line.copy()
        elif kind == 1:                                   # Sub
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:                                   # Up
            cur = line + prior
        elif kind in (3, 4):                              # Average, Paeth
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    cur[i] = (cur[i] + ((a + b) >> 1)) & 0xff
                    continue
                c = up[i - bpp] if i >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xff
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f'PNG: unknown filter type {kind} in row {y}')
        out[y] = cur
        prior = out[y]
    return out


def decode_png(data: bytes, name: str = 'PNG') -> np.ndarray:
    """The bytes of an 8-bit greyscale [H,W], RGB [H,W,3] or RGBA [H,W,4]
    PNG, not interlaced -> uint8 array.  Other PNGs raise ValueError, whose
    message starts with `name`."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f'{name}: PNG without IHDR or IDAT')
    width, height, depth, colour, method, filt, interlace = header
    if depth != 8 or colour not in _CHANNELS or method or filt or interlace:
        raise ValueError(f'{name}: unsupported PNG (bit depth {depth}, '
                         f'colour type {colour}, interlace {interlace}); '
                         '8-bit grey, RGB or RGBA, not interlaced, expected')
    ch = _CHANNELS[colour]
    try:
        raw = zlib.decompress(b''.join(idat))
    except zlib.error as e:
        raise ValueError(f'{name}: bad PNG image data: {e}') from e
    img = _unfilter(raw, height, width * ch, ch)
    return img.reshape(height, width) if ch == 1 else \
        img.reshape(height, width, ch)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H,W] (grey), [H,W,3] (RGB) or [H,W,4] (RGBA) -> the bytes of
    a PNG, every scanline unfiltered, zlib level 6."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    colour = {1: 0, 3: 2, 4: 6}.get(1 if img.ndim == 2 else img.shape[-1])
    if img.ndim not in (2, 3) or colour is None:
        raise ValueError(f'encode_png: cannot write shape {img.shape}')
    height, width = img.shape[:2]
    rows = np.concatenate([np.zeros((height, 1), np.uint8),
                           img.reshape(height, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack('>I', len(body)) + kind + body
                + struct.pack('>I', zlib.crc32(kind + body)))

    return (PNG_SIGNATURE
            + chunk(b'IHDR', struct.pack('>IIBBBBB', width, height, 8,
                                         colour, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(rows.tobytes(), 6))
            + chunk(b'IEND', b''))


def read_png(path: str) -> np.ndarray:
    """A PNG file -> uint8 array (see decode_png)."""
    with open(path, 'rb') as f:
        return decode_png(f.read(), path)


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H,W], [H,W,3] or [H,W,4] -> PNG file (see encode_png)."""
    data = encode_png(img)
    with open(path, 'wb') as f:
        f.write(data)


def read_rgb(path: str) -> np.ndarray:
    """A PNG as uint8 RGB [H,W,3]: grey is repeated, alpha dropped (as
    PIL's convert('RGB'))."""
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def write_rgb(path: str, img: np.ndarray) -> None:
    write_png(path, np.asarray(img).astype(np.uint8))


def to_float(img_u8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1] (ref: hair_editor.py:121-123)."""
    return np.asarray(img_u8, dtype=np.float32) / 127.5 - 1.0


def to_uint8(img_f: np.ndarray) -> np.ndarray:
    """float [-1,1] -> uint8 [0,255] (truncating, as the JAX twin)."""
    img = np.asarray(img_f, dtype=np.float32) * 127.5 + 127.5
    return np.clip(img, 0, 255).astype(np.uint8)


def mask_to_rgb(label: np.ndarray, draw_type: int = 2) -> np.ndarray:
    """Visualise a [H,W] label map (ref: util/mask_color_util.py:15-64).

    draw_type 0: all classes; 1: {bg, face, hair}; 2: {hair, other}.
    """
    label = np.asarray(label)
    if label.ndim == 3 and label.shape[0] == 1:
        label = label[0]
    color = MASK_VIS_COLOR.copy()
    if draw_type == 2:
        keep = np.zeros(len(color), bool)
        keep[HAIR_IDX] = True
        color[~keep] = [255, 255, 255]
    elif draw_type == 1:
        keep = np.zeros(len(color), bool)
        keep[HAIR_IDX] = True
        keep[0] = True
        color[~keep] = [237, 28, 36]
    lut = np.concatenate([color, np.full((256 - len(color), 3), 255, np.uint8)])
    return lut[np.where(label == UNKNOWN_LABEL, 255, label)]


class Canvas:
    """Grid canvas for sample sheets (ref: util/canvas_grid.py:15-34)."""

    def __init__(self, rows: int, cols: int, cell: int = 256, margin: int = 2):
        self.cell = cell
        self.margin = margin
        h = rows * (cell + margin) + margin
        w = cols * (cell + margin) + margin
        self.img = np.full((h, w, 3), 255, np.uint8)

    def paste(self, row: int, col: int, img: np.ndarray) -> None:
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = to_uint8(img)
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        y = row * (self.cell + self.margin) + self.margin
        x = col * (self.cell + self.margin) + self.margin
        self.img[y:y + img.shape[0], x:x + img.shape[1]] = img

    def save(self, path: str) -> None:
        write_rgb(path, self.img)
