# Host-side image I/O and normalisation helpers.
#
# Port of ctrlhair_tpu/utils/image.py: PNG read/write (files and bytes),
# uint8 <-> [-1,1] float conversion, label-map colouring and the grid
# canvas.  The codec is the standard library's zlib plus numpy (the JAX
# package reads and writes through PIL) and reads what PIL reads the way PIL
# does: PNG of every colour type and bit depth, interlaced or not, all five
# scanline filters (PNG spec, sections 8-9), and baseline and progressive
# JPEG (utils/jpeg.py).  It writes 8-bit grey, RGB and RGBA PNG.
# (ref counterparts: util/imutil.py:13-24, util/canvas_grid.py:15-34,
#  util/mask_color_util.py:15-64)

from __future__ import annotations

import struct
import zlib

import numpy as np

from ctrlhair_tpu_torch.constants import (
    HAIR_IDX, MASK_VIS_COLOR, UNKNOWN_LABEL)


PNG_SIGNATURE = b'\x89PNG\r\n\x1a\n'
JPEG_SIGNATURE = b'\xff\xd8\xff'
# colour type -> (samples a pixel, allowed bit depths) (PNG spec, 11.2.2)
_PNG_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
              3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy) (PNG spec, 8.2)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _samples(raw: bytes, width: int, height: int, depth: int,
             ch: int) -> np.ndarray:
    """Scanlines of one (sub)image -> [height, width, ch] samples (uint8,
    or uint16 at depth 16)."""
    stride = (width * ch * depth + 7) // 8
    rows = _unfilter(raw, height, stride, max(1, ch * depth // 8))
    if depth == 16:
        return rows.view('>u2').astype(np.uint16).reshape(height, width, ch)
    if depth == 8:
        return rows.reshape(height, width, ch)
    bits = np.unpackbits(rows, axis=1)[:, :width * ch * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(height, width, ch, depth) * weights).sum(
        -1, dtype=np.uint8)


def _png_samples(raw: bytes, width: int, height: int, depth: int, ch: int,
                 interlace: int) -> np.ndarray:
    """Decompressed image data -> [H, W, ch] samples, Adam7 undone."""
    if not interlace:
        return _samples(raw, width, height, depth, ch)
    out = np.zeros((height, width, ch), np.uint16 if depth == 16
                   else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        w = max(0, (width - x0 + dx - 1) // dx)
        h = max(0, (height - y0 + dy - 1) // dy)
        if w == 0 or h == 0:
            continue
        n = h * ((w * ch * depth + 7) // 8 + 1)
        out[y0::dy, x0::dx] = _samples(raw[pos:pos + n], w, h, depth, ch)
        pos += n
    if pos != len(raw):
        raise ValueError(f'PNG: {len(raw)} bytes of interlaced scanlines, '
                         f'expected {pos}')
    return out


def _decode_png(data: bytes, name: str):
    """-> (samples [H, W, ch], colour type, bit depth, palette [256, 3])."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b'IHDR':
            header = struct.unpack('>IIBBBBB', body)
        elif kind == b'PLTE':
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8)
        elif kind == b'IDAT':
            idat.append(body)
    if header is None or not idat:
        raise ValueError(f'{name}: PNG without IHDR or IDAT')
    width, height, depth, colour, method, filt, interlace = header
    if colour not in _PNG_TYPES or depth not in _PNG_TYPES[colour][1] \
            or method or filt or interlace > 1:
        raise ValueError(f'{name}: unsupported PNG (bit depth {depth}, '
                         f'colour type {colour}, interlace {interlace})')
    if colour == 3 and palette is None:
        raise ValueError(f'{name}: palette PNG without PLTE')
    try:
        raw = zlib.decompress(b''.join(idat))
    except zlib.error as e:
        raise ValueError(f'{name}: bad PNG image data: {e}') from e
    samples = _png_samples(raw, width, height, depth, _PNG_TYPES[colour][0],
                           interlace)
    lut = np.zeros((256, 3), np.uint8)       # entries past PLTE are black
    if palette is not None:
        pal = palette.reshape(-1, 3)[:256]
        lut[:len(pal)] = pal
    return samples, colour, depth, lut


def decode_png(data: bytes, name: str = 'PNG') -> np.ndarray:
    """The bytes of a PNG -> the array that np.asarray(PIL.Image.open(...))
    gives: every colour type at every bit depth the PNG spec allows,
    interlaced or not.  Grey: [H,W], bool at depth 1, scaled to 0..255 at
    depths 2 and 4, uint16 at 16; palette: [H,W] indices; grey+alpha:
    [H,W,2], or RGBA [H,W,4] at depth 16; RGB [H,W,3]; RGBA [H,W,4].
    16-bit colour keeps the high byte of each sample.  ValueError for
    anything else, its message starting with `name` (or 'not a PNG
    file')."""
    samples, colour, depth, _ = _decode_png(data, name)
    if colour == 0:
        grey = samples[..., 0]
        if depth == 1:
            return grey != 0
        return grey * (255 // (2 ** depth - 1)) if depth < 8 else grey
    if colour == 3:
        return samples[..., 0]
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
        if colour == 4:
            samples = samples[..., [0, 0, 0, 1]]
    return samples


def decode_rgb(data: bytes, name: str = 'image') -> np.ndarray:
    """The bytes of a PNG or a JPEG, told apart by their first bytes ->
    uint8 RGB [H,W,3], as PIL.Image.open(...).convert('RGB') gives it:
    palette colours for a palette PNG, grey repeated (16-bit grey clipped
    to 255), alpha dropped.  ValueError for other bytes."""
    if data[:3] == JPEG_SIGNATURE:
        from ctrlhair_tpu_torch.utils.jpeg import decode_jpeg
        img = decode_jpeg(data, name)
    else:
        samples, colour, depth, lut = _decode_png(data, name)
        if colour == 3:
            return lut[samples[..., 0]]
        if colour == 0 and depth == 16:
            img = np.minimum(samples[..., 0], 255).astype(np.uint8)
        else:
            img = decode_png(data, name)
            if colour == 4:
                img = img[..., 0]
    if img.ndim == 2:
        return np.repeat(img.astype(np.uint8)[..., None] * (
            255 if img.dtype == bool else 1), 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


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
    """A PNG file -> np.asarray(PIL.Image.open(path)) (see decode_png);
    label maps of any colour type come back as their indices."""
    with open(path, 'rb') as f:
        return decode_png(f.read(), path)


def write_png(path: str, img: np.ndarray) -> None:
    """uint8 [H,W], [H,W,3] or [H,W,4] -> PNG file (see encode_png)."""
    data = encode_png(img)
    with open(path, 'wb') as f:
        f.write(data)


def read_rgb(path: str) -> np.ndarray:
    """A PNG or JPEG file as uint8 RGB [H,W,3], as PIL's
    Image.open(path).convert('RGB') (see decode_rgb)."""
    with open(path, 'rb') as f:
        return decode_rgb(f.read(), path)


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
