# The port's image reader (ctrlhair_tpu_torch/utils/image.py and
# utils/jpeg.py) against PIL, which the JAX package reads through
# (ctrlhair_tpu/utils/image.py: Image.open(path).convert('RGB'); label maps
# as np.asarray(Image.open(path))).  Fixtures are made here from
# samples/input.png: by PIL where PIL can write the kind, else by the small
# encoder below (16-bit colour, 2- and 4-bit grey, Adam7 interlace), and
# read back by both.  Bar: every PNG and every JPEG equal to PIL exactly,
# dtype and shape included.
import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ctrlhair_tpu.pipeline.backend import Backend as JaxBackend
from ctrlhair_tpu.utils.image import read_rgb as jax_read_rgb
from ctrlhair_tpu_torch.utils.image import (
    decode_png, decode_rgb, read_png, read_rgb)
from ctrlhair_tpu_torch.utils.jpeg import decode_jpeg

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def sample(size=None) -> np.ndarray:
    img = Image.open(JaxBackend._repo_path('samples/input.png')).convert('RGB')
    if size is not None:
        img = img.crop((40, 60, 40 + size[1], 60 + size[0]))
    return np.asarray(img)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack('>I', len(body)) + kind + body
            + struct.pack('>I', zlib.crc32(kind + body)))


def _rows(samples: np.ndarray, depth: int) -> bytes:
    """[h, w, ch] samples -> filter-0 scanlines."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        rows = flat.astype('>u2').view(np.uint8).reshape(h, -1)
    elif depth == 8:
        rows = flat.astype(np.uint8)
    else:
        bits = (flat[..., None].astype(np.uint8)
                >> np.arange(depth - 1, -1, -1).astype(np.uint8)) & 1
        rows = np.packbits(bits.reshape(h, -1), axis=1)
    return b''.join(b'\x00' + r.tobytes() for r in rows)


def encode(samples: np.ndarray, depth: int, colour: int, interlace=False,
           extra: bytes = b'') -> bytes:
    """A PNG of raw samples [H, W, ch] at any bit depth, Adam7 on demand."""
    h, w = samples.shape[:2]
    if interlace:
        data = b''.join(_rows(samples[y0::dy, x0::dx], depth)
                        for x0, y0, dx, dy in ADAM7
                        if w > x0 and h > y0)
    else:
        data = _rows(samples, depth)
    return (b'\x89PNG\r\n\x1a\n'
            + _chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, depth, colour, 0,
                                          0, int(interlace)))
            + extra + _chunk(b'IDAT', zlib.compress(data))
            + _chunk(b'IEND', b''))


def palette_of(img: np.ndarray, bits: int):
    """(indices [H,W], palette [n,3]) of img quantised to 2**bits colours."""
    q = Image.fromarray(img).quantize(colors=2 ** bits)
    pal = np.asarray(q.getpalette()[:3 * 2 ** bits], np.uint8).reshape(-1, 3)
    return np.asarray(q), pal


def same_as_pil(path, tmp_path=None):
    """read_png / read_rgb / the JAX reader against PIL, exactly."""
    ref = np.asarray(Image.open(path))
    got = read_png(str(path))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    rgb = np.asarray(Image.open(path).convert('RGB'))
    np.testing.assert_array_equal(read_rgb(str(path)), rgb)
    np.testing.assert_array_equal(read_rgb(str(path)),
                                  jax_read_rgb(str(path)))


# ------------------------------------------------------------------ PNG
@pytest.mark.parametrize('bits', [1, 2, 4, 8])
@pytest.mark.parametrize('trns', [False, True])
def test_palette_png(bits, trns, tmp_path):
    idx, pal = palette_of(sample(), bits)
    extra = _chunk(b'PLTE', pal.tobytes())
    if trns:
        extra += _chunk(b'tRNS', (np.arange(len(pal)) * 37 % 256).astype(
            np.uint8).tobytes())
    path = tmp_path / 'p.png'
    path.write_bytes(encode(idx[..., None], bits, 3, extra=extra))
    same_as_pil(path)
    # and as PIL writes it
    Image.fromarray(sample()).quantize(colors=2 ** bits).save(
        tmp_path / 'pil.png', bits=bits)
    same_as_pil(tmp_path / 'pil.png')


def test_palette_png_short_plte(tmp_path):
    """Indices past the PLTE's entries are black, as in PIL."""
    idx = np.arange(20, dtype=np.uint8).reshape(4, 5, 1)
    path = tmp_path / 'short.png'
    path.write_bytes(encode(idx, 8, 3, extra=_chunk(b'PLTE', bytes(range(
        1, 31)))))
    same_as_pil(path)


@pytest.mark.parametrize('bits', [1, 2, 4, 8, 16])
def test_grey_png(bits, tmp_path):
    grey = np.asarray(Image.fromarray(sample()).convert('L')).astype(
        np.uint16)
    if bits == 16:
        # values above and below 255: convert('RGB') clips at 255
        grey = grey * 257 // np.array([1, 300], np.uint16)[
            np.arange(grey.shape[1]) % 2]
    else:
        grey >>= 8 - bits
    path = tmp_path / 'g.png'
    path.write_bytes(encode(grey[..., None], bits, 0))
    same_as_pil(path)


def test_grey_png_as_pil_writes(tmp_path):
    """Mode '1', 'L' with tRNS, 'LA' and 'I;16' as PIL saves them."""
    img = Image.fromarray(sample())
    img.convert('1').save(tmp_path / 'b.png')
    img.convert('L').save(tmp_path / 't.png', transparency=7)
    img.convert('LA').save(tmp_path / 'la.png')
    Image.fromarray(np.asarray(img.convert('L')).astype(np.uint16)
                    * 100).save(tmp_path / 'w.png')
    img.save(tmp_path / 'rgbt.png', transparency=(1, 2, 3))
    for name in ('b', 't', 'la', 'w', 'rgbt'):
        same_as_pil(tmp_path / f'{name}.png')


@pytest.mark.parametrize('colour,depth', [(4, 8), (4, 16), (2, 16),
                                          (6, 16)])
def test_grey_alpha_and_16bit_colour_png(colour, depth, tmp_path):
    rgb = sample().astype(np.uint16)
    alpha = rgb[..., :1] // 2 + 40
    if colour == 4:
        samples = np.concatenate([rgb[..., 1:2], alpha], axis=-1)
    else:
        samples = rgb if colour == 2 else np.concatenate([rgb, alpha], -1)
    if depth == 16:                  # distinct low bytes, dropped by PIL
        samples = samples * 257 + np.arange(samples.shape[1])[:, None] % 7
    path = tmp_path / 'c.png'
    path.write_bytes(encode(samples.astype(np.uint16), depth, colour))
    same_as_pil(path)


@pytest.mark.parametrize('size', [(256, 256), (37, 23), (1, 5), (6, 1)])
@pytest.mark.parametrize('kind', ['rgb8', 'palette4', 'grey16', 'rgba16',
                                  'grey1'])
def test_adam7_png(kind, size, tmp_path):
    img = sample(size)
    extra = b''
    if kind == 'rgb8':
        samples, depth, colour = img, 8, 2
    elif kind == 'palette4':
        idx, pal = palette_of(img, 4)
        samples, depth, colour = idx[..., None], 4, 3
        extra = _chunk(b'PLTE', pal.tobytes())
    elif kind == 'grey16':
        samples, depth, colour = img[..., :1].astype(np.uint16) * 3, 16, 0
    elif kind == 'rgba16':
        samples = np.concatenate([img, img[..., :1]], -1).astype(
            np.uint16) * 251
        depth, colour = 16, 6
    else:
        samples, depth, colour = img[..., :1] > 100, 1, 0
    path = tmp_path / 'i.png'
    path.write_bytes(encode(np.asarray(samples), depth, colour,
                            interlace=True, extra=extra))
    same_as_pil(path)


def test_png_refusals():
    good = encode(sample((8, 8)), 8, 2)
    with pytest.raises(ValueError, match='not a PNG file'):
        decode_rgb(b'GIF89a' + good[6:])
    with pytest.raises(ValueError, match='unsupported PNG'):
        decode_png(encode(sample((8, 8)), 4, 2))         # 4-bit RGB
    with pytest.raises(ValueError, match='without PLTE'):
        decode_png(encode(sample((8, 8))[..., :1], 8, 3))


# ----------------------------------------------------------------- JPEG
@pytest.mark.parametrize('progressive', [False, True])
@pytest.mark.parametrize('subsampling', [0, 1, 2])      # 4:4:4 4:2:2 4:2:0
@pytest.mark.parametrize('quality', [30, 95])
def test_jpeg(progressive, subsampling, quality, tmp_path):
    path = tmp_path / 'photo.jpg'
    Image.fromarray(sample()).save(path, quality=quality,
                                   subsampling=subsampling,
                                   progressive=progressive)
    rgb = np.asarray(Image.open(path).convert('RGB'))
    np.testing.assert_array_equal(read_rgb(str(path)), rgb)
    np.testing.assert_array_equal(jax_read_rgb(str(path)), rgb)


@pytest.mark.parametrize('size', [(37, 23), (9, 250), (17, 1)])
def test_jpeg_odd_sizes_grey_and_restarts(size, tmp_path):
    img = Image.fromarray(sample(size))
    for i, kw in enumerate([dict(subsampling=2, progressive=True),
                            dict(subsampling=1, restart_marker_blocks=3),
                            dict(subsampling=2, restart_marker_rows=1,
                                 progressive=True)]):
        path = tmp_path / f'{i}.jpg'
        img.save(path, **kw)
        np.testing.assert_array_equal(
            read_rgb(str(path)), np.asarray(Image.open(path).convert('RGB')))
    grey = tmp_path / 'grey.jpg'
    img.convert('L').save(grey, progressive=True)
    np.testing.assert_array_equal(decode_jpeg(grey.read_bytes()),
                                  np.asarray(Image.open(grey)))
    np.testing.assert_array_equal(
        read_rgb(str(grey)), np.asarray(Image.open(grey).convert('RGB')))


def test_jpeg_by_magic_and_refusals(tmp_path):
    """read_rgb tells a JPEG by its bytes, not its name; broken JPEGs and
    kinds PIL would decode differently raise ValueError."""
    buf = io.BytesIO()
    Image.fromarray(sample()).save(buf, 'JPEG')
    data = buf.getvalue()
    path = tmp_path / 'photo.png'                   # a JPEG named .png
    path.write_bytes(data)
    np.testing.assert_array_equal(read_rgb(str(path)),
                                  np.asarray(Image.open(path).convert('RGB')))
    with pytest.raises(ValueError):
        decode_rgb(data[:len(data) // 3])           # cut short
    with pytest.raises(ValueError):
        decode_rgb(b'\xff\xd8\xff\xe0\x00\x10JFIF\x00' + bytes(64))
    cmyk = io.BytesIO()
    Image.fromarray(sample()).convert('CMYK').save(cmyk, 'JPEG')
    with pytest.raises(ValueError, match='4 components'):
        decode_rgb(cmyk.getvalue())
