# The port's host utilities against their JAX twins on the same numpy
# inputs: SSIM / PSNR / batched SSIM (utils/metrics.py, within 1e-5: both
# filter in float32, the port by separable slices, JAX by one 2-D conv),
# the timing harness (utils/profiling.py, on the CPU), and the image helpers
# added for the UIs (utils/image.py: the PNG codec on bytes, uint8 <-> float
# conversion and the grid canvas, exact).
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.utils import image as jimage
from ctrlhair_tpu.utils import metrics as jmetrics
from ctrlhair_tpu_torch.utils import image as timage
from ctrlhair_tpu_torch.utils import metrics, profiling

TOL = 1e-5


def _pair(rng, shape, dtype, noise):
    a = rng.integers(0, 256, shape).astype(dtype)
    b = np.clip(a.astype(np.float64) + rng.normal(0, noise, shape), 0, 255)
    return a, b.astype(dtype)


@pytest.mark.parametrize('shape,dtype,noise', [
    ((64, 48, 3), np.uint8, 20.0),
    ((37, 29, 1), np.float32, 5.0),
    ((11, 11, 3), np.float32, 60.0),     # one valid window
    ((256, 256, 3), np.uint8, 2.0),
])
def test_ssim_psnr_match_jax(shape, dtype, noise):
    rng = np.random.default_rng(shape[0])
    a, b = _pair(rng, shape, dtype, noise)
    for x, y in ((a, b), (a, a), (b, a)):
        got = metrics.ssim(x, y)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - float(jmetrics.ssim(jnp.asarray(x),
                                                    jnp.asarray(y)))) < TOL
        assert abs(float(metrics.psnr(x, y)) - float(
            jmetrics.psnr(jnp.asarray(x), jnp.asarray(y)))) < TOL * 100
    assert float(metrics.ssim(a, a)) == pytest.approx(1.0, abs=1e-6)
    # data_range and tensors in, as the port's callers pass them
    fa, fb = a.astype(np.float32) / 255.0, b.astype(np.float32) / 255.0
    assert abs(float(metrics.ssim(torch.from_numpy(fa), torch.from_numpy(fb),
                                  data_range=1.0))
               - float(jmetrics.ssim(jnp.asarray(fa), jnp.asarray(fb),
                                     data_range=1.0))) < TOL


def test_batch_ssim_matches_jax():
    rng = np.random.default_rng(2)
    a, b = _pair(rng, (4, 40, 36, 3), np.float32, 15.0)
    b[1] = a[1]
    got = metrics.batch_ssim(a, b).numpy()
    ref = np.asarray(jmetrics.batch_ssim(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == ref.shape == (4,)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)
    np.testing.assert_allclose(got[[0, 2]], [float(metrics.ssim(a[i], b[i]))
                                             for i in (0, 2)], atol=1e-7)


def test_psnr_floor_of_equal_images():
    a = np.full((8, 8, 3), 7, np.uint8)
    assert float(metrics.psnr(a, a)) == pytest.approx(
        float(jmetrics.psnr(jnp.asarray(a), jnp.asarray(a))), rel=1e-6)


# --------------------------------------------------------------- profiling
def test_benchmark_keys_and_order():
    calls = []
    res = profiling.benchmark(lambda n: calls.append(n), 3, iters=5, warmup=2)
    assert set(res) == {'mean_s', 'p50_s', 'p90_s', 'min_s', 'iters'}
    assert res['iters'] == 5 and len(calls) == 7 and calls[0] == 3
    assert 0 <= res['min_s'] <= res['p50_s'] <= res['p90_s']
    assert res['min_s'] <= res['mean_s']


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / 'tr')) as log_dir:
        torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert log_dir == str(tmp_path / 'tr')
    with open(os.path.join(log_dir, 'trace.json')) as f:
        events = json.load(f)['traceEvents']
    assert any('mm' in str(e.get('name', '')) for e in events)


# ------------------------------------------------------------ image helpers
def test_png_bytes_roundtrip_and_pil():
    from PIL import Image
    rng = np.random.default_rng(3)
    for shape in ((17, 23), (17, 23, 3), (5, 9, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        data = timage.encode_png(img)
        np.testing.assert_array_equal(timage.decode_png(data), img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                      img)
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, 'PNG')
        np.testing.assert_array_equal(timage.decode_png(buf.getvalue()), img)
    with pytest.raises(ValueError, match='not a PNG'):
        timage.decode_png(b'\xff\xd8\xff\xe0 a JPEG')


def test_float_conversions_and_canvas_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (9, 7, 3), dtype=np.uint8)
    f = rng.uniform(-1.3, 1.3, (9, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(timage.to_float(u8), jimage.to_float(u8))
    np.testing.assert_array_equal(timage.to_uint8(f), jimage.to_uint8(f))
    canvases = []
    for mod in (timage, jimage):
        c = mod.Canvas(2, 3, cell=8, margin=1)
        c.paste(0, 0, u8[:8, :7])
        c.paste(1, 2, f[:8, :6])              # float [-1,1] -> uint8
        c.paste(0, 1, u8[:8, :8, 0])          # grey -> RGB
        c.save(str(tmp_path / f'{mod.__name__}.png'))
        canvases.append(c.img)
    np.testing.assert_array_equal(*canvases)
    np.testing.assert_array_equal(
        timage.read_png(str(tmp_path / 'ctrlhair_tpu_torch.utils.image.png')),
        jimage.read_rgb(str(tmp_path / 'ctrlhair_tpu.utils.image.png')))
