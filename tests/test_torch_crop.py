# The port's FFHQ crop (ctrlhair_tpu_torch/ops/crop.py) and the 1024 px
# photo path built on it (HairEditor.crop_face / get_hair_color /
# generate_*, warp_hair_mask_between_images(need_crop=True)) against the JAX
# package on the real portrait samples/input.png, plus the port's PNG codec
# against PIL.
#
# The JAX crop takes cv2 where it is installed (remap, GaussianBlur on a
# pyramid, INTER_LINEAR resizes) and numpy / scipy / its own resize
# otherwise; the port has only the second set.  With cv2 hidden from the JAX
# crop both take the same branches.  Bars: without cv2, >= 99.9% of pixels
# within one step and equal landmarks; against the JAX default with cv2,
# every pixel within one step and a mean |diff| <= 1e-3 (cv2.remap
# quantises coordinates to 1/32 px; the feather blur takes a pyramid).
# Tiny editors at float32: crop_face as the crop; get_hair_color within
# 1e-3; renders within 1e-4 * max|ref|; need_crop labels equal on >= 99.9%
# of pixels.
import sys
import zlib

import jax
import numpy as np
import pytest

from ctrlhair_tpu.ops import crop as jax_crop
from ctrlhair_tpu.ops import warp as jax_warp
from ctrlhair_tpu_torch.convert import from_flax
from ctrlhair_tpu_torch.ops import crop as port_crop
from ctrlhair_tpu_torch.ops import landmarks as tl
from ctrlhair_tpu_torch.ops.warp import warp_hair_mask_between_images
from ctrlhair_tpu_torch.pipeline.backend import repo_path
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.utils.image import read_png, read_rgb, write_rgb
from test_landmarks import synthetic_face
from test_torch_convert import port_config
from test_torch_landmark_net import upscale

SAMPLES = ['color_sweep', 'input', 'parsed_mask', 'regen_mask',
           'texture_samples', 'transfer_color_texture', 'transfer_matrix',
           'transfer_shape']


def without_cv2(fn):
    """`fn` run with cv2 hidden (an import of it fails)."""
    def call(*args, **kwargs):
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, 'cv2', None)
            return fn(*args, **kwargs)
    return call


@pytest.fixture
def no_cv2_crop(monkeypatch):
    """The JAX package's crop without cv2, wherever it is called from."""
    monkeypatch.setattr(jax_crop, 'recreate_aligned_image',
                        without_cv2(jax_crop.recreate_aligned_image))


@pytest.fixture(scope='module')
def photo():
    return read_rgb(repo_path('samples/input.png'))


@pytest.fixture(scope='module')
def port_net():
    tl.unload_landmark_net()
    assert tl.load_landmark_net(device='cpu')
    yield
    tl.unload_landmark_net()


def crop_cases(photo):
    """(image, 68 landmarks in pixels, output size): the 256 px portrait
    (the quad leaves the image: reflect pad, feather, median pull), its
    1024 px upscale at 256 and 1024 px out and shrunk to 128 px out, and the
    portrait inside a wide border (a crop without padding)."""
    lm = tl.net_landmarks_81(photo, device='cpu')[0][:68]
    big = upscale(photo, 1024)
    lm_big = tl.net_landmarks_81(big, device='cpu')[0][:68] * 1024
    inside = np.pad(photo, ((256, 256), (256, 256), (0, 0)), mode='edge')
    return {'pad_256': (photo, lm * 256, 256),
            'big_256': (big, lm_big, 256),
            'big_1024': (big, lm_big, 1024),
            'shrink_128': (big, lm_big, 128),
            'inside_256': (inside, lm * 256 + 256, 256)}


@pytest.mark.parametrize('case', ['pad_256', 'big_256', 'big_1024',
                                  'shrink_128', 'inside_256'])
def test_recreate_aligned_image(photo, port_net, case):
    img, lm, size = crop_cases(photo)[case]
    got, got_lm = port_crop.recreate_aligned_image(img, lm, size)
    assert got.dtype == np.uint8 and got.shape == (size, size, 3)
    # the JAX default (cv2)
    ref, ref_lm = jax_crop.recreate_aligned_image(img, lm, size)
    d = np.abs(got.astype(np.int32) - ref)
    assert d.max() <= 1 and d.mean() <= 1e-3, (d.max(), d.mean())
    np.testing.assert_array_equal(got_lm, ref_lm)
    # cv2 hidden: the same branches
    ref, ref_lm = without_cv2(jax_crop.recreate_aligned_image)(img, lm, size)
    d = np.abs(got.astype(np.int32) - ref)
    assert (d <= 1).mean() >= 0.999, (d <= 1).mean()
    np.testing.assert_array_equal(got_lm, ref_lm)


def test_crop_helpers_match_jax():
    rng = np.random.default_rng(0)
    lm = synthetic_landmarks(rng)
    quad, qsize = port_crop.crop_quad_from_landmarks(lm)
    ref_quad, ref_qsize = jax_crop.crop_quad_from_landmarks(lm)
    np.testing.assert_array_equal(quad, ref_quad)
    assert qsize == ref_qsize
    np.testing.assert_array_equal(port_crop._perspective_from_quad(quad),
                                  jax_crop._perspective_from_quad(quad))
    img = rng.uniform(0, 255, (40, 50, 3)).astype(np.float32)
    import scipy.ndimage
    np.testing.assert_array_equal(
        port_crop._gaussian_blur(img, 2.5),
        scipy.ndimage.gaussian_filter(img, [2.5, 2.5, 0]))


def synthetic_landmarks(rng):
    from ctrlhair_tpu_torch.ops.landmarks import canonical_template_81
    return canonical_template_81()[:68] * 300 + 40 + rng.normal(0, 2,
                                                                (68, 2))


# ----------------------------------------------------- the tiny editors
@pytest.fixture(scope='module')
def port(tiny_editor):
    ed = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    ed.load_state_dict(from_flax(jax.device_get(tiny_editor.params)))
    return ed


@pytest.fixture(scope='module')
def crop_faces(tiny_editor, port, photo, port_net):
    """{name: (port, JAX)} crop_face of the portrait and of its 1024 px
    upscale, computed once for the module, the JAX crop without cv2."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_crop, 'recreate_aligned_image',
                   without_cv2(jax_crop.recreate_aligned_image))
        for name, img in (('photo', photo),
                          ('upscale_1024', upscale(photo, 1024))):
            out[name] = (port.crop_face(img), tiny_editor.crop_face(img))
    return out


@pytest.mark.parametrize('name', ['photo', 'upscale_1024'])
def test_crop_face(crop_faces, name):
    """The landmarks come from the net on the raw photo (the parse is not
    used), the crop without cv2 on both sides."""
    got, ref = crop_faces[name]
    d = np.abs(got.astype(np.int32) - ref)
    assert got.shape == ref.shape == (64, 64, 3)
    assert (d <= 1).mean() >= 0.999, (d <= 1).mean()


def test_backend_crop_face_matches_jax(crop_faces, port, photo):
    """Backend.crop_face runs the editor's FFHQ crop on the shipped net's
    landmarks, as the JAX Backend's does (which is the JAX editor's
    crop_face, held in crop_faces)."""
    from ctrlhair_tpu_torch.pipeline.backend import Backend
    got = Backend(editor=port, cfg=port.cfg).crop_face(photo)
    np.testing.assert_array_equal(got, crop_faces['photo'][0])
    ref = crop_faces['photo'][1]
    assert got.shape == ref.shape == (64, 64, 3)
    d = np.abs(got.astype(np.int32) - ref)
    assert (d <= 1).mean() >= 0.999


def test_get_hair_color(tiny_editor, port, photo):
    """Without cv2 the JAX editor resizes to the parse size on the device,
    as the port does (cv2's INTER_LINEAR rounds halves up)."""
    got = port.get_hair_color(photo)
    ref = without_cv2(tiny_editor.get_hair_color)(photo)
    assert got.shape == (3,) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-3)
    # the parse found hair for the mean to cover
    assert np.abs(ref).sum() > 0


def test_generate_by_sean_and_instance_transfer(tiny_editor, port, photo):
    from ctrlhair_tpu.pipeline.latent import Latent as JaxLatent
    from ctrlhair_tpu_torch.pipeline.latent import Latent
    rng = np.random.default_rng(4)
    s = port.cfg.edit_size
    face = upscale(photo, s)
    hair = np.ascontiguousarray(face[:, ::-1])
    face_label = synthetic_face(s)[0]
    hair_label = synthetic_face(s, cx=0.46, cy=0.55)[0]
    codes = rng.standard_normal((19, port.cfg.sean.style_dim)).astype(
        np.float32)
    hair_code = rng.standard_normal(port.cfg.sean.style_dim).astype(
        np.float32)

    def close(got, ref):
        ref = np.asarray(ref, np.float32)
        assert got.shape == ref.shape == (s, s, 3)
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-4 * float(np.abs(ref).max()))

    close(port.generate_by_sean(codes, hair_code, hair_label),
          tiny_editor.generate_by_sean(codes, hair_code, hair_label))
    close(port.generate_instance_transfer_img(face, face_label, hair,
                                              hair_label, hair_label),
          tiny_editor.generate_instance_transfer_img(
              face, face_label, hair, hair_label, hair_label))
    close(port.generate_instance_transfer_img(face, face_label, None, None,
                                              face_label),
          tiny_editor.generate_instance_transfer_img(
              face, face_label, None, None, face_label))
    fields = {'hsv': [[20.0, 120.0, 90.0]], 'pca_std': [[40.0]],
              'curliness': [[0.3]], 'texture': rng.standard_normal((1, 8)),
              'shape': rng.standard_normal((1, 16)),
              'face': rng.standard_normal((1, 1024))}
    jl = JaxLatent(**{k: np.asarray(v, np.float32) for k, v in
                      fields.items()})
    import torch
    tlat = Latent(**{k: torch.tensor(np.asarray(v, np.float32)) for k, v in
                     fields.items()})
    close(port.generate_instance_transfer_img(face, face_label, hair,
                                              hair_label, face_label, tlat),
          tiny_editor.generate_instance_transfer_img(
              face, face_label, hair, hair_label, face_label, jl))


def test_need_crop_transfer(tiny_editor, port, photo, no_cv2_crop):
    """Both raw photos FFHQ-aligned at 1024 px, both crops parsed in one
    batch, landmarks by the shipped net on each crop, warped."""
    mirrored = np.ascontiguousarray(photo[:, ::-1])
    tl.unload_landmark_net()
    got = warp_hair_mask_between_images(photo, mirrored, port,
                                        need_crop=True).numpy()
    ref = np.asarray(jax_warp.warp_hair_mask_between_images(
        photo, mirrored, tiny_editor, need_crop=True))
    assert tl._NET is not None           # 'auto' loaded the shipped net
    s = port.cfg.edit_size
    assert got.shape == ref.shape == (s, s)
    assert (got == ref).mean() >= 0.999, (got == ref).mean()
    tl.unload_landmark_net()


# --------------------------------------------------------------- PNG codec
@pytest.mark.parametrize('name', SAMPLES)
def test_png_codec_matches_pil(name, tmp_path):
    from PIL import Image
    path = repo_path(f'samples/{name}.png')
    ref = np.asarray(Image.open(path))
    np.testing.assert_array_equal(read_png(path), ref)
    np.testing.assert_array_equal(read_rgb(path),
                                  np.asarray(Image.open(path).convert('RGB')))
    out = tmp_path / 'out.png'
    write_rgb(str(out), ref)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), ref)


def test_png_codec_grey_rgba_and_refusals(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    grey = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    rgba = rng.integers(0, 256, (21, 19, 4), dtype=np.uint8)
    for img in (grey, rgba):
        Image.fromarray(img).save(tmp_path / 'pil.png')
        np.testing.assert_array_equal(read_png(str(tmp_path / 'pil.png')),
                                      img)
        np.testing.assert_array_equal(
            read_rgb(str(tmp_path / 'pil.png')),
            np.asarray(Image.open(tmp_path / 'pil.png').convert('RGB')))
        write_rgb(str(tmp_path / 'ours.png'), img)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / 'ours.png')), img)
    # palette and 16-bit PNGs read as PIL reads them (more colour types in
    # test_torch_image_codec.py); a PNG flagged interlaced whose data is not
    # Adam7's, and a broken CRC, are refused
    Image.fromarray(grey).convert('P').save(tmp_path / 'p.png')
    Image.fromarray(grey.astype(np.uint16) * 200).save(tmp_path / 'w.png')
    for name in ('p', 'w'):
        path = tmp_path / f'{name}.png'
        np.testing.assert_array_equal(read_png(str(path)),
                                      np.asarray(Image.open(path)))
        np.testing.assert_array_equal(
            read_rgb(str(path)), np.asarray(Image.open(path).convert('RGB')))
    data = bytearray((tmp_path / 'ours.png').read_bytes())
    interlaced = data.copy()
    interlaced[28] = 1                     # IHDR's interlace method
    interlaced[29:33] = zlib.crc32(bytes(interlaced[12:29])).to_bytes(4,
                                                                      'big')
    (tmp_path / 'i.png').write_bytes(bytes(interlaced))
    data[40] ^= 0xff
    (tmp_path / 'crc.png').write_bytes(bytes(data))
    for name in ('i', 'crc'):
        with pytest.raises(ValueError):
            read_png(str(tmp_path / f'{name}.png'))
