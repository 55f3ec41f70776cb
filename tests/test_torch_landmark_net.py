# The port's learned landmark net (ctrlhair_tpu_torch/models/landmark_net.py,
# the net half of ops/landmarks.py) against the JAX package's, both with the
# shipped checkpoint model_trained/landmark_net, on the real portrait
# samples/input.png: at its 256 px, at a 1024 px upscale, at 300 px (a
# non-integer ratio to the net's 128 px input) and mirrored.
#
# Tolerances.  preprocess_image: within 1e-5 of the JAX one, which resizes
# with cv2's INTER_AREA (the port reproduces it without cv2; the values are
# uint8 steps of 1/127.5 apart, so this is equality).  Landmarks and
# presence: within 1e-4 (float32 convolutions summed in other orders).
import numpy as np
import pytest
import torch

from ctrlhair_tpu.models.landmark_net import preprocess_image as jax_prep
from ctrlhair_tpu.ops import landmarks as jl
from ctrlhair_tpu_torch.models.landmark_net import (area_resize_u8,
                                                    preprocess_image)
from ctrlhair_tpu_torch.ops import landmarks as tl
from ctrlhair_tpu_torch.ops.resize import resize_bilinear_nhwc
from ctrlhair_tpu_torch.pipeline.backend import repo_path
from ctrlhair_tpu_torch.utils.image import read_rgb

ATOL = 1e-4


def upscale(img, size):
    out = resize_bilinear_nhwc(torch.as_tensor(img, dtype=torch.float32)[None],
                               (size, size))[0]
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8).numpy()


def photos():
    img = read_rgb(repo_path('samples/input.png'))
    return {'sample_256': img, 'upscale_1024': upscale(img, 1024),
            'resize_300': upscale(img, 300),
            'mirrored': np.ascontiguousarray(img[:, ::-1])}


def non_faces():
    """The JAX package's non-faces (tests/test_landmark_net.py)."""
    rng = np.random.default_rng(0)
    return (rng.integers(0, 255, (256, 256, 3), dtype=np.uint8),
            np.full((256, 256, 3), 90, np.uint8),
            np.tile(np.linspace(0, 255, 256, dtype=np.uint8)[:, None, None],
                    (1, 256, 3)))


@pytest.fixture(scope='module')
def nets():
    """Both packages' nets loaded once for the module (the JAX load costs
    seconds), unloaded after it."""
    jl.unload_landmark_net()
    tl.unload_landmark_net()
    assert jl.load_landmark_net()
    assert tl.load_landmark_net(device='cpu')
    yield
    jl.unload_landmark_net()
    tl.unload_landmark_net()


@pytest.mark.parametrize('size', [128, 256, 300, 517, 1024, 64, 32])
def test_preprocess_matches_cv2_inter_area(size):
    rng = np.random.default_rng(size)
    img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    for im in (img, upscale(read_rgb(repo_path('samples/input.png')), size)):
        got, ref = preprocess_image(im, 128), jax_prep(im, 128)
        assert got.shape == ref.shape == (1, 128, 128, 3)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_preprocess_other_upscales_within_one_step():
    """A non-integer upscale uses cv2's 11-bit fixed-point weights; the
    rounding of its second pass is not reproduced bit for bit."""
    import cv2
    for size in (100, 77):
        img = np.random.default_rng(size).integers(0, 256, (size, size, 3),
                                                   dtype=np.uint8)
        got = area_resize_u8(img, 128).astype(np.int32)
        ref = cv2.resize(img, (128, 128), interpolation=cv2.INTER_AREA)
        assert np.abs(got - ref).max() <= 1


@pytest.mark.parametrize('name', ['sample_256', 'upscale_1024', 'resize_300',
                                  'mirrored'])
def test_net_matches_jax_on_the_sample(nets, name):
    img = photos()[name]
    ref = jl.net_landmarks_81(img)
    got = tl.net_landmarks_81(img, device='cpu')
    assert ref is not None and got is not None
    assert got[0].shape == (81, 2) and got[0].dtype == np.float32
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=ATOL)
    assert abs(got[1] - ref[1]) <= ATOL and got[1] >= 0.9


def test_non_faces_rejected_by_both(nets):
    for i, img in enumerate(non_faces()):
        assert jl.net_landmarks_81(img) is None, i
        assert tl.net_landmarks_81(img, device='cpu') is None, i


@pytest.fixture(scope='module')
def estimates(nets):
    """{method: [(port, JAX)]} of estimate_landmarks_81 on every photo and
    non-face, each computed once for the module."""
    from test_landmarks import synthetic_face
    label = synthetic_face(256)[0]
    out = {}
    for method in ('auto', 'net'):
        out[method] = [
            (tl.estimate_landmarks_81(label, method=method, image=img,
                                      device='cpu'),
             jl.estimate_landmarks_81(label, method=method, image=img))
            for img in (*photos().values(), *non_faces())]
    return label, out


@pytest.mark.parametrize('method', ['auto', 'net'])
def test_estimate_matches_jax(estimates, method):
    """'auto' and 'net' take the net on a face and the contour estimator
    when the presence head rejects the frame, on both sides."""
    label, out = estimates
    imgs = (*photos().values(), *non_faces())
    for (got, ref), img in zip(out[method], imgs):
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
        np.testing.assert_allclose(
            tl.estimate_landmarks_68(label, method=method, image=img,
                                     device='cpu'), ref[:68], atol=ATOL)
    with pytest.raises(ValueError):
        tl.estimate_landmarks_81(label, method='net', device='cpu')


def test_estimate_takes_the_shipped_net(estimates):
    """On the sample portrait 'auto' and 'net' give the shipped net's
    landmarks on both sides, not the contour estimator's; an unknown
    method raises."""
    label, out = estimates
    for method in ('auto', 'net'):
        got, ref = out[method][0]                 # samples/input.png
        np.testing.assert_allclose(got, ref, atol=1e-4)
        np.testing.assert_array_equal(
            got, tl.net_landmarks_81(photos()['sample_256'],
                                     device='cpu')[0])
        assert np.abs(ref - jl.contour_landmarks_81(label)).max() > 0.01
    with pytest.raises(ValueError):
        tl.estimate_landmarks_81(label, method='dlib')


def test_autoload_and_checkpoint_errors(monkeypatch, tmp_path):
    """An absent checkpoint directory leaves 'auto' on the contour
    estimator; a present but unreadable one raises (the JAX package
    swallows it); the shipped one loads on first use."""
    from test_landmarks import synthetic_face
    label = synthetic_face(128)[0]
    face = read_rgb(repo_path('samples/input.png'))
    tl.unload_landmark_net()
    try:
        monkeypatch.setattr(tl, 'default_landmark_ckpt_dir',
                            lambda: str(tmp_path / 'absent'))
        np.testing.assert_array_equal(
            tl.estimate_landmarks_81(label, image=face, device='cpu'),
            tl.contour_landmarks_81(label))
        tl.unload_landmark_net()
        (tmp_path / 'bad').mkdir()
        (tmp_path / 'bad' / 'latest_checkpoint').write_text('0000001.ckpt\n')
        (tmp_path / 'bad' / '0000001.ckpt').write_bytes(b'\x81\xa6params')
        monkeypatch.setattr(tl, 'default_landmark_ckpt_dir',
                            lambda: str(tmp_path / 'bad'))
        for _ in range(2):             # raises again: not remembered as a miss
            with pytest.raises(ValueError):
                tl.estimate_landmarks_81(label, image=face, device='cpu')
        monkeypatch.undo()
        assert tl._NET is None
        got = tl.estimate_landmarks_81(label, image=face, device='cpu')
        assert tl._NET is not None
        np.testing.assert_array_equal(
            got, tl.net_landmarks_81(face, device='cpu')[0])
    finally:
        tl.unload_landmark_net()
