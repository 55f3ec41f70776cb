# The port's host landmark estimators against the JAX package's, on painted
# label maps (tests/test_landmarks.synthetic_face).  Both sides are numpy
# code on the same input, so the bar is atol 1e-6 on [0,1] coordinates.
# Both sides are held to the estimators that read the label map (no
# landmark net on either), so method='auto' is the contour estimator on
# both; the net is tested in test_torch_landmark_net.py.
import numpy as np
import pytest

from ctrlhair_tpu.constants import PARSING_LABEL_LIST
from ctrlhair_tpu.ops import landmarks as jl
from ctrlhair_tpu_torch.ops import landmarks as tl
from test_landmarks import synthetic_face

L = {name: i for i, name in enumerate(PARSING_LABEL_LIST)}


def two_faces(size=256):
    lab, _ = synthetic_face(size, cx=0.33, cy=0.5, fw=0.20, fh=0.28)
    small, _ = synthetic_face(size, cx=0.78, cy=0.55, fw=0.10, fh=0.14,
                              with_hair=False)
    lab[small > 0] = small[small > 0]
    return lab


def glasses(size=256):
    lab, _ = synthetic_face(size)
    eyes = np.isin(lab, [L['l_eye'], L['r_eye'], L['l_brow'], L['r_brow']])
    ys, xs = np.nonzero(eyes)
    lab[ys.min() - 4:ys.max() + 5, xs.min() - 4:xs.max() + 5] = L['eye_g']
    return lab


CASES = {
    'frontal': lambda: synthetic_face(256)[0],
    'shifted_small': lambda: synthetic_face(
        512, cx=0.44, cy=0.58, fw=0.20, fh=0.27)[0],
    'no_hair': lambda: synthetic_face(128, with_hair=False)[0],
    'two_faces': two_faces,
    'glasses': glasses,
    'empty': lambda: np.zeros((128, 128), np.int32),
    'noise': lambda: np.random.default_rng(5).integers(
        0, 19, (128, 128)).astype(np.int32),
}


@pytest.fixture(autouse=True)
def no_landmark_net(monkeypatch):
    """Hold both sides' method='auto' to the contour estimator (their
    shipped landmark net would otherwise load)."""
    for side in (jl, tl):
        monkeypatch.setattr(side, '_AUTOLOAD_TRIED', True)
        monkeypatch.setattr(side, '_NET', None)


def test_canonical_template_equal():
    np.testing.assert_array_equal(tl.canonical_template_81(),
                                  jl.canonical_template_81())


@pytest.mark.parametrize('case', sorted(CASES))
@pytest.mark.parametrize('method', ['contour', 'template', 'auto'])
def test_estimators_match_jax(case, method):
    lab = CASES[case]()
    img = np.zeros(lab.shape + (3,), np.uint8)
    got = tl.estimate_landmarks_81(lab, method=method, image=img)
    ref = jl.estimate_landmarks_81(lab, method=method, image=img)
    assert got.shape == (81, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(
        tl.estimate_landmarks_68(lab, method=method), ref[:68], atol=1e-6)


@pytest.mark.parametrize('case', ['two_faces', 'frontal', 'empty'])
def test_select_main_face_equal(case):
    lab = CASES[case]()
    np.testing.assert_array_equal(tl.select_main_face(lab),
                                  jl.select_main_face(lab))


def test_landmarks_follow_the_face():
    """The contour estimator is driven by the painted geometry, not the
    bare template: moving the face moves the landmarks with it."""
    a = tl.contour_landmarks_81(synthetic_face(256)[0])
    b = tl.contour_landmarks_81(synthetic_face(256, cx=0.42, cy=0.60)[0])
    shift = (b - a)[27:68].mean(0)
    np.testing.assert_allclose(shift, [-0.08, 0.06], atol=0.02)
