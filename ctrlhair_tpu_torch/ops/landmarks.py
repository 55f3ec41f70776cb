# Facial landmark estimation without dlib.
#
# Port of ctrlhair_tpu/ops/landmarks.py:
#   1. a parametric canonical 81-point template in FFHQ-aligned coordinates,
#   2. a similarity transform fitted from face-parsing region centroids
#      (eyes / nose / mouth from the BiSeNet label map) mapping the template
#      onto the actual face,
#   3. the parsing-contour estimator that drives each landmark group from
#      the region boundaries of the segmentation (host numpy),
#   4. the learned regressor (models/landmark_net.py) on the RGB image, its
#      shipped checkpoint loaded once per process on first use.
# The reference depends on dlib's HOG detector + 68/81-point shape predictors
# (ref: external_code/landmarks_util.py:17-19).  method='auto' takes the
# regressor when an image is given and its checkpoint is in the checkout,
# else the contour estimator, as the JAX package does.  The regressor runs
# on the device its caller names; none means the first CUDA device.

from __future__ import annotations

import os

import numpy as np
import torch

from ctrlhair_tpu_torch.constants import PARSING_LABEL_LIST

_L_EYE = PARSING_LABEL_LIST.index('l_eye')
_R_EYE = PARSING_LABEL_LIST.index('r_eye')
_NOSE = PARSING_LABEL_LIST.index('nose')
_MOUTH_IDS = [PARSING_LABEL_LIST.index(n) for n in ('mouth', 'u_lip', 'l_lip')]


def canonical_template_81() -> np.ndarray:
    """81 landmarks in [0,1]^2 FFHQ-aligned coordinates (x right, y down).

    Index layout follows the dlib 68+13 convention: 0-16 jaw, 17-26 brows,
    27-35 nose, 36-47 eyes, 48-67 mouth, 68-80 forehead/hairline arc.
    """
    pts = np.zeros((81, 2), np.float64)
    # jaw: half-ellipse from left temple over the chin to the right temple
    t = np.linspace(np.pi, 2 * np.pi, 17)
    pts[0:17, 0] = 0.5 + 0.33 * np.cos(t)
    pts[0:17, 1] = 0.52 + 0.40 * np.sin(t - np.pi)
    # brows
    bx = np.linspace(-0.17, -0.04, 5)
    pts[17:22] = np.stack([0.5 + bx, 0.40 - 0.03 * np.cos(
        np.linspace(0, np.pi, 5))], 1)
    pts[22:27] = np.stack([0.5 - bx[::-1], 0.40 - 0.03 * np.cos(
        np.linspace(np.pi, 0, 5))], 1)
    # nose bridge + nostrils
    pts[27:31] = np.stack([np.full(4, 0.5),
                           np.linspace(0.45, 0.60, 4)], 1)
    nx = np.linspace(-0.05, 0.05, 5)
    pts[31:36] = np.stack([0.5 + nx, 0.645 - 0.012 * np.abs(nx) / 0.05], 1)
    # eyes (6 points each, left-clockwise)
    def eye(cx, cy, w=0.055, h=0.022):
        ang = np.array([180, 120, 60, 0, -60, -120]) * np.pi / 180
        return np.stack([cx + w * np.cos(ang), cy - h * np.sin(ang)], 1)
    pts[36:42] = eye(0.365, 0.465)
    pts[42:48] = eye(0.635, 0.465)
    # mouth: outer 12 left-clockwise, inner 8
    ang = np.linspace(np.pi, 3 * np.pi, 13)[:12]
    pts[48:60] = np.stack([0.5 + 0.10 * np.cos(ang),
                           0.76 + 0.045 * np.sin(ang)], 1)
    ang_i = np.linspace(np.pi, 3 * np.pi, 9)[:8]
    pts[60:68] = np.stack([0.5 + 0.06 * np.cos(ang_i),
                           0.76 + 0.022 * np.sin(ang_i)], 1)
    # forehead arc 68-80 (hairline), left to right
    t = np.linspace(np.pi * 0.95, np.pi * 0.05, 13)
    pts[68:81] = np.stack([0.5 + 0.36 * np.cos(t),
                           0.22 - 0.10 * np.sin(t)], 1)
    return pts.astype(np.float32)


_TEMPLATE = canonical_template_81()
# template anchor points used for the similarity fit
_TEMPLATE_ANCHORS = {
    'l_eye': _TEMPLATE[36:42].mean(0),
    'r_eye': _TEMPLATE[42:48].mean(0),
    'nose': _TEMPLATE[27:36].mean(0),
    'mouth': _TEMPLATE[48:68].mean(0),
}


def select_main_face(label: np.ndarray) -> np.ndarray:
    """Restrict a parse to its largest connected face, for multi-face frames.

    dlib's detector picks one face box per call (ref:
    external_code/landmarks_util.py:17-19,30-37); our parsing-driven
    estimator has no detector, so centroids over a two-face frame would
    average across faces.  Equivalent hardening: connected components over
    the face-evidence mask (closed to bridge small occlusions), keep the
    largest, relabel every other component's face pixels as background.
    """
    from scipy import ndimage
    face = np.isin(label, _FACE_IDS + [_L_EAR, _R_EAR])
    if not face.any():
        return label
    closed = ndimage.binary_closing(
        face, structure=np.ones((3, 3), bool), iterations=2)
    comp, n = ndimage.label(closed)
    if n <= 1:
        return label
    sizes = ndimage.sum_labels(np.ones(comp.shape), comp,
                               index=np.arange(1, n + 1))
    keep = 1 + int(np.argmax(sizes))
    out = np.asarray(label).copy()
    out[face & (comp != keep)] = 0
    return out


def _region_centroid(label: np.ndarray, ids) -> np.ndarray | None:
    if np.isscalar(ids):
        ids = [ids]
    mask = np.isin(label, ids)
    if mask.sum() < 4:
        return None
    ys, xs = np.nonzero(mask)
    return np.array([xs.mean(), ys.mean()], np.float64) / label.shape[1]


def _fit_similarity(src: np.ndarray, dst: np.ndarray):
    """Least-squares similarity (scale+rot+shift) mapping src -> dst."""
    src_c = src - src.mean(0)
    dst_c = dst - dst.mean(0)
    num = (dst_c[:, 0] * src_c[:, 0] + dst_c[:, 1] * src_c[:, 1]).sum()
    num_r = (dst_c[:, 1] * src_c[:, 0] - dst_c[:, 0] * src_c[:, 1]).sum()
    den = (src_c ** 2).sum()
    if den < 1e-12:
        # degenerate (coincident source anchors): identity rotation
        return np.eye(2), dst.mean(0) - src.mean(0)
    a = num / den
    b = num_r / den
    rot = np.array([[a, -b], [b, a]])
    t = dst.mean(0) - src.mean(0) @ rot.T
    return rot, t


def template_landmarks_81(label_map: np.ndarray) -> np.ndarray:
    """[S, S] CelebA label map -> [81, 2] normalised landmarks in [0,1].

    Fits the canonical template through parsing-region centroids; identity
    placement if fewer than two anchor regions are visible.
    """
    anchors_src, anchors_dst = [], []
    found = {}
    for name, ids in (('l_eye', _L_EYE), ('r_eye', _R_EYE),
                      ('nose', _NOSE), ('mouth', _MOUTH_IDS)):
        c = _region_centroid(label_map, ids)
        if c is not None:
            found[name] = True
            anchors_src.append(_TEMPLATE_ANCHORS[name])
            anchors_dst.append(c)
    # Glasses fallback: `eye_g` occludes both eye regions in CelebAMask
    # parses; recover the two eye anchors as the left/right-lobe centroids
    # of the glasses region (dlib still regresses eyes under glasses).
    if 'l_eye' not in found and 'r_eye' not in found:
        ys, xs = np.nonzero(np.asarray(label_map) == _EYE_G)
        if xs.size >= 32:
            mid = np.median(xs)
            s = float(label_map.shape[1])
            for name, sel in (('l_eye', xs <= mid), ('r_eye', xs > mid)):
                if sel.sum() >= 8:
                    anchors_src.append(_TEMPLATE_ANCHORS[name])
                    anchors_dst.append(np.array(
                        [xs[sel].mean(), ys[sel].mean()]) / s)
    if len(anchors_src) < 2:
        return _TEMPLATE.copy()
    rot, t = _fit_similarity(np.asarray(anchors_src, np.float64),
                             np.asarray(anchors_dst, np.float64))
    out = _TEMPLATE.astype(np.float64) @ rot.T + t
    return np.clip(out, 0.0, 1.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Parsing-contour landmarks: drive every landmark group from the actual
# region boundaries of the segmentation (jaw <- face-skin silhouette,
# hairline <- skin/hair boundary, eyes/brows/nose/mouth <- per-region
# contours), with the similarity-fitted template only as prior/fallback.
# Replaces what dlib's regressors provide in the reference
# (ref: external_code/landmarks_util.py:17-19, wrap_codes/mask_adaptor.py:110).
# ---------------------------------------------------------------------------

_SKIN = PARSING_LABEL_LIST.index('skin_other')
_L_BROW = PARSING_LABEL_LIST.index('l_brow')
_R_BROW = PARSING_LABEL_LIST.index('r_brow')
_EYE_G = PARSING_LABEL_LIST.index('eye_g')
_L_EAR = PARSING_LABEL_LIST.index('l_ear')
_R_EAR = PARSING_LABEL_LIST.index('r_ear')
_MOUTH_IN = PARSING_LABEL_LIST.index('mouth')
_U_LIP = PARSING_LABEL_LIST.index('u_lip')
_L_LIP = PARSING_LABEL_LIST.index('l_lip')

_FACE_IDS = [_SKIN, _L_BROW, _R_BROW, _EYE_G, _L_EYE, _R_EYE, _NOSE,
             _MOUTH_IN, _U_LIP, _L_LIP]


def _col_stats(mask: np.ndarray):
    """Per-column (top y, bottom y, mean y) for occupied columns.

    Returns (xs, top, bottom, mean) arrays over occupied columns only."""
    cols = np.nonzero(mask.any(axis=0))[0]
    if cols.size == 0:
        return None
    ys, xs = np.nonzero(mask)
    order = np.argsort(xs, kind='stable')
    xs_s, ys_s = xs[order], ys[order]
    starts = np.searchsorted(xs_s, cols)
    ends = np.searchsorted(xs_s, cols, side='right')
    top = np.minimum.reduceat(ys_s, starts)
    bottom = np.maximum.reduceat(ys_s, starts)
    mean = np.add.reduceat(ys_s.astype(np.float64), starts) / (ends - starts)
    return cols, top.astype(np.float64), bottom.astype(np.float64), mean


def _pick_col(cols: np.ndarray, x: float) -> int:
    return int(np.argmin(np.abs(cols - x)))


def _eye_points(mask: np.ndarray):
    """6 dlib-ordered eye points (corner, 2 upper, corner, 2 lower)."""
    st = _col_stats(mask)
    if st is None or mask.sum() < 16:
        return None
    cols, top, bottom, mean = st
    x0, x1 = cols[0], cols[-1]
    if x1 - x0 < 3:
        return None
    p = np.zeros((6, 2), np.float64)
    p[0] = (x0, mean[0])
    p[3] = (x1, mean[-1])
    for k, f in ((1, 1 / 3), (2, 2 / 3)):
        i = _pick_col(cols, x0 + f * (x1 - x0))
        p[k] = (cols[i], top[i])
    for k, f in ((4, 2 / 3), (5, 1 / 3)):
        i = _pick_col(cols, x0 + f * (x1 - x0))
        p[k] = (cols[i], bottom[i])
    return p


def _brow_points(mask: np.ndarray):
    """5 points along the brow centreline, left to right."""
    st = _col_stats(mask)
    if st is None or mask.sum() < 12:
        return None
    cols, _, _, mean = st
    x0, x1 = cols[0], cols[-1]
    if x1 - x0 < 4:
        return None
    p = np.zeros((5, 2), np.float64)
    for k, f in enumerate(np.linspace(0.02, 0.98, 5)):
        i = _pick_col(cols, x0 + f * (x1 - x0))
        p[k] = (cols[i], mean[i])
    return p


def _nose_points(mask: np.ndarray):
    """27-30 bridge (per-row centroid) + 31-35 nostril bottom line."""
    if mask.sum() < 25:
        return None
    rows = np.nonzero(mask.any(axis=1))[0]
    y0, y1 = rows[0], rows[-1]
    if y1 - y0 < 6:
        return None
    p = np.zeros((9, 2), np.float64)
    for k, f in enumerate((0.05, 0.35, 0.65, 0.92)):
        yr = rows[_pick_col(rows, y0 + f * (y1 - y0))]
        xs = np.nonzero(mask[yr])[0]
        p[k] = (xs.mean(), yr)
    st = _col_stats(mask)
    cols, _, bottom, _ = st
    x0, x1 = cols[0], cols[-1]
    for k, f in enumerate((0.08, 0.3, 0.5, 0.7, 0.92)):
        i = _pick_col(cols, x0 + f * (x1 - x0))
        p[4 + k] = (cols[i], bottom[i])
    return p


def _mouth_points(outer: np.ndarray, inner: np.ndarray):
    """12 outer + 8 inner dlib-ordered mouth points."""
    st = _col_stats(outer)
    if st is None or outer.sum() < 30:
        return None
    cols, top, bottom, mean = st
    x0, x1 = cols[0], cols[-1]
    if x1 - x0 < 6:
        return None
    p = np.zeros((20, 2), np.float64)
    p[0] = (x0, mean[0])                               # 48 left corner
    p[6] = (x1, mean[-1])                              # 54 right corner
    for k, f in enumerate((1 / 6, 2 / 6, 3 / 6, 4 / 6, 5 / 6)):
        i = _pick_col(cols, x0 + f * (x1 - x0))
        p[1 + k] = (cols[i], top[i])                   # 49-53 upper
    for k, f in enumerate((5 / 6, 4 / 6, 3 / 6, 2 / 6, 1 / 6)):
        i = _pick_col(cols, x0 + f * (x1 - x0))
        p[7 + k] = (cols[i], bottom[i])                # 55-59 lower (r->l)
    ist = _col_stats(inner) if inner.sum() >= 16 else None
    if ist is not None:
        icols, itop, ibottom, imean = ist
        ix0, ix1 = icols[0], icols[-1]
        p[12] = (ix0, imean[0])                        # 60
        p[16] = (ix1, imean[-1])                       # 64
        for k, f in ((13, 0.25), (14, 0.5), (15, 0.75)):
            i = _pick_col(icols, ix0 + f * (ix1 - ix0))
            p[k] = (icols[i], itop[i])
        for k, f in ((17, 0.75), (18, 0.5), (19, 0.25)):
            i = _pick_col(icols, ix0 + f * (ix1 - ix0))
            p[k] = (icols[i], ibottom[i])
    else:
        # closed mouth: inner points = outer ring shrunk toward its centroid
        centre = p[:12].mean(0)
        ring = np.array([0, 1, 3, 5, 6, 7, 9, 11])
        p[12:20] = centre + 0.45 * (p[ring] - centre)
    return p


def _ray_boundary(mask: np.ndarray, centre: np.ndarray, dirs: np.ndarray,
                  max_gap_frac: float = 0.08):
    """March rays from `centre` along unit `dirs` [K,2]; return the outermost
    mask boundary radius reachable without a gap longer than max_gap_frac*S.

    Returns (radii [K], hit [K] bool)."""
    size = mask.shape[0]
    n_steps = int(size * 0.75)
    rs = np.arange(1, n_steps, dtype=np.float64)
    pts = centre[None, None, :] + rs[None, :, None] * dirs[:, None, :]
    xi = np.clip(np.round(pts[..., 0]).astype(np.int64), 0, size - 1)
    yi = np.clip(np.round(pts[..., 1]).astype(np.int64), 0, size - 1)
    on = mask[yi, xi]                                   # [K, R]
    max_gap = max(2, int(size * max_gap_frac))
    radii = np.zeros(len(dirs))
    hit = np.zeros(len(dirs), bool)
    for k in range(len(dirs)):
        idx = np.nonzero(on[k])[0]
        if idx.size == 0:
            continue
        # walk outwards, stopping at the first gap wider than max_gap
        last = idx[0]
        if last > max_gap * 2:       # centre not inside the region
            continue
        for j in idx[1:]:
            if j - last > max_gap:
                break
            last = j
        radii[k] = rs[last]
        hit[k] = True
    return radii, hit


def _smooth_open(vals: np.ndarray) -> np.ndarray:
    """3-tap [1,2,1]/4 smoothing of an open polyline's radii."""
    if len(vals) < 3:
        return vals
    out = vals.copy()
    out[1:-1] = 0.25 * vals[:-2] + 0.5 * vals[1:-1] + 0.25 * vals[2:]
    return out


def contour_landmarks_81(label_map: np.ndarray) -> np.ndarray:
    """[S, S] CelebA label map -> [81, 2] landmarks in [0,1], driven by the
    parsing-region contours with the fitted template as prior/fallback.

    Groups: 0-16 jaw (face-silhouette rays), 17-26 brows, 27-35 nose,
    36-47 eyes, 48-67 mouth, 68-80 hairline (skin/hair boundary rays).

    Failure envelope (tests/test_landmarks.py adversarial cases): multi-face
    frames resolve to the largest face; glasses fall back to eye_g-derived
    anchors + template eyes; missing regions fall back per-group to the
    fitted template; an empty parse returns the bare template.  In-plane
    rotation up to ~30 deg is recovered by the similarity fit.  Profile
    (out-of-plane) faces and parses where *no* anchor region survives
    degrade to the template prior — same envelope where dlib's frontal HOG
    detector simply fails (ref: external_code/landmarks_util.py:17-19).
    """
    label = select_main_face(np.asarray(label_map))
    size = label.shape[0]
    prior = template_landmarks_81(label).astype(np.float64) * size
    out = prior.copy()

    def accept(idx, pts, tol=0.30):
        """Take measured points unless implausibly far from the prior."""
        pts = np.asarray(pts, np.float64)
        ok = np.linalg.norm(pts - prior[idx], axis=-1) < tol * size
        out[idx] = np.where(ok[:, None], pts, prior[idx])

    # --- per-region contour groups
    eye_l = _eye_points(label == _L_EYE)
    if eye_l is not None:
        accept(np.arange(36, 42), eye_l, tol=0.12)
    eye_r = _eye_points(label == _R_EYE)
    if eye_r is not None:
        accept(np.arange(42, 48), eye_r, tol=0.12)
    brow_l = _brow_points(label == _L_BROW)
    if brow_l is not None:
        accept(np.arange(17, 22), brow_l, tol=0.15)
    brow_r = _brow_points(label == _R_BROW)
    if brow_r is not None:
        accept(np.arange(22, 27), brow_r, tol=0.15)
    nose = _nose_points(label == _NOSE)
    if nose is not None:
        accept(np.arange(27, 36), nose, tol=0.15)
    mouth = _mouth_points(np.isin(label, [_MOUTH_IN, _U_LIP, _L_LIP]),
                          label == _MOUTH_IN)
    if mouth is not None:
        accept(np.arange(48, 68), mouth, tol=0.18)

    # --- silhouette groups (rays from a face centre along prior directions)
    face = np.isin(label, _FACE_IDS)
    if face.sum() > size * size * 0.01:
        nose_c = _region_centroid(label, _NOSE)
        centre = (nose_c * size if nose_c is not None
                  else prior[27:36].mean(0))
        for idx, region in ((np.arange(0, 17),
                             face | np.isin(label, [_L_EAR, _R_EAR])),
                            (np.arange(68, 81), face)):
            dirs = out[idx] - centre
            norms = np.linalg.norm(dirs, axis=-1, keepdims=True)
            dirs = dirs / np.maximum(norms, 1e-9)
            radii, hit = _ray_boundary(region, centre, dirs)
            radii = np.where(hit, radii, norms[:, 0])
            radii = _smooth_open(radii)
            pts = centre + radii[:, None] * dirs
            keep = hit & (np.abs(radii - norms[:, 0]) < 0.35 * size)
            out[idx] = np.where(keep[:, None], pts, out[idx])

    return np.clip(out / size, 0.0, 1.0).astype(np.float32)


def estimate_landmarks_81(label_map: np.ndarray,
                          method: str = 'auto',
                          image: np.ndarray | None = None,
                          device=None) -> np.ndarray:
    """[S, S] CelebA label map -> [81, 2] normalised landmarks in [0,1].

    method='auto' (default): the learned regressor when an RGB `image` is
        given and its trained weights ship in the checkout (loaded once from
        model_trained/landmark_net); otherwise the contour estimator.
    method='contour': parsing-contour estimator above.
    method='net': the learned regressor (load_landmark_net first; pass the
        RGB `image`); falls back to contour when no net is loaded or the
        presence head says no face, the analogue of dlib's detector
        returning no boxes (ref: external_code/landmarks_util.py:30-37).
    method='template': bare fitted template prior.
    `device`: where the regressor runs (None: the first CUDA device).
    """
    if method == 'auto':
        method = ('net' if image is not None
                  and _autoload_landmark_net(device) else 'contour')
    if method == 'net':
        if image is None:
            raise ValueError("method='net' needs the RGB image")
        res = net_landmarks_81(image, device=device)
        if res is not None:
            return res[0]
        method = 'contour'
    if method == 'contour':
        return contour_landmarks_81(label_map)
    if method == 'template':
        return template_landmarks_81(select_main_face(np.asarray(label_map)))
    raise ValueError(f'estimate_landmarks_81: unknown method {method!r}')


def estimate_landmarks_68(label_map: np.ndarray,
                          method: str = 'auto',
                          image: np.ndarray | None = None,
                          device=None) -> np.ndarray:
    return estimate_landmarks_81(label_map, method=method, image=image,
                                 device=device)[:68]


# --------------------------------------------------------------------------
# Learned regressor path (models/landmark_net.py): one net per process,
# as the reference loads its dlib predictor once per process
# (ref: external_code/landmarks_util.py:17-19).

_NET = None  # (LandmarkNet, LandmarkNetConfig) once loaded
_AUTOLOAD_TRIED = False


def _resolve(device) -> torch.device:
    from ctrlhair_tpu_torch.pipeline.editor import resolve_device
    return resolve_device(device)


def _autoload_landmark_net(device) -> bool:
    """One load of the shipped checkpoint for method='auto'; an absent
    checkpoint is remembered, an unreadable one raises (and is tried again
    on the next call)."""
    global _AUTOLOAD_TRIED
    if _NET is not None:
        return True
    if _AUTOLOAD_TRIED:
        return False
    found = load_landmark_net(device=device)
    _AUTOLOAD_TRIED = True
    return found


def default_landmark_ckpt_dir() -> str:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, 'model_trained', 'landmark_net',
                        'checkpoints')


def load_landmark_net(ckpt_dir: str | None = None, cfg=None,
                      device=None) -> bool:
    """Load the trained landmark regressor as the process's net, on
    `device` (None: the first CUDA device).

    Returns True when a checkpoint was found and loaded; False (no
    checkpoint directory or manifest) leaves the contour estimator as the
    only path.  A checkpoint that is present but does not decode or does not
    fit the net raises.
    """
    global _NET
    from ctrlhair_tpu_torch.convert import from_flax
    from ctrlhair_tpu_torch.models.landmark_net import (LandmarkNet,
                                                        LandmarkNetConfig)
    from ctrlhair_tpu_torch.utils.checkpoint import load_checkpoint
    device = _resolve(device)
    restored = load_checkpoint(ckpt_dir or default_landmark_ckpt_dir())
    if restored is None:
        return False
    cfg = cfg or LandmarkNetConfig()
    tree = restored[0]
    if not (isinstance(tree, dict) and set(tree) == {'params'}):
        raise ValueError('landmark net checkpoint: keys '
                         f'{sorted(tree) if isinstance(tree, dict) else tree}'
                         ", expected {'params'}")
    state = from_flax({'net': tree})
    with torch.device(device):
        model = LandmarkNet(cfg)
    model.load_state_dict({k[len('net.'):]: v for k, v in state.items()},
                          strict=True)
    model.eval().requires_grad_(False)
    _NET = (model, cfg)
    return True


def unload_landmark_net() -> None:
    global _NET, _AUTOLOAD_TRIED
    _NET = None
    _AUTOLOAD_TRIED = False


@torch.inference_mode()
def net_landmarks_81(image: np.ndarray, min_presence: float = 0.5,
                     device=None):
    """RGB uint8 image -> ([81,2] normalised landmarks, presence prob), or
    None when no net is loaded or the presence head rejects the frame.  The
    net runs on `device` (None: the first CUDA device); the image is resized
    on the host, as the JAX package does."""
    if _NET is None:
        return None
    from ctrlhair_tpu_torch.models.landmark_net import preprocess_image
    model, cfg = _NET
    model.to(_resolve(device))
    x = torch.from_numpy(preprocess_image(image, cfg.input_size))
    out = model(x.to(model.template.device))
    logit = out['presence'][0].cpu().numpy()
    presence = float(1 / (1 + np.exp(-logit)))
    if presence < min_presence:
        return None
    return np.clip(out['landmarks'][0].cpu().numpy(), 0.0, 1.0), presence
