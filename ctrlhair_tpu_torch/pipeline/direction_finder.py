# Semantic-direction discovery for the shape/texture sliders.
#
# Port of ctrlhair_tpu/pipeline/direction_finder.py.  Parity target:
# util/find_semantic_direction.py:12-21 + the two script_find_direction.py
# drivers — random candidate directions made orthogonal to the
# already-chosen set (Gram-Schmidt), sign-canonicalised, rendered as sweep
# grids for manual curation, or picked by measured metric slopes
# (auto_curate) or by regression over encoded data (regression_directions);
# the chosen pickles define the slider semantics (length/volume/bangs...,
# ref: ui/backend.py:211-226).  The pickles are sorted '<idx>.pkl' files,
# each one plain numpy vector (the loading contract of the reference,
# hair_editor.py:84-91, 111-119).  Every render of a sweep goes through
# Backend.output, so with blending on it launches the masked-CG kernel on a
# card.

from __future__ import annotations

import json
import os
import pickle
import warnings
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ctrlhair_tpu_torch.constants import HAIR_IDX, PARSING_LABEL_LIST
from ctrlhair_tpu_torch.ops.resize import resize_nearest
from ctrlhair_tpu_torch.utils.image import Canvas, read_png


def random_orthogonal_direction(dim: int, existing: Sequence[np.ndarray],
                                rng: np.random.Generator) -> np.ndarray:
    """One unit direction orthogonal to `existing`, sign-canonicalised
    (largest-|coord| component positive)."""
    v = rng.standard_normal(dim)
    for e in existing:
        v = v - np.dot(v, e) * e
    v = v / np.linalg.norm(v)
    if v[np.argmax(np.abs(v))] < 0:
        v = -v
    return v.astype(np.float32)


def save_direction(dir_path: str, index: int, direction: np.ndarray) -> None:
    """Persist as sorted '<idx>.pkl' files, the loading contract of
    hair_editor (ref: hair_editor.py:84-91, 111-119).

    Atomic per file (tmp + os.replace): a crash landing mid-curation must
    never leave a deleted-but-not-rewritten pickle behind."""
    os.makedirs(dir_path, exist_ok=True)
    path = os.path.join(dir_path, f'{index:03d}.pkl')
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        pickle.dump(np.asarray(direction, np.float32), f)
    os.replace(tmp, path)


def load_directions(dir_path: str) -> Optional[List[np.ndarray]]:
    """The directions under `dir_path`, in file-name order; None when the
    directory does not exist or holds no pickle.  The pickles are the ones
    that ship with this checkout's trained weights or that save_direction
    wrote."""
    if not os.path.isdir(dir_path):
        # relative contract paths (model_trained/..., ref hair_editor.py:82)
        # also resolve against the repo root, so shipped pickles load no
        # matter the caller's CWD
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        rooted = os.path.join(repo, dir_path)
        if os.path.isabs(dir_path) or not os.path.isdir(rooted):
            return None
        dir_path = rooted
    out = []
    for name in sorted(os.listdir(dir_path)):
        if not name.endswith('.pkl'):
            continue
        with open(os.path.join(dir_path, name), 'rb') as f:
            vec = pickle.load(f)
        out.append(np.asarray(vec, np.float32))
    return out or None


# ---------------------------------------------------------------------------
# Automatic curation.
#
# The reference leaves slider semantics to an operator eyeballing sweep grids
# (color_texture_branch/script_find_direction.py:27-74 and the shape variant).
# auto_curate replaces the eyeball with measurable hair statistics so shipped
# sliders provably move what their label says: every candidate direction is
# swept through the trained generator and scored by the least-squares SLOPE
# of a per-label metric over the sweep; slider slots are assigned greedily by
# selectivity (strong on their own metric, weak on the others) and the
# direction's sign is flipped so +slider increases the labelled quantity.
# Slot order matches ui/app.SLIDER_SPECS.

SHAPE_SLOTS = ['length', 'volume', 'bangs_direction', 'bangs']
TEXTURE_SLOTS = ['smoothness', 'thickness']


def _face_band(input_mask: np.ndarray):
    """Forehead band (rows, cols) from the input parse: top of face skin
    down to the top of the brows (or 20% of face height when no brow pixels
    exist), restricted to the face's x-range."""
    skin = input_mask == PARSING_LABEL_LIST.index('skin_other')
    brows = np.isin(input_mask, (PARSING_LABEL_LIST.index('l_brow'),
                                 PARSING_LABEL_LIST.index('r_brow')))
    ys, xs = np.nonzero(skin)
    if ys.size == 0:
        h, w = input_mask.shape
        return (h // 4, h // 2), (w // 4, 3 * w // 4)
    top = int(ys.min())
    bys = np.nonzero(brows)[0]
    bot = (int(bys.min()) if bys.size
           else top + max(2, int(0.2 * (int(ys.max()) - top))))
    if bot <= top:
        bot = top + 2
    c0 = int(np.percentile(xs, 2))
    c1 = int(np.percentile(xs, 98)) + 1
    return (top, bot), (c0, c1)


def shape_metrics(mask: np.ndarray, band) -> dict:
    """Label-map statistics behind the four shape sliders: hair length
    (lowest hair row, robust), volume (hair area), bangs (hair coverage of
    the forehead band), bangs_direction (signed left/right asymmetry of
    that coverage)."""
    (r0, r1), (c0, c1) = band
    hair = mask == HAIR_IDX
    ys = np.nonzero(hair)[0]
    length = float(np.percentile(ys, 97) / mask.shape[0]) if ys.size else 0.0
    volume = float(hair.mean())
    fore = hair[r0:r1, c0:c1]
    bangs = float(fore.mean()) if fore.size else 0.0
    mid = fore.shape[1] // 2
    denom = float(fore.sum())
    bangs_direction = (float(fore[:, :mid].sum() - fore[:, mid:].sum())
                       / denom if denom else 0.0)
    return {'length': length, 'volume': volume, 'bangs': bangs,
            'bangs_direction': bangs_direction}


def texture_metrics(img: np.ndarray, mask: np.ndarray) -> dict:
    """Rendered-image statistics behind the two texture sliders.
    smoothness = negated high-frequency (Laplacian) energy in the hair
    region; thickness = hair-region grey-level contrast (std) — documented
    proxies for what the reference's operator judges visually."""
    hair = mask == HAIR_IDX
    if int(hair.sum()) < 16:
        return {'smoothness': 0.0, 'thickness': 0.0}
    g = np.asarray(img, np.float32).mean(-1)
    lap = np.abs(4 * g[1:-1, 1:-1] - g[:-2, 1:-1] - g[2:, 1:-1]
                 - g[1:-1, :-2] - g[1:-1, 2:])
    hl = hair[1:-1, 1:-1]
    highfreq = float(lap[hl].mean()) if hl.any() else 0.0
    return {'smoothness': -highfreq, 'thickness': float(g[hair].std())}


def auto_curate(backend, att_name: str, n_candidates: int = 24,
                values: Sequence[float] = (-2.0, -1.0, 0.0, 1.0, 2.0),
                seed: int = 0, save_dir: Optional[str] = None,
                report_path: Optional[str] = None):
    """Pick one direction per slider slot by measured metric slope.

    Requires backend.set_input_img to have been called.  Returns
    (directions, report): directions[i] belongs to slot i of
    SHAPE_SLOTS / TEXTURE_SLOTS; report records per-slot slopes and
    scores.  With save_dir set, ships the sorted '<idx>.pkl' contract the
    Backend auto-loads (ref: hair_editor.py:84-119)."""
    slots = SHAPE_SLOTS if att_name == 'shape' else TEXTURE_SLOTS
    dim = int(getattr(backend.cur_latent, att_name).shape[-1])
    rng = np.random.default_rng(seed)
    cands = [random_orthogonal_direction(dim, [], rng)
             for _ in range(n_candidates)]
    band = _face_band(np.asarray(backend.input_mask))

    vals = np.asarray(values, np.float64)
    vc = vals - vals.mean()
    saved = getattr(backend.cur_latent, att_name)

    def measure_slopes(d: np.ndarray) -> Dict[str, float]:
        rows = []
        for v in values:
            backend.continue_change_with_direction(att_name, d, float(v))
            if att_name == 'shape':
                rows.append(shape_metrics(np.asarray(backend.cur_mask),
                                          band))
            else:
                img = backend.output()
                rows.append(texture_metrics(
                    np.asarray(img), np.asarray(backend.cur_mask)))
        backend.cur_latent = backend.cur_latent.replace(**{att_name: saved})
        if att_name == 'shape':
            backend.refresh_cur_mask()
        return {
            m: float(np.dot(vc, [r[m] for r in rows]) / np.dot(vc, vc))
            for m in rows[0]}

    slopes = [measure_slopes(d) for d in cands]

    # z-normalise |slope| per metric across candidates so selectivity is
    # comparable between metrics with different units
    z = {m: np.asarray([s[m] for s in slopes])
         / (np.std([abs(s[m]) for s in slopes]) + 1e-12)
         for m in slopes[0]}

    chosen, report, used = [], [], set()
    for slot_idx, m in enumerate(slots):
        others = [o for o in slopes[0] if o != m]
        penalty = (np.mean([np.abs(z[o]) for o in others], axis=0)
                   if others else np.zeros(n_candidates))
        score = np.abs(z[m]) - 0.5 * penalty
        pick = next(i for i in np.argsort(-score) if i not in used)
        used.add(pick)
        flip = -1.0 if z[m][pick] < 0 else 1.0
        chosen.append(flip * cands[pick])
        report.append({'slot': slot_idx, 'label': m, 'candidate': int(pick),
                       'slope': flip * slopes[pick][m],
                       'score': float(score[pick]),
                       'all_slopes': slopes[pick]})

    # orthogonalise the chosen set in slot order (keeps sliders independent,
    # the property the reference's Gram-Schmidt curation flow guarantees)
    ortho: List[np.ndarray] = []
    for d in chosen:
        v = d.astype(np.float64).copy()
        for e in ortho:
            v = v - np.dot(v, e) * e
        n = np.linalg.norm(v)
        ortho.append(v / n if n > 1e-6 else d.astype(np.float64))
    chosen = [o.astype(np.float32) for o in ortho]

    # the orthogonalised vector is no longer the one that was scored:
    # re-measure each SHIPPED direction, re-sign it so +slider still
    # increases its labelled metric, and report the as-shipped slope
    for slot_idx, m in enumerate(slots):
        shipped = measure_slopes(chosen[slot_idx])
        if shipped[m] < 0:
            chosen[slot_idx] = -chosen[slot_idx]
            shipped = {k: -v for k, v in shipped.items()}
        report[slot_idx]['slope'] = shipped[m]
        report[slot_idx]['all_slopes'] = shipped

    if save_dir:
        for i, d in enumerate(chosen):
            save_direction(save_dir, i, d)
    if report_path:
        with open(report_path, 'w') as f:
            json.dump(report, f, indent=1)
    return chosen, report


def regression_directions(z: np.ndarray, stats: Dict[str, np.ndarray],
                          slots: Sequence[str] = SHAPE_SLOTS,
                          ridge: float = 1e-2):
    """Latent directions from DATA, not random probing.

    The reference finds its shipped directions from labelled latent codes
    of real samples (util/find_semantic_direction.py consumes latents of
    curated examples); the measurable analogue: ridge-regress each mask
    statistic onto the encoded latents `z` [N,D] and take the regression
    coefficient vector — the direction in raw latent space along which the
    statistic increases fastest across the real data manifold.  Random
    orthogonal probes around one encoded latent can all score ~0 when the
    decoder's response is anisotropic (soak r4: every probe slope < 1e-3);
    the regression direction concentrates exactly the variance the probes
    miss.

    Returns (directions, report): directions[i] serves slots[i], unit-norm,
    mutually orthogonal (Gram-Schmidt in slot order), re-signed after
    orthogonalisation so +direction still increases its statistic; report
    carries per-slot R^2 on the regression fit — a LOW R^2 is the honest
    signal that the latent does not yet encode that statistic (e.g. an
    under-trained or posterior-collapsed encoder).
    """
    z = np.asarray(z, np.float64)
    n, d = z.shape
    z0 = z - z.mean(0)
    cov = z0.T @ z0 + ridge * n * np.eye(d)
    raw, report = {}, []
    for m in slots:
        y = np.asarray(stats[m], np.float64)
        y0 = y - y.mean()
        w = np.linalg.solve(cov, z0.T @ y0)
        pred = z0 @ w
        ss_res = float(((y0 - pred) ** 2).sum())
        ss_tot = float((y0 ** 2).sum()) + 1e-12
        raw[m] = w
        report.append({'label': m, 'r2': 1.0 - ss_res / ss_tot,
                       'coef_norm': float(np.linalg.norm(w))})
    def _residual_basis(i: int, existing: List[np.ndarray]) -> np.ndarray:
        """Degenerate-coefficient fallback: the first standard basis vector
        (starting at slot i) with a non-trivial residual after projecting
        out `existing` — the raw eye-vector could be collinear with an
        already-kept direction and would break the unit-norm/mutually-
        orthogonal contract the latent-edit projections rely on."""
        for j in range(d):
            v = np.eye(d)[(i + j) % d]
            for e in existing:
                v = v - np.dot(v, e) * e
            nrm = np.linalg.norm(v)
            if nrm > 1e-6:
                return v / nrm
        raise ValueError('no basis vector independent of the kept set '
                         f'(d={d}, kept={len(existing)})')

    ortho: List[np.ndarray] = []
    for i, m in enumerate(slots):
        v = raw[m].copy()
        nrm = np.linalg.norm(v)
        v = v / nrm if nrm > 1e-12 else _residual_basis(i, ortho)
        for e in ortho:
            v = v - np.dot(v, e) * e
        nrm = np.linalg.norm(v)
        v = v / nrm if nrm > 1e-6 else _residual_basis(i, ortho)
        if np.dot(v, raw[m]) < 0:   # keep +direction = +statistic
            v = -v
        ortho.append(v)
        report[i]['kept_alignment'] = float(abs(np.dot(
            ortho[i], raw[m] / (np.linalg.norm(raw[m]) + 1e-12))))
    return [o.astype(np.float32) for o in ortho], report


def check_directions_alive(reg_report, probe_deltas: Dict[str, Dict[str, float]],
                           r2_min: float = 0.3,
                           probe_min: float = 0.05) -> List[str]:
    """Liveliness gate for shipped shape directions.

    A direction may only ship when the latent provably encodes its
    statistic (regression R^2 >= r2_min) AND a decoded-mask probe over a
    +-2 sweep moves the labelled statistic visibly (|delta| >= probe_min;
    every statistic is a [0,1] fraction of the mask).  Returns the list of
    failure strings — empty means alive.  The r4 soak shipped directions
    with R^2 ~ 1e-4 and probe deltas <= 1e-4 (five identical evidence-grid
    cells); this gate makes that state a loud error instead of a
    deliverable."""
    failures = []
    for r in reg_report:
        if r['r2'] < r2_min:
            failures.append(
                f"slot {r['label']}: regression R^2 {r['r2']:.4f} < "
                f"{r2_min} — the latent does not encode this statistic "
                "(under-trained or collapsed encoder)")
    for label, deltas in probe_deltas.items():
        own = abs(float(deltas.get(label, 0.0)))
        if own < probe_min:
            failures.append(
                f"slot {label}: decoded-mask probe delta {own:.4f} < "
                f"{probe_min} over a +-2 sweep — the slider visibly "
                "does nothing")
    return failures


def data_driven_shape_directions(editor, pool_dir: str,
                                 max_masks: int = 200,
                                 save_dir: Optional[str] = None,
                                 report_path: Optional[str] = None):
    """Encode up to `max_masks` warp-pool label maps (8-bit grey PNGs) and
    fit regression_directions on their shape latents vs shape_metrics.

    The pool is the soak's real-warp target set (ShapeDataset's training
    distribution), so the directions live on the data manifold the VAE was
    trained on.  `editor` is a HairEditor, whose shape VAE encodes the
    masks (the JAX twin's `params` live in the module here)."""
    s = editor.cfg.shape.img_size
    names = sorted(f for f in os.listdir(pool_dir) if f.endswith('.png'))
    names = names[:max_masks]
    dim = int(editor.cfg.shape.hair_dim)
    if not names:
        raise ValueError(f'no .png masks in pool_dir={pool_dir!r} — '
                         'generate the warp pool first '
                         '(data.shape_dataset.generate_warp_pool)')
    if len(names) <= dim:
        raise ValueError(
            f'{len(names)} pool masks for a {dim}-d latent: the ridge fit '
            'would be underdetermined and its R^2 meaningless; need at '
            f'least {dim + 1} (ideally >= {4 * dim})')
    if len(names) < 4 * dim:
        warnings.warn(f'only {len(names)} pool masks for a {dim}-d latent '
                      f'ridge fit; R^2 may be inflated (want >= {4 * dim})',
                      stacklevel=2)
    zs, rows = [], []
    for name in names:
        lab = read_png(os.path.join(pool_dir, name)).astype(np.int32)
        if lab.shape[0] != s:
            lab = resize_nearest(torch.from_numpy(lab), (s, s)).numpy()
        band = _face_band(lab)
        rows.append(shape_metrics(lab, band))
        code, _face = editor.encode_shape(lab[None])
        zs.append(code[0].cpu().numpy())
    z = np.stack(zs)
    stats = {m: np.asarray([r[m] for r in rows]) for m in rows[0]}
    dirs, report = regression_directions(z, stats)
    for r in report:
        r['n_masks'] = len(names)
    if save_dir:
        for i, d in enumerate(dirs):
            save_direction(save_dir, i, d)
    if report_path:
        with open(report_path, 'w') as f:
            json.dump(report, f, indent=1)
    return dirs, report


def render_candidate_grids(backend, att_name: str, out_dir: str,
                           n_candidates: int = 20,
                           values: Sequence[float] = (-2, -1, 0, 1, 2),
                           seed: int = 0,
                           directions: Optional[Sequence[np.ndarray]] = None,
                           name_fmt: str = 'candidate_{i:03d}.png'
                           ) -> List[np.ndarray]:
    """Render a sweep grid per direction for manual selection
    (ref: color_texture_branch/script_find_direction.py:27-74).

    Requires backend.set_input_img to have been called.  With `directions`
    given, renders exactly those (evidence grids for shipped pickles);
    otherwise draws n_candidates fresh orthogonal candidates.  Returns the
    directions; grids land in out_dir/<name_fmt>.
    """
    os.makedirs(out_dir, exist_ok=True)
    if directions is None:
        rng = np.random.default_rng(seed)
        dim = int(getattr(backend.cur_latent, att_name).shape[-1])
        existing = list(backend.texture_dirs if att_name == 'texture'
                        else backend.shape_dirs)
        directions = [random_orthogonal_direction(dim, existing, rng)
                      for _ in range(n_candidates)]
    directions = list(directions)
    for i, d in enumerate(directions):
        cell = backend.cfg.edit_size
        canvas = Canvas(1, len(values), cell=cell)
        saved = getattr(backend.cur_latent, att_name)
        for c, val in enumerate(values):
            backend.continue_change_with_direction(att_name, d, val)
            img = backend.output()
            canvas.paste(0, c, img)
        backend.cur_latent = backend.cur_latent.replace(
            **{att_name: saved})
        if att_name == 'shape':
            backend.refresh_cur_mask()
        canvas.save(os.path.join(out_dir, name_fmt.format(i=i)))
    return directions
