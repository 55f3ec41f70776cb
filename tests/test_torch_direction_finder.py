# The port's direction finder (pipeline/direction_finder.py) against the JAX
# twin on the same weights and inputs: candidate directions (bit-equal for a
# seed), the pickles, the label-map and image metrics (equal), the ridge
# regression (within 1e-6), the liveliness gate (equal failures), the
# data-driven shape directions on one PNG pool (within 1e-4), the sweep grids
# (within 1 uint8 step on >= 99.9% of pixels) and auto_curate (the same
# picks, directions within 1e-4).
#
# The tiny editor's random shape decoder draws no hair, which leaves every
# slope of auto_curate at 0 and its picks trivial.  The module therefore
# lifts the hair decoder's output bias by 0.75 on both sides (46% of the
# decoded mask becomes hair, mask and slopes depending on the latent) and
# paints a hair region into the current mask for the texture probes.  The
# seeds were chosen for the gaps between each slot's pick and its runner-up,
# in the z-units auto_curate scores in (texture seed 1 leads by >= 0.5,
# shape seed 0 by >= 0.05); the test recomputes every candidate's score
# from the metrics both sides measured and holds the gaps above ten times
# the largest difference between the two sides' scores.
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.constants import HAIR_IDX, PARSING_LABEL_LIST
from ctrlhair_tpu.pipeline import direction_finder as jd
from ctrlhair_tpu.pipeline.backend import Backend as JaxBackend
from ctrlhair_tpu_torch.convert import from_flax
from ctrlhair_tpu_torch.pipeline import direction_finder as td
from ctrlhair_tpu_torch.pipeline.backend import Backend
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.utils.image import read_png, write_png
from test_torch_backend import images_agree, sample_photos
from test_torch_convert import port_config

HAIR_BIAS = 0.75
TEXTURE_SEED, SHAPE_SEED = 1, 0


@pytest.fixture(scope='module')
def editors(tiny_editor):
    """(JAX editor, port editor) on the same weights, the hair decoder's
    bias lifted; the JAX editor's own parameters come back afterwards."""
    params = jax.tree_util.tree_map(np.array, jax.device_get(
        tiny_editor.params))
    params['shape']['params']['hair_decoder']['out']['conv']['conv'][
        'bias'] += HAIR_BIAS
    port = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    port.load_state_dict(from_flax(params))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tiny_editor, 'params',
                   jax.tree_util.tree_map(jnp.asarray, params))
        yield tiny_editor, port


@pytest.fixture(scope='module')
def backends(editors):
    """A JAX and a port Backend (no blending) on samples/input.png."""
    je, pe = editors
    img = sample_photos()[0]
    jb = JaxBackend(maximum_value_fe=2.5, blending=False, cfg=je.cfg,
                    editor=je)
    tb = Backend(maximum_value_fe=2.5, blending=False, cfg=pe.cfg, editor=pe)
    jb.set_input_img(img)
    tb.set_input_img(img)
    np.testing.assert_array_equal(tb.cur_mask, np.asarray(jb.cur_mask))
    assert 0.3 < (tb.cur_mask == HAIR_IDX).mean() < 0.6
    return jb, tb


# ------------------------------------------------------- host functions
def test_random_orthogonal_direction_bit_equal():
    for seed, dim, n_existing in ((0, 16, 0), (3, 16, 3), (9, 8, 1)):
        existing = list(np.linalg.qr(np.random.default_rng(seed + 50)
                                     .standard_normal((dim, dim)))[0][
            :n_existing].astype(np.float32))
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(4):
            got = td.random_orthogonal_direction(dim, existing, tr)
            ref = jd.random_orthogonal_direction(dim, existing, jr)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, ref)


def test_save_direction_writes_the_same_pickle(tmp_path):
    d = np.random.default_rng(1).standard_normal(16)
    td.save_direction(str(tmp_path / 'port'), 2, d)
    jd.save_direction(str(tmp_path / 'jax'), 2, d)
    assert os.listdir(tmp_path / 'port') == ['002.pkl']
    assert (tmp_path / 'port' / '002.pkl').read_bytes() == \
        (tmp_path / 'jax' / '002.pkl').read_bytes()
    with open(tmp_path / 'port' / '002.pkl', 'rb') as f:
        np.testing.assert_array_equal(pickle.load(f), d.astype(np.float32))
    assert td.SHAPE_SLOTS == jd.SHAPE_SLOTS
    assert td.TEXTURE_SLOTS == jd.TEXTURE_SLOTS


def _label_maps():
    """The JAX test's hand-made face, one without brows, one without skin,
    and three seeded random label maps."""
    skin = PARSING_LABEL_LIST.index('skin_other')
    mask = np.zeros((64, 64), np.int32)
    mask[20:40, 20:44] = skin
    mask[22:24, 24:40] = PARSING_LABEL_LIST.index('l_brow')
    hair = mask.copy()
    hair[10:20, 16:48] = HAIR_IDX
    hair[20:22, 20:32] = HAIR_IDX
    browless = np.where(hair == PARSING_LABEL_LIST.index('l_brow'), skin,
                        hair)
    rng = np.random.default_rng(4)
    rand = [rng.integers(0, 19, (48, 56)).astype(np.int32) for _ in range(3)]
    return [mask, hair, browless, np.zeros((32, 32), np.int32)] + rand


def test_face_band_and_metrics_equal():
    rng = np.random.default_rng(5)
    for lab in _label_maps():
        band = td._face_band(lab)
        assert band == jd._face_band(lab)
        assert td.shape_metrics(lab, band) == jd.shape_metrics(lab, band)
        img = rng.integers(0, 256, lab.shape + (3,), dtype=np.uint8)
        assert td.texture_metrics(img, lab) == jd.texture_metrics(img, lab)


def test_regression_directions_match_jax():
    rng = np.random.default_rng(3)
    z = rng.standard_normal((300, 16))
    stats = {m: z @ rng.standard_normal(16) + 0.1 * rng.standard_normal(300)
             for m in td.SHAPE_SLOTS}
    stats['bangs'] = rng.standard_normal(300)          # pure noise
    degenerate = {m: (z[:, 0] if i == 0 else np.zeros(300))
                  for i, m in enumerate(td.SHAPE_SLOTS)}
    for st in (stats, degenerate):
        got, grep = td.regression_directions(z, st)
        ref, rrep = jd.regression_directions(z, st)
        for g, r in zip(got, ref):
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, r, atol=1e-6, rtol=0)
        for g, r in zip(grep, rrep):
            assert g.keys() == r.keys() and g['label'] == r['label']
            for k in ('r2', 'coef_norm', 'kept_alignment'):
                assert abs(g[k] - r[k]) < 1e-6, (k, g[k], r[k])


def test_check_directions_alive_equal_failures():
    reps = [[{'label': 'length', 'r2': 1e-4}, {'label': 'volume', 'r2': 0.5}],
            [{'label': 'length', 'r2': 0.62}, {'label': 'volume', 'r2': 0.41}]]
    probes = [{'length': {'length': 0.0001}, 'volume': {'volume': 0.0}},
              {'length': {'length': 0.12}, 'volume': {'volume': -0.08}},
              {'bangs': {'length': 0.3}}]
    for rep in reps:
        for probe in probes:
            for kw in ({}, {'r2_min': 0.5, 'probe_min': 0.1}):
                assert td.check_directions_alive(rep, probe, **kw) == \
                    jd.check_directions_alive(rep, probe, **kw)
    assert len(td.check_directions_alive(reps[0], probes[0])) == 3


# ---------------------------------------------------- through the editors
def test_data_driven_shape_directions_match_jax(editors, tmp_path):
    """One pool of grey PNG label maps (some at twice the shape size, so the
    nearest resize runs) through both encoders; the guards raise alike."""
    je, pe = editors
    s = pe.cfg.shape.img_size
    skin = PARSING_LABEL_LIST.index('skin_other')
    rng = np.random.default_rng(0)
    pool = tmp_path / 'pool'
    pool.mkdir()
    n_masks = pe.cfg.shape.hair_dim + 4
    for i in range(n_masks):
        size = s * (2 if i % 3 == 0 else 1)
        lab = np.zeros((size, size), np.uint8)
        lab[size // 3:, size // 4:3 * size // 4] = skin
        top = int(rng.integers(0, size // 4))
        depth = int(rng.integers(size // 3, size - 1))
        lab[top:depth, size // 8:7 * size // 8] = HAIR_IDX
        write_png(str(pool / f'm{i:02d}.png'), lab)
    out = {}
    for name, run in (
            ('port', lambda **kw: td.data_driven_shape_directions(pe, **kw)),
            ('jax', lambda **kw: jd.data_driven_shape_directions(
                je, je.params, **kw))):
        with pytest.warns(UserWarning, match='R\\^2 may be inflated'):
            out[name] = run(pool_dir=str(pool), max_masks=n_masks,
                            save_dir=str(tmp_path / name),
                            report_path=str(tmp_path / f'{name}.json'))
    (got, grep), (ref, rrep) = out['port'], out['jax']
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=0)
    for g, r in zip(grep, rrep):
        assert g['label'] == r['label'] and g['n_masks'] == n_masks
        assert abs(g['r2'] - r['r2']) < 1e-4
    loaded = td.load_directions(str(tmp_path / 'port'))
    np.testing.assert_array_equal(np.stack(loaded), np.stack(got))
    with open(tmp_path / 'port.json') as f:
        assert [r['label'] for r in json.load(f)] == td.SHAPE_SLOTS
    empty = tmp_path / 'empty'
    empty.mkdir()
    with pytest.raises(ValueError, match='no .png masks'):
        td.data_driven_shape_directions(pe, str(empty))
    with pytest.raises(ValueError, match='underdetermined'):
        td.data_driven_shape_directions(pe, str(pool), max_masks=3)


def test_render_candidate_grids_match_jax(backends, tmp_path):
    jb, tb = backends
    before = np.asarray(tb.cur_latent.texture).copy()
    got = td.render_candidate_grids(tb, 'texture', str(tmp_path / 'port'),
                                    n_candidates=2, values=(-1.0, 1.0))
    ref = jd.render_candidate_grids(jb, 'texture', str(tmp_path / 'jax'),
                                    n_candidates=2, values=(-1.0, 1.0))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    for name in ('candidate_000.png', 'candidate_001.png'):
        images_agree(read_png(str(tmp_path / 'port' / name)),
                     read_png(str(tmp_path / 'jax' / name)), name)
    np.testing.assert_array_equal(np.asarray(tb.cur_latent.texture), before)
    # given directions, shape att: the mask is refreshed after the sweep
    d = [np.eye(16, dtype=np.float32)[3]]
    td.render_candidate_grids(tb, 'shape', str(tmp_path / 'port'),
                              values=(-2.0, 2.0), directions=d,
                              name_fmt='shape_{i}.png')
    jd.render_candidate_grids(jb, 'shape', str(tmp_path / 'jax'),
                              values=(-2.0, 2.0), directions=d,
                              name_fmt='shape_{i}.png')
    images_agree(read_png(str(tmp_path / 'port' / 'shape_0.png')),
                 read_png(str(tmp_path / 'jax' / 'shape_0.png')), 'shape')
    np.testing.assert_array_equal(tb.cur_mask, np.asarray(jb.cur_mask))


def candidate_scores(rows, n, values, slots):
    """Every candidate's score for every slot, as auto_curate computes them,
    from the metric rows of its first n * len(values) probes."""
    vc = np.asarray(values) - np.mean(values)
    slopes = [{m: float(np.dot(vc, [r[m] for r in rows[i:i + len(values)]])
                        / np.dot(vc, vc)) for m in rows[0]}
              for i in range(0, n * len(values), len(values))]
    z = {m: np.asarray([sl[m] for sl in slopes])
         / (np.std([abs(sl[m]) for sl in slopes]) + 1e-12) for m in rows[0]}
    return {m: np.abs(z[m]) - 0.5 * np.mean(
        [np.abs(z[o]) for o in z if o != m], axis=0) for m in slots}


@pytest.mark.parametrize('att,seed,n,min_gap', [
    ('texture', TEXTURE_SEED, 3, 0.5), ('shape', SHAPE_SEED, 5, 0.05)])
def test_auto_curate_matches_jax(backends, tmp_path, monkeypatch, att, seed,
                                 n, min_gap):
    jb, tb = backends
    if att == 'texture':
        paint = np.asarray(tb.cur_mask).copy()
        paint[8:40, 10:54] = HAIR_IDX
        jb.cur_mask, tb.cur_mask = paint.copy(), paint.copy()
    metric = f'{att}_metrics'
    rows = {}
    for name, mod in (('port', td), ('jax', jd)):
        measure = getattr(mod, metric)
        rows[name] = []

        def recording(*args, measure=measure, out=rows[name]):
            out.append(measure(*args))
            return out[-1]

        monkeypatch.setattr(mod, metric, recording)
    saved = np.asarray(getattr(tb.cur_latent, att)).copy()
    values = (-1.0, 0.0, 1.0)
    got, grep = td.auto_curate(tb, att, n_candidates=n, values=values,
                               seed=seed, save_dir=str(tmp_path / 'dirs'),
                               report_path=str(tmp_path / 'report.json'))
    ref, rrep = jd.auto_curate(jb, att, n_candidates=n, values=values,
                               seed=seed)
    assert [r['candidate'] for r in grep] == [r['candidate'] for r in rrep]
    assert [r['label'] for r in grep] == [r['label'] for r in rrep]
    # the picks are robust: each leads its runner-up by more than ten times
    # the largest difference between the two sides' scores
    slots = [r['label'] for r in grep]
    scores = {k: candidate_scores(rows[k], n, values, slots) for k in rows}
    diff = max(float(np.abs(scores['port'][m] - scores['jax'][m]).max())
               for m in slots)
    used = set()
    for r in grep:
        order = [i for i in np.argsort(-scores['port'][r['label']])
                 if i not in used]
        assert order[0] == r['candidate']
        gap = scores['port'][r['label']][order[0]] - \
            scores['port'][r['label']][order[1]] if len(order) > 1 else np.inf
        assert gap >= min_gap and gap > 10 * diff, (r['label'], gap, diff)
        used.add(order[0])
    for g, r in zip(grep, rrep):
        assert g['slope'] >= 0 and abs(g['slope'] - r['slope']) < 1e-4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=0)
    mat = np.stack(got)
    np.testing.assert_allclose(mat @ mat.T, np.eye(len(got)), atol=1e-4)
    assert len(td.load_directions(str(tmp_path / 'dirs'))) == len(got)
    assert os.path.exists(tmp_path / 'report.json')
    np.testing.assert_array_equal(np.asarray(getattr(tb.cur_latent, att)),
                                  saved)
    assert getattr(tb.cur_latent, att).grad_fn is None
    assert isinstance(getattr(tb.cur_latent, att), torch.Tensor)
