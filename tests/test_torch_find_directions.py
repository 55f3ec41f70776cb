# The port's curation entry point (python -m
# ctrlhair_tpu_torch.pipeline.find_directions) against the JAX package's
# scripts/find_directions.py, each main(argv) run in process on the same
# tiny weights (test_torch_direction_finder's editors, the hair decoder's
# bias lifted).  Each side's Backend is patched alike, to a Backend without
# blending on its tiny editor, built once for the module.  Each side crops
# samples/input.png once for the module (the JAX crop without cv2, so that
# both take the same branches), and the two crops are held to
# test_torch_crop's bar (>= 99.9% of pixels within one step); each side's
# crop_face is then patched alike to record its input and hand back the
# JAX crop, so that both curate from the same pixels (auto_curate's
# z-scores over three candidates magnify a one-step difference).
# Every route: --pool-dir (the regression on a PNG pool, then the chosen
# grids), --auto (auto_curate of the texture slots, then the chosen grids)
# and the candidate grids with --choose; and the argparse errors.  The same
# file names on both sides; directions within 1e-4, r2 and slopes within
# 1e-4, grids within 1 uint8 step on >= 99.9% of pixels (the bars of
# test_torch_direction_finder), printed lines equal up to those numbers.
import importlib.util
import json
import os
import pickle
import re

import numpy as np
import pytest

from ctrlhair_tpu.ops import crop as jax_crop
from ctrlhair_tpu.pipeline import backend as jax_backend
from ctrlhair_tpu_torch.constants import HAIR_IDX, PARSING_LABEL_LIST
from ctrlhair_tpu_torch.pipeline import find_directions as port_tool
from ctrlhair_tpu_torch.pipeline.backend import Backend, repo_path
from ctrlhair_tpu_torch.utils.image import read_png, read_rgb, write_png
from test_torch_backend import images_agree
from test_torch_crop import without_cv2
from test_torch_direction_finder import editors  # noqa: F401 (fixture)

INPUT = repo_path('samples/input.png')


@pytest.fixture(scope='module')
def jax_tool():
    """scripts/find_directions.py as a module."""
    spec = importlib.util.spec_from_file_location(
        'jax_find_directions', repo_path('scripts/find_directions.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def tools(editors, jax_tool):
    """{side: main} with each side's Backend constructor patched to one
    Backend without blending on its tiny editor, built once."""
    je, pe = editors
    built = {'jax': jax_backend.Backend(blending=False, cfg=je.cfg,
                                        editor=je),
             'port': Backend(blending=False, cfg=pe.cfg, editor=pe)}
    photo = read_rgb(INPUT)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_crop, 'recreate_aligned_image',
                   without_cv2(jax_crop.recreate_aligned_image))
        crops = {side: b.crop_face(photo) for side, b in built.items()}
    d = np.abs(crops['port'].astype(np.int32) - crops['jax'])
    assert crops['port'].shape == crops['jax'].shape == (64, 64, 3)
    assert (d <= 1).mean() >= 0.999, (d <= 1).mean()
    calls = []

    def make(side):
        def backend(blending=True, device=None):
            calls.append((side, blending, device))
            return built[side]
        return backend

    def crop_face(side):
        def crop(img_rgb, save_path=None):
            np.testing.assert_array_equal(img_rgb, photo)
            calls.append((side, 'crop_face'))
            return crops['jax'].copy()
        return crop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_backend, 'Backend', make('jax'))
        mp.setattr(port_tool, 'Backend', make('port'))
        for side, b in built.items():
            mp.setattr(b, 'crop_face', crop_face(side))
        yield {'jax': jax_tool.main,
               'port': lambda argv: port_tool.main(argv + ['--device',
                                                           'cpu'])}, calls


def run_both(tools, capsys, tmp_path, argv):
    """Each side's main on argv with its own --out-dir and --save-dir
    under tmp_path/<side>; -> {side: (printed lines, out dir, save dir)}."""
    mains, calls = tools
    out = {}
    for side in ('jax', 'port'):
        out_dir, save_dir = tmp_path / side / 'out', tmp_path / side / 'dirs'
        calls.clear()
        mains[side](argv + ['--out-dir', str(out_dir),
                            '--save-dir', str(save_dir)])
        assert calls == [(side, False, 'cpu' if side == 'port' else None),
                         (side, 'crop_face')]
        lines = capsys.readouterr().out.replace(str(tmp_path / side),
                                                '<tmp>').splitlines()
        out[side] = (lines, out_dir, save_dir)
    return out


NUMBER = re.compile(r'[-+]?\d+\.\d+')


def lines_agree(got, ref, atol):
    """Equal lines once their decimal numbers are taken out, the numbers
    within atol (plus the printed rounding)."""
    assert len(got) == len(ref), (got, ref)
    for g, r in zip(got, ref):
        assert NUMBER.sub('#', g) == NUMBER.sub('#', r), (g, r)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(r)):
            digits = len(a.split('.')[1])
            assert abs(float(a) - float(b)) <= atol + 10.0 ** -digits, (g, r)


def dirs_agree(got_dir, ref_dir, atol=1e-4):
    names = sorted(os.listdir(got_dir))
    assert names == sorted(os.listdir(ref_dir)) and names
    for name in names:
        with open(got_dir / name, 'rb') as f:
            got = pickle.load(f)
        with open(ref_dir / name, 'rb') as f:
            ref = pickle.load(f)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=atol, rtol=0)
    return names


def grids_agree(got_dir, ref_dir, names):
    assert sorted(os.listdir(got_dir)) == sorted(os.listdir(ref_dir))
    for name in names:
        images_agree(read_png(str(got_dir / name)),
                     read_png(str(ref_dir / name)), name)


def test_candidate_grids_and_choose(tools, capsys, tmp_path):
    """The operator's route: two shape candidates rendered, then candidate
    1 saved as slot 2; and the grids alone, nothing saved."""
    out = run_both(tools, capsys, tmp_path,
                   ['--att', 'shape', '--input', INPUT, '--n', '2',
                    '--seed', '3', '--choose', '1', '--index', '2'])
    (got, got_out, got_dirs), (ref, ref_out, ref_dirs) = \
        out['port'], out['jax']
    assert got == ref == ['2 candidate grids in <tmp>/out',
                          'saved candidate 1 as slot 2 in <tmp>/dirs']
    assert dirs_agree(got_dirs, ref_dirs, atol=0) == ['002.pkl']
    grids_agree(got_out, ref_out, ['candidate_000.png', 'candidate_001.png'])
    out = run_both(tools, capsys, tmp_path / 'grids',
                   ['--att', 'texture', '--input', INPUT, '--n', '1'])
    assert out['port'][0] == out['jax'][0] == [
        '1 candidate grids in <tmp>/out']
    assert not out['port'][2].exists() and not out['jax'][2].exists()
    grids_agree(out['port'][1], out['jax'][1], ['candidate_000.png'])


def test_auto_curate_route(tools, capsys, tmp_path):
    """--auto for the texture slots: the same picks, pickles and report,
    then a sweep grid a slot."""
    out = run_both(tools, capsys, tmp_path,
                   ['--att', 'texture', '--input', INPUT, '--auto',
                    '--n', '3', '--seed', '1'])
    (got, got_out, got_dirs), (ref, ref_out, ref_dirs) = \
        out['port'], out['jax']
    lines_agree(got, ref, 1e-4)
    assert got[-1] == '2 directions shipped to <tmp>/dirs'
    assert dirs_agree(got_dirs, ref_dirs) == ['000.pkl', '001.pkl']
    with open(got_out / 'texture_curation.json') as f:
        grep = json.load(f)
    with open(ref_out / 'texture_curation.json') as f:
        rrep = json.load(f)
    for g, r in zip(grep, rrep):
        assert (g['slot'], g['label'], g['candidate']) == \
            (r['slot'], r['label'], r['candidate'])
        assert abs(g['slope'] - r['slope']) < 1e-4
    grids_agree(got_out, ref_out, ['slot_0_texture.png',
                                   'slot_1_texture.png'])


def test_pool_dir_route(tools, capsys, tmp_path):
    """--pool-dir: the regression directions of a pool of grey PNG label
    maps, its report, and a sweep grid a slot."""
    skin = PARSING_LABEL_LIST.index('skin_other')
    rng = np.random.default_rng(0)
    pool = tmp_path / 'pool'
    pool.mkdir()
    s = 64
    for i in range(20):
        lab = np.zeros((s, s), np.uint8)
        lab[s // 3:, s // 4:3 * s // 4] = skin
        top = int(rng.integers(0, s // 4))
        depth = int(rng.integers(s // 3, s - 1))
        lab[top:depth, s // 8:7 * s // 8] = HAIR_IDX
        write_png(str(pool / f'm{i:02d}.png'), lab)
    with pytest.warns(UserWarning, match='R\\^2 may be inflated'):
        out = run_both(tools, capsys, tmp_path,
                       ['--att', 'shape', '--input', INPUT,
                        '--pool-dir', str(pool)])
    (got, got_out, got_dirs), (ref, ref_out, ref_dirs) = \
        out['port'], out['jax']
    lines_agree(got, ref, 1e-4)
    assert got[0].startswith('slot 0 (length): r2 ')
    assert got[-1] == '4 directions shipped to <tmp>/dirs'
    assert dirs_agree(got_dirs, ref_dirs) == [f'{i:03d}.pkl'
                                              for i in range(4)]
    with open(got_out / 'shape_dir_regression.json') as f:
        grep = json.load(f)
    with open(ref_out / 'shape_dir_regression.json') as f:
        rrep = json.load(f)
    for g, r in zip(grep, rrep):
        assert g['label'] == r['label'] and g['n_masks'] == 20
        assert abs(g['r2'] - r['r2']) < 1e-4
    grids_agree(got_out, ref_out, [f'slot_{i}_shape.png' for i in range(4)])


def test_trained_root_is_loaded_first(tools, capsys, tmp_path):
    """--trained-root names a root without checkpoints: nothing loads, and
    both sides say so before the curation."""
    root = tmp_path / 'root'
    root.mkdir()
    out = run_both(tools, capsys, tmp_path,
                   ['--att', 'texture', '--input', INPUT, '--n', '1',
                    '--trained-root', str(root)])
    assert out['port'][0] == out['jax'][0] == [
        f'loaded trained checkpoints from {root}',
        '1 candidate grids in <tmp>/out']


@pytest.mark.parametrize('argv,message', [
    (['--att', 'texture', '--input', INPUT, '--pool-dir', 'pool'],
     '--pool-dir applies to --att shape only'),
    (['--att', 'colour', '--input', INPUT], "invalid choice: 'colour'"),
    (['--input', INPUT], 'the following arguments are required: --att'),
    (['--att', 'shape'], 'the following arguments are required: --input'),
    (['--att', 'shape', '--input', INPUT, '--n', 'two'],
     "invalid int value: 'two'")])
def test_argument_errors_exit_2(tools, capsys, tmp_path, argv, message):
    """The same argparse errors, exit 2 on both sides, nothing written."""
    mains, calls = tools
    argv = argv + ['--out-dir', str(tmp_path / 'out')]
    for side in ('jax', 'port'):
        with pytest.raises(SystemExit) as e:
            mains[side](argv)
        assert e.value.code == 2
        assert message in capsys.readouterr().err
    assert not (tmp_path / 'out').exists()


def test_no_card_exits_2(monkeypatch, capsys, tmp_path):
    """Without a card and without --device cpu the tool exits 2 before it
    builds anything."""
    import torch
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    monkeypatch.setattr(port_tool, 'Backend', None)
    for extra in ([], ['--device', 'cuda:0']):
        with pytest.raises(SystemExit) as e:
            port_tool.main(['--att', 'shape', '--input', INPUT,
                            '--out-dir', str(tmp_path / 'out')] + extra)
        assert e.value.code == 2
        assert 'pass --device cpu' in capsys.readouterr().err
    assert not (tmp_path / 'out').exists()
