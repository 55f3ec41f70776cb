# The port's flax-msgpack reader (ctrlhair_tpu_torch/utils/flax_msgpack.py)
# and checkpoint directory rules (utils/checkpoint.py) against flax and the
# JAX package's utils/checkpoint.py: every shipped checkpoint and synthetic
# trees written by the JAX save_checkpoint decode to the same keys and
# bit-equal leaves (bfloat16 compared after its exact widening to float32).
# Also: the port imports nothing of JAX, flax, msgpack, cv2, PIL or the JAX
# package (an import scan of every module and of chip_smoke.py), and tkinter
# only inside ui/app.EditorApp.
import ast
import glob
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from ctrlhair_tpu.utils import checkpoint as jax_ckpt
from ctrlhair_tpu_torch.utils import checkpoint as port_ckpt
from ctrlhair_tpu_torch.utils import flax_msgpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ['bisenet', 'color_encoder', 'color_texture',
            'curliness_classifier', 'landmark_net']


def assert_same_tree(got, ref, path='tree'):
    """Same containers and keys; leaves of the same type, arrays of the same
    dtype (bfloat16 as its float32 widening) and shape, bit-equal."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), path
        for k in ref:
            assert_same_tree(got[k], ref[k], f'{path}/{k}')
    elif isinstance(ref, list):
        assert isinstance(got, list) and len(got) == len(ref), path
        for i, (g, r) in enumerate(zip(got, ref)):
            assert_same_tree(g, r, f'{path}[{i}]')
    elif isinstance(ref, (np.ndarray, np.generic)):
        ref = np.asarray(ref) if isinstance(ref, np.ndarray) else ref
        if ref.dtype == jnp.bfloat16:
            # flax hands a bfloat16 scalar back as a 0-d array
            ref = np.asarray(ref).astype(np.float32)
            ref = ref[()] if ref.ndim == 0 else ref
        assert isinstance(got, np.generic) == isinstance(ref, np.generic), \
            path
        ref = np.asarray(ref)
        got = np.asarray(got)
        assert got.dtype == ref.dtype and got.shape == ref.shape, path
        assert got.tobytes() == ref.tobytes(), path
    else:
        assert type(got) is type(ref) and (got == ref or got != got), path


@pytest.mark.parametrize('family', FAMILIES)
def test_shipped_checkpoints_decode_like_flax(family):
    ckpt_dir = os.path.join(REPO, 'model_trained', family, 'checkpoints')
    path = port_ckpt.latest_checkpoint_path(ckpt_dir)
    assert path == jax_ckpt.latest_checkpoint_path(ckpt_dir)
    with open(path, 'rb') as f:
        data = f.read()
    assert_same_tree(flax_msgpack.restore(data),
                     flax.serialization.msgpack_restore(data))
    tree, step = port_ckpt.load_checkpoint(ckpt_dir)
    assert step == int(os.path.basename(path)[:7])
    assert_same_tree(tree, flax.serialization.msgpack_restore(data))


def synthetic_tree(rng):
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    return {
        'params': {'dense': {'kernel': f32, 'bias': np.zeros(5, np.float32)},
                   'bf16': f32.astype(jnp.bfloat16),
                   'int8': rng.integers(-128, 127, (4,), dtype=np.int8),
                   'u64': np.arange(3, dtype=np.uint64),
                   'f64': rng.standard_normal((2, 2)),
                   'flag': np.array([True, False]),
                   'empty': np.zeros((0, 3), np.float32)},
        'step': np.int32(1234),
        'scalars': {'f': np.float32(1.5), 'bf': jnp.bfloat16(2.5),
                    'd': np.float64(-0.25), 'c': complex(1.0, -2.0)},
        'nested': [1, -70000, 2 ** 40, 0.5, 'text', None, True, b'\x00\xff',
                   [np.arange(4, dtype=np.int16), {'k': 'v'}]],
        'stats': {},
    }


def test_synthetic_checkpoint_written_by_jax(tmp_path):
    """bfloat16 leaves, numpy scalars, nested lists (written as dicts keyed
    '0', '1', ... by flax's state dict) through save_checkpoint."""
    tree = synthetic_tree(np.random.default_rng(0))
    jax_ckpt.save_checkpoint(str(tmp_path), tree, 7)
    got, step = port_ckpt.load_checkpoint(str(tmp_path))
    assert step == 7
    with open(tmp_path / '0000007.ckpt', 'rb') as f:
        ref = flax.serialization.msgpack_restore(f.read())
    assert_same_tree(got, ref)
    assert got['params']['bf16'].dtype == np.float32
    np.testing.assert_array_equal(
        got['params']['bf16'],
        np.asarray(tree['params']['bf16']).astype(np.float32))
    assert got['nested']['8']['0'].dtype == np.int16
    # numpy scalars that reach the packer as scalars (ext type 3)
    data = flax.serialization.msgpack_serialize(tree['scalars'])
    got = flax_msgpack.restore(data)
    assert_same_tree(got, flax.serialization.msgpack_restore(data))
    assert isinstance(got['f'], np.float32) and got['f'] == 1.5
    assert isinstance(got['bf'], np.float32) and got['bf'] == 2.5
    assert got['c'] == complex(1.0, -2.0)


def test_chunked_array(monkeypatch):
    """Arrays over flax's chunk limit are stored as chunk dicts and joined
    again, at every depth."""
    monkeypatch.setattr(flax.serialization, 'MAX_CHUNK_SIZE', 64)
    rng = np.random.default_rng(1)
    tree = {'big': rng.standard_normal((10, 7)).astype(np.float32),
            'deep': {'bf': rng.standard_normal(100).astype(jnp.bfloat16),
                     'small': np.arange(3, dtype=np.int32)}}
    data = flax.serialization.msgpack_serialize(tree)
    assert b'__msgpack_chunked_array__' in data
    got = flax_msgpack.restore(data)
    assert_same_tree(got, flax.serialization.msgpack_restore(data))
    np.testing.assert_array_equal(got['big'], tree['big'])


def test_manifest_rules(tmp_path):
    d = str(tmp_path)
    assert port_ckpt.load_checkpoint(d) is None
    assert port_ckpt.load_checkpoint(str(tmp_path / 'absent')) is None
    for step in (5, 12, 30):
        jax_ckpt.save_checkpoint(d, {'w': np.full(2, step, np.float32)},
                                 step, max_keep=2)
    assert port_ckpt.latest_checkpoint_path(d) == \
        jax_ckpt.latest_checkpoint_path(d) == os.path.join(d, '0000030.ckpt')
    tree, step = port_ckpt.load_checkpoint(d)
    assert step == 30 and tree['w'].tolist() == [30.0, 30.0]
    # the manifest's first line decides, whatever else is on disk
    with open(os.path.join(d, port_ckpt.MANIFEST), 'w') as f:
        f.write('0000012.ckpt\n0000030.ckpt\n')
    assert port_ckpt.load_checkpoint(d)[1] == 12
    # a manifest that names a deleted file means no checkpoint
    os.remove(os.path.join(d, '0000012.ckpt'))
    assert port_ckpt.latest_checkpoint_path(d) is None
    assert jax_ckpt.latest_checkpoint_path(d) is None


@pytest.mark.parametrize('cut', ['truncated', 'trailing', 'bad_byte',
                                 'bad_ext', 'bad_dtype', 'short_buffer'])
def test_malformed_input_raises(cut):
    good = flax.serialization.msgpack_serialize(
        {'a': np.arange(6, dtype=np.float32)})
    ext = good.index(b'\xc7')                       # the ndarray ext
    bad = {
        'truncated': good[:-3],
        'trailing': good + b'\x00',
        'bad_byte': b'\xc1',
        'bad_ext': good[:ext + 2] + b'\x09' + good[ext + 3:],
        'bad_dtype': good.replace(b'float32', b'floatXY'),
        'short_buffer': good.replace(b'\xc4\x18', b'\xc4\x14')[:-4],
    }[cut]
    with pytest.raises(ValueError):
        flax_msgpack.restore(bad)


leaves = st.one_of(
    st.integers(-2 ** 63, 2 ** 64 - 1), st.floats(allow_nan=False),
    st.booleans(), st.none(), st.text(max_size=8), st.binary(max_size=8),
    st.builds(lambda s, d: np.arange(s, dtype=d), st.integers(0, 40),
              st.sampled_from([np.float32, np.float64, np.int8, np.uint16,
                               np.int64, jnp.bfloat16])),
    st.builds(np.float32, st.floats(-1e6, 1e6, width=32)))
trees = st.recursive(
    leaves,
    lambda kids: st.one_of(st.lists(kids, max_size=4),
                           st.dictionaries(st.text(max_size=6), kids,
                                           max_size=4)),
    max_leaves=20)


@settings(max_examples=60, deadline=None)
@given(trees)
def test_random_trees_decode_like_msgpack_restore(tree):
    data = flax.serialization.msgpack_serialize(
        jax.tree_util.tree_map(lambda x: x, tree), in_place=True)
    assert_same_tree(flax_msgpack.restore(data),
                     flax.serialization.msgpack_restore(data))


FORBIDDEN = {'jax', 'flax', 'msgpack', 'cv2', 'PIL', 'ctrlhair_tpu'}
PORT_FILES = sorted(
    os.path.relpath(p, REPO) for p in
    glob.glob(os.path.join(REPO, 'ctrlhair_tpu_torch', '**', '*.py'),
              recursive=True)) + ['chip_smoke.py']


@pytest.mark.parametrize('rel', PORT_FILES)
def test_port_imports_nothing_of_jax(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), rel)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = sorted(n for n in names if n.split('.')[0] in FORBIDDEN)
    assert not bad, f'{rel} imports {bad}'


def _imports(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Import):
            yield sub, [a.name for a in sub.names]
        elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
            yield sub, [sub.module]


def test_port_imports_tkinter_only_in_the_app():
    """tkinter is imported only inside ui/app.EditorApp (when a window is
    built), so the web server, the headless demo and the tests never need
    a display or Tk."""
    allowed, found = set(), set()
    for rel in PORT_FILES:
        with open(os.path.join(REPO, rel)) as f:
            tree = ast.parse(f.read(), rel)
        for node, names in _imports(tree):
            if any(n.split('.')[0] == 'tkinter' for n in names):
                found.add((rel, node.lineno))
        if rel == os.path.join('ctrlhair_tpu_torch', 'ui', 'app.py'):
            cls = next(n for n in tree.body if isinstance(n, ast.ClassDef)
                       and n.name == 'EditorApp')
            allowed = {(rel, node.lineno) for node, _ in _imports(cls)}
    assert found and found <= allowed, sorted(found - allowed)
