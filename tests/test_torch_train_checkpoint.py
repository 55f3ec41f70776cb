# Training checkpoints cross between the packages: the port's writer
# (utils/flax_msgpack.pack, utils/checkpoint.save_checkpoint) and the
# state trees of training/train_state.py against the JAX package's
# save_checkpoint / load_checkpoint (flax.serialization).  Bar: bit
# equality of every leaf in both directions (the writer's bytes equal
# flax's msgpack_serialize of the same tree); the manifest and max_keep
# as in JAX; run_training resumes at step + 1 and a resumed run equals the
# unbroken one bit for bit.
import dataclasses
import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from ctrlhair_tpu.training.color_texture_trainer import (
    ColorTextureTrainer as JaxCTTrainer)
from ctrlhair_tpu.training.predictor_trainer import (
    PredictorTrainer as JaxPredictorTrainer)
from ctrlhair_tpu.utils import checkpoint as jckpt
from ctrlhair_tpu_torch.training.color_texture_trainer import (
    ColorTextureTrainer)
from ctrlhair_tpu_torch.training.loop import MetricsWriter, run_training
from ctrlhair_tpu_torch.training.predictor_trainer import PredictorTrainer
from ctrlhair_tpu_torch.utils import checkpoint as ckpt
from ctrlhair_tpu_torch.utils import flax_msgpack
from test_torch_trainers import (
    TINY_CT, assert_trees, port_cfg, predictor_batch, predictor_cfgs,
    to_torch)


def jax_tree(state):
    return flax.serialization.to_state_dict(jax.device_get(state))


def pairs():
    """(name, JAX state, port trainer, port state) of each trainer kind;
    the port state holds its own seeded weights, not JAX's."""
    jct, _ = JaxCTTrainer(TINY_CT).init_state(jax.random.PRNGKey(0))
    ct_state, _ = ColorTextureTrainer(port_cfg(TINY_CT),
                                      device='cpu').init_state(5)
    out = [('color_texture', jct, ct_state)]
    for which, cfg in predictor_cfgs().items():
        jp = JaxPredictorTrainer(cfg).init_state(jax.random.PRNGKey(1))
        pp = PredictorTrainer(port_cfg(cfg), device='cpu').init_state(6)
        out.append((which, jp, pp))
    return out


@pytest.mark.parametrize('lr_schedule', [False, True])
def test_port_writes_jax_restores(tmp_path, lr_schedule):
    for name, jstate, pstate in pairs():
        if lr_schedule and name == 'color_texture':
            # a {step: lr} schedule adds the schedule's count ('1')
            cfg = dataclasses.replace(TINY_CT, lr_g={0: 2e-4, 10: 1e-4},
                                      lr_d={0: 2e-4, 10: 1e-4})
            jstate, _ = JaxCTTrainer(cfg).init_state(jax.random.PRNGKey(0))
            pstate, _ = ColorTextureTrainer(port_cfg(cfg), device='cpu'
                                            ).init_state(5)
        elif lr_schedule:
            continue
        pstate.step = 7
        tree = pstate.to_tree()
        d = str(tmp_path / name / str(lr_schedule))
        ckpt.save_checkpoint(d, tree, 7)
        restored, step = jckpt.load_checkpoint(d, jstate)
        assert step == 7
        assert_trees(jax_tree(restored), tree, 0)


def test_jax_writes_port_restores(tmp_path):
    for name, jstate, pstate in pairs():
        jstate = jstate.replace(step=jstate.step + 3)
        d = str(tmp_path / name)
        jckpt.save_checkpoint(d, jstate, 3)
        tree, step = ckpt.load_checkpoint(d)
        assert step == 3
        pstate.load_tree(tree)
        assert pstate.step == 3
        assert_trees(pstate.to_tree(), jax_tree(jstate), 0)


def test_manifest_and_max_keep(tmp_path):
    tree = {'step': np.asarray(0, np.int32), 'w': np.arange(3.0)}
    for step in (1, 2, 3, 2, 5):
        ckpt.save_checkpoint(str(tmp_path / 'port'), tree, step, max_keep=2)
        jckpt.save_checkpoint(str(tmp_path / 'jax'), tree, step, max_keep=2)
    for side in ('port', 'jax'):
        assert sorted(os.listdir(tmp_path / side)) == \
            ['0000002.ckpt', '0000005.ckpt', 'latest_checkpoint']
    manifests = [open(tmp_path / side / 'latest_checkpoint').read()
                 for side in ('port', 'jax')]
    assert manifests[0] == manifests[1] == \
        '0000005.ckpt\n0000002.ckpt\n0000005.ckpt\n'
    assert ckpt._ckpt_name(42) == jckpt._ckpt_name(42) == '0000042.ckpt'
    back, step = ckpt.load_checkpoint(str(tmp_path / 'jax'))
    assert step == 5 and np.array_equal(back['w'], tree['w'])


def test_msgpack_writer_matches_flax():
    rng = np.random.default_rng(0)
    tree = {'a': {'k': rng.standard_normal((3, 4)).astype(np.float32),
                  'n': np.asarray(5, np.int32), 'e': {}},
            'b': [1, -1, -33, 200, 70000, -70000, 2 ** 40, -2 ** 40, 1.5,
                  'x' * 40, b'bytes', True, None, np.float32(2.0), 3 + 4j],
            'big': {str(i): i for i in range(20)},
            'u8': np.zeros((0,), np.uint8),
            's' * 300: np.arange(70000, dtype=np.int16)}
    data = flax_msgpack.pack(tree)
    assert data == flax.serialization.msgpack_serialize(tree)
    back = flax_msgpack.restore(data)
    np.testing.assert_array_equal(back['a']['k'], tree['a']['k'])
    assert back['b'][:10] == tree['b'][:10]
    with pytest.raises(ValueError):
        flax_msgpack.pack({'f': object()})


def test_msgpack_writer_chunks_as_flax(monkeypatch):
    """Arrays above the chunk limit are written in flax's chunked form
    (the limit lowered on both sides so the test stays small)."""
    monkeypatch.setattr(flax_msgpack, 'MAX_CHUNK_SIZE', 64)
    monkeypatch.setattr(flax.serialization, 'MAX_CHUNK_SIZE', 64)
    tree = {'w': np.arange(50, dtype=np.float32).reshape(5, 10)}
    data = flax_msgpack.pack(tree)
    assert data == flax.serialization.msgpack_serialize(tree)
    np.testing.assert_array_equal(flax_msgpack.restore(data)['w'],
                                  tree['w'])


def test_run_training_resumes_at_step_plus_one(tmp_path, capsys):
    """Three steps, stop, resume to six: the same state, bit for bit, as
    six steps in one go; the loop says where it resumed."""
    cfg = port_cfg(predictor_cfgs()['rgb'])
    batch_fn = lambda step: to_torch(predictor_batch('rgb', 50 + step))

    def run(total, d):
        tr = PredictorTrainer(cfg, device='cpu', seed=4)
        return run_training(tr.init_state(0), tr.train_step, batch_fn,
                            total, ckpt_dir=d, log_step=1,
                            model_save_step=100, verbose=True)[0]

    unbroken = run(6, str(tmp_path / 'a'))
    run(3, str(tmp_path / 'b'))
    assert ckpt.load_checkpoint(str(tmp_path / 'b'))[1] == 2
    resumed = run(6, str(tmp_path / 'b'))
    assert 'resumed from step 2' in capsys.readouterr().out
    assert resumed.step == unbroken.step == 6
    assert_trees(resumed.to_tree(), unbroken.to_tree(), 0)
    # the cadence: a save every model_save_step, and one at the end
    d = str(tmp_path / 'c')
    tr = PredictorTrainer(cfg, device='cpu')
    run_training(tr.init_state(0), tr.train_step, batch_fn, 7, ckpt_dir=d,
                 model_save_step=2, max_keep=10, verbose=False)
    assert sorted(f for f in os.listdir(d) if f.endswith('.ckpt')) == \
        ['0000002.ckpt', '0000004.ckpt', '0000006.ckpt']


def test_metrics_writer_without_tensorboardx(tmp_path):
    w = MetricsWriter(str(tmp_path / 'logs'))
    w.scalars('t', {'a': torch.tensor(1.0), 'b': 2.0}, 0)
    w.close()


def test_run_scripts_on_cpu_and_their_refusals(tmp_path, monkeypatch,
                                              capsys):
    """python -m ctrlhair_tpu_torch.training.run_* on synthetic batches:
    three steps on the CPU write a checkpoint the JAX package restores into
    its own trainer's state; --sean-checkpoint loads a reference SEAN;
    without a card and without --device cpu they exit 2; --dp 2 is
    refused."""
    from ctrlhair_tpu.config import (
        ColorTextureConfig as JaxCT, curliness_predictor_config,
        rgb_predictor_config)
    from ctrlhair_tpu_torch.training import run_color_texture, run_predictor
    d = str(tmp_path / 'ct')
    state = run_color_texture.main(['--synthetic', '--steps', '3',
                                    '--device', 'cpu', '--batch-size', '8',
                                    '--out-dir', d])
    assert state.step == 3
    target, _ = JaxCTTrainer(JaxCT()).init_state(jax.random.PRNGKey(0))
    restored, step = jckpt.load_checkpoint(os.path.join(d, 'checkpoints'),
                                           target)
    assert step == 2
    assert_trees(jax_tree(restored), state.to_tree(), 0)
    for which, cfg in (('rgb', rgb_predictor_config()),
                       ('curliness', curliness_predictor_config())):
        d = str(tmp_path / which)
        state = run_predictor.main(['--which', which, '--synthetic',
                                    '--steps', '3', '--device', 'cpu',
                                    '--out-dir', d])
        target = JaxPredictorTrainer(cfg).init_state(jax.random.PRNGKey(0))
        restored, step = jckpt.load_checkpoint(
            os.path.join(d, 'checkpoints'), target)
        assert step == 2 and int(restored.step) == 3
        assert_trees(jax_tree(restored), state.to_tree(), 0)
    # --sean-checkpoint: a reference SEAN netG state dict ('module.'
    # prefixed, as DDP saves it) loads through the port's converter (a tiny
    # SEANConfig stands in for the published one)
    from ctrlhair_tpu.config import SEANConfig as JaxSEANConfig
    from ctrlhair_tpu_torch import config as cfg_mod
    from test_convert_sean import _fake_sean_sd
    tiny = dict(crop_size=32, ngf=2, zencoder_ngf=2, style_dim=64)
    sd = _fake_sean_sd(np.random.default_rng(0), JaxSEANConfig(**tiny))
    pth = str(tmp_path / 'netG.pth')
    torch.save({'module.' + k: torch.tensor(v) for k, v in sd.items()}, pth)
    real = cfg_mod.SEANConfig
    monkeypatch.setattr(cfg_mod, 'SEANConfig', lambda: real(**tiny))
    run_color_texture.main(['--synthetic', '--steps', '1', '--device', 'cpu',
                            '--batch-size', '4', '--sean-checkpoint', pth,
                            '--out-dir', str(tmp_path / 'sean')])
    assert 'frozen SEAN loaded' in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    for main in (run_color_texture.main, run_predictor.main):
        with pytest.raises(SystemExit) as e:
            main(['--synthetic', '--steps', '1', '--out-dir',
                  str(tmp_path / 'none')])
        assert e.value.code == 2
    with pytest.raises(SystemExit, match='later slice'):
        run_color_texture.main(['--dp', '2', '--synthetic'])
