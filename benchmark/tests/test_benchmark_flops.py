"""The FLOP counts of benchmark/flops/ against torch.utils.flop_counter
on the port's modules, built on the meta device at the configurations'
published widths (nothing is computed), and the K1 bound against the
figures PERF.md gives for it."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import peaks
from benchmark.flops import edit, sean, sean_train
from benchmark.tests.helpers import REPO

from ctrlhair_tpu_torch.config import PipelineConfig
from ctrlhair_tpu_torch.models.color_texture import make_generator
from ctrlhair_tpu_torch.models.sean import SEAN
from ctrlhair_tpu_torch.models.sean_discriminator import (
    MultiscaleDiscriminator, VGG19Features)
from ctrlhair_tpu_torch.models.shape import ShapeGenerator


def load(name):
    with open(os.path.join(REPO, 'benchmark', 'configs', name)) as f:
        return json.load(f)


def counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope='module')
def models():
    cfg = PipelineConfig()
    with torch.device('meta'):
        return {'sean': SEAN(cfg.sean, dtype=torch.bfloat16),
                'shape': ShapeGenerator(cfg.shape),
                'ct': make_generator(cfg.color_texture),
                'dis': MultiscaleDiscriminator(2, 64, 4, 22),
                'vgg': VGG19Features()}


@pytest.mark.parametrize('n', [1, 8])
def test_edit_counts(models, n):
    e = load('ctrlhair_edit.json')['pipeline']
    m = models
    with torch.device('meta'):
        label = torch.zeros(n, 256, 256, dtype=torch.int32)
        codes = torch.zeros(n, 19, 512)
        assert sean.decode(e['sean'], n) == counted(
            lambda: m['sean'].decode(label, codes))
        assert sean.encode(e['sean'], n) == counted(
            lambda: m['sean'].encode(torch.zeros(n, 256, 256, 3), label))
        assert edit.decode_mask(e, n) == counted(
            lambda: m['shape'].decode(torch.zeros(n, 16),
                                      torch.zeros(n, 1024)))
        data = {'noise': torch.zeros(n, 8),
                'noise_curliness': torch.zeros(n, 1),
                'rgb_mean': torch.zeros(n, 3), 'pca_std': torch.zeros(n, 1)}
        assert edit.feature(e['color_texture'], n) == counted(
            lambda: m['ct'](data))


def test_published_figures():
    """299.6 GFLOP a render at batch 1, 32.2 a mask decode, 342.3 SEAN's
    forward (encode and decode)."""
    e = load('ctrlhair_edit.json')['pipeline']
    assert round(edit.render(e, 1) / 1e9, 1) == 299.6
    assert round(edit.decode_mask(e, 1) / 1e9, 1) == 32.2
    assert round((sean.encode(e['sean'], 1) + sean.decode(e['sean'], 1))
                 / 1e9, 1) == 342.3


def test_training_counts(models):
    t = load('sean_train.json')
    with torch.device('meta'):
        x = torch.zeros(4, 22, 256, 256)
        assert sean_train.discriminator(t['trainer'], 22, 256, 4) == \
            counted(lambda: models['dis'](x))
        assert sean_train.vgg19(256, 4) == counted(
            lambda: models['vgg'](torch.zeros(4, 3, 256, 256)))
    g = sean.encode(t['sean'], 4) + sean.decode(t['sean'], 4)
    d = 2 * sean_train.discriminator(t['trainer'], 22, 256, 4)
    v = sean_train.vgg19(256, 4)
    assert sean_train.step(t, 4) == 3 * (g + d + v) + v


@pytest.mark.parametrize('n, ms', [(1, 0.009977), (8, 0.079817)])
def test_k1_bound(n, ms):
    ops, nbytes = edit.cg_work(n, 3, 256, 256, 200)
    bound = max(ops / peaks.FLOPS['float32'], nbytes / peaks.HBM_BYTES_PER_S)
    assert round(bound * 1e3, 6) == ms
