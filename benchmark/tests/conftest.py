"""The CPU tests' checkouts (helpers.checkout) also carry the shape
training configuration cut to a size the CPU runs in seconds, and its
traffic with a short settling, so that a test over every cell runs
shape.train there too."""

import json
import os

from benchmark.tests import helpers

# the shape VAE-GAN at 32 px, 3 layers, 32 channels, a 64-d face code,
# and a settling of a second before the window (the card's is 20 s)
SHAPE_TINY = dict(img_size=32, layer_num=3, max_channel=32, face_dim=64)
SETTLE_S = 1.0


def shape_train_config() -> dict:
    with open(os.path.join(helpers.REPO, 'benchmark', 'configs',
                           'shape_train.json')) as f:
        cfg = json.load(f)
    cfg['shape'].update(SHAPE_TINY)
    cfg['chunk_size'] = 2
    cfg['reduced'] = ['widths cut for the CPU tests']
    return cfg


def _with_shape_train(checkout):
    def wrapped(tmp, *args, **kwargs):
        root = checkout(tmp, *args, **kwargs)
        rel = 'benchmark/configs/test_shape_train.json'
        helpers.write_json(os.path.join(root, rel), shape_train_config())
        path = os.path.join(root, 'BENCHMARK.json')
        with open(path) as f:
            manifest = json.load(f)
        for entry in manifest['configs']:
            if entry['name'] == 'shape_train':
                entry['file'] = rel
        helpers.write_json(path, manifest)
        traffic = os.path.join(root, 'benchmark', 'traffic',
                               'fresh_masks.json')
        with open(traffic) as f:
            mix = json.load(f)
        mix['settle_seconds'] = SETTLE_S
        helpers.write_json(traffic, mix)
        return root
    wrapped.__wrapped__ = checkout
    return wrapped


if not hasattr(helpers.checkout, '__wrapped__'):
    helpers.checkout = _with_shape_train(helpers.checkout)
