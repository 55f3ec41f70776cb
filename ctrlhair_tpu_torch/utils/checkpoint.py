# Reading the checkpoints the JAX package's trainers write.
#
# Port of the read half of ctrlhair_tpu/utils/checkpoint.py: a checkpoint
# directory holds numbered `%07d.ckpt` files (flax msgpack, see
# flax_msgpack.py) and a manifest `latest_checkpoint` whose first line names
# the newest one.  The JAX reader restores into a target structure; this one
# needs none and returns the decoded tree of nested dicts.  The writer
# (save_checkpoint, retention) comes with the trainers.

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

from ctrlhair_tpu_torch.utils import flax_msgpack

MANIFEST = 'latest_checkpoint'


def latest_checkpoint_path(ckpt_dir: str) -> Optional[str]:
    """The file the manifest's first line names, or None when there is no
    manifest or that file is gone."""
    manifest_path = os.path.join(ckpt_dir, MANIFEST)
    if not os.path.exists(manifest_path):
        return None
    with open(manifest_path) as f:
        name = f.readline().strip()
    path = os.path.join(ckpt_dir, name)
    return path if os.path.exists(path) else None


def load_checkpoint(ckpt_dir: str) -> Optional[Tuple[Any, int]]:
    """(decoded tree, step) of the newest checkpoint, or None when the
    directory has none.  The step is the number in the file's name."""
    path = latest_checkpoint_path(ckpt_dir)
    if path is None:
        return None
    step = int(os.path.splitext(os.path.basename(path))[0])
    return flax_msgpack.read(path), step
