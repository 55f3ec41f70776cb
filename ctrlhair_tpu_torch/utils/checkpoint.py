# Checkpoints in the JAX package's format, read and written.
#
# Port of ctrlhair_tpu/utils/checkpoint.py: a checkpoint directory holds
# numbered `%07d.ckpt` files (flax msgpack, see flax_msgpack.py) and a
# manifest `latest_checkpoint` whose first line names the newest one and
# whose other lines list the kept files, oldest first; beyond `max_keep`
# the oldest are deleted.  The JAX reader restores into a target structure;
# this one needs none and returns the decoded tree of nested dicts.  The
# writer takes the tree already in flax's state-dict layout (numpy leaves;
# training/train_state.py builds it), so either package resumes from the
# other's checkpoints.

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

from ctrlhair_tpu_torch.utils import flax_msgpack

MANIFEST = 'latest_checkpoint'


def _ckpt_name(step: int) -> str:
    return '%07d.ckpt' % step


def save_checkpoint(ckpt_dir: str, tree: Any, step: int,
                    max_keep: int = 2) -> str:
    """Write `tree` to <dir>/%07d.ckpt, update the manifest, delete the
    oldest files beyond `max_keep`.  Returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = _ckpt_name(step)
    path = os.path.join(ckpt_dir, name)
    flax_msgpack.write(path, tree)
    manifest_path = os.path.join(ckpt_dir, MANIFEST)
    existing = []
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            existing = [l.strip() for l in f.readlines()[1:] if l.strip()]
    existing = [e for e in existing if e != name] + [name]
    while len(existing) > max_keep:
        victim = os.path.join(ckpt_dir, existing.pop(0))
        if os.path.exists(victim):
            os.remove(victim)
    with open(manifest_path, 'w') as f:
        f.write(name + '\n')
        f.write('\n'.join(existing) + '\n')
    return path


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
