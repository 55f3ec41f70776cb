# The curated semantic directions of the shape/texture sliders.
#
# Port of ctrlhair_tpu/pipeline/direction_finder.py, the loader only: the
# chosen directions are sorted '<idx>.pkl' files, each one plain numpy
# vector (the loading contract of the reference, hair_editor.py:84-91,
# 111-119).  Finding and curating directions (random candidates, sweep
# grids, auto_curate) is not ported yet.

from __future__ import annotations

import os
import pickle
from typing import List, Optional

import numpy as np


def load_directions(dir_path: str) -> Optional[List[np.ndarray]]:
    """The directions under `dir_path`, in file-name order; None when the
    directory does not exist or holds no pickle.  The pickles are the ones
    that ship with this checkout's trained weights."""
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
