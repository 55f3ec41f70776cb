"""Faults planted in the program under a CPU run (benchmark/tests), and a
watch on where the run writes.  Each fault breaks the timed path the way
a faulty program could, and the run's `correct` has to come out false."""

from __future__ import annotations

import os
import sys


def plant(name: str) -> None:
    import torch
    from ctrlhair_tpu_torch.pipeline.editor import HairEditor
    from ctrlhair_tpu_torch.training import sean_trainer
    from ctrlhair_tpu_torch.ui import app

    if name == 'slider_unchanged':
        # a tick that leaves the session's latent as it was
        app.apply_slider = lambda *a, **k: None
    elif name == 'answer_altered':
        # every blended image shifted where the editor produces it
        blend = HairEditor._blend

        def altered(self, *a, **k):
            out = blend(self, *a, **k)
            return torch.clamp(out.to(torch.int16) + 12, 0, 255).to(
                torch.uint8)
        HairEditor._blend = altered
    elif name == 'sweep_half_batch':
        # the sweep renders the first half of its alphas, and the second
        # half repeats them
        sweep = HairEditor._output_sweep

        def half(self, codes, l1, l2, alphas, *rest):
            n = alphas.shape[0]
            out = sweep(self, codes, l1, l2, alphas[:n // 2], *rest)
            return torch.cat([out, out])[:n]
        HairEditor._output_sweep = half
    elif name == 'train_unchanged':
        # a step that computes its losses and leaves the state unchanged
        sean_trainer.safe_apply_updates = lambda *a, **k: None
    elif name == 'train_half_batch':
        # the step's mean taken over the first half of the batch
        step = sean_trainer.SEANTrainer.train_step

        def half(self, state, batch, noise=None):
            n = batch['image'].shape[0] // 2
            return step(self, state, {k: v[:n] for k, v in batch.items()},
                        noise)
        sean_trainer.SEANTrainer.train_step = half
    else:
        raise ValueError(name)


def audit_writes(allowed) -> None:
    """Fail the process when it opens a file for writing, or makes,
    renames or removes a path, outside the allowed directories."""
    roots = [os.path.realpath(p) for p in allowed if p] + ['/dev/null']
    out = sys.stderr

    def inside(path) -> bool:
        try:
            p = os.path.realpath(os.fsdecode(path))
        except (TypeError, ValueError):
            return True             # a descriptor, not a path
        return any(p == r or p.startswith(r + os.sep) for r in roots)

    def hook(event, args):
        paths = []
        if event == 'open' and args and isinstance(args[0], (str, bytes)):
            mode, flags = args[1], args[2] if len(args) > 2 else 0
            writes = (isinstance(mode, str) and any(c in mode for c in 'wax+')
                      ) or (flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT))
            if writes:
                paths = [args[0]]
        elif event in ('os.mkdir', 'os.remove', 'os.rmdir', 'os.unlink',
                       'shutil.rmtree', 'os.truncate'):
            paths = [args[0]]
        elif event in ('os.rename', 'os.replace', 'shutil.move',
                       'shutil.copyfile'):
            paths = list(args[:2])
        for p in paths:
            if isinstance(p, (str, bytes, os.PathLike)) and not inside(p):
                out.write(f'WRITE OUTSIDE: {event} {p!r}\n')
                out.flush()
                os._exit(17)
    sys.addaudithook(hook)
