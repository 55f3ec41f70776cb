# The training loop: metrics logging, checkpoint cadence, resume.
#
# Port of ctrlhair_tpu/training/loop.py.  `train_step(state, batch, *extra)`
# advances the state; a trainer draws its own randomness from its seed and
# the state's step (see the trainers), so a run resumed from a checkpoint
# takes the same draws as one that never stopped.  Scalars go to
# tensorboardX when it is installed; without it MetricsWriter does nothing,
# as in JAX.  Under data parallelism (`mesh`) every rank resumes from the
# same checkpoint, the state is broadcast from rank 0 once at the start,
# rank 0 alone writes the summaries and the checkpoints, and every rank
# returns after the last checkpoint is written.  Under tensor parallelism
# every rank takes part in gathering the tree rank 0 writes (to_tree), and
# every rank reads the whole tree on resume and keeps its slices.  `entry_mesh` gives the
# entry points JAX's --dp under `python -m torch.distributed.run`.

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Any, Callable, Dict, Optional

import torch

from ctrlhair_tpu_torch.parallel import mesh as pmesh
from ctrlhair_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint


class MetricsWriter:
    """tensorboardX scalar writer; a no-op when tensorboardX is absent."""

    def __init__(self, log_dir: Optional[str]):
        self.writer = None
        if log_dir:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                return
            os.makedirs(log_dir, exist_ok=True)
            self.writer = SummaryWriter(log_dir)

    def scalars(self, tag: str, metrics: Dict[str, Any], step: int) -> None:
        if self.writer is None:
            return
        for key, val in metrics.items():
            if isinstance(val, torch.Tensor) and val.numel() == 1:
                self.writer.add_scalar(f'{tag}/{key}', float(val), step)
            elif isinstance(val, (int, float)):
                self.writer.add_scalar(f'{tag}/{key}', float(val), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


def device_or_exit(device, tag: str) -> torch.device:
    """An entry point's device: cuda:0 unless `device` names another.
    Exits 2 with a message when the card it names is missing; every other
    error of building the trainer is left to propagate."""
    from ctrlhair_tpu_torch.pipeline.editor import resolve_device
    try:
        return resolve_device(device)
    except RuntimeError:
        print(f'[{tag}] no CUDA device is available; pass --device cpu to '
              'train on the CPU', file=sys.stderr)
        sys.exit(2)


@contextlib.contextmanager
def entry_mesh(dp: int, device, tag: str):
    """(mesh, device) of an entry point's --dp and --device, as JAX's --dp:
    under `python -m torch.distributed.run --nproc_per_node N`, --dp must
    be N (WORLD_SIZE) and this process trains its rows of the global batch
    on cuda:<LOCAL_RANK> over NCCL (on the CPU over gloo with --device
    cpu); the group is torn down on the way out.  Without the launcher,
    --dp must be 1 and the mesh is None.  Exits 2 with a message on a
    mismatch or a missing card."""
    launched = 'WORLD_SIZE' in os.environ
    if not launched:
        if dp != 1:
            print(f'[{tag}] --dp {dp} needs one process a rank: run under '
                  f'python -m torch.distributed.run --nproc_per_node {dp}',
                  file=sys.stderr)
            sys.exit(2)
        yield None, device_or_exit(device, tag)
        return
    world = int(os.environ['WORLD_SIZE'])
    if dp != world:
        print(f'[{tag}] --dp {dp} but the launcher started {world} '
              'processes (WORLD_SIZE); they must agree', file=sys.stderr)
        sys.exit(2)
    cpu = device is not None and torch.device(device).type == 'cpu'
    if not cpu:
        device_or_exit(device, tag)
    dev = pmesh.initialize_runtime('cpu' if cpu else None)
    try:
        yield pmesh.make_mesh(dp, device=dev), dev
    finally:
        torch.distributed.destroy_process_group()


def _save(ckpt_dir: str, state, step: int, max_keep: int, mesh) -> None:
    """Rank 0 writes state.to_tree(); with tp > 1 every rank gathers it
    (a collective over the tp ranks)."""
    main = pmesh.is_main(mesh)
    if main or pmesh.tp_size(mesh) > 1:
        tree = state.to_tree()
        if main:
            save_checkpoint(ckpt_dir, tree, step, max_keep=max_keep)


def run_training(state, train_step: Callable, batch_fn: Callable,
                 total_steps: int, *,
                 step_args: Callable | None = None,
                 log_dir: Optional[str] = None,
                 ckpt_dir: Optional[str] = None,
                 log_step: int = 10, model_save_step: int = 20000,
                 sample_step: int = 25000, max_keep: int = 2,
                 sample_fn: Optional[Callable] = None,
                 tag: str = 'train', verbose: bool = True, mesh=None):
    """Run `train_step(state, batch, *extra)` for steps [start, total_steps).

    - batch_fn(step) -> batch dict (host-side sampling; this rank's rows
      under a mesh)
    - step_args() -> extra positional arguments (e.g. frozen predictors)
    - resume: when ckpt_dir holds a checkpoint, the state is restored from
      it (state.load_tree) and the loop continues at its step + 1
    - a checkpoint every model_save_step steps (not at step 0) and one at
      the end, state.to_tree() in flax's layout, by rank 0 alone
    """
    main = pmesh.is_main(mesh)
    verbose = verbose and main
    writer = MetricsWriter(log_dir if main else None)
    start = 0
    if ckpt_dir:
        restored = load_checkpoint(ckpt_dir)
        if restored is not None:
            tree, last = restored
            state.load_tree(tree)
            start = last + 1
            if verbose:
                print(f'[loop] resumed from step {last}')
    pmesh.replicated(state, mesh)

    extra = tuple(step_args()) if step_args else ()
    t0 = time.time()
    metrics: Dict[str, Any] = {}
    for step in range(start, total_steps):
        batch = batch_fn(step)
        state, metrics = train_step(state, batch, *extra)
        if step % log_step == 0:
            writer.scalars(tag, metrics, step)
            if verbose and step % (log_step * 100) == 0:
                rate = (step - start + 1) / max(time.time() - t0, 1e-9)
                vals = ' '.join(f'{k}={float(metrics[k]):.4f}'
                                for k in ('g_total', 'd_total', 'total')
                                if k in metrics)
                print(f'[loop:{tag}] step {step}/{total_steps} '
                      f'{vals} ({rate:.1f} it/s)')
        if ckpt_dir and step > 0 and step % model_save_step == 0:
            _save(ckpt_dir, state, step, max_keep, mesh)
        if main and sample_fn and step > 0 and step % sample_step == 0:
            sample_fn(state, step)
    if ckpt_dir:
        _save(ckpt_dir, state, total_steps - 1, max_keep, mesh)
    writer.close()
    pmesh.barrier(mesh)
    return state, metrics
