# The multi-rank dry run, and the process launcher it shares with the
# tests.
#
# Port of __graft_entry__.dryrun_multichip: one training step of each of
# the four data-parallel trainer families (colour/texture, the shape
# VAE-GAN, the face parser with synced BatchNorm, SEAN with synced
# BatchNorm and spectral norm) at that function's tiny configs, the global
# batch 2 n sharded over n gloo ranks on the CPU (dp = n; the JAX dry run's
# tp = 2 placement is not ported: ROADMAP.md, section 1), each step finite,
# a progress line per family.
#
#   python -m ctrlhair_tpu_torch.parallel.dryrun [N]
#
# run_on_ranks starts the ranks as spawned processes that meet through a
# file:// store in a temporary directory (no port to collide with another
# run), each on one torch thread, and joins them within a deadline: a rank
# that fails, dies or hangs fails the call, and whatever is still running
# then is killed.

from __future__ import annotations

import multiprocessing
import os
import queue
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch

# gloo's timeout for the ranks of run_on_ranks: a lost rank fails its
# partners' next collective instead of hanging them
RANK_TIMEOUT_S = 60.0


def _rank_main(fn, rank: int, world: int, store: str, results, device,
               backend, args) -> None:
    import torch.distributed as dist
    from ctrlhair_tpu_torch.parallel.mesh import initialize_runtime, make_mesh
    torch.set_num_threads(1)
    try:
        dev = initialize_runtime(device, init_method=f'file://{store}',
                                 world_size=world, rank=rank,
                                 backend=backend, timeout=RANK_TIMEOUT_S)
        out = fn(make_mesh(world, device=dev), *args)
        results.put((rank, True, out))
    except BaseException:       # reported to the parent, which re-raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_on_ranks(fn: Callable, world: int, *args, device: str = 'cpu',
                 backend: str = 'gloo', deadline_s: float = 300.0
                 ) -> List[Any]:
    """[fn(mesh, *args) of each rank] from `world` spawned processes, one
    rank each, on `device` ('cpu', or one CUDA device that every rank
    shares, such as 'cuda:0') over `backend`.  fn and args are pickled (fn
    a module-level function).  Raises the first rank's error, or
    TimeoutError past `deadline_s`."""
    ctx = multiprocessing.get_context('spawn')
    results = ctx.Queue()
    out, failure = {}, None
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, 'store')
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, store, results, device,
                                   backend, args), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        end = time.monotonic() + deadline_s
        try:
            while len(out) < world and failure is None:
                left = end - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f'run_on_ranks: {world - len(out)} '
                                       f'of {world} ranks still running '
                                       f'after {deadline_s} s')
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        # a rank's last report may still be in the pipe
                        try:
                            rank, ok, value = results.get(timeout=5.0)
                        except queue.Empty:
                            raise RuntimeError(
                                f'run_on_ranks: rank {dead[0]} died (exit '
                                f'code {procs[dead[0]].exitcode}) without '
                                'a result') from None
                    else:
                        continue
                if ok:
                    out[rank] = value
                else:
                    failure = f'rank {rank} of {world} failed:\n{value}'
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(end - time.monotonic(), 10.0))
                       if failure is None and len(out) == world else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world)]


def _dryrun_rank(mesh) -> List[str]:
    """The four families' steps on this rank; rank 0 prints the progress
    lines.  Returns the families whose step was finite."""
    import numpy as np

    from ctrlhair_tpu_torch.config import (
        BiSeNetConfig, ColorTextureConfig, SEANConfig, ShapeConfig)
    from ctrlhair_tpu_torch.parallel.mesh import replicated, shard_batch
    from ctrlhair_tpu_torch.training import (
        color_texture_trainer as ctt, shape_trainer as sht)
    from ctrlhair_tpu_torch.training.bisenet_trainer import BiSeNetTrainer
    from ctrlhair_tpu_torch.training.sean_trainer import SEANTrainer

    t0 = time.time()
    n = 2 * mesh.world
    done = []

    def log(msg):
        if mesh.rank == 0:
            print(f'[dryrun +{time.time() - t0:7.1f}s] {msg}', flush=True)

    def step(name, trainer, state, batch, *extra):
        replicated(state, mesh)
        _, metrics = trainer.train_step(state, shard_batch(batch, mesh),
                                        *extra)
        if not bool(metrics['finite']):
            raise AssertionError(f'non-finite {name} training step')
        done.append(name)
        log(f'family {len(done)}/4 {name}: train step OK'
            + (' - DRYRUN COMPLETE' if len(done) == 4 else ''))

    log(f'mesh ready: dp={mesh.world}, gloo on the CPU')
    cfg = ColorTextureConfig(style_dim=64, g_hidden_dim=32, d_hidden_dim=32)
    trainer = ctt.ColorTextureTrainer(cfg, device='cpu', mesh=mesh)
    state, pred = trainer.init_state(0)
    step('color_texture', trainer, state, ctt.synthetic_batch(
        torch.Generator().manual_seed(1), cfg, n), pred)

    cfg = ShapeConfig(img_size=16, layer_num=3, max_channel=32,
                      hidden_in_channel=8, face_dim=32)
    trainer = sht.ShapeTrainer(cfg, device='cpu', mesh=mesh)
    step('shape', trainer, trainer.init_state(3), sht.synthetic_batch(
        torch.Generator().manual_seed(4), cfg, n))

    rng = np.random.default_rng(0)
    trainer = BiSeNetTrainer(BiSeNetConfig(input_size=32,
                                           blocks_per_stage=1),
                             device='cpu', mesh=mesh)
    step('bisenet', trainer, trainer.init_state(6), {
        'image': torch.from_numpy(rng.standard_normal(
            (n, 32, 32, 3)).astype(np.float32)),
        'label': torch.from_numpy(rng.integers(0, 19, (n, 32, 32)).astype(
            np.int32))})

    # slim SEAN, as the JAX dry run: 3 upsamples, a 1-scale 2-layer PatchGAN
    cfg = SEANConfig(crop_size=32, ngf=4, zencoder_ngf=4, style_dim=32,
                     use_ace_noise=False, num_up_layers=3,
                     num_middle_blocks=1)
    trainer = SEANTrainer(cfg, use_vgg=False, dis_num_d=1, dis_ndf=8,
                          dis_n_layers=2, device='cpu', mesh=mesh)
    step('sean', trainer, trainer.init_state(8), {
        'image': torch.from_numpy((rng.standard_normal(
            (n, 32, 32, 3)) * 0.5).astype(np.float32)),
        'label': torch.from_numpy(rng.integers(0, 19, (n, 32, 32)).astype(
            np.int32))})
    return done


def dryrun_multichip(n_devices: int, deadline_s: float = 600.0) -> None:
    """One step of each trainer family over `n_devices` gloo ranks on the
    CPU (dp = n_devices), each finite; raises otherwise."""
    done = run_on_ranks(_dryrun_rank, n_devices, deadline_s=deadline_s)
    if any(d != ['color_texture', 'shape', 'bisenet', 'sean']
           for d in done):
        raise AssertionError(f'dry run: families done per rank {done}')


if __name__ == '__main__':
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2)
