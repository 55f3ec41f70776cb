# Training entry point of the shape branch (the hair-mask VAE-GAN).
#
# Port of ctrlhair_tpu/training/run_shape.py, same flags: triplet batches
# from the warp pool (data/shape_dataset.ShapeDataset; generate it with
# data.shape_dataset.generate_warp_pool), or synthetic ones when the pool is
# absent or empty; the fused D / G / Dz step, checkpoints and resume.  Runs
# on cuda:0; without a card it exits 2 unless given --device cpu.  --dp N
# trains on N ranks under the launcher, --batch-size staying the global
# batch (one process a card; training/loop.entry_mesh):
#   python -m torch.distributed.run --nproc_per_node N \
#       -m ctrlhair_tpu_torch.training.run_shape --dp N ...
#
# Usage: python -m ctrlhair_tpu_torch.training.run_shape \
#            [--data-root dataset_info_ctrlhair] [--steps N] [--synthetic]

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data-root', default='dataset_info_ctrlhair')
    parser.add_argument('--out-dir',
                        default='model_trained/shape/ctrlhair_tpu')
    parser.add_argument('--steps', type=int, default=None)
    parser.add_argument('--batch-size', type=int, default=None)
    parser.add_argument('--dp', type=int, default=1,
                        help='data-parallel ranks (the launcher\'s '
                             '--nproc_per_node)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--synthetic', action='store_true',
                        help='train on synthetic batches (smoke runs)')
    parser.add_argument('--device', default=None,
                        help="'cpu' to train without a card (default: "
                             'cuda:0)')
    args = parser.parse_args(argv)

    from ctrlhair_tpu_torch.training.loop import entry_mesh
    with entry_mesh(args.dp, args.device, 'run_shape') as (mesh, device):
        return train(args, mesh, device)


def train(args, mesh, device):
    from ctrlhair_tpu_torch.config import ShapeConfig
    from ctrlhair_tpu_torch.parallel.mesh import shard_batch
    from ctrlhair_tpu_torch.training.loop import run_training
    from ctrlhair_tpu_torch.training.predictor_trainer import step_generator
    from ctrlhair_tpu_torch.training.shape_trainer import (
        ShapeTrainer, synthetic_batch)

    cfg = ShapeConfig()
    total_steps = args.steps or cfg.total_step
    batch_size = args.batch_size or cfg.total_batch_size
    trainer = ShapeTrainer(cfg, device=device, seed=args.seed, mesh=mesh)
    state = trainer.init_state(args.seed)

    dataset = None
    if not args.synthetic and os.path.isdir(args.data_root):
        from ctrlhair_tpu_torch.data.shape_dataset import ShapeDataset
        try:
            dataset = ShapeDataset(cfg, args.data_root)
        except (OSError, KeyError, ValueError) as exc:
            print(f'[run_shape] dataset unavailable ({exc!r}); falling back '
                  'to synthetic batches')
        else:
            if not dataset.pool_files:
                dataset = None

    def batch_fn(step):
        """The global batch; this rank's rows of it."""
        if dataset is not None:
            batch = {k: torch.from_numpy(v) for k, v in
                     dataset.training_batch(batch_size).items()}
        else:
            # keyed by the step, so a resumed run sees the same batches
            batch = synthetic_batch(step_generator(args.seed + 1, step),
                                    cfg, batch_size)
        return {k: v.to(device) for k, v in shard_batch(batch, mesh).items()}

    state, metrics = run_training(
        state, trainer.train_step, batch_fn, total_steps,
        log_dir=os.path.join(args.out_dir, 'summaries'),
        ckpt_dir=os.path.join(args.out_dir, 'checkpoints'),
        model_save_step=10000, sample_step=10000, max_keep=1, tag='shape',
        mesh=mesh)
    print('[run_shape] done:',
          {k: float(v) for k, v in metrics.items()
           if isinstance(v, torch.Tensor) and v.numel() == 1})
    return state


if __name__ == '__main__':
    main()
