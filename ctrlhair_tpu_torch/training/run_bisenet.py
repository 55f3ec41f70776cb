# Training entry point of the BiSeNet face parser.
#
# Port of ctrlhair_tpu/training/run_bisenet.py, same flags: paired images and
# label maps read through data/sean_dataset.SEANDataset (ImageNet-
# normalised), or synthetic batches (standard-normal images, then labels
# drawn from 0..18, both from one numpy generator of the seed, as JAX draws
# them); OHEM over the main and both auxiliary heads, SGD with momentum,
# checkpoints and resume.  Runs on cuda:0; without a card it exits 2 unless
# given --device cpu.  --dp N trains on N ranks with synced BatchNorm under
# the launcher, --batch-size staying the global batch (one process a card;
# training/loop.entry_mesh):
#   python -m torch.distributed.run --nproc_per_node N \
#       -m ctrlhair_tpu_torch.training.run_bisenet --dp N ...
#
# Usage: python -m ctrlhair_tpu_torch.training.run_bisenet \
#            [--image-dir ...] [--label-dir ...] [--steps N] [--synthetic]

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--image-dir',
                        default='dataset_info_ctrlhair/images_256')
    parser.add_argument('--label-dir', default='dataset_info_ctrlhair/label')
    parser.add_argument('--out-dir',
                        default='model_trained/bisenet/ctrlhair_tpu')
    parser.add_argument('--steps', type=int, default=80000)
    parser.add_argument('--batch-size', type=int, default=16)
    parser.add_argument('--dp', type=int, default=1,
                        help='data-parallel ranks (the launcher\'s '
                             '--nproc_per_node)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--input-size', type=int, default=None)
    parser.add_argument('--synthetic', action='store_true',
                        help='train on synthetic batches (smoke runs)')
    parser.add_argument('--device', default=None,
                        help="'cpu' to train without a card (default: "
                             'cuda:0)')
    args = parser.parse_args(argv)

    from ctrlhair_tpu_torch.training.loop import entry_mesh
    with entry_mesh(args.dp, args.device, 'run_bisenet') as (mesh, device):
        return train(args, mesh, device)


def train(args, mesh, device):
    from ctrlhair_tpu_torch.config import BiSeNetConfig
    from ctrlhair_tpu_torch.models.bisenet import normalize_imagenet
    from ctrlhair_tpu_torch.parallel.mesh import shard_batch
    from ctrlhair_tpu_torch.training.bisenet_trainer import BiSeNetTrainer
    from ctrlhair_tpu_torch.training.loop import run_training

    cfg = BiSeNetConfig() if args.input_size is None else BiSeNetConfig(
        input_size=args.input_size)
    trainer = BiSeNetTrainer(cfg, device=device, mesh=mesh)
    state = trainer.init_state(args.seed)

    dataset = None
    if not args.synthetic:
        from ctrlhair_tpu_torch.data.sean_dataset import SEANDataset
        # the same paired image/label layout as SEAN training
        dataset = SEANDataset(args.image_dir, args.label_dir,
                              crop_size=cfg.input_size, seed=args.seed)
        if len(dataset) == 0:
            dataset = None
            print('[run_bisenet] no paired data found; using synthetic '
                  'batches')

    host_rng = np.random.default_rng(args.seed)
    s = cfg.input_size

    def batch_fn(step):
        """The global batch; this rank's rows of it."""
        if dataset is not None:
            batch = dataset.batch(args.batch_size)
            batch = shard_batch({k: torch.from_numpy(v)
                                 for k, v in batch.items()}, mesh)
            img = batch['image'].to(device) * 0.5 + 0.5
            return {'image': normalize_imagenet(img),
                    'label': batch['label'].to(device)}
        image = host_rng.standard_normal((args.batch_size, s, s, 3))
        label = host_rng.integers(0, 19, (args.batch_size, s, s))
        batch = shard_batch(
            {'image': torch.from_numpy(image.astype(np.float32)),
             'label': torch.from_numpy(label.astype(np.int32))}, mesh)
        return {k: v.to(device) for k, v in batch.items()}

    state, metrics = run_training(
        state, trainer.train_step, batch_fn, args.steps,
        log_dir=os.path.join(args.out_dir, 'summaries'),
        ckpt_dir=os.path.join(args.out_dir, 'checkpoints'),
        model_save_step=10000, sample_step=10000, max_keep=1,
        tag='bisenet', mesh=mesh)
    print('[run_bisenet] done:',
          {k: float(v) for k, v in metrics.items()
           if isinstance(v, torch.Tensor) and v.numel() == 1})
    return state


if __name__ == '__main__':
    main()
