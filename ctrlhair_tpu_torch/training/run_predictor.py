# Training entry point of the supervised predictors (curliness / colour).
#
# Port of ctrlhair_tpu/training/run_predictor.py, same flags: labelled code
# batches from the data root (ColorTextureDataset), or synthetic ones,
# checkpoints and resume.  Runs on cuda:0; without a card it exits 2
# unless given --device cpu.
#
# Usage: python -m ctrlhair_tpu_torch.training.run_predictor \
#            --which rgb|curliness [--steps N] [--synthetic] [--device cpu]

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--which', choices=['rgb', 'curliness'],
                        default='rgb')
    parser.add_argument('--data-root', default='dataset_info_ctrlhair')
    parser.add_argument('--out-dir', default=None)
    parser.add_argument('--steps', type=int, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--synthetic', action='store_true')
    parser.add_argument('--device', default=None,
                        help="'cpu' to train without a card (default: "
                             'cuda:0)')
    args = parser.parse_args(argv)

    from ctrlhair_tpu_torch.config import (ColorTextureConfig,
                                           curliness_predictor_config,
                                           rgb_predictor_config)
    from ctrlhair_tpu_torch.training.loop import device_or_exit, run_training
    from ctrlhair_tpu_torch.training.predictor_trainer import (
        PredictorTrainer)

    cfg = (rgb_predictor_config() if args.which == 'rgb'
           else curliness_predictor_config())
    out_dir = args.out_dir or (
        'model_trained/color_encoder/ctrlhair_tpu' if args.which == 'rgb'
        else 'model_trained/curliness_classifier/ctrlhair_tpu')
    total_steps = args.steps or cfg.total_step
    device = device_or_exit(args.device, 'run_predictor')
    trainer = PredictorTrainer(cfg, device=device, seed=args.seed)
    state = trainer.init_state(args.seed)

    dataset = None
    if not args.synthetic and os.path.isdir(args.data_root):
        from ctrlhair_tpu_torch.data.color_texture_dataset import (
            ColorTextureDataset)
        try:
            dataset = ColorTextureDataset(ColorTextureConfig(),
                                          args.data_root)
        except (OSError, KeyError, ValueError) as exc:
            print(f'[run_predictor] dataset unavailable ({exc!r}); '
                  'synthetic')
        else:
            if not dataset.train_keys:
                dataset = None

    rng = np.random.default_rng(args.seed)

    def on_device(batch):
        return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                for k, v in batch.items()}

    def batch_fn(step):
        n = cfg.total_batch_size
        if dataset is not None:
            if args.which == 'curliness':
                b = dataset.curliness_batch(n)
                if b is not None:
                    return on_device(b)
            else:
                b = dataset.training_batch(n)
                return on_device({k: b[k] for k in
                                  ('code', 'rgb_mean', 'pca_std')})
        # synthetic fallback
        code = rng.standard_normal((n, cfg.style_dim)).astype(np.float32)
        batch = {'code': code}
        if args.which == 'curliness':
            batch['curliness_label'] = np.where(
                code[:, :1].sum(1, keepdims=True) > 0, 1.0, -1.0)
        else:
            batch['rgb_mean'] = code[:, :3] * 40 + 128
            batch['pca_std'] = np.abs(code[:, 3:4]) * 30 + 20
        return on_device(batch)

    state, metrics = run_training(
        state, trainer.train_step, batch_fn, total_steps,
        log_dir=os.path.join(out_dir, 'logs'),
        ckpt_dir=os.path.join(out_dir, 'checkpoints'),
        model_save_step=1000, sample_step=10 ** 9, tag=args.which)
    print('[run_predictor] done:',
          {k: float(v) for k, v in metrics.items()
           if isinstance(v, torch.Tensor) and v.numel() == 1})
    return state


if __name__ == '__main__':
    main()
