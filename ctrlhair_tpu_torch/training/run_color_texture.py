# Training entry point of the colour & texture branch.
#
# Port of ctrlhair_tpu/training/run_color_texture.py, same flags: dataset
# batches (or synthetic ones), the fused step, checkpoints and resume, and
# with --sean-checkpoint (a reference SEAN netG .pth) the frozen-SEAN
# lambda_rec_img term.  Runs on cuda:0; without a card it exits 2 unless
# given --device cpu.  --dp above 1 (data-parallel training) is a later
# slice of the port and is refused.
#
# Usage: python -m ctrlhair_tpu_torch.training.run_color_texture \
#            [--data-root dataset_info_ctrlhair] [--steps N] [--synthetic]

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data-root', default='dataset_info_ctrlhair')
    parser.add_argument('--out-dir',
                        default='model_trained/color_texture/ctrlhair_tpu')
    parser.add_argument('--steps', type=int, default=None)
    parser.add_argument('--batch-size', type=int, default=None)
    parser.add_argument('--dp', type=int, default=1,
                        help='data-parallel devices (1 only, for now)')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--synthetic', action='store_true',
                        help='train on synthetic batches (smoke runs)')
    parser.add_argument('--sean-checkpoint', default=None,
                        help='reference SEAN netG .pth for the frozen-SEAN '
                             'lambda_rec_img loss (scheduled on at 600k); '
                             'without it the term stays off')
    parser.add_argument('--device', default=None,
                        help="'cpu' to train without a card (default: "
                             'cuda:0)')
    args = parser.parse_args(argv)
    if args.dp > 1:
        raise SystemExit('run_color_texture: --dp above 1 needs data-'
                         'parallel training, a later slice of the port; '
                         'run with --dp 1')

    from ctrlhair_tpu_torch.config import ColorTextureConfig
    from ctrlhair_tpu_torch.training.color_texture_trainer import (
        ColorTextureTrainer, synthetic_batch)
    from ctrlhair_tpu_torch.training.loop import run_training
    from ctrlhair_tpu_torch.training.predictor_trainer import step_generator

    cfg = ColorTextureConfig()
    total_steps = args.steps or cfg.total_step
    batch_size = args.batch_size or cfg.total_batch_size
    try:
        trainer = ColorTextureTrainer(cfg, device=args.device,
                                      seed=args.seed)
    except RuntimeError:
        print('[run_color_texture] no CUDA device is available; pass '
              '--device cpu to train on the CPU', file=sys.stderr)
        sys.exit(2)
    device = trainer.device
    if args.sean_checkpoint and os.path.exists(args.sean_checkpoint):
        from ctrlhair_tpu_torch.config import SEANConfig
        from ctrlhair_tpu_torch.convert import load_variables
        from ctrlhair_tpu_torch.convert import torch_import as ti
        from ctrlhair_tpu_torch.convert.load import torch_load
        from ctrlhair_tpu_torch.models.sean import SEAN
        scfg = SEANConfig()
        sd = torch_load(args.sean_checkpoint)
        if hasattr(sd, 'state_dict'):
            sd = sd.state_dict()
        with torch.device(device):
            sean = SEAN(scfg)
        load_variables(sean, 'sean', ti.convert_sean(
            ti.strip_ddp_prefix(sd), ngf=scfg.ngf,
            semantic_nc=scfg.semantic_nc, style_dim=scfg.style_dim))
        trainer = ColorTextureTrainer(cfg, sean=sean, device=device,
                                      seed=args.seed)
        print('[run_color_texture] frozen SEAN loaded: lambda_rec_img '
              'active per schedule')
    elif cfg.lambda_rec_img:
        print('[run_color_texture] NOTE: no --sean-checkpoint; the '
              'scheduled lambda_rec_img term (on at 600k in the reference) '
              'stays OFF', flush=True)
    state, predictors = trainer.init_state(args.seed)

    dataset = None
    if not args.synthetic and os.path.isdir(args.data_root):
        from ctrlhair_tpu_torch.data.color_texture_dataset import (
            ColorTextureDataset)
        try:
            dataset = ColorTextureDataset(cfg, args.data_root)
        except (OSError, KeyError, ValueError) as exc:
            print(f'[run_color_texture] dataset unavailable ({exc!r}); '
                  'falling back to synthetic batches')
        else:
            if not dataset.train_keys:
                dataset = None

    def batch_fn(step):
        if dataset is not None:
            batch = dataset.training_batch(batch_size)
            batch.pop('items', None)
            return {k: torch.as_tensor(np.asarray(v, np.float32),
                                       device=device)
                    for k, v in batch.items()}
        # keyed by the step, so a resumed run sees the same batches
        return synthetic_batch(step_generator(args.seed + 1, step), cfg,
                               batch_size, device)

    state, metrics = run_training(
        state, trainer.train_step, batch_fn, total_steps,
        step_args=lambda: (predictors,),
        log_dir=os.path.join(args.out_dir, 'logs'),
        ckpt_dir=os.path.join(args.out_dir, 'checkpoints'),
        model_save_step=20000, sample_step=25000, tag='color_texture')
    print('[run_color_texture] done:',
          {k: float(v) for k, v in metrics.items()
           if isinstance(v, torch.Tensor) and v.numel() == 1})
    return state


if __name__ == '__main__':
    main()
