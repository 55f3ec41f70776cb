# Training entry point of the landmark regressor (the dlib stand-in).
#
# The port's counterpart of scripts/train_landmark_net.py: a pool of
# synthetic faces and backgrounds (data/landmark_dataset.py) is rendered
# once on the host, in chunks of 256 from one numpy generator of the seed,
# and moved to the device once (images as uint8); each step's batch is a
# gather from it on the device, its indices drawn there from a generator
# seeded by (seed, step).  After the last step the held-out metrics of 128
# fresh samples (seed 999) are printed and the parameters ({'params': ...},
# flax's layout) are written where ops/landmarks.load_landmark_net reads
# them.  Runs on cuda:0; without a card it exits 2 unless given --device
# cpu.
#
# Usage: python -m ctrlhair_tpu_torch.training.run_landmark \
#            [--steps N] [--out-dir model_trained/landmark_net/checkpoints]

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def main(argv=None):
    from ctrlhair_tpu_torch.ops.landmarks import default_landmark_ckpt_dir
    parser = argparse.ArgumentParser()
    parser.add_argument('--steps', type=int, default=None,
                        help='default: the config\'s total_step (3000)')
    parser.add_argument('--out-dir', default=default_landmark_ckpt_dir(),
                        help='checkpoint directory (default: the one '
                             'load_landmark_net reads)')
    parser.add_argument('--pool', type=int, default=3072,
                        help='samples rendered into the pool')
    parser.add_argument('--batch-size', type=int, default=None)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default=None,
                        help="'cpu' to train without a card (default: "
                             'cuda:0)')
    args = parser.parse_args(argv)

    from ctrlhair_tpu_torch.data import landmark_dataset as D
    from ctrlhair_tpu_torch.models.landmark_net import LandmarkNetConfig
    from ctrlhair_tpu_torch.training.landmark_trainer import LandmarkTrainer
    from ctrlhair_tpu_torch.training.predictor_trainer import step_seed
    from ctrlhair_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = LandmarkNetConfig()
    steps = args.steps or cfg.total_step
    try:
        trainer = LandmarkTrainer(cfg, device=args.device)
    except RuntimeError:
        print('[run_landmark] no CUDA device is available; pass --device cpu '
              'to train on the CPU', file=sys.stderr)
        sys.exit(2)
    device = trainer.device
    state = trainer.init_state(args.seed)

    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    chunks = [D.training_batch(rng, 256, cfg.input_size)
              for _ in range(max(args.pool // 256, 1))]
    pool = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    print(f'[run_landmark] pool: {len(pool["image"])} samples rendered in '
          f'{time.time() - t0:.1f} s', flush=True)
    # the renders are uint8 values: kept as uint8 on the device
    imgs_d = torch.from_numpy(np.clip(np.round(
        (pool['image'] + 1.0) * 127.5), 0, 255).astype(np.uint8)).to(device)
    lms_d = torch.from_numpy(pool['landmarks']).to(device)
    pres_d = torch.from_numpy(pool['presence']).to(device)
    n_pool = imgs_d.shape[0]
    batch_size = args.batch_size or cfg.total_batch_size

    def make_batch(step: int):
        gen = torch.Generator(device).manual_seed(step_seed(args.seed, step))
        idx = torch.randint(0, n_pool, (batch_size,), generator=gen,
                            device=device)
        return {'image': imgs_d[idx].float() / 127.5 - 1.0,
                'landmarks': lms_d[idx], 'presence': pres_d[idx]}

    t0 = time.time()
    metrics = {}
    for step in range(steps):
        state, metrics = trainer.train_step(state, make_batch(step))
        if step % 200 == 0 or step == steps - 1:
            print(f'[{time.time() - t0:7.1f}s] step {step}: '
                  f'coord={float(metrics["coord"]):.5f} '
                  f'presence={float(metrics["presence"]):.4f} '
                  f'finite={bool(metrics["finite"])}', flush=True)
    held = D.training_batch(np.random.default_rng(999), 128, cfg.input_size)
    ev = trainer.eval_metrics(
        state, {k: torch.from_numpy(v).to(device) for k, v in held.items()})
    print(f'[run_landmark] held-out: '
          f'{ {k: float(v) for k, v in ev.items()} }', flush=True)
    save_checkpoint(args.out_dir, state.model.to_tree()['params'], steps,
                    max_keep=1)
    print(f'[run_landmark] checkpoint -> {args.out_dir}', flush=True)
    return state, metrics, ev


if __name__ == '__main__':
    main()
