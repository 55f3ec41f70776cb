# Slider curation from the command line: sweep grids of random candidate
# directions for an operator to pick from, metric-scored curation of every
# slider slot, or (shape only) regression on the warp pool's masks.  The
# chosen directions are saved as sorted '<idx>.pkl' files, which Backend
# loads as its sliders (pipeline/direction_finder.py).
#
# Port of scripts/find_directions.py: the same flags and defaults, the
# same three routes in the same order (--pool-dir, then --auto, else the
# candidate grids and --choose), the same printed lines and the same files
# (candidate_NNN.png, slot_{i}_{att}.png, {att}_curation.json,
# shape_dir_regression.json and the pickles).  As in the JAX script the
# Backend runs without blending, and the input photo is cropped before it
# is analysed.  Two differences: --device names the editor's device (the
# first CUDA device by default; without a card the tool exits with an
# error unless given --device cpu), and --pool-dir with --att texture is
# refused before the editor is built.
#
#   python -m ctrlhair_tpu_torch.pipeline.find_directions --att shape \
#       --input face.png --out-dir /tmp/shape_candidates --n 20
#   # inspect /tmp/shape_candidates/candidate_*.png, then:
#   python -m ctrlhair_tpu_torch.pipeline.find_directions --att shape \
#       --choose 7 --index 0 --input face.png \
#       --out-dir /tmp/shape_candidates --save-dir /tmp/shape_dir_used
#
# Without --save-dir the directions go to model_trained/<att>_dir_used
# under the working directory, as the JAX script's do.

from __future__ import annotations

import argparse
import os

import torch

from ctrlhair_tpu_torch.convert.load import load_trained_root
from ctrlhair_tpu_torch.pipeline.backend import Backend
from ctrlhair_tpu_torch.pipeline.direction_finder import (
    auto_curate, data_driven_shape_directions, render_candidate_grids,
    save_direction)
from ctrlhair_tpu_torch.utils.image import read_rgb


def main(argv=None) -> None:
    p = argparse.ArgumentParser(
        description='Curate the shape / texture slider directions')
    p.add_argument('--att', choices=['shape', 'texture'], required=True)
    p.add_argument('--input', required=True, help='aligned face image')
    p.add_argument('--out-dir', required=True)
    p.add_argument('--n', type=int, default=20)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--choose', type=int, default=None,
                   help='candidate index to persist (after inspection)')
    p.add_argument('--index', type=int, default=0,
                   help='slider slot to save the chosen direction under')
    p.add_argument('--save-dir', default=None,
                   help='directions dir (default model_trained/<att>_dir_used)')
    p.add_argument('--auto', action='store_true',
                   help='metric-scored curation: fill EVERY slider slot '
                        'and write a score report (no operator in the loop)')
    p.add_argument('--pool-dir', default=None,
                   help='shape only: warp-pool label dir; regress the '
                        'pool latents on mask geometry and ship the '
                        'regression directions')
    p.add_argument('--trained-root', default=None,
                   help='model_trained root with <family>/checkpoints dirs '
                        'to load before curating')
    p.add_argument('--device', default=None,
                   help="torch device of the editor (default: cuda:0; "
                        "'cpu' runs on the CPU)")
    args = p.parse_args(argv)
    if torch.device(args.device or 'cuda').type == 'cuda' \
            and not torch.cuda.is_available():
        p.error('no CUDA device is available; pass --device cpu to run on '
                'the CPU')
    if args.pool_dir and args.att != 'shape':
        p.error('--pool-dir applies to --att shape only')
    save_dir = args.save_dir or os.path.join('model_trained',
                                             f'{args.att}_dir_used')

    backend = Backend(blending=False, device=args.device)
    if args.trained_root:
        load_trained_root(backend.editor, args.trained_root)
        print(f'loaded trained checkpoints from {args.trained_root}',
              flush=True)
    backend.set_input_img(backend.crop_face(read_rgb(args.input)))

    if args.pool_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        dirs_, report = data_driven_shape_directions(
            backend.editor, args.pool_dir, save_dir=save_dir,
            report_path=os.path.join(args.out_dir,
                                     'shape_dir_regression.json'))
        for i, r in enumerate(report):
            print(f"slot {i} ({r['label']}): r2 {r['r2']:.3f} over "
                  f"{r['n_masks']} masks", flush=True)
        _render_chosen_grids(backend, 'shape', dirs_, args.out_dir)
        print(f'{len(dirs_)} directions shipped to {save_dir}', flush=True)
        return

    if args.auto:
        os.makedirs(args.out_dir, exist_ok=True)
        dirs_, report = auto_curate(
            backend, args.att, n_candidates=args.n, seed=args.seed,
            save_dir=save_dir,
            report_path=os.path.join(args.out_dir,
                                     f'{args.att}_curation.json'))
        for r in report:
            print(f"slot {r['slot']} ({r['label']}): candidate "
                  f"{r['candidate']} slope {r['slope']:+.5f} "
                  f"score {r['score']:.2f}", flush=True)
        # a sweep grid per shipped slot, for a visual audit
        _render_chosen_grids(backend, args.att, dirs_, args.out_dir)
        print(f'{len(dirs_)} directions shipped to {save_dir}', flush=True)
        return

    candidates = render_candidate_grids(
        backend, args.att, args.out_dir, n_candidates=args.n,
        seed=args.seed)
    print(f'{len(candidates)} candidate grids in {args.out_dir}', flush=True)
    if args.choose is not None:
        save_direction(save_dir, args.index, candidates[args.choose])
        print(f'saved candidate {args.choose} as slot {args.index} '
              f'in {save_dir}', flush=True)


def _render_chosen_grids(backend, att_name, directions, out_dir,
                         values=(-2.0, -1.0, 0.0, 1.0, 2.0)):
    render_candidate_grids(backend, att_name, out_dir, values=values,
                           directions=directions,
                           name_fmt=f'slot_{{i}}_{att_name}.png')


if __name__ == '__main__':
    main()
