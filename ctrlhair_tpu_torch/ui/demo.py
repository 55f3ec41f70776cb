# Demo entry point (ref CLI: python ui/frontend_demo.py -g .. --no_blending,
# util/common_options.py:10-15).  Port of ctrlhair_tpu/ui/demo.py.
#
# Usage: python -m ctrlhair_tpu_torch.ui.demo [--no-blending] [--input IMG]
#        [--target IMG] [--headless OUT.png] [--max-fe F] [--device DEV]
# --headless runs the backend example flow without a display (the analogue of
# the reference's `python ui/backend.py` smoke main, ref ui/backend.py:468-504)
# and writes a PNG.  Images are PNG files.  The editor runs on the first CUDA
# device unless --device names another (--device cpu: the CPU); without a
# card and without --device it exits with an error.

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--no-blending', action='store_true')
    parser.add_argument('--input', default=None)
    parser.add_argument('--target', default=None)
    parser.add_argument('--headless', default=None,
                        help='render one edited image to this path and exit')
    parser.add_argument('--max-fe', type=float, default=2.0)
    parser.add_argument('--device', default=None,
                        help="torch device of the editor (default: the first "
                             "CUDA device; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)

    for path in (args.input, args.target):
        if path and not os.path.exists(path):
            parser.error(f'image not found: {path}')
    if args.device is None and not torch.cuda.is_available():
        parser.error('no CUDA device is available; pass --device cpu to run '
                     'on the CPU')

    from ctrlhair_tpu_torch.pipeline.backend import Backend
    # one scale for backend AND sliders: a larger backend range would make
    # the top of the pca_std range unreachable from the UI and let
    # transfers push readbacks past the slider clamp
    backend = Backend(maximum_value_fe=args.max_fe,
                      blending=not args.no_blending, device=args.device)

    if args.headless:
        import numpy as np
        from ctrlhair_tpu_torch.utils.image import read_rgb, write_rgb
        img = (read_rgb(args.input) if args.input else
               np.random.default_rng(0).integers(
                   0, 255, (256, 256, 3), dtype=np.uint8))
        backend.set_input_img(img)
        if args.target:
            backend.set_target_img(read_rgb(args.target))
            backend.transfer_latent_representation('texture')
            backend.transfer_latent_representation('color')
        backend.change_color(1.0, 2)
        out = backend.output()
        write_rgb(args.headless, out)
        print(f'[demo] wrote {args.headless}')
        return out

    from ctrlhair_tpu_torch.ui.app import EditorApp
    app = EditorApp(backend, maximum_value_fe=args.max_fe)
    if args.input:
        app._load_input(args.input)
    if args.target:
        app._load_target(args.target)
    app.run()


if __name__ == '__main__':
    main()
