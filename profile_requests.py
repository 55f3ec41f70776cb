#!/usr/bin/env python3
"""Device time of the port's three requests, one checkout against another.

    python3 profile_requests.py [CHECKOUT ...]

For every checkout named (this one when none is), in the order given and
each in a process of its own, it builds that checkout's kernels, sets up
the full-width editor and Backend session of that checkout's
`chip_smoke.py` (same seed, same photos, same painted parses), and reads
with torch.profiler the summed device time of the kernels of

    editor.output            one 256 px edit under an edited hair mask
    Backend.output           the session's render with blending
    Backend.transfer_latent_representation('shape')   landmarks cached

three warm calls each, beside the host's wall time of the same calls.  The
host's clock moves by up to 2x from machine to machine and from minute to
minute; the device time of a request does not, so it tells a change in the
work a request gives the card from a slow host.  Name the checkouts as
parent, change, change, parent to see a drift within the run.

Prints one JSON line per checkout, then the card's name and power limit.
Needs one CUDA device; exits 1 without one.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

REPS = 3


def profile_call(fn) -> dict:
    """One warm call of `fn` under torch.profiler: host wall ms, the summed
    device ms of its kernels and copies, and their count."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    return {'wall_ms': wall,
            'device_ms': sum(e.self_device_time_total for e in events) / 1e3,
            'launches': sum(e.count for e in events)}


def one(root: str) -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print('profile_requests: no CUDA device available', file=sys.stderr)
        return 1
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(root, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from ctrlhair_tpu_torch import config as cfg_mod
    from ctrlhair_tpu_torch.pipeline.backend import Backend
    from ctrlhair_tpu_torch.pipeline.editor import HairEditor

    cfg = cfg_mod.PipelineConfig()
    editor = HairEditor(cfg, device='cuda', seed=smoke.SEED)
    editor.load_style_fallback(smoke.STYLE_DIR)
    rng = np.random.default_rng(smoke.SEED)
    img_in = smoke.make_image(rng, cfg.edit_size)
    img_tg = smoke.make_image(rng, cfg.edit_size)
    alphas = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    with torch.inference_mode():
        a_in, lat, hair_label, _, _ = smoke.session(editor, img_in, img_tg,
                                                    alphas)
    backend = Backend(cfg=cfg, editor=editor, seed=smoke.SEED,
                      trained_root=os.path.join(root, 'model_trained'))
    smoke.backend_session(backend, img_in, img_tg, alphas)

    def editor_output():
        with torch.inference_mode():
            editor.output(a_in['sean_codes'], lat, img_in[None],
                          a_in['label'], hair_label)

    requests = {
        'editor.output': editor_output,
        'backend.output': backend.output,
        'backend.shape_transfer':
            lambda: backend.transfer_latent_representation('shape'),
    }
    result = {'checkout': root}
    for name, fn in requests.items():
        fn()                                            # warm-up
        result[name] = [profile_call(fn) for _ in range(REPS)]
    print(json.dumps(result), flush=True)
    return 0


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == '--one':
        return one(argv[1])
    roots = argv or [os.path.dirname(os.path.abspath(__file__))]
    for root in roots:
        # of what the checkout's process prints, only its JSON line is
        # passed on
        done = subprocess.run([sys.executable, os.path.abspath(__file__),
                               '--one', root], capture_output=True, text=True)
        sys.stderr.write(done.stderr[-4000:])
        lines = [ln for ln in done.stdout.splitlines()
                 if ln.startswith('{"checkout"')]
        if done.returncode != 0 or len(lines) != 1:
            sys.stderr.write(done.stdout[-4000:])
            print(f'profile_requests: {root} failed', file=sys.stderr)
            return 1
        print(lines[0], flush=True)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
