"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's four paths at the full default PipelineConfig() width:
  1. the editor (random weights from a seed, the shipped median style
     codes): analyze -> latent edits -> output / output_refresh /
     output_sweep, through ctrlhair_tpu_torch.pipeline.editor.HairEditor;
  2. the Backend session on the same editor (which the Backend loads with
     the shipped checkpoints of model_trained/): set input and target, every
     slider, colour and texture transfer, reference-photo shape transfer
     (twice), an interpolation sweep and a painted hair mask, through
     ctrlhair_tpu_torch.pipeline.backend.Backend;
  3. the deployment session: Backend() as a user starts it, on an editor of
     its own built and loaded from model_trained/ (SEAN and the shape VAE,
     which do not ship, stay seeded), on the real photo samples/input.png:
     crop_face of its 1024 px upscale, hair colour, colour / texture / shape
     transfer with the shipped landmark net, a need_crop=True transfer of
     two 1024 px photos, sliders, blended outputs and a sweep; the shipped
     families' weights are held to their checkpoints by checksum;
  4. the serving surface, each part on a Backend() of its own after the
     last is freed: the web server as `python -m ctrlhair_tpu_torch.ui.web`
     builds it, served on 127.0.0.1 and driven over HTTP (both photos,
     every slider, the three transfers and random draws, the images, one
     bad request of each kind; the served PNGs decode to the held arrays),
     then auto_curate('texture') and render_candidate_grids on its session;
     the headless demo (ui.demo.main) in this process; and the multigrid
     blend on the card against the CPU.
Builds every hand-written kernel of those paths from csrc/ (and the native
host library from native/), holds each kernel against its plain PyTorch
version on the card (the masked CG on shapes that take its cluster kernel
and on one that takes its grid kernel, with a second launch that must be
bit-identical), shows from the launch counts, set to 0 before each path and
read after it, that the paths ran through the kernels and that every blend
took the cluster kernel, and times kernels and stages with CUDA events, the
profiler and torch.cuda.synchronize().  It
checks what comes out: uint8 images of the expected shape; for the
request under an edited hair mask, a finite solution that rounds to the session's output, a CG residual cut at least
a hundredfold, and a face that moves from the input only by the seam
correction; and a tiny float32 session on the card equals the same
session on the CPU, where the plain versions run.  For the Backend
session: the warped composite of the shape transfer has only the labels it
may have, enough hair, and a hair centroid that moved the way the
landmarks did; the kernel route of the warp agrees with the host C++ route.

Output: phase lines, then one {"kernels": [...]} JSON line, one {"slice":
...} JSON line, the card's `nvidia-smi` name and power limit, and as the
last line {"ok": true, "device": {...}}.  Exits non-zero, with no final
line, without a CUDA device or when any phase fails.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import functools
import gc
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
STYLE_DIR = os.path.join(ROOT, 'model_trained', 'mean_style_code', 'median')
SEED = 0

# float32 peak outside the tensor cores and HBM rate of one H100 SXM
# (NVIDIA data sheet), for the kernels' bounds
F32_PEAK_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# masked CG: float operations per iteration and element (stencil 7, two
# dot products 4, three axpys 6)
CG_FLOPS_PER_ELEMENT = 17
# the UV rasteriser against its plain version (the bar of the JAX package's
# tests/test_raster_pallas.py): share of pixels within 1e-4, median
RASTER_WITHIN, RASTER_MEDIAN = 0.995, 1e-6
# the warp's kernel route against its host route: share of equal labels
ROUTES_AGREE = 0.999
# masked CG against its plain version: on [0,255] after the decode, and on
# pinned pixels against the target (the bars of the JAX blend test)
CG_BAR, CG_PINNED_BAR = 0.5, 6e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean ms per call on the card, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn, reps: int) -> float:
    """Mean host ms per call, each ended by torch.cuda.synchronize()."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def median_wall_ms_in_turns(fns: dict, rounds: int) -> dict:
    """Median host ms of each function, each call ended by
    torch.cuda.synchronize(), the functions taken in turns and the order
    reversed every round, so that a drift of the host's speed falls on all
    of them alike."""
    samples = {name: [] for name in fns}
    for name, fn in fns.items():
        fn()                                    # warm-up
    torch.cuda.synchronize()
    for r in range(rounds):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            t0 = time.perf_counter()
            fns[name]()
            torch.cuda.synchronize()
            samples[name].append((time.perf_counter() - t0) * 1e3)
    return {name: float(np.median(v)) for name, v in samples.items()}


def kernel_device_ms(fn, kernel_name: str, reps: int) -> float:
    """Mean ms the card spends in the kernel `kernel_name` per call of `fn`,
    from torch.profiler: the kernel alone, without the host's launch cost
    that CUDA events around a short kernel include."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if kernel_name in e.key]
    count = sum(e.count for e in events)
    # the profiler may drop a record of a microsecond kernel: the mean is
    # taken over the launches it saw, which must be some and no more than
    # were made
    if not 0 < count <= reps:
        raise AssertionError(f'profiler saw {count} launches of '
                             f'{kernel_name}, expected {reps}')
    if count < reps:
        log(f'[profile] {kernel_name}: the profiler kept {count} of {reps} '
            'launches')
    return sum(e.self_device_time_total for e in events) / 1e3 / count


def masked_cg_bound_ms(n: int, c: int, h: int, w: int, iterations: int):
    elems = n * c * h * w
    # b, unk, x0 in; x out
    return bound_ms(4 * elems * 4, CG_FLOPS_PER_ELEMENT * iterations * elems)


def bound_ms(n_bytes: float, flops: float):
    """(least ms the card could take, 'operations' or 'bytes')."""
    ops_s, bytes_s = flops / F32_PEAK_FLOPS, n_bytes / HBM_BYTES_PER_S
    if ops_s >= bytes_s:
        return ops_s * 1e3, 'operations'
    return bytes_s * 1e3, 'bytes'


def raster_uv_work(n_tris: int, counts: np.ndarray, height: int,
                   width: int, max_bin: int):
    """(bytes, float operations) one UV map of these tables needs at least:
    the 14 floats of every triangle row (56 B of the 64 B row; the rest is
    padding), one offset per tile and one more, and the `counts[tile]`
    indices the tile walks read once, the map written once; per pixel every
    triangle binned to its tile tested once (3 edge functions of 6
    operations: 18) and one barycentric UV (3 + 10), plus the identity UV
    (2)."""
    from ctrlhair_tpu_torch.ops.raster_pallas import TILE_H, TILE_W
    if int(counts.max(initial=0)) > max_bin:
        raise AssertionError('a tile holds more indices than its budget')
    n_bytes = (n_tris * 56 + int(counts.sum()) * 4 + (counts.size + 1) * 4
               + height * width * 2 * 4)
    rows = np.minimum(TILE_H, height - np.arange(-(-height // TILE_H))
                      * TILE_H)
    cols = np.minimum(TILE_W, width - np.arange(-(-width // TILE_W))
                      * TILE_W)
    pixels = (rows[:, None] * cols[None, :]).ravel()
    flops = int((pixels * counts).sum()) * 18 + height * width * (13 + 2)
    return int(n_bytes), flops


def ptxas_report(log_text: str) -> dict:
    """{kernel entry: {'registers', 'spill_bytes', 'stack_bytes',
    'smem_bytes'}} from nvcc's `-Xptxas -v` output."""
    report, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            report[name] = {'registers': None, 'spill_bytes': 0,
                            'stack_bytes': 0, 'smem_bytes': 0}
            continue
        if name is None:
            continue
        m = re.search(r'(\d+) bytes stack frame, (\d+) bytes spill stores, '
                      r'(\d+) bytes spill loads', line)
        if m:
            report[name]['stack_bytes'] = int(m.group(1))
            report[name]['spill_bytes'] = int(m.group(2)) + int(m.group(3))
        m = re.search(r'Used (\d+) registers', line)
        if m:
            report[name]['registers'] = int(m.group(1))
            m = re.search(r'(\d+) bytes smem', line)
            if m:
                report[name]['smem_bytes'] = int(m.group(1))
    return report


def kernel_entry(report: dict, *parts: str) -> dict:
    """The one entry of `ptxas_report` whose mangled name holds all of
    `parts`."""
    found = [v for k, v in report.items() if all(p in k for p in parts)]
    if len(found) != 1:
        raise AssertionError(f'{len(found)} ptxas entries match {parts}: '
                             f'{sorted(report)}')
    return found[0]


def phase_build():
    """Build both kernels at once (one nvcc each) and the native host
    library, all from the sources beside this script."""
    from concurrent.futures import ThreadPoolExecutor
    from ctrlhair_tpu_torch.native import NATIVE
    from ctrlhair_tpu_torch.ops.poisson_pallas import MASKED_CG
    from ctrlhair_tpu_torch.ops.raster_pallas import RASTER_UV
    libs = (MASKED_CG, RASTER_UV, NATIVE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:
        paths = list(pool.map(lambda lib: lib.build(), libs))
    log(f'[build] {", ".join(os.path.relpath(p, ROOT) for p in paths)} in '
        f'{time.perf_counter() - t0:.1f} s')
    log(f'[build] host compiler: {" ".join(NATIVE.command())}')
    for kernel in (MASKED_CG, RASTER_UV):
        for line in kernel.build_log().splitlines():
            if 'ptxas info' in line and ('Used' in line or 'spill' in line
                                         or 'Compiling' in line):
                log(f'[build] {line.strip()}')
            elif 'bytes stack frame' in line:
                log(f'[build] {line.strip()}')
    for lib in libs:
        lib.lib()           # load and declare, so a bad build fails here
    cg_report = ptxas_report(MASKED_CG.build_log())
    ptxas = {
        'masked_cg_cluster': kernel_entry(cg_report,
                                          'masked_cg_cluster_kernel'),
        'masked_cg_grid': kernel_entry(cg_report, '16masked_cg_kernel'),
        'raster_uv': kernel_entry(ptxas_report(RASTER_UV.build_log()),
                                  'raster_uv_kernel'),
    }
    for name in ptxas:
        if ptxas[name]['spill_bytes'] != 0 or ptxas[name]['registers'] is None:
            raise AssertionError(f'ptxas: {name} spills or was not reported: '
                                 f'{ptxas[name]}')
    log(f'[build] ptxas: {json.dumps(ptxas)}')
    return ptxas


def make_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """A smooth seeded RGB image (low-frequency noise, uint8)."""
    small = rng.uniform(0, 255, (size // 16, size // 16, 3))
    img = np.kron(small, np.ones((16, 16, 1)))
    img += rng.normal(0, 8, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def with_hair(label: torch.Tensor) -> torch.Tensor:
    """`label` with a hair region painted over its upper middle, as a shape
    edit hands a mask to `output`.  Random weights parse and decode little
    or no hair; without any, the blend would pin no pixel and its CG solve
    would start at its own solution."""
    from ctrlhair_tpu_torch.constants import HAIR_IDX
    s = label.shape[-1]
    out = label.clone()
    out[:, s // 8:s // 2, s // 4:3 * s // 4] = HAIR_IDX
    return out


def session(editor, img_in, img_tg, alphas):
    """The main path as a user drives it: analyze two photos, transfer
    texture and colour, two slider edits, an output per request, one under
    an edited hair mask, one mask refresh and one interpolation sweep.
    Returns (input analysis, edited latent, edited mask, outputs, hair
    pixels the parser found in the input)."""
    from ctrlhair_tpu_torch.constants import HAIR_IDX
    from ctrlhair_tpu_torch.pipeline.latent import (
        apply_direction, semantic_directions, transfer)
    a_in = editor.analyze_image(img_in)
    a_tg = editor.analyze_image(img_tg)
    dev = editor.device
    lat = transfer(a_in['latent'], a_tg['latent'], 'texture')
    lat = transfer(lat, a_tg['latent'], 'color')
    tex_dir = torch.as_tensor(
        semantic_directions(lat.texture.shape[1], 1)[0], device=dev)
    lat_tex = lat.replace(texture=apply_direction(lat.texture, tex_dir, 1.5))
    v_dir = torch.tensor([0.0, 0.0, 1.0], device=dev)
    lat_val = lat_tex.replace(hsv=apply_direction(lat_tex.hsv, v_dir, 200.0))
    face = img_in[None]
    codes, label = a_in['sean_codes'], a_in['label']
    outs = {}
    for name, latent in (('transfer', lat), ('texture', lat_tex),
                         ('value', lat_val)):
        outs[name] = editor.output(codes, latent, face, label,
                                   a_in['regen_label'])
    hair_label = with_hair(a_in['regen_label'])
    outs['hair_mask'] = editor.output(codes, lat_val, face, label,
                                      hair_label)
    outs['refresh'] = editor.output_refresh(codes, lat_val, face, label)[0]
    outs['sweep'] = editor.output_sweep(codes, a_in['latent'], lat_val,
                                        alphas, face, label, hair_label)
    hair_px = int((a_in['label'] == HAIR_IDX).sum())
    return a_in, lat_val, hair_label, outs, hair_px


def relative_residual(b, unk, x, x0) -> float:
    """||b - A x|| / ||b - A x0|| of the masked system A v = lap(v*unk)*unk,
    in float64 with the plain stencil."""
    from ctrlhair_tpu_torch.ops.poisson import laplacian
    b, unk = b.double(), unk.double()

    def norm(v):
        return float(((b - laplacian(v.double() * unk) * unk) * unk).norm())
    return norm(x) / norm(x0)


def check_outputs(editor, a_in, lat, hair_label, outs, face_u8):
    """Every output is uint8 [N,S,S,3].  The request under the edited hair
    mask is solved again through the kernel, in float: its solution must be
    finite and round to the session's output within one step; the CG
    solve must have cut the system's residual at least a hundredfold (the
    plain version reaches ~1e-3 on such images at 200 iterations); and the
    face where it keeps its own gradients may move from the input only by
    the seam correction, a mean of at most 48 steps (~15 on such images)."""
    from ctrlhair_tpu_torch.ops.poisson import blend_system, decode_solution
    from ctrlhair_tpu_torch.ops.poisson_pallas import masked_cg
    s = editor.cfg.edit_size
    for name, out in outs.items():
        if out.dtype != torch.uint8 or out.dim() != 4 or \
                tuple(out.shape[1:]) != (s, s, 3):
            raise AssertionError(f'output {name}: {out.dtype} '
                                 f'{tuple(out.shape)}')
    with torch.inference_mode():
        src, tgt, mask = blend_case(editor, a_in, lat, face_u8, hair_label,
                                    None)
        b, u, x0, fixed, tgt_s, gamma = blend_system(src, tgt, mask)
        x = masked_cg(b, u, x0, editor.cfg.poisson_iterations)
        out_f = decode_solution(x, fixed, tgt_s, gamma)
        got = outs['hair_mask'].float()
        stats = {
            'pinned': int(fixed.sum()),
            'finite': bool(torch.isfinite(x).all()),
            'max_step_vs_session': float(
                (torch.round(out_f) - got).abs().max()),
            'relative_residual': relative_residual(b, u, x, x0),
            'face_mean_abs_diff': float(
                (got - src).abs()[mask != 0].mean()),
        }
    log(f'[session] edited-mask request: {stats}')
    if not (stats['pinned'] > 0 and stats['finite']
            and stats['max_step_vs_session'] <= 1.0
            and stats['relative_residual'] <= 1e-2
            and stats['face_mean_abs_diff'] <= 48.0):
        raise AssertionError(f'edited-mask output fails its checks: {stats}')
    return stats


def phase_reference(cfg_mod, seed):
    """The same tiny float32 sessions, the editor's and the Backend's, on
    the card and on the CPU (plain versions of every kernel): labels and
    images must agree."""
    from ctrlhair_tpu_torch.pipeline.backend import Backend
    from ctrlhair_tpu_torch.pipeline.editor import HairEditor
    cfg = cfg_mod.PipelineConfig(
        sean=cfg_mod.SEANConfig(crop_size=64, ngf=4, zencoder_ngf=4,
                                style_dim=64),
        bisenet=cfg_mod.BiSeNetConfig(input_size=128),
        color_texture=cfg_mod.ColorTextureConfig(style_dim=64),
        shape=cfg_mod.ShapeConfig(img_size=64, layer_num=5, max_channel=64,
                                  hidden_in_channel=8),
        edit_size=64, poisson_iterations=60, compute_dtype='float32')
    gpu = HairEditor(cfg, device='cuda', seed=seed)
    cpu = HairEditor(cfg, device='cpu', seed=seed)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    rng = np.random.default_rng(seed + 1)
    img = make_image(rng, 64)
    img_tg = make_image(rng, 64)
    alphas = np.linspace(0, 1, 3, dtype=np.float32)
    (a_gpu, _, _, out_gpu, _), (a_cpu, _, _, out_cpu, _) = [
        session(ed, img, img_tg, alphas) for ed in (gpu, cpu)]
    label_eq = float((a_gpu['label'].cpu() == a_cpu['label']
                      ).float().mean())
    worst = 1.0
    for name in out_gpu:
        d = (out_gpu[name].cpu().int() - out_cpu[name].int()).abs()
        worst = min(worst, float((d <= 1).float().mean()))
    log(f'[reference] tiny float32 session, card vs CPU: labels equal on '
        f'{label_eq:.5f} of pixels; outputs within 1 step on >= '
        f'{worst:.5f} of pixels')
    # the Backend session: on the card the warp takes the kernel route, on
    # the CPU the plain one
    be_gpu, be_cpu = (Backend(cfg=cfg, editor=ed, seed=seed)
                      for ed in (gpu, cpu))
    alphas8 = np.linspace(0, 1, 8, dtype=np.float32)
    b_gpu = backend_session(be_gpu, img, img_tg, alphas8)[0]
    b_cpu = backend_session(be_cpu, img, img_tg, alphas8)[0]
    warp_eq = float((be_gpu.warp_target.cpu() == be_cpu.warp_target
                     ).float().mean())
    b_worst = 1.0
    for name in b_gpu:
        d = np.abs(b_gpu[name].astype(np.int32) - b_cpu[name])
        b_worst = min(b_worst, float((d <= 1).mean()))
    log(f'[reference] tiny float32 Backend session, card vs CPU: '
        f'warp_target equal on {warp_eq:.5f} of pixels; outputs within 1 '
        f'step on >= {b_worst:.5f} of pixels')
    if min(label_eq, worst, warp_eq, b_worst) < 0.999:
        raise AssertionError('card and CPU runs of the port disagree')
    return {'labels_equal': label_eq, 'within_1_step': worst,
            'backend_warp_equal': warp_eq, 'backend_within_1_step': b_worst}


def centre_block_case(size, rng, device, n=1, width=None):
    """The centre-block case of the JAX package's Pallas blend test, at the
    edit size (or n images of size x width): uniform source and target, the
    target kept in the centre."""
    width = size if width is None else width
    src = torch.as_tensor(rng.uniform(0, 255, (n, size, width, 3)),
                          dtype=torch.float32, device=device)
    tgt = torch.as_tensor(rng.uniform(0, 255, (n, size, width, 3)),
                          dtype=torch.float32, device=device)
    mask = torch.ones((n, size, width), device=device)
    mask[:, size // 4:size * 3 // 4, width // 4:width * 3 // 4] = 0.0
    return src, tgt, mask


def phase_masked_cg(editor, a_in, lat, img_in, hair_label, alphas):
    """K1 against its plain version on the card, float32, on the systems of
    the session's edited-mask request and sweep and on synthetic systems
    that take each route; two launches on one input; then its times.
    Returns the kernel's entry for the kernels line, without the launch
    counts."""
    from ctrlhair_tpu_torch.ops import poisson_pallas as pp
    from ctrlhair_tpu_torch.ops.poisson import blend_system, decode_solution
    dev, s = editor.device, editor.cfg.edit_size
    iters = editor.cfg.poisson_iterations
    plan = pp.cluster_plan(3, s, s)
    if plan is None:
        raise AssertionError(f'no cluster plan for the edit size {s}')
    active = pp.active_clusters(dev.index or 0, plan.threads)
    log(f'[kernel] masked_cg cluster of {pp.CLUSTER_SIZE}: bands of '
        f'{plan.rows} rows, {plan.threads} threads and {plan.smem_bytes} B of '
        f'shared memory a block, {active} clusters at once on this card')
    rng = np.random.default_rng(7)
    with torch.inference_mode():
        cases = {
            'blend_n1': blend_case(editor, a_in, lat, img_in, hair_label,
                                   None),
            'blend_n8': blend_case(editor, a_in, lat, img_in, hair_label,
                                   alphas),
            'centre_block': centre_block_case(s, rng, dev),
            'more_than_clusters': centre_block_case(s, rng, dev,
                                                    n=active + 3),
            'ragged': centre_block_case(40, rng, dev, n=2, width=72),
            'grid_route': centre_block_case(512, rng, dev),
        }
        systems = {k: blend_system(*v) for k, v in cases.items()}
        max_err, routes = 0.0, {}
        for name, (b, u, x0, fixed, tgt_s, gamma) in systems.items():
            want_route = pp.masked_cg_route(*b.shape[1:])
            if (name == 'grid_route') != (want_route == 'grid'):
                raise AssertionError(f'{name} {tuple(b.shape)} would take '
                                     f'the {want_route} route')
            before = dict(pp.ROUTE_LAUNCHES)
            x = pp.masked_cg_cuda(b, u, x0, iters)
            took = [r for r in before
                    if pp.ROUTE_LAUNCHES[r] == before[r] + 1]
            if took != [want_route]:
                raise AssertionError(f'{name}: launched {took}, the shape '
                                     f'says {want_route}')
            routes[name] = want_route
            again = pp.masked_cg_cuda(b, u, x0, iters)
            torch.cuda.synchronize()
            if not torch.equal(x, again):
                raise AssertionError(f'masked_cg {name}: two launches on one '
                                     'input differ')
            got = decode_solution(x, fixed, tgt_s, gamma)
            want = decode_solution(pp.masked_cg_plain(b, u, x0, iters), fixed,
                                   tgt_s, gamma)
            err = float((got - want).abs().max())
            # pinned pixels come back as the target through the gamma
            # encode and decode
            keep = fixed[:, 0]
            tgt_raw = cases[name][1]
            ident = float((got[keep] - tgt_raw[keep]).abs().max()) \
                if keep.any() else 0.0
            log(f'[kernel] masked_cg {name} {tuple(b.shape)} by the '
                f'{want_route} route: max |kernel - plain| {err:.6f} on '
                f'[0,255]; {int(keep.sum())} pinned pixels vs target '
                f'{ident:.2e}; a second launch bit-identical')
            if not (err <= CG_BAR and ident <= CG_PINNED_BAR
                    and torch.isfinite(x).all()):
                raise AssertionError(f'masked_cg disagrees on {name}')
            max_err = max(max_err, err)

        # times: the cluster kernel and the grid kernel, taken in this
        # order within one run
        timed = {}
        for name in ('blend_n1', 'blend_n8'):
            b, u, x0 = systems[name][:3]
            ship = lambda: pp.masked_cg_cuda(b, u, x0, iters)
            t = {
                'ms': cuda_ms(ship, 20),
                'device_ms': kernel_device_ms(
                    ship, 'masked_cg_cluster_kernel', 10),
                'previous_device_ms': kernel_device_ms(
                    lambda: pp.masked_cg_grid_cuda(b, u, x0, iters),
                    'masked_cg_kernel', 10),
                'plain_ms': cuda_ms(
                    lambda: pp.masked_cg_plain(b, u, x0, iters), 3),
            }
            t['bound_ms'], t['bound_by'] = masked_cg_bound_ms(*b.shape,
                                                              iters)
            timed[name] = t
            log(f'[time] masked_cg {name} {tuple(b.shape)}: cluster of '
                f'{pp.CLUSTER_SIZE} {t["ms"]:.4f} ms by CUDA events, '
                f'{t["device_ms"]:.4f} ms on the card by the profiler; '
                f'the grid kernel {t["previous_device_ms"]:.4f} ms '
                f'on the card; plain {t["plain_ms"]:.4f} ms; bound '
                f'{t["bound_ms"]:.6f} ms ({t["bound_by"]})')
        # the yardstick of the dependency chain: one cluster passing 2
        # barriers an iteration and doing nothing else
        probe = 4000
        barrier_us = kernel_device_ms(
            lambda: pp.barrier_probe_cuda(plan.threads, probe, dev),
            'cluster_barrier_probe', 5) * 1e3 / probe
        log(f'[time] one cluster barrier ({pp.CLUSTER_SIZE} blocks of '
            f'{plan.threads} threads): {barrier_us:.4f} us; {2 * iters} of '
            f'them {2 * iters * barrier_us / 1e3:.4f} ms')
    n1, n8 = timed['blend_n1'], timed['blend_n8']
    entry = {
        'max_abs_err': max_err, 'max_abs_vs_plain': max_err,
        'ms': n1['ms'], 'kernel_ms': n1['ms'], 'device_ms': n1['device_ms'],
        'plain_ms': n1['plain_ms'], 'bound_ms': n1['bound_ms'],
        'bound_by': n1['bound_by'], 'bound_us': n1['bound_ms'] * 1e3,
        'library_ms': None,
        'case': {
            'shape': [1, 3, s, s], 'iterations': iters, 'routes': routes,
            'cluster_size': pp.CLUSTER_SIZE, 'active_clusters': active,
            'smem_bytes_per_block': plan.smem_bytes,
            'threads_per_block': plan.threads,
            'previous_device_ms': {'n1': n1['previous_device_ms'],
                                   'n8': n8['previous_device_ms']},
            'barrier_us': barrier_us,
            'barriers_ms': 2 * iters * barrier_us / 1e3,
            'n8': {k: n8[k] for k in ('ms', 'device_ms', 'plain_ms',
                                      'bound_ms')}},
    }
    return entry


def paint_face(size: int, cx: float, cy: float, scale: float,
               device) -> torch.Tensor:
    """A synthetic CelebA-style parse [size,size] int32, painted on
    `device`: background, neck, a hair cap, a skin ellipse, brows, eyes,
    nose and mouth at face-proportional places.  (cx, cy) is the face
    centre and `scale` its size, in fractions of the image."""
    from ctrlhair_tpu_torch.constants import PARSING_LABEL_LIST
    idx = {name: i for i, name in enumerate(PARSING_LABEL_LIST)}
    ys, xs = torch.meshgrid(
        torch.arange(size, dtype=torch.float32, device=device) / size,
        torch.arange(size, dtype=torch.float32, device=device) / size,
        indexing='ij')
    lab = torch.zeros((size, size), dtype=torch.int32, device=device)
    fw, fh = 0.26 * scale, 0.34 * scale

    def ellipse(ex, ey, rx, ry, name):
        lab[((xs - ex) / rx) ** 2 + ((ys - ey) / ry) ** 2 <= 1] = idx[name]

    lab[(ys > cy) & ((xs - cx).abs() < 0.5 * fw)] = idx['neck']
    ellipse(cx, cy - 0.06 * scale, fw * 1.25, fh * 1.15, 'hair')
    ellipse(cx, cy, fw, fh, 'skin_other')
    lab[(ys < cy - 0.24 * scale) & (lab == idx['skin_other'])] = idx['hair']
    ex, ey = 0.45 * fw, cy - 0.30 * fh
    for side, sign in (('l', -1), ('r', 1)):
        ellipse(cx + sign * ex, ey, 0.17 * fw, 0.05 * fh, f'{side}_eye')
        ellipse(cx + sign * ex, ey - 0.14 * fh, 0.22 * fw, 0.02 * fh,
                f'{side}_brow')
    ellipse(cx, cy + 0.05 * fh, 0.13 * fw, 0.22 * fh, 'nose')
    my = cy + 0.55 * fh
    ellipse(cx, my - 0.03 * fh, 0.30 * fw, 0.045 * fh, 'u_lip')
    ellipse(cx, my + 0.03 * fh, 0.30 * fw, 0.045 * fh, 'l_lip')
    ellipse(cx, my, 0.24 * fw, 0.022 * fh, 'mouth')
    return lab


def backend_session(be, img_in, img_tg, alphas):
    """The Backend path as a user drives it: load two photos, move every
    slider, read the sliders back, transfer colour and texture, render;
    transfer the reference photo's hair shape twice (the second from the
    cached landmarks), render after each; sweep; paint a hair mask, render.
    Random weights parse no face, so two painted parses stand in for the
    parser's output in the Backend's cache before the shape transfer.
    Returns (outputs by name, blends made, shape transfers made, the two
    painted parses)."""
    from ctrlhair_tpu_torch.constants import HAIR_IDX
    outs, blends = {}, 0
    be.set_input_img(img_in)
    be.set_target_img(img_tg)
    start = be.cur_latent
    be.change_curliness(0.7)
    for idx, val in enumerate((0.4, -0.8, 1.1, 0.5)):
        be.change_color(val, idx)
    for idx, val in enumerate((0.6, -0.4, 0.3, -0.2)):
        be.change_shape(val, idx)
    for idx, val in enumerate((0.9, -0.5)):
        be.change_texture(val, idx)
    sliders = (be.get_curliness_be2fe(), *be.get_color_be2fe(),
               *be.get_shape_be2fe(), *be.get_texture_be2fe())
    if not np.isfinite(sliders).all():
        raise AssertionError(f'slider read-backs not finite: {sliders}')
    be.transfer_latent_representation('color')
    be.transfer_latent_representation('texture')
    outs['transfer'] = be.output()
    blends += 1

    p = be.cfg.bisenet.input_size
    parse_in = paint_face(p, 0.50, 0.54, 1.0, be.device)
    parse_tg = paint_face(p, 0.42, 0.58, 0.85, be.device)
    be._parse512['input'], be._parse512['target'] = parse_in, parse_tg
    be._lm81['input'] = be._lm81['target'] = None
    be.transfer_latent_representation('shape')
    outs['shape'] = be.output()
    blends += 1
    landmarks = be._lm81['target']
    be.transfer_latent_representation('shape')
    if be._lm81['target'] is not landmarks:
        raise AssertionError('the second shape transfer estimated the '
                             'landmarks again')
    outs['shape_again'] = be.output(be.cur_latent)    # the refresh branch
    blends += 1
    outs['sweep'] = be.interpolation_sweep(start, be.cur_latent, alphas)
    blends += 1
    s = be.cfg.edit_size
    painted = np.zeros((s, s), np.int32)
    painted[s // 8:s // 2, s // 4:3 * s // 4] = HAIR_IDX
    be.directly_change_hair_mask(painted)
    outs['painted'] = be.output()
    blends += 1
    return outs, blends, 2, (parse_in, parse_tg)


def check_backend_session(be, outs, parses):
    """Outputs are finite uint8 [.., S, S, 3] images; the warped composite
    has labels only from the input parse, hair and `unknown`, more than
    1,000 hair pixels at the edit size, and its hair moved from the
    reference photo's place the way the landmarks did."""
    from ctrlhair_tpu_torch.constants import HAIR_IDX, UNKNOWN_LABEL
    s = be.cfg.edit_size
    for name, out in outs.items():
        if not isinstance(out, np.ndarray) or out.dtype != np.uint8 \
                or out.shape[-3:] != (s, s, 3):
            raise AssertionError(f'Backend output {name}: {type(out)} '
                                 f'{getattr(out, "shape", None)}')
    if outs['sweep'].shape[0] != 8:
        raise AssertionError(f'sweep of {outs["sweep"].shape[0]} images')
    parse_in, parse_tg = parses
    wt = be.warp_target
    if wt.device != be.device or tuple(wt.shape) != (s, s):
        raise AssertionError(f'warp_target {wt.device} {tuple(wt.shape)}')
    allowed = set(parse_in.unique().tolist()) | {HAIR_IDX, UNKNOWN_LABEL}
    labels = set(wt.unique().tolist())
    hair = wt == HAIR_IDX
    f = parse_tg.shape[0] // s
    donor = parse_tg[::f, ::f] == HAIR_IDX

    def centroid(mask):
        ys, xs = torch.nonzero(mask, as_tuple=True)
        return np.array([float(xs.float().mean()), float(ys.float().mean())])

    moved = centroid(hair) - centroid(donor)
    lm_shift = (be._lm81['input'] - be._lm81['target']).mean(0) * s
    stats = {'labels': sorted(labels), 'hair_px': int(hair.sum()),
             'unknown_px': int((wt == UNKNOWN_LABEL).sum()),
             'hair_moved_px': moved.tolist(),
             'landmarks_moved_px': lm_shift.tolist()}
    log(f'[backend] warped composite: {stats}')
    # the landmarks move by (+0.08, -0.04) of the image; the hair follows
    # with at least a quarter of that, in the same direction, on each axis
    follows = all(m * l > 0 and abs(m) >= 0.25 * abs(l)
                  for m, l in zip(moved, lm_shift))
    if not (labels <= allowed and stats['hair_px'] > 1000 and follows):
        raise AssertionError(f'warped composite fails its checks: {stats}')
    return stats


def raster_cases(be):
    """(name, verts_dst, tris, uv, size) for the kernel's comparison: the
    Backend session's own warp mesh at parse size + 2 * BG_PAD, the 5-point
    mesh of the JAX package's rasteriser test at 64 px, no triangle, and a
    seeded soup of 900 large triangles at 96 px that puts more than 256 in
    a tile."""
    from ctrlhair_tpu_torch.ops import warp
    p = be.cfg.bisenet.input_size
    big = p + 2 * warp.BG_PAD
    sel = warp.CHOSEN_LANDMARKS
    # the transfer warps the reference (target) photo's hair onto the input
    src = be._lm81['target'].astype(np.float64)[sel] * p + warp.BG_PAD
    dst = be._lm81['input'].astype(np.float64)[sel] * p + warp.BG_PAD
    verts, vdst, tris = warp.build_warp_mesh(src, dst, big, big)
    yield 'session', vdst, tris, verts / big, big
    src = np.array([[16, 16], [48, 16], [16, 48], [48, 48], [32, 32]], float)
    verts, vdst, tris = warp.build_warp_mesh(
        src, src + np.array([3.0, -2.0]), 64, 64, use_arap=False)
    yield 'five_point', vdst, tris, verts / 64, 64
    yield ('empty', np.zeros((3, 2)), np.full((64, 3), -1, np.int32),
           np.zeros((3, 2)), 32)
    rng = np.random.default_rng(3)
    verts = rng.uniform(0, 96, (400, 2))
    yield ('crowded', verts + rng.normal(0, 1.5, verts.shape),
           rng.integers(0, 400, (900, 3)).astype(np.int32), verts / 96, 96)


def phase_raster_kernel(be):
    """K2 against its plain version on the card, float32, then its times on
    the session's mesh.  Returns the kernel's entry for the kernels line
    (without the launch count) and the session's mesh."""
    from ctrlhair_tpu_torch.ops import raster_pallas as rp
    from ctrlhair_tpu_torch.ops import warp
    dev = be.device
    up = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    max_err, entry, mesh, bit_equal = 0.0, {}, None, {}
    for name, vdst, tris, uv, size in raster_cases(be):
        got = rp.rasterize_uv_cuda(vdst, tris, uv, size, size, dev)
        want = warp.rasterize_uv(up(vdst, torch.float32),
                                 up(tris, torch.int64),
                                 up(uv, torch.float32), size, size)
        torch.cuda.synchronize()
        d = (got - want).abs()
        within = float((d < 1e-4).float().mean())
        median, worst = float(d.median()), float(d.max())
        bit_equal[name] = float((d == 0).float().mean())
        tri, uvt = rp.triangle_tables(vdst, tris, uv)
        offsets, indices, gh, gw, max_bin = rp.bin_with_retry(tri, size,
                                                              size)
        counts = np.diff(offsets)
        log(f'[kernel] raster_uv {name} {size}x{size}, {tri.shape[0]} '
            f'triangles, at most {counts.max(initial=0)} in a tile (budget '
            f'{max_bin}): within 1e-4 on {within:.5f} of pixels, bit-equal '
            f'on {bit_equal[name]:.5f}, median {median:.2e}, max '
            f'{worst:.2e}')
        if not (within >= RASTER_WITHIN and median < RASTER_MEDIAN
                and torch.isfinite(got).all()):
            raise AssertionError(f'raster_uv disagrees on {name}')
        if name == 'empty' and worst != 0.0:
            raise AssertionError('raster_uv: the identity UV is not exact')
        if name == 'crowded' and max_bin <= rp.MAX_BIN:
            raise AssertionError('the crowded case stayed within the first '
                                 'triangle budget')
        max_err = max(max_err, worst)
        if name != 'session':
            continue
        mesh = (vdst, tris, uv, size)
        n_bytes, flops = raster_uv_work(tri.shape[0], counts, size, size,
                                        max_bin)
        words = torch.from_numpy(rp.pack_tables(
            rp.triangle_rows(tri, uvt), offsets, indices)).to(dev)
        tabs = rp.unpack_tables(words, tri.shape[0], gh * gw)
        args = (up(vdst, torch.float32), up(tris, torch.int64),
                up(uv, torch.float32), size, size)
        b_ms, b_by = bound_ms(n_bytes, flops)
        resident = rp.resident_blocks(dev)
        empty_ms = kernel_device_ms(lambda: rp.empty_launch_cuda(dev),
                                    'empty_kernel', 20)
        if gh * gw > resident:
            raise AssertionError(f'{gh * gw} tiles do not fit the '
                                 f'{resident} blocks the card holds at once')
        entry = {
            'ms': cuda_ms(lambda: rp.rasterize_binned_cuda(*tabs, size,
                                                           size), 50),
            'device_ms': kernel_device_ms(
                lambda: rp.rasterize_binned_cuda(*tabs, size, size),
                'raster_uv_kernel', 20),
            'plain_ms': cuda_ms(lambda: warp.rasterize_uv(*args), 3),
            'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
            'bound_us': b_ms * 1e3,
            'case': {
                'shape': [size, size, 2], 'triangles': int(tri.shape[0]),
                'max_bin': max_bin, 'bytes': n_bytes, 'flops': flops,
                'indices_binned': int(counts.sum()),
                'mean_triangles_per_tile': float(counts.mean()),
                'max_triangles_per_tile': int(counts.max()),
                'tile': [rp.TILE_H, rp.TILE_W],
                'blocks_launched': gh * gw, 'blocks_resident': resident,
                'empty_kernel_ms': empty_ms,
                'upload_bytes': int(words.numel() * 4)},
        }
        entry['kernel_ms'] = entry['ms']
        log(f'[time] raster_uv {size}x{size}, {tri.shape[0]} triangles, '
            f'{counts.mean():.1f} per {rp.TILE_H}x{rp.TILE_W} tile (max '
            f'{counts.max()}), {gh * gw} blocks of {resident} resident, '
            f'{words.numel() * 4} B uploaded: kernel {entry["ms"]:.4f} ms '
            'per call by CUDA events (the wrapper\'s host cost included), '
            f'{entry["device_ms"]:.4f} ms on the card by the profiler (an '
            f'empty kernel {empty_ms:.5f} ms); plain '
            f'{entry["plain_ms"]:.4f} ms, bound {b_ms:.6f} ms ({b_by})')
    for name in ('session', 'five_point', 'empty'):
        if bit_equal[name] != 1.0:
            raise AssertionError(f'raster_uv {name}: bit-equal to the plain '
                                 f'version on {bit_equal[name]} of pixels')
    entry['case']['bit_equal'] = bit_equal
    entry['max_abs_err'] = entry['max_abs_vs_plain'] = max_err
    return entry, mesh


def phase_warp_routes(be, parses, mesh):
    """The whole warp by the kernel route against the host C++ route on the
    session's parses and landmarks, and the times of its parts."""
    from ctrlhair_tpu_torch.ops import raster_pallas as rp
    from ctrlhair_tpu_torch.ops import warp
    parse_in, parse_tg = parses
    lm_tg, lm_in = be._lm81['target'], be._lm81['input']
    s = be.cfg.edit_size

    def run(route):
        return warp.hair_mask_transfer_warp(parse_tg, parse_in, lm_tg, lm_in,
                                            out_size=s, raster=route)

    before = rp.RASTER_UV.launches
    on_card, on_host = run(None), run('host')
    if rp.RASTER_UV.launches != before + 1:
        raise AssertionError('raster=None on CUDA tensors did not launch the '
                             'kernel exactly once')
    agree = float((on_card == on_host).float().mean())
    same = float((on_card == be.warp_target).float().mean())
    log(f'[backend] warp, kernel route vs host route: labels equal on '
        f'{agree:.5f} of pixels; vs the session\'s warp_target {same:.5f}')
    if agree < ROUTES_AGREE or same != 1.0:
        raise AssertionError('the warp routes disagree')

    vdst, tris, uv, size = mesh
    p = be.cfg.bisenet.input_size
    sel = warp.CHOSEN_LANDMARKS
    src = lm_tg.astype(np.float64)[sel] * p + warp.BG_PAD
    dst = lm_in.astype(np.float64)[sel] * p + warp.BG_PAD

    def bin_mesh():
        tri, _ = rp.triangle_tables(vdst, tris, uv)
        rp.bin_with_retry(tri, size, size)

    # the warp's parts and its two routes, in turns within one run
    times = median_wall_ms_in_turns({
        'warp.mesh_arap_host': lambda: warp.build_warp_mesh(src, dst, size,
                                                            size),
        'warp.binning_host': bin_mesh,
        'warp.kernel_route': lambda: run(None),
        'warp.host_route': lambda: run('host'),
    }, 10)
    times['backend.shape_transfer'] = wall_ms(
        lambda: be.transfer_latent_representation('shape'), 3)
    times['backend.output'] = wall_ms(be.output, 5)
    return {'routes_agree': agree}, times


DEPLOYMENT_REPS = 5
# families shipped in model_trained/ (as the editor names them), and the
# two that are not (their checkpoints are distributed separately)
SHIPPED = {'bisenet', 'ct_gen', 'ct_dis', 'rgb_pred', 'curliness_pred'}
NOT_SHIPPED = {'sean', 'shape'}
# the trained parse of the sample: share of its 256 px label that is hair
# (the JAX package gives 0.28 at 512 px), and the landmark net's presence
HAIR_SHARE_MIN, PRESENCE_MIN = 0.10, 0.9


def float_leaves(tree):
    """Every float array leaf of a decoded checkpoint tree."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from float_leaves(v)
    elif isinstance(tree, np.ndarray) and tree.dtype.kind == 'f':
        yield tree


def module_sum(module) -> float:
    return sum(float(v.double().sum()) for v in module.state_dict().values())


def family_checksums(be, net):
    """Read and decode each shipped checkpoint again (host ms, bytes, leaves)
    and hold the float64 sum of the leaves each family loaded against the
    sum of that family's parameters and statistics on the card (1e-6
    relative).  The landmark net's checkpoint is held against the net."""
    from ctrlhair_tpu_torch.convert.load import family_dirs, pick_variables
    from ctrlhair_tpu_torch.utils import flax_msgpack
    from ctrlhair_tpu_torch.utils.checkpoint import latest_checkpoint_path
    root = os.path.join(ROOT, 'model_trained')
    dirs = {arg[:-len('_dir')]: d for arg, d in family_dirs(root).items()}
    dirs['landmark_net'] = os.path.join(root, 'landmark_net', 'checkpoints')
    family_of = {'color_texture': 'color_texture', 'rgb_predictor': 'rgb_pred',
                 'curliness_predictor': 'curliness_pred',
                 'bisenet': 'bisenet', 'shape': 'shape', 'sean': 'sean'}
    out = {}
    for name, ckpt_dir in sorted(dirs.items()):
        if ckpt_dir is None:
            continue
        path = latest_checkpoint_path(ckpt_dir)
        if path is None:
            raise AssertionError(f'{ckpt_dir}: no checkpoint')
        t0 = time.perf_counter()
        tree = flax_msgpack.read(path)
        read_ms = (time.perf_counter() - t0) * 1e3
        if name == 'landmark_net':
            parts = {'landmark_net': (tree, net)}
        else:
            parts = {fam: (variables, getattr(be.editor, fam)) for fam, variables
                     in pick_variables(family_of[name], tree).items()}
        for fam, (variables, module) in parts.items():
            want = sum(float(a.astype(np.float64).sum())
                       for a in float_leaves(variables))
            got = module_sum(module)
            rel = abs(got - want) / max(abs(want), 1e-30)
            out[fam] = {'file': os.path.relpath(path, ROOT),
                        'bytes': os.path.getsize(path),
                        'leaves': sum(1 for _ in float_leaves(tree)),
                        'read_decode_ms': read_ms, 'sum_file': want,
                        'sum_card': got, 'relative_difference': rel}
            log(f'[deploy] {fam}: {out[fam]["file"]}, {out[fam]["bytes"]} B, '
                f'{out[fam]["leaves"]} leaves, read and decoded in '
                f'{read_ms:.3f} ms on the host; float64 sum {want:.9e} in the '
                f'file, {got:.9e} on the card (relative {rel:.2e})')
            if not rel <= 1e-6:
                raise AssertionError(f'{fam}: the card\'s weights do not sum '
                                     'to the checkpoint\'s')
    return out


def phase_deployment():
    """The deployment session: Backend() as a user starts it builds the
    full-width PipelineConfig() editor on the card and loads model_trained/;
    then a real photo (samples/input.png), its 4x upscale made on the card as
    the raw 1024 px photo, and its mirror image as the reference photo go
    through crop_face, set_input/set_target, get_hair_color, colour,
    texture and shape transfer (twice, the second from the cached
    landmarks), one need_crop=True transfer of the two 1024 px photos, four
    slider moves, two blended outputs and an interpolation sweep of 8.
    Returns (launches of K1 and K2, the session's record)."""
    from ctrlhair_tpu_torch.constants import HAIR_IDX
    from ctrlhair_tpu_torch.ops import landmarks
    from ctrlhair_tpu_torch.ops.poisson_pallas import (
        MASKED_CG, ROUTE_LAUNCHES)
    from ctrlhair_tpu_torch.ops.raster_pallas import RASTER_UV
    from ctrlhair_tpu_torch.ops.resize import resize_bilinear_nhwc
    from ctrlhair_tpu_torch.ops.warp import warp_hair_mask_between_images
    from ctrlhair_tpu_torch.pipeline.backend import Backend
    from ctrlhair_tpu_torch.utils.image import read_rgb

    t0 = time.perf_counter()
    be = Backend()
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    ed = be.editor
    n_params = sum(p.numel() for p in ed.parameters())
    seeded = sorted(NOT_SHIPPED - set(be.loaded_families))
    log(f'[deploy] Backend(): PipelineConfig() editor on {ed.device}, '
        f'{n_params} parameters, built and loaded in {build_ms:.1f} ms; '
        f'loaded {be.loaded_families}; at their seeded initialisation: '
        f'{seeded}')
    if ed.device.type != 'cuda' or set(be.loaded_families) != SHIPPED \
            or seeded != sorted(NOT_SHIPPED):
        raise AssertionError('Backend() did not build on the card and load '
                             f'every shipped family: {be.loaded_families}')

    sample = read_rgb(os.path.join(ROOT, 'samples', 'input.png'))
    up = resize_bilinear_nhwc(torch.as_tensor(sample, dtype=torch.float32,
                                              device=ed.device)[None],
                              (1024, 1024))
    raw = torch.clamp(torch.round(up[0]), 0, 255).to(torch.uint8).cpu(
        ).numpy()
    mirrored = np.ascontiguousarray(sample[:, ::-1])
    raw_mirrored = np.ascontiguousarray(raw[:, ::-1])
    hair_share = float((ed.analyze_image(sample)['label'] == HAIR_IDX
                        ).float().mean())
    s = be.cfg.edit_size

    MASKED_CG.launches = RASTER_UV.launches = 0
    ROUTE_LAUNCHES.update(cluster=0, grid=0)
    crop = be.crop_face(raw)
    be.set_input_img(crop)
    be.set_target_img(mirrored)
    colour = ed.get_hair_color(raw)
    be.transfer_latent_representation('color')
    be.transfer_latent_representation('texture')
    be.transfer_latent_representation('shape')
    cached = be._lm81['target']
    be.transfer_latent_representation('shape')
    if be._lm81['target'] is not cached:
        raise AssertionError('the second shape transfer estimated the '
                             'landmarks again')
    transfers = 2
    warp_1024 = warp_hair_mask_between_images(raw, raw_mirrored, ed,
                                              need_crop=True)
    transfers += 1
    start = be.cur_latent
    be.change_color(0.8, 0)
    be.change_curliness(0.5)
    be.change_shape(0.6, 1)
    be.change_texture(-0.4, 0)
    outs = {'output': be.output(), 'output_refresh': be.output(be.cur_latent),
            'sweep': be.interpolation_sweep(
                start, be.cur_latent, np.linspace(0, 1, 8, dtype=np.float32))}
    blends = 3
    torch.cuda.synchronize()
    launches = {'masked_cg': MASKED_CG.launches,
                'raster_uv': RASTER_UV.launches}
    routes = dict(ROUTE_LAUNCHES)

    presence = {name: landmarks.net_landmarks_81(img, device=ed.device)
                for name, img in (('sample', sample), ('crop', crop),
                                  ('mirrored', mirrored))}
    record = {
        'build_ms': build_ms, 'parameters': n_params,
        'loaded_families': be.loaded_families, 'seeded_families': seeded,
        'hair_share_sample_256': hair_share,
        'hair_share_crop_256': float((be.input_mask == HAIR_IDX).mean()),
        'presence': {k: (None if v is None else v[1])
                     for k, v in presence.items()},
        'hair_colour_rgb': colour.tolist(),
        'warp_need_crop_hair_px': int((warp_1024 == HAIR_IDX).sum()),
        'warp_cached_hair_px': int((be.warp_target == HAIR_IDX).sum()),
        'launches': launches, 'routes': routes,
    }
    log(f'[deploy] session: crop_face, 2 photos, hair colour, colour, '
        f'texture and {transfers} shape transfers (one need_crop=True at '
        f'1024 px), 4 slider moves, {blends} blends (one a sweep of 8): '
        f'{json.dumps(record)}')
    if record['hair_share_sample_256'] < HAIR_SHARE_MIN:
        raise AssertionError('the trained parser labels too little hair')
    if any(v is None or v < PRESENCE_MIN for v in record['presence'].values()):
        raise AssertionError(f'landmark net presence {record["presence"]}')
    if launches != {'masked_cg': blends, 'raster_uv': transfers} or \
            routes != {'cluster': blends, 'grid': 0}:
        raise AssertionError(f'deployment launches {launches} by {routes}, '
                             f'expected {blends} blends by the cluster '
                             f'kernel and {transfers} shape transfers')
    shapes = {'crop': ((s, s, 3), crop), 'output': ((s, s, 3), outs['output']),
              'output_refresh': ((s, s, 3), outs['output_refresh']),
              'sweep': ((8, s, s, 3), outs['sweep'])}
    for name, (shape, img) in shapes.items():
        if not (isinstance(img, np.ndarray) and img.dtype == np.uint8
                and img.shape == shape):
            raise AssertionError(f'deployment {name}: {type(img)} '
                                 f'{getattr(img, "shape", None)}')
    for name, wt in (('need_crop', warp_1024), ('cached', be.warp_target)):
        if tuple(wt.shape) != (s, s) or wt.device != ed.device or \
                int((wt == HAIR_IDX).sum()) == 0:
            raise AssertionError(f'warp {name}: {tuple(wt.shape)}, no hair')
    if not np.isfinite(colour).all() or colour.shape != (3,):
        raise AssertionError(f'hair colour {colour}')

    if landmarks._NET is None:
        raise AssertionError('the landmark net was not loaded')
    record['checksums'] = family_checksums(be, landmarks._NET[0])
    # times, each call ended by torch.cuda.synchronize(), in turns; the
    # host parts of the two slow ones alone: the 1024 px crop (one of the
    # two a need_crop transfer makes) and the net's area resize
    from ctrlhair_tpu_torch.models.landmark_net import preprocess_image
    from ctrlhair_tpu_torch.ops.crop import recreate_aligned_image
    lm68 = landmarks.net_landmarks_81(raw, device=ed.device)[0][:68] * 1024.0
    record['median_ms'] = median_wall_ms_in_turns({
        'crop_face': lambda: be.crop_face(raw),
        'net_landmarks_81': lambda: landmarks.net_landmarks_81(
            raw, device=ed.device),
        'net_area_resize_1024_host': lambda: preprocess_image(raw, 128),
        'warp_need_crop_1024': lambda: warp_hair_mask_between_images(
            raw, raw_mirrored, ed, need_crop=True),
        'crop_1024_host': lambda: recreate_aligned_image(raw, lm68, 1024),
        'backend_output': be.output,
    }, DEPLOYMENT_REPS)
    return launches, record


# --------------------------------------------------------------- serving
# The web script's renders: 11 slider moves, 3 transfers, 3 random draws,
# each one blend; and the bar of the multigrid blend, card against CPU, on
# [0,255].
WEB_RENDERS = 17
MG_BAR = 0.05
WEB_SLIDER_VALUES = (0.7, -0.4, 1.2, 0.5, 0.6, -0.8, 0.9, 1.1, -0.6, 0.3,
                     -1.0)


@functools.lru_cache(maxsize=1)
def http_opener():
    """One urllib opener for every request (building one takes longer
    than a request to the server), with the environment's proxies
    bypassed."""
    import urllib.request
    return urllib.request.build_opener(urllib.request.ProxyHandler({}))


def http(base: str, path: str, payload=None, raw: bytes = None):
    """(status, body) of one GET (no payload) or POST to the local
    server."""
    import urllib.error
    import urllib.request
    data = raw if raw is not None else (
        None if payload is None else json.dumps(payload).encode())
    req = urllib.request.Request(base + path, data=data,
                                 method='GET' if data is None else 'POST')
    try:
        with http_opener().open(req, timeout=600) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def ok(base: str, path: str, payload=None) -> bytes:
    code, body = http(base, path, payload)
    if code != 200:
        raise AssertionError(f'{path} {payload}: HTTP {code} {body[:200]!r}')
    return body


def in_new_thread(fn):
    """fn() on a thread started for it, as a ThreadingHTTPServer runs each
    request."""
    import threading
    out = []
    thread = threading.Thread(target=lambda: out.append(fn()))
    thread.start()
    thread.join()
    if not out:
        raise AssertionError('the call on a new thread raised')
    return out[0]


def reset_launches() -> None:
    from ctrlhair_tpu_torch.ops.poisson_pallas import (
        MASKED_CG, ROUTE_LAUNCHES)
    from ctrlhair_tpu_torch.ops.raster_pallas import RASTER_UV
    torch.cuda.synchronize()
    MASKED_CG.launches = RASTER_UV.launches = 0
    ROUTE_LAUNCHES.update(cluster=0, grid=0)


def read_launches(what: str, masked_cg: int, raster_uv: int) -> dict:
    """The launch counts since reset_launches(); they must be the ones
    given, every masked CG by the cluster kernel."""
    from ctrlhair_tpu_torch.ops.poisson_pallas import (
        MASKED_CG, ROUTE_LAUNCHES)
    from ctrlhair_tpu_torch.ops.raster_pallas import RASTER_UV
    torch.cuda.synchronize()
    got = {'masked_cg': MASKED_CG.launches, 'raster_uv': RASTER_UV.launches}
    routes = dict(ROUTE_LAUNCHES)
    if got != {'masked_cg': masked_cg, 'raster_uv': raster_uv} or \
            routes != {'cluster': masked_cg, 'grid': 0}:
        raise AssertionError(f'{what}: launches {got} by {routes}, expected '
                             f'{masked_cg} masked CG by the cluster kernel '
                             f'and {raster_uv} raster_uv')
    return got


def phase_web(tmp: str, smi: str):
    """The web server as `python -m ctrlhair_tpu_torch.ui.web` builds it
    (ui.web.build_web_editor: Backend() on the card from model_trained/),
    served from a daemon thread on 127.0.0.1 and driven over HTTP: the page,
    both photos, the state, every slider, the three transfers, the three
    random draws, the four images and one bad request of each kind.
    Returns (the WebEditor, its launches, its record)."""
    import threading
    from ctrlhair_tpu_torch.ui import web
    from ctrlhair_tpu_torch.ui.app import SLIDER_SPECS
    from ctrlhair_tpu_torch.utils.image import decode_png, read_rgb, write_rgb
    from ctrlhair_tpu_torch.utils.metrics import ssim
    from ctrlhair_tpu_torch.utils.profiling import benchmark
    sample = os.path.join(ROOT, 'samples', 'input.png')
    mirror = os.path.join(tmp, 'mirror.png')
    write_rgb(mirror, np.ascontiguousarray(read_rgb(sample)[:, ::-1]))
    jpeg = os.path.join(tmp, 'photo.jpg')
    with open(jpeg, 'wb') as f:
        f.write(b'\xff\xd8\xff\xe0\x00\x10JFIF\x00' + bytes(64))

    t0 = time.perf_counter()
    editor = web.build_web_editor()
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    be = editor.backend
    if be.device.type != 'cuda' or set(be.loaded_families) != SHIPPED:
        raise AssertionError('build_web_editor() did not build on the card '
                             f'from model_trained/: {be.loaded_families}')
    server = editor.make_server('127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f'http://127.0.0.1:{server.server_address[1]}'
    try:
        steps = [('page', '/', None, None, 200),
                 ('load_input', '/load', {'path': sample}, None, 200),
                 ('load_target', '/load', {'path': mirror,
                                           'which': 'target'}, None, 200),
                 ('state', '/state', None, None, 200)]
        for (group, _, idx), val in zip(SLIDER_SPECS, WEB_SLIDER_VALUES):
            steps.append((f'slider_{group}_{idx}', '/slider',
                          {'group': group, 'idx': idx, 'value': val}, None,
                          200))
        steps += [(f'{kind}_{arg}', f'/{kind}', {'arg': arg}, None, 200)
                  for kind, args in (('transfer', ('color', 'texture',
                                                   'shape')),
                                     ('random', ('texture', 'shape',
                                                 'curliness')))
                  for arg in args]
        steps += [(f'image_{n}', f'/image/{n}', None, None, 200)
                  for n in ('input', 'mask', 'target', 'output')]
        steps += [('bad_image', '/image/nope', None, None, 404),
                  ('bad_path', '/nope', None, None, 404),
                  ('bad_json', '/slider', None, b'not json', 400),
                  ('bad_route', '/nope', {'arg': 'color'}, None, 404),
                  ('bad_slider', '/slider', {'group': 'color'}, None, 500),
                  ('bad_load', '/load', {'path': jpeg}, None, 500)]
        reset_launches()
        results = {}
        for name, path, payload, raw, want in steps:
            results[name] = http(base, path, payload, raw)
            if results[name][0] != want:
                raise AssertionError(f'web {name}: HTTP {results[name][0]}, '
                                     f'expected {want}: '
                                     f'{results[name][1][:300]!r}')
        launches = read_launches('web script', WEB_RENDERS, 1)
        if b'not a PNG' not in results['bad_load'][1]:
            raise AssertionError(f'/load of a JPEG: {results["bad_load"]}')
        state = json.loads(results['state'][1])
        if len(state['sliders']) != 11 or not np.isfinite(
                list(state['sliders'].values())).all():
            raise AssertionError(f'/state: {state}')
        for n in ('input', 'mask', 'target', 'output'):
            if not np.array_equal(decode_png(results[f'image_{n}'][1]),
                                  editor.images[n]):
                raise AssertionError(f'/image/{n} does not decode to the '
                                     'held array')
        out = editor.images['output']
        s = be.cfg.edit_size
        if out.dtype != np.uint8 or out.shape != (s, s, 3):
            raise AssertionError(f'/image/output: {out.dtype} {out.shape}')
        fresh = be.output()
        same = float(ssim(fresh, out))
        if same != 1.0:
            raise AssertionError(f'ssim of the served output against a fresh '
                                 f'Backend.output(): {same}')
        # round trips, each ended by torch.cuda.synchronize(), medians
        p50 = lambda fn, n: benchmark(fn, iters=n, warmup=1)['p50_s'] * 1e3
        times = {
            'web.slider': p50(lambda: ok(base, '/slider', {
                'group': 'color', 'idx': 0, 'value': 0.5}), 10),
            'web.state': p50(lambda: ok(base, '/state'), 10),
            'web.image_output': p50(lambda: ok(base, '/image/output'), 20),
            'web.transfer_shape': p50(lambda: ok(base, '/transfer', {
                'arg': 'shape'}), 5),
            'web.load_input': p50(lambda: ok(base, '/load', {
                'path': sample}), 5),
        }
        # one render on this thread, on the editor's worker, and on a new
        # thread each time (as the server's handler threads are), with
        # cuDNN on and off: what a cold thread costs, and whose state it is
        on_worker = lambda fn: editor._worker.submit(fn).result()
        times['backend.output'] = p50(be.output, 10)
        times['backend.output_worker_thread'] = p50(
            lambda: on_worker(be.output), 10)
        times['backend.output_new_thread'] = p50(
            lambda: in_new_thread(be.output), 5)
        with torch.backends.cudnn.flags(enabled=False):
            times['backend.output_no_cudnn'] = p50(be.output, 5)
            times['backend.output_new_thread_no_cudnn'] = p50(
                lambda: in_new_thread(be.output), 5)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    record = {'build_ms': build_ms, 'requests': len(steps),
              'renders': WEB_RENDERS, 'launches': launches,
              'state_sliders': state['sliders'], 'ssim_output_vs_fresh': same,
              'png_bytes_output': len(results['image_output'][1]),
              'median_ms': times}
    log(f'[web] build_web_editor() in {build_ms:.1f} ms; {len(steps)} '
        f'requests over HTTP, {WEB_RENDERS} renders: launches {launches}, '
        'all masked CG by the cluster kernel; every PNG decodes to the held '
        f'array; ssim(served output, fresh output) {same}')
    for k, v in times.items():
        what = 'HTTP round trip' if k.startswith('web.') else 'wall'
        log(f'[time] {k}: {v:.3f} ms median {what} ({smi})')
    return editor, launches, record


def phase_curation(be, tmp: str, smi: str):
    """auto_curate('texture') and one render_candidate_grids on the web
    session's Backend, each between reset_launches() and read_launches()."""
    from ctrlhair_tpu_torch.pipeline.direction_finder import (
        TEXTURE_SLOTS, auto_curate, render_candidate_grids)
    from ctrlhair_tpu_torch.utils.image import read_png
    reset_launches()
    t0 = time.perf_counter()
    dirs, report = auto_curate(be, 'texture', n_candidates=3,
                               values=(-1.0, 0.0, 1.0))
    torch.cuda.synchronize()
    curate_ms = (time.perf_counter() - t0) * 1e3
    # 3 candidates x 3 values, then each of the 2 slots re-measured
    curate = read_launches('auto_curate', 15, 0)
    mat = np.stack(dirs).astype(np.float64)
    gram_err = float(np.abs(mat @ mat.T - np.eye(len(dirs))).max())
    if len(dirs) != len(TEXTURE_SLOTS) or gram_err > 1e-4:
        raise AssertionError(f'auto_curate directions: {len(dirs)}, '
                             f'|D D^T - I| {gram_err}')
    reset_launches()
    t0 = time.perf_counter()
    render_candidate_grids(be, 'texture', os.path.join(tmp, 'grids'),
                           n_candidates=2, values=(-1.0, 1.0))
    torch.cuda.synchronize()
    grids_ms = (time.perf_counter() - t0) * 1e3
    grids = read_launches('render_candidate_grids', 4, 0)
    cell = be.cfg.edit_size
    for i in range(2):
        grid = read_png(os.path.join(tmp, 'grids', f'candidate_{i:03d}.png'))
        if grid.shape != (cell + 4, 2 * (cell + 2) + 2, 3):
            raise AssertionError(f'grid {i}: {grid.shape}')
    record = {'auto_curate_ms': curate_ms, 'grids_ms': grids_ms,
              'launches': {'auto_curate': curate, 'grids': grids},
              'gram_error': gram_err,
              'picks': [{k: r[k] for k in ('label', 'candidate', 'slope',
                                           'score')} for r in report]}
    log(f'[curation] auto_curate(texture, 3 candidates, 3 values): '
        f'{curate_ms:.3f} ms, launches {curate}, |D D^T - I| {gram_err:.2e}, '
        f'picks {record["picks"]}; render_candidate_grids(2 x 2): '
        f'{grids_ms:.3f} ms, launches {grids} ({smi})')
    return curate['masked_cg'] + grids['masked_cg'], record


def phase_demo(tmp: str, smi: str):
    """`python -m ctrlhair_tpu_torch.ui.demo --headless` in this process, on
    a Backend() of its own: one blended output written as a PNG."""
    from ctrlhair_tpu_torch.ui import demo
    from ctrlhair_tpu_torch.utils.image import read_png
    out_path = os.path.join(tmp, 'demo.png')
    reset_launches()
    t0 = time.perf_counter()
    out = demo.main(['--headless', out_path, '--input',
                     os.path.join(ROOT, 'samples', 'input.png'),
                     '--target', os.path.join(tmp, 'mirror.png')])
    torch.cuda.synchronize()
    demo_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches('demo', 1, 0)
    written = read_png(out_path)
    if written.shape != (256, 256, 3) or not np.array_equal(written, out):
        raise AssertionError(f'demo wrote {written.shape}')
    log(f'[demo] --headless: {demo_ms:.3f} ms in this process, Backend() '
        f'build included; launches {launches}; wrote a 256x256 PNG ({smi})')
    return launches, {'wall_ms': demo_ms, 'launches': launches}


def phase_multigrid(case, blend_ms: float, smi: str):
    """poisson_blend(method='mg') on the editor session's blend system (the
    request under the edited hair mask) on the card against the same call
    on the CPU; its distance from K1's solution of that system."""
    from ctrlhair_tpu_torch.ops.poisson import poisson_blend
    from ctrlhair_tpu_torch.ops.poisson_pallas import MASKED_CG
    from ctrlhair_tpu_torch.utils.metrics import ssim
    src, tgt, mask = (t[0] for t in case)
    before = MASKED_CG.launches
    card = poisson_blend(src, tgt, mask, method='mg')
    torch.cuda.synchronize()
    if MASKED_CG.launches != before:
        raise AssertionError('the multigrid blend launched the masked CG')
    cpu = poisson_blend(src.cpu(), tgt.cpu(), mask.cpu(), method='mg')
    k1 = poisson_blend(src, tgt, mask, iterations=200)
    vs_cpu = float((card.cpu() - cpu).abs().max())
    diff = (card - k1).abs()
    rec = {'shape': list(card.shape), 'max_vs_cpu': vs_cpu,
           'max_vs_k1': float(diff.max()), 'mean_vs_k1': float(diff.mean()),
           'ssim_vs_k1': float(ssim(card, k1)),
           'finite': bool(torch.isfinite(card).all()),
           'mg_ms': wall_ms(lambda: poisson_blend(src, tgt, mask,
                                                  method='mg'), 5),
           'cg_200_ms': wall_ms(lambda: poisson_blend(src, tgt, mask,
                                                      iterations=200), 5),
           'output_blend_ms': blend_ms}
    log(f'[multigrid] 10 V-cycles on {tuple(card.shape)}: card vs CPU max '
        f'{vs_cpu:.6f} (bar {MG_BAR}); vs K1 (200 CG iterations) max '
        f'{rec["max_vs_k1"]:.4f} mean {rec["mean_vs_k1"]:.4f} ssim '
        f'{rec["ssim_vs_k1"]:.6f}; {rec["mg_ms"]:.3f} ms wall against '
        f'{rec["cg_200_ms"]:.3f} ms for poisson_blend by K1 and '
        f'{blend_ms:.3f} ms for output.blend ({smi})')
    if not (rec['finite'] and vs_cpu <= MG_BAR):
        raise AssertionError(f'multigrid blend: {rec}')
    return rec


def phase_serving(mg_case, blend_ms: float, smi: str):
    """The serving surface: the web server over HTTP, curation on its
    session, then (the web session freed) the headless demo on a Backend of
    its own, then the multigrid blend.  Returns (launches by path, record)."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        editor, web_launches, web_rec = phase_web(tmp, smi)
        cur_launches, cur_rec = phase_curation(editor.backend, tmp, smi)
        editor.close()
        del editor
        gc.collect()
        torch.cuda.empty_cache()
        demo_launches, demo_rec = phase_demo(tmp, smi)
        gc.collect()
        torch.cuda.empty_cache()
    mg_rec = phase_multigrid(mg_case, blend_ms, smi)
    launches = {
        'masked_cg': {'web': web_launches['masked_cg'],
                      'curation': cur_launches,
                      'demo': demo_launches['masked_cg']},
        'raster_uv': {'web': web_launches['raster_uv'], 'curation': 0,
                      'demo': demo_launches['raster_uv']}}
    return launches, {'web': web_rec, 'curation': cur_rec, 'demo': demo_rec,
                      'multigrid': mg_rec}


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ctrlhair_tpu_torch import config as cfg_mod
    from ctrlhair_tpu_torch.ops.poisson_pallas import (
        MASKED_CG, ROUTE_LAUNCHES)
    from ctrlhair_tpu_torch.ops.raster_pallas import RASTER_UV
    from ctrlhair_tpu_torch.pipeline.backend import Backend
    from ctrlhair_tpu_torch.pipeline.editor import HairEditor

    t_start = time.perf_counter()
    log(f'[env] torch {torch.__version__} cuda {torch.version.cuda} '
        f'device {torch.cuda.get_device_name(0)} '
        f'count {torch.cuda.device_count()}')

    # 1. build
    ptxas = phase_build()

    # 2. full float32 arithmetic for every comparison below
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log('[tf32] torch.backends.cudnn.allow_tf32 = False, '
        'torch.backends.cuda.matmul.allow_tf32 = False')

    # 3. the full-width editor
    cfg = cfg_mod.PipelineConfig()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    editor = HairEditor(cfg, device='cuda', seed=SEED)
    editor.load_style_fallback(STYLE_DIR)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in editor.parameters())
    log(f'[editor] PipelineConfig() compute_dtype={cfg.compute_dtype} '
        f'edit_size={cfg.edit_size} parse={cfg.bisenet.input_size} '
        f'poisson_iterations={cfg.poisson_iterations}: {n_params} '
        f'parameters, built in {time.perf_counter() - t0:.1f} s, '
        f'max_memory_allocated {torch.cuda.max_memory_allocated()} B')
    if float(editor.style_fallback.abs().sum()) == 0:
        raise AssertionError('no median style code was loaded')

    # 4. a session on the main path, the launch counts read around it
    rng = np.random.default_rng(SEED)
    s = cfg.edit_size
    img_in = make_image(rng, s)         # parsed at 512 after a resize
    img_tg = make_image(rng, s)
    alphas = np.linspace(0.0, 1.0, 8, dtype=np.float32)
    MASKED_CG.launches = RASTER_UV.launches = 0
    ROUTE_LAUNCHES.update(cluster=0, grid=0)
    with torch.inference_mode():
        a_in, lat, hair_label, outs, hair_px = session(
            editor, img_in, img_tg, alphas)
    torch.cuda.synchronize()
    launches = MASKED_CG.launches
    raster_launches = RASTER_UV.launches
    if ROUTE_LAUNCHES != {'cluster': launches, 'grid': 0}:
        raise AssertionError('the editor\'s session did not take the cluster '
                             f'route on every blend: {ROUTE_LAUNCHES}')
    log(f'[session] 2 analyses, 4 outputs, 1 refresh, 1 sweep of '
        f'{len(alphas)}: masked_cg launches {launches}, raster_uv launches '
        f'{raster_launches}; hair pixels in the input label {hair_px}')
    if launches != 6:
        raise AssertionError(f'masked_cg launched {launches} times on the '
                             'main path, expected 6 (one per blend)')
    if raster_launches != 0:
        raise AssertionError(f'raster_uv launched {raster_launches} times '
                             'on the editor\'s path, which warps nothing')
    session_check = check_outputs(editor, a_in, lat, hair_label, outs,
                                  img_in)
    reference = phase_reference(cfg_mod, SEED)

    # 4b. the Backend session on the same editor, the launch counts of both
    # kernels set to 0 before it and read after it
    backend = Backend(cfg=cfg, editor=editor, seed=SEED,
                      trained_root=os.path.join(ROOT, 'model_trained'))
    log(f'[backend] Backend(editor, trained_root=model_trained): loaded '
        f'{backend.loaded_families}, HSV table of '
        f'{backend.dist_translation.n} rows, {len(backend.shape_dirs)} shape '
        f'and {len(backend.texture_dirs)} texture directions')
    log('[backend] the synthetic photos hold no face: two synthetic '
        f'{cfg.bisenet.input_size} px label maps (skin, brows, eyes, nose, '
        'mouth, neck, hair cap; the reference photo\'s face shifted and '
        'scaled) are painted on the card and put into the Backend\'s '
        'cached parses before the shape transfer')
    MASKED_CG.launches = RASTER_UV.launches = 0
    ROUTE_LAUNCHES.update(cluster=0, grid=0)
    b_outs, blends, transfers, parses = backend_session(
        backend, img_in, img_tg, alphas)
    torch.cuda.synchronize()
    b_launches = {'masked_cg': MASKED_CG.launches,
                  'raster_uv': RASTER_UV.launches}
    if ROUTE_LAUNCHES != {'cluster': b_launches['masked_cg'], 'grid': 0}:
        raise AssertionError('the Backend session did not take the cluster '
                             f'route on every blend: {ROUTE_LAUNCHES}')
    log(f'[backend] session: 2 photos, 11 slider moves, colour, texture and '
        f'{transfers} shape transfers, {blends} blends (one a sweep of '
        f'{len(alphas)}): launches {b_launches}')
    if b_launches != {'masked_cg': blends, 'raster_uv': transfers}:
        raise AssertionError(f'Backend session launched {b_launches}, '
                             f'expected {blends} blends and {transfers} '
                             'shape transfers')
    warp_check = check_backend_session(backend, b_outs, parses)

    # 5. K1 against its plain version and its times; 5b. K2 against its
    # plain version, and the warp's two routes
    cg_entry = phase_masked_cg(editor, a_in, lat, img_in,
                                         hair_label, alphas)
    raster_entry, mesh = phase_raster_kernel(backend)
    routes_check, backend_ms = phase_warp_routes(backend, parses, mesh)

    # 6. stage timings
    with torch.inference_mode():
        face = img_in[None]
        codes, label, regen = (a_in['sean_codes'], a_in['label'],
                               hair_label)
        stage_ms = {
            'analyze_image': wall_ms(lambda: editor.analyze_image(img_in), 5),
            'output': wall_ms(lambda: editor.output(
                codes, lat, face, label, regen), 5),
            'output_sweep_8': wall_ms(lambda: editor.output_sweep(
                codes, a_in['latent'], lat, alphas, face, label, regen), 3),
        }
        # the two halves of one output: render, then blend (K1 inside)
        face_t = torch.as_tensor(face, device=editor.device)
        gen = editor._edit_render(codes, regen, lat)
        stage_ms['output.render'] = wall_ms(
            lambda: editor._edit_render(codes, regen, lat), 5)
        stage_ms['output.blend'] = wall_ms(
            lambda: editor._blend(face_t, gen, label, regen), 5)
        # the blend system of the request under the edited hair mask, kept
        # for the multigrid blend after this editor is freed
        mg_case = blend_case(editor, a_in, lat, img_in, hair_label, None)
    stage_ms.update(backend_ms)
    for k, v in stage_ms.items():
        log(f'[time] {k}: {v:.3f} ms wall')
    profile = profile_output(editor, codes, lat, face, label, regen)
    log(f'[profile] one output: {profile["wall_ms"]:.3f} ms wall, '
        f'{profile["device_ms"]:.3f} ms in {profile["launches"]} kernel '
        'launches on the card; top: '
        + ', '.join(f'{n} {ms:.3f} ms' for n, ms in profile['top']))

    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()

    # 7. the deployment session, on an editor of its own: the first one is
    # freed, the launch counts set to 0 before the session and read after it
    del editor, backend, a_in, lat, hair_label, outs, b_outs, parses, mesh
    del codes, label, regen, face, face_t, gen
    gc.collect()
    torch.cuda.empty_cache()
    d_launches, deployment = phase_deployment()
    log(f'[time] deployment Backend() build and load: '
        f'{deployment["build_ms"]:.3f} ms wall, one build ({smi})')
    for k, v in deployment['median_ms'].items():
        log(f'[time] deployment {k}: {v:.3f} ms median wall of '
            f'{DEPLOYMENT_REPS} ({smi})')
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the serving surface: web server, curation, demo, multigrid
    s_launches, serving = phase_serving(mg_case, stage_ms['output.blend'],
                                        smi)
    cg_entry['case']['ptxas'] = {k: v for k, v in ptxas.items()
                                 if k.startswith('masked_cg')}
    raster_entry['case']['ptxas'] = ptxas['raster_uv']
    kernels = [{
        'name': 'masked_cg', 'route': 'cuda',
        'source': 'ctrlhair_tpu_torch/csrc/masked_cg.cu',
        'replaces': 'ctrlhair_tpu/ops/poisson_pallas.py:33',
        'launches': launches + b_launches['masked_cg']
        + d_launches['masked_cg'] + sum(s_launches['masked_cg'].values()),
        'launches_by_path': {'editor': launches,
                             'backend': b_launches['masked_cg'],
                             'deployment': d_launches['masked_cg'],
                             **s_launches['masked_cg']},
        **cg_entry,
    }, {
        'name': 'raster_uv', 'route': 'cuda',
        'source': 'ctrlhair_tpu_torch/csrc/raster_uv.cu',
        'replaces': 'ctrlhair_tpu/ops/raster_pallas.py:146',
        'launches': raster_launches + b_launches['raster_uv']
        + d_launches['raster_uv'] + sum(s_launches['raster_uv'].values()),
        'launches_by_path': {'editor': raster_launches,
                             'backend': b_launches['raster_uv'],
                             'deployment': d_launches['raster_uv'],
                             **s_launches['raster_uv']},
        **raster_entry,
    }]
    if set(kernels[0]) != set(kernels[1]):
        raise AssertionError('the kernels line gives the two kernels '
                             'different keys: '
                             f'{set(kernels[0]) ^ set(kernels[1])}')
    log(json.dumps({'kernels': kernels}))
    log(json.dumps({'slice': {
        'config': 'PipelineConfig()', 'compute_dtype': cfg.compute_dtype,
        'parameters': n_params,
        'max_memory_allocated': torch.cuda.max_memory_allocated(),
        'stage_ms': stage_ms, 'profile': profile,
        'session_check': session_check, 'reference': reference,
        'backend_check': {**warp_check, **routes_check},
        'deployment': deployment, 'serving': serving,
        'seconds': time.perf_counter() - t_start}}))
    log(smi)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def profile_output(editor, codes, lat, face, label, regen):
    """torch.profiler over one warm `output`: host wall time, the summed
    device time of its kernels, and the five kernels that take longest."""
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        editor.output(codes, lat, face, label, regen)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            editor.output(codes, lat, face, label, regen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages() if e.self_device_time_total > 0]
    events.sort(key=lambda kv: -kv[1])
    return {'wall_ms': wall, 'device_ms': sum(ms for _, ms, _ in events),
            'launches': sum(c for _, _, c in events),
            'top': [(name[:60], ms) for name, ms, _ in events[:5]]}


def blend_case(editor, a, latent, face_u8, target_label, alphas):
    """(source, target, mask) of a real _blend call of the session: one
    output under `target_label` (alphas None) or the interpolation sweep
    over `alphas`."""
    from ctrlhair_tpu_torch.pipeline.latent import interpolate
    face = torch.as_tensor(face_u8, device=editor.device)[None]
    codes, label, target = a['sean_codes'], a['label'], target_label
    if alphas is not None:
        n = len(alphas)
        al = torch.as_tensor(alphas, device=editor.device)[:, None]
        bcast = lambda t: t.expand((n,) + tuple(t.shape[1:]))
        latent = interpolate(a['latent'], latent, al).map(bcast)
        face, codes, label, target = map(bcast,
                                         (face, codes, label, target))
    gen = editor._edit_render(codes, target, latent)
    return editor._blend_inputs(face, gen, label, target)


if __name__ == '__main__':
    sys.exit(main())
