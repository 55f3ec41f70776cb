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
     blend on the card against the CPU;
  5. the training slice, its launch counts set to 0 before it and read
     after it: (d) generate_warp_pool(count=24, num_threads=4) on cuda:0
     over 12 painted 512 px parses, one K2 launch a warp, each pool mask
     held to the same pair through the host route, then ShapeDataset
     batches from the pool; (e) the shape trainer at ShapeConfig() with the
     soak's recipe (kl_free_bits 0.25, lambda_geo 30, lambda_info 1), batch
     4 from the pool; (a) the colour/texture trainer at ColorTextureConfig()
     (batch 128) with a frozen seeded SEANConfig() SEAN and lambda_rec_img
     on from step 0; (b) both predictor trainers at their configs (batch
     256); (f) the face parser at BiSeNetConfig() (batch 16); (g) the
     landmark regressor at LandmarkNetConfig() (batch 64 from the port's
     renderer); five steps each, each held to the port's CPU step from the
     same state, batch and draws (the shape, face-parser and landmark steps
     on the batch's first two samples, in float64, and their float32 steps
     against the CPU's float64 one), to a NaN batch that must leave the
     state bit-identical, and to a save after step 2 whose resume must equal
     the unbroken run bit for bit; then (c) run_color_texture.main([--synthetic,
     --steps 3]) and (h) run_shape.main on the pool, run_bisenet.main
     --synthetic and run_landmark.main, 3 steps each, in this process, each
     checkpoint read back by the port's reader, the landmark one loaded by
     load_landmark_net; (i) the SEAN trainer at SEANConfig() (crop 256, ngf
     64, style 512, syncbatch, spectral norm) against the default two-scale
     PatchGAN and a seeded random VGG19, batch 4, five steps timed at full
     width, held at crop 64 to the CPU step (float64, and the float32
     step against it), to a NaN batch (weights
     bit-identical, the u vectors one power iteration on) and to a resume,
     then run_sean.main on cuda:0, 3 steps; (j) a validation
     canvas (the transfer matrix of samples/input.png and its mirror image)
     and a data-prep pass over a folder made from them (crop, parse, SEAN
     codes, colour statistics, median codes, landmarks) on Backend()'s
     editor;
  6. data parallelism, phase (k), its launch counts set to 0 before it and
     read after it: (k1) a one-rank NCCL group in this process, the
     colour/texture, shape, face-parser and SEAN trainers of the training
     phase at their configs and batches, two steps through the group held
     bit-equal to two plain steps, then timed against them, the gradient
     reduce alone by CUDA events; (k2) the face parser at 32 px on two
     gloo ranks on cuda:0 against one process on the global batch; (k3)
     run_bisenet under python -m torch.distributed.run --nproc_per_node 1,
     resumed in this process;
  7. tensor parallelism, phase (l), its launch counts set to 0 before it
     and read after it: two gloo ranks on cuda:0 as make_mesh(2, tp=2)
     (dp 1), the shape trainer of (e) on its first batches and the
     colour/texture trainer at ColorTextureConfig() (batch 128,
     lambda_rec_img off), each generator and discriminator sharded as
     JAX's dry run shards them; two steps held to one process on the
     card (in float64), the ranks' gathered trees bit-identical, a NaN
     batch and a resume after step 1 bit-identical on both ranks; the bytes of trained
     parameters a rank holds, collectives a step, tp against plain step ms
     and each rank's peak memory.
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

import copy
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
    # the profiler may drop records of a microsecond kernel, once all of a
    # capture's (seen on the H100): a capture that kept none is taken again,
    # twice at most; the mean is taken over the launches it saw, which must
    # be some and no more than were made
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if kernel_name in e.key]
        count = sum(e.count for e in events)
        if count:
            break
        log(f'[profile] {kernel_name}: the profiler kept no launch of '
            f'{reps}; capture {attempt + 2} of 3')
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
        if b'JPEG: no marker' not in results['bad_load'][1]:
            raise AssertionError(f'/load of a broken JPEG: '
                                 f'{results["bad_load"]}')
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


# ------------------------------------------------------------- training
TRAIN_STEPS = 5
CT_BATCH, PREDICTOR_BATCH = 128, 256
# card against the port's CPU step, float32 with TF32 off: every loss and
# every leaf of the state within this much of the CPU's, scaled by the
# larger of 1 and the leaf's largest magnitude (cuBLAS / cuDNN and the
# CPU's BLAS sum in other orders)
TRAIN_CARD_BAR = 1e-4
# the card's float32 step, as the trainers train, against the CPU's float64
# step of the held check: within this much, as held_to_cpu measures it.
# The bar of tests/test_torch_cuda.py, which sets it between the float32
# readings and those of the same steps with TF32 on (cuDNN's and cuBLAS's
# 10-bit products) and holds TF32 outside it (readings in PERF.md)
FLOAT32_CARD_BAR = 5e-3


def cudnn_flags(**flags):
    """A decorator: fn run with the given torch.backends.cudnn flags set,
    and the old values restored after it."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            saved = {k: getattr(torch.backends.cudnn, k) for k in flags}
            for k, v in flags.items():
                setattr(torch.backends.cudnn, k, v)
            try:
                return fn(*args, **kwargs)
            finally:
                for k, v in saved.items():
                    setattr(torch.backends.cudnn, k, v)
        return run
    return wrap


# cuDNN held to deterministic algorithms, so that two runs of the same steps
# (the resume check) can agree bit for bit
deterministic = cudnn_flags(deterministic=True)
# cudnn.benchmark on (cuDNN times its algorithms for each new shape and
# keeps the fastest): a reading of what the convolutions could cost, not a
# setting of any path
autotuned = cudnn_flags(benchmark=True)


def profile_step(fn, step_ms: float) -> dict:
    """torch.profiler over one warm call: the summed device ms of the
    kernels it launched and their count (kernel records only: operator
    records carry their kernels' time too, and CUPTI's own buffer records
    are no kernels), the five longest, and the card's idle share of a step
    of `step_ms` (the unprofiled median: the profiler slows the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [(e.key, e.self_device_time_total / 1e3, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0
              and not e.key.startswith(('Activity Buffer', 'Buffer Flush'))]
    events.sort(key=lambda kv: -kv[1])
    device = sum(ms for _, ms, _ in events)
    return {'device_ms': device, 'launches': sum(c for _, _, c in events),
            'step_ms': step_ms, 'idle_share': max(0.0, 1.0 - device / step_ms),
            'top': [(name[:60], ms) for name, ms, _ in events[:5]]}


def tree_leaves(tree, prefix=()):
    """(path, array) of every leaf; a dict keyed by path tuples (as
    card_against_cpu rebuilds one) is walked as the tree it flattens."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            key = k if isinstance(k, tuple) else (k,)
            yield from tree_leaves(tree[k], prefix + key)
    elif tree is not None:
        yield prefix, np.asarray(tree)


def tree_diff(got, ref) -> tuple:
    """(worst scaled difference, its leaf) between two state trees of the
    same keys."""
    g, r = list(tree_leaves(got)), list(tree_leaves(ref))
    if [p for p, _ in g] != [p for p, _ in r]:
        raise AssertionError('state trees differ in their keys')
    worst, where = 0.0, None
    for (path, a), (_, b) in zip(g, r):
        if b.size == 0:
            continue
        if a.shape != b.shape:
            raise AssertionError(f'{"/".join(path)}: shape {a.shape} '
                                 f'against {b.shape}')
        d = float(np.abs(a.astype(np.float64) - b).max()) / max(
            1.0, float(np.abs(b).max()))
        if not d <= worst:
            worst, where = d, '/'.join(path)
    return worst, where


def bit_equal(got, ref) -> bool:
    g, r = list(tree_leaves(got)), list(tree_leaves(ref))
    return [p for p, _ in g] == [p for p, _ in r] and all(
        a.shape == b.shape and np.array_equal(a, b, equal_nan=False)
        for (_, a), (_, b) in zip(g, r))


def without_step(tree):
    return {k: v for k, v in tree.items() if k != 'step'}


def to_device(batch, device):
    return {k: v.to(device) for k, v in batch.items()}


def train_steps(step_fn, state, batches, draws_fn=None):
    """Run steps on the given batches; returns (state, metrics of the last,
    per-step host ms, each ended by torch.cuda.synchronize())."""
    times, metrics = [], None
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, metrics, times


def check_metrics(metrics, ref, what, gate: bool = True,
                  bar: float = TRAIN_CARD_BAR):
    worst = 0.0
    for k, v in ref.items():
        a, b = float(metrics[k]), float(v)
        if k == 'finite':
            if a != b:
                raise AssertionError(f'{what}: finite {a} against {b}')
            continue
        worst = max(worst, abs(a - b) / max(1.0, abs(b)))
    if gate and not worst <= bar:
        raise AssertionError(f'{what}: a loss differs by {worst:.3g} '
                             f'(bar {bar})')
    return worst


def ill_conditioned(card, cpu, part: str) -> dict:
    """{parameter path: mask} of the entries of one ModelOpt whose first
    gradient the two devices do not reproduce to 1% (mu is 0.5 g after the
    first step): rounding noise.  Adam divides a gradient by its own
    magnitude, so such an entry moves by about +-lr whichever sign the
    noise has.  The biases a batch-statistics BatchNorm cancels, and a
    WGAN critic's bias of a unit whose slope is the same on every sample,
    have a true gradient of zero and are such entries."""
    mus = [dict(tree_leaves(t[part]['opt_state']['0']['mu']))
           for t in (card, cpu)]
    return {path: np.abs(mus[0][path] - a) > 1e-2 * np.abs(a)
            for path, a in mus[1].items()}


def trained_modules(state) -> list:
    """The modules a train state trains: a GAN state's three parts or the
    one model of the others."""
    parts = state.parts().values() if hasattr(state, 'parts') \
        else [state.model]
    return [part.module for part in parts]


def one_step(make_trainer, init_tree, batch, draws, device, dtype=None):
    """(state tree, metrics) after one step on `device` from `init_tree`,
    the models computing in `dtype` (None: as built); `draws` None for a
    trainer whose step draws nothing."""
    from ctrlhair_tpu_torch.models.layers import set_compute_dtype
    trainer, state, args = make_trainer(device)
    state.load_tree(init_tree)
    if dtype is not None:
        frozen = [m for m in (getattr(trainer, 'vgg', None),) if m is not None]
        for module in trained_modules(state) + frozen:
            set_compute_dtype(module, dtype)
    b = to_device(batch, device)
    extra = () if draws is None else ({
        k: ([m.to(device) for m in v] if isinstance(v, list)
            else v.to(device)) for k, v in draws.items()},)
    state, metrics = trainer.train_step(state, b, *args(state), *extra)
    return state.to_tree(), {k: v.cpu() for k, v in metrics.items()}


def held_to_cpu(card, card_m, cpu, cpu_m, init_tree, lr: dict,
                gate: bool = True, bar: float = TRAIN_CARD_BAR) -> dict:
    """Every loss and every leaf of the card's state within `bar` of the
    CPU's (scaled by the leaf's magnitude), the gradients (Adam's
    mu) included; the parameter entries whose gradient is rounding noise
    (ill_conditioned) are held instead to a move of at most 2 lr on both
    devices.  `lr`: {part: learning rate} of the Adam-trained parts.  With
    gate=False the differences are measured and nothing raises."""
    loss_err = check_metrics(card_m, cpu_m, 'card against CPU', gate, bar)
    noisy = 0
    for part, part_lr in lr.items():
        masks = ill_conditioned(card, cpu, part)
        init = dict(tree_leaves(init_tree[part]['params']))
        sides = [dict(tree_leaves(t[part]['params'])) for t in (card, cpu)]
        for path, mask in masks.items():
            for side in sides:
                moved = np.abs(side[path] - init[path])[mask]
                if gate and moved.size and moved.max() > 2 * part_lr:
                    raise AssertionError(
                        f'{part}/{"/".join(path)}: an entry with a noise '
                        f'gradient moved {moved.max():.3g} > 2 lr')
                side[path] = np.where(mask, 0.0, side[path])
            noisy += int(mask.sum())
        for t, side in zip((card, cpu), sides):
            t[part]['params'] = side
    err, where = tree_diff(card, cpu)
    if gate and not err <= bar:
        raise AssertionError(f'card against CPU: {where} differs by '
                             f'{err:.3g} (bar {bar})')
    return {'state_max_scaled_err': err, 'worst_leaf': where,
            'loss_max_scaled_err': loss_err,
            'noise_gradient_entries': noisy}


def card_against_cpu(make_trainer, init_tree, batch, draws, lr: dict,
                     dtype=None, float32: bool = False):
    """One step on the card against the port's CPU step from the same
    state, batch and draws, both computing in `dtype` (None: as built),
    held as held_to_cpu says.  With `float32`, the card's step as built
    (float32) is held against that CPU step to FLOAT32_CARD_BAR under
    'float32'."""
    cpu = {}

    def cpu_step(dt):
        if dt not in cpu:
            cpu[dt] = one_step(make_trainer, init_tree, batch, draws, 'cpu',
                               dt)
        tree, metrics = cpu[dt]
        return copy.deepcopy(tree), metrics

    card, card_m = one_step(make_trainer, init_tree, batch, draws, 'cuda',
                            dtype)
    out = held_to_cpu(card, card_m, *cpu_step(dtype), init_tree, lr)
    if float32:
        card, card_m = one_step(make_trainer, init_tree, batch, draws,
                                'cuda', None)
        out['float32'] = held_to_cpu(card, card_m, *cpu_step(dtype),
                                     init_tree, lr, bar=FLOAT32_CARD_BAR)
    return out


def nan_and_resume(make_trainer, init_tree, batches, nan_batch,
                   moved=None):
    """A NaN batch leaves the state bit-identical (its step aside); a save
    after step 2 and a resume to the end equal the unbroken run bit for
    bit.  `moved(before, after)`: for a state that a NaN step rightly
    moves in part (the SEAN trainer's u vectors), checks those leaves and
    returns their keys, which the bit identity leaves out."""
    import tempfile
    from ctrlhair_tpu_torch.utils.checkpoint import (
        load_checkpoint, save_checkpoint)
    trainer, state, args = make_trainer('cuda')
    state.load_tree(init_tree)
    for b in batches:
        state, _ = trainer.train_step(state, b, *args(state))
    unbroken = state.to_tree()
    state, m = trainer.train_step(state, nan_batch, *args(state))
    after = state.to_tree()
    skip = moved(unbroken, after) if moved else ()
    kept = lambda t: {k: v for k, v in without_step(t).items()
                      if k not in skip}
    if bool(m['finite']) or int(after['step']) != int(unbroken['step']) + 1 \
            or not bit_equal(kept(after), kept(unbroken)):
        raise AssertionError('a NaN batch moved the training state')
    trainer, state, args = make_trainer('cuda')
    state.load_tree(init_tree)
    with tempfile.TemporaryDirectory() as tmp:
        for b in batches[:3]:
            state, _ = trainer.train_step(state, b, *args(state))
        save_checkpoint(tmp, state.to_tree(), state.step - 1)
        trainer, state, args = make_trainer('cuda')
        tree, last = load_checkpoint(tmp)
        state.load_tree(tree)
    for b in batches[last + 1:]:
        state, _ = trainer.train_step(state, b, *args(state))
    if not bit_equal(state.to_tree(), unbroken):
        raise AssertionError('the run resumed after step 2 differs from the '
                             'unbroken run')
    return {'nan_state_bit_identical': True, 'resume_bit_identical': True,
            'resumed_after_step': last, 'nan_step_moves': list(skip)}


def ct_rec_batch(cfg, sean_cfg, gen, n):
    """The rec_img fields of a batch: SEAN codes, blocky label maps that
    hold hair, images in [-1,1] (seeded, on the card)."""
    from ctrlhair_tpu_torch.constants import HAIR_IDX
    s = sean_cfg.crop_size
    coarse = torch.randint(0, sean_cfg.semantic_nc, (n, 16, 16),
                           generator=gen, device='cuda')
    coarse[:, 2:8, 3:13] = HAIR_IDX
    label = coarse.repeat_interleave(s // 16, 1).repeat_interleave(s // 16,
                                                                   2)
    return {'sean_code': torch.randn((n, sean_cfg.semantic_nc,
                                      sean_cfg.style_dim), generator=gen,
                                     device='cuda'),
            'label': label,
            'image': torch.rand((n, s, s, 3), generator=gen,
                                device='cuda') * 2 - 1}


def phase_train_ct(smi: str, dp_cases: dict):
    """(a) The colour/texture trainer at ColorTextureConfig() with a frozen
    seeded SEAN at SEANConfig() and lambda_rec_img on from step 0; its
    trainer and batches go into dp_cases for phase (k)."""
    import dataclasses
    from ctrlhair_tpu_torch.config import ColorTextureConfig, SEANConfig
    from ctrlhair_tpu_torch.models.layers import init_parameters_
    from ctrlhair_tpu_torch.models.sean import SEAN
    from ctrlhair_tpu_torch.training.color_texture_trainer import (
        ColorTextureTrainer, synthetic_batch)
    cfg = dataclasses.replace(ColorTextureConfig(),
                              lambda_rec_img={0: 1000.0})
    scfg = SEANConfig()
    seans = {}

    def sean_on(device):
        """The frozen SEAN, seeded on the card, the same weights on the
        CPU."""
        if device not in seans:
            with torch.device(device):
                seans[device] = SEAN(scfg)
            if device == 'cuda':
                init_parameters_(seans[device],
                                 torch.Generator(device).manual_seed(SEED))
            else:
                seans[device].load_state_dict(seans['cuda'].state_dict())
        return seans[device]

    predictor_trees = {}

    def make_trainer(device, rec_img=True, mesh=None):
        trainer = ColorTextureTrainer(
            cfg, sean=sean_on(device) if rec_img else None,
            rec_img_subset=4, device=device, seed=SEED, mesh=mesh)
        state, preds = trainer.init_state(SEED)
        for k, p in preds.items():     # the card's predictors everywhere
            if k in predictor_trees:
                p.load_state_dict(predictor_trees[k])
            else:
                predictor_trees[k] = {n: t.cpu() for n, t in
                                      p.state_dict().items()}
        return trainer, state, lambda st: (preds,)

    gen = torch.Generator('cuda').manual_seed(SEED)
    rec = ct_rec_batch(cfg, scfg, gen, CT_BATCH)
    batches = [dict(synthetic_batch(torch.Generator().manual_seed(100 + i),
                                    cfg, CT_BATCH, 'cuda'), **rec)
               for i in range(TRAIN_STEPS)]
    trainer, state, args = make_trainer('cuda')
    init_tree = state.to_tree()
    n_params = sum(p.numel() for m in state.parts().values()
                   for p in m.module.parameters())
    torch.cuda.reset_peak_memory_stats()
    state, metrics, ms_on = train_steps(
        lambda s, b: trainer.train_step(s, b, *args(s)), state, batches)
    peak = torch.cuda.max_memory_allocated()
    if not bool(metrics['finite']) or 'g/lambda_rec_img' not in metrics:
        raise AssertionError(f'colour/texture step: {metrics}')
    # the same steps with lambda_rec_img off (no SEAN fields in the batch)
    off_batches = [{k: v for k, v in b.items() if k not in rec}
                   for b in batches]
    trainer_off, state_off, args_off = make_trainer('cuda', rec_img=False)
    state_off.load_tree(init_tree)
    state_off, m_off, ms_off = train_steps(
        lambda s, b: trainer_off.train_step(s, b, *args_off(s)), state_off,
        off_batches)
    if 'g/lambda_rec_img' in m_off or not bool(m_off['finite']):
        raise AssertionError('colour/texture step without SEAN fields')
    # the SEAN decode's forward + backward, alone, on the subset, with
    # cuDNN's defaults and with deterministic algorithms (the checks')
    ae_code = torch.randn((CT_BATCH, cfg.style_dim), device='cuda',
                          requires_grad=True)
    sean_fn = lambda: torch.autograd.grad(
        trainer._rec_img_hair_mse(ae_code, batches[0]), ae_code)
    sean_ms = wall_ms(sean_fn, 5)
    sean_ms_det = deterministic(wall_ms)(sean_fn, 5)
    sean_ms_tuned = autotuned(wall_ms)(sean_fn, 5)
    prof_on = profile_step(lambda: trainer.train_step(
        state, batches[0], *args(state)), float(np.median(ms_on[1:])))
    prof_off = profile_step(lambda: trainer_off.train_step(
        state_off, off_batches[0], *args_off(state_off)),
        float(np.median(ms_off[1:])))
    log(f'[train] colour/texture ColorTextureConfig() ({n_params} trained '
        f'parameters), batch {CT_BATCH}, frozen SEANConfig() (ngf '
        f'{scfg.ngf}, style {scfg.style_dim}, {scfg.crop_size} px), '
        f'lambda_rec_img on, rec_img_subset 4: {TRAIN_STEPS} steps '
        f'{", ".join(f"{t:.3f}" for t in ms_on)} ms; losses d '
        f'{float(metrics["d_total"]):.4f} g {float(metrics["g_total"]):.4f} '
        f'rec_img {float(metrics["g/lambda_rec_img"]):.5f} ({smi})')
    # steady state: the median of steps 2..5 (step 1 builds cuBLAS/cuDNN
    # plans)
    on = float(np.median(ms_on[1:]))
    off = float(np.median(ms_off[1:]))
    log(f'[time] train colour/texture, lambda_rec_img on: {on:.3f} ms a '
        f'step, {1e3 / on:.2f} steps/s; off: {off:.3f} ms a step, '
        f'{1e3 / off:.2f} steps/s; SEAN decode forward+backward of 4 '
        f'images {sean_ms:.3f} ms, {100 * sean_ms / on:.1f}% of a step '
        f'({sean_ms_det:.3f} ms with deterministic cuDNN, '
        f'{sean_ms_tuned:.3f} ms with cudnn.benchmark, which no path sets); '
        f'peak device memory {peak} B ({smi})')
    for name, prof in (('on', prof_on), ('off', prof_off)):
        log(f'[profile] train colour/texture step, lambda_rec_img {name}: '
            f'{prof["device_ms"]:.3f} ms of kernels in {prof["launches"]} '
            f'launches, card idle {100 * prof["idle_share"]:.1f}% of a '
            f'{prof["step_ms"]:.3f} ms step; top: '
            + ', '.join(f'{n} {ms:.3f} ms' for n, ms in prof['top'])
            + f' ({smi})')
    # checks: card against CPU, NaN, resume
    draws = trainer.draws(0, CT_BATCH)
    cpu_check = deterministic(card_against_cpu)(
        make_trainer, init_tree, {k: v.cpu() for k, v in batches[0].items()},
        {k: v.cpu() for k, v in draws.items()},
        {'gen': cfg.lr_g, 'dis': cfg.lr_d, 'dis_noise': cfg.lr_g})
    nan_batch = {k: v.clone() for k, v in batches[0].items()}
    nan_batch['code'][3, 7] = float('nan')
    checks = deterministic(nan_and_resume)(make_trainer, init_tree, batches,
                                           nan_batch)
    log(f'[train] colour/texture checks: card against CPU {cpu_check} (bar '
        f'{TRAIN_CARD_BAR}); {checks}')
    dp_cases['color_texture'] = (make_trainer, batches)
    # phase (l): the published config without SEAN, these batches' seeds
    dp_cases.setdefault('tp', {})['color_texture'] = {
        'family': 'color_texture', 'cfg': ColorTextureConfig(),
        'label': 'ColorTextureConfig(), lambda_rec_img off', 'batches': None,
        'batch': CT_BATCH,
        'lr': {'gen': cfg.lr_g, 'dis': cfg.lr_d, 'dis_noise': cfg.lr_g}}
    return {'config': 'ColorTextureConfig(), lambda_rec_img={0: 1000.0}',
            'sean': 'SEANConfig()', 'batch': CT_BATCH,
            'trained_parameters': n_params, 'step_ms_rec_img_on': ms_on,
            'step_ms_rec_img_off': ms_off, 'median_ms_on': on,
            'median_ms_off': off, 'steps_per_s_on': 1e3 / on,
            'steps_per_s_off': 1e3 / off, 'sean_fwd_bwd_ms': sean_ms,
            'sean_share': sean_ms / on, 'sean_fwd_bwd_ms_deterministic':
            sean_ms_det, 'sean_fwd_bwd_ms_cudnn_benchmark': sean_ms_tuned,
            'profile_on': prof_on, 'profile_off': prof_off,
            'peak_bytes': peak,
            'card_vs_cpu': cpu_check, **checks}


def phase_train_predictors(smi: str):
    """(b) Both predictor trainers at their configs, batch 256."""
    from ctrlhair_tpu_torch.config import (curliness_predictor_config,
                                           rgb_predictor_config)
    from ctrlhair_tpu_torch.training.predictor_trainer import (
        PredictorTrainer)
    out = {}
    for which, cfg in (('rgb', rgb_predictor_config()),
                       ('curliness', curliness_predictor_config())):
        def make_trainer(device, cfg=cfg):
            trainer = PredictorTrainer(cfg, device=device, seed=SEED)
            return trainer, trainer.init_state(SEED), lambda st: ()

        batches = []
        for i in range(TRAIN_STEPS):
            g = torch.Generator().manual_seed(200 + i)
            code = torch.randn((PREDICTOR_BATCH, cfg.style_dim),
                               generator=g)
            b = {'code': code}
            if which == 'curliness':
                b['curliness_label'] = torch.where(
                    code[:, :1] + code[:, 1:2] > 0, 1.0, -1.0)
            else:
                b['rgb_mean'] = code[:, :3] * 40 + 128
                b['pca_std'] = code[:, 3:4].abs() * 30 + 20
            batches.append(to_device(b, 'cuda'))
        trainer, state, _ = make_trainer('cuda')
        init_tree = state.to_tree()
        torch.cuda.reset_peak_memory_stats()
        state, metrics, ms = train_steps(trainer.train_step, state, batches)
        peak = torch.cuda.max_memory_allocated()
        if not bool(metrics['finite']):
            raise AssertionError(f'{which} predictor step: {metrics}')
        med = float(np.median(ms[1:]))
        prof = profile_step(lambda: trainer.train_step(state, batches[0]),
                            med)
        ev = trainer.eval_metrics(state, batches[0])
        log(f'[time] train {which} predictor ({cfg.name}, hidden '
            f'{cfg.hidden_dim}x{cfg.hidden_layer_num}, dropout '
            f'{cfg.dropout}), batch {PREDICTOR_BATCH}: {TRAIN_STEPS} steps '
            f'{", ".join(f"{t:.3f}" for t in ms)} ms; {med:.3f} ms a step, '
            f'{1e3 / med:.2f} steps/s; total {float(metrics["total"]):.4f}; '
            f'eval {sorted((k, round(float(v), 4)) for k, v in ev.items())}; '
            f'peak device memory {peak} B; a step: {prof["device_ms"]:.3f} '
            f'ms of kernels in {prof["launches"]} launches, card idle '
            f'{100 * prof["idle_share"]:.1f}% ({smi})')
        draws = trainer.draws(0, PREDICTOR_BATCH)
        cpu_check = deterministic(card_against_cpu)(
            make_trainer, init_tree,
            {k: v.cpu() for k, v in batches[0].items()},
            {'dropout': [m.cpu() for m in draws['dropout']]},
            {'model': cfg.lr})
        nan_batch = {k: v.clone() for k, v in batches[0].items()}
        nan_batch['code'][5, 9] = float('nan')
        checks = deterministic(nan_and_resume)(make_trainer, init_tree, batches,
                                           nan_batch)
        log(f'[train] {which} predictor checks: card against CPU '
            f'{cpu_check} (bar {TRAIN_CARD_BAR}); {checks}')
        out[which] = {'config': cfg.name, 'batch': PREDICTOR_BATCH,
                      'step_ms': ms, 'median_ms': med,
                      'steps_per_s': 1e3 / med, 'peak_bytes': peak,
                      'profile': prof,
                      'card_vs_cpu': cpu_check, **checks}
    return out


def phase_train_script(smi: str):
    """(c) run_color_texture.main in this process on the card, then the
    port's reader on the checkpoint it wrote."""
    import tempfile
    from ctrlhair_tpu_torch.training import run_color_texture
    from ctrlhair_tpu_torch.utils.checkpoint import load_checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        state = run_color_texture.main(['--synthetic', '--steps', '3',
                                        '--out-dir', tmp])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        tree, step = load_checkpoint(os.path.join(tmp, 'checkpoints'))
    if step != 2 or int(tree['step']) != 3 or state.step != 3 or \
            set(tree) != {'step', 'gen', 'dis', 'dis_noise'}:
        raise AssertionError(f'run_color_texture wrote step {step}, keys '
                             f'{sorted(tree)}')
    if not bit_equal(tree, state.to_tree()):
        raise AssertionError('run_color_texture\'s checkpoint does not read '
                             'back as its final state')
    if next(state.gen.module.parameters()).device.type != 'cuda':
        raise AssertionError('run_color_texture did not train on the card')
    log(f'[train] run_color_texture.main([--synthetic, --steps 3]) on '
        f'{next(state.gen.module.parameters()).device}: {wall:.1f} ms wall '
        f'with its set-up; checkpoint 0000002.ckpt read back equal ({smi})')
    return {'wall_ms': wall, 'checkpoint_step': step}


# The shape trainer's pool: painted 512 px parses, the warps, and the bar of
# each pool mask against the same pair through the host route
POOL_PARSES, POOL_WARPS, POOL_THREADS = 12, 24, 4
SHAPE_BATCH, BISENET_BATCH, LANDMARK_BATCH = 4, 16, 64
# the shape step's card-against-CPU check at 128 px, every layer and width
# kept (with the check at 256 px the shape phase took 196 s of a 613 s
# smoke, measured on the H100; a float64 CPU step of two samples 34 s at
# 256 px and 14 s at 128 px on an 8-core host)
SHAPE_CHECK_SIZE = 128
# the card-against-CPU checks of trainer_phase take the first CHECK_BATCH
# samples of the first batch: the CPU's float64 steps at full width are
# most of the smoke's time, and two samples hold every layer
CHECK_BATCH = 2


def first_samples(tree, n_all: int, n: int):
    """The first n samples of every tensor whose first dim is the batch
    (n_all); other tensors (a step's coin) as they are."""
    return {k: v[:n] if v.dim() and v.shape[0] == n_all else v
            for k, v in tree.items()}


def trainer_phase(name: str, make_trainer, batches, nan_batch, draws,
                  lr: dict, smi: str, check=None) -> dict:
    """The steps of one trainer on the card, timed (host ms a step, ended by
    torch.cuda.synchronize(); steady state = the median of steps 2 to 5),
    its peak device memory and a profiler reading of one step; then the
    checks: the card's first step against the port's CPU step on the first
    CHECK_BATCH samples (held with the models computing in float64, and
    the float32 step against the CPU's float64 one), a NaN batch, and a
    resume after step 2.
    `check`: (make_trainer, batch, draws) of a smaller depth for the
    card-against-CPU check, in place of this trainer's."""
    trainer, state, args = make_trainer('cuda')
    init_tree = state.to_tree()
    n_params = sum(p.numel() for m in trained_modules(state)
                   for p in m.parameters())
    torch.cuda.reset_peak_memory_stats()
    state, metrics, ms = train_steps(
        lambda st, b: trainer.train_step(st, b, *args(st)), state, batches)
    peak = torch.cuda.max_memory_allocated()
    if not bool(metrics['finite']):
        raise AssertionError(f'{name} step: {metrics}')
    med = float(np.median(ms[1:]))
    prof = profile_step(lambda: trainer.train_step(
        state, batches[0], *args(state)), med)
    losses = {k: round(float(v), 5) for k, v in metrics.items()
              if k != 'finite' and v.numel() == 1}
    log(f'[time] train {name} ({n_params} trained parameters): '
        f'{len(batches)} steps {", ".join(f"{t:.3f}" for t in ms)} ms; '
        f'{med:.3f} ms a step, {1e3 / med:.2f} steps/s; peak device memory '
        f'{peak} B; a step: {prof["device_ms"]:.3f} ms of kernels in '
        f'{prof["launches"]} launches, card idle '
        f'{100 * prof["idle_share"]:.1f}%; top: '
        + ', '.join(f'{n} {t:.3f} ms' for n, t in prof['top'])
        + f'; losses {losses} ({smi})')
    # held with the models computing in float64 on both devices: in
    # float32 the shape step's own error (against float64, on the CPU)
    # reaches 1.2e-4 of a gradient's scale, the bar itself; the float32
    # step, as trained, held against the CPU's float64 step beside it
    make_check, batch, check_draws = check or (make_trainer, batches[0],
                                               draws)
    n_all = next(iter(batch.values())).shape[0]
    cpu_check = deterministic(card_against_cpu)(
        make_check, make_check('cuda')[1].to_tree() if check else init_tree,
        first_samples({k: v.cpu() for k, v in batch.items()}, n_all,
                      CHECK_BATCH),
        None if check_draws is None else first_samples(
            {k: v.cpu() for k, v in check_draws.items()}, n_all,
            CHECK_BATCH),
        lr, dtype=torch.float64, float32=True)
    checks = deterministic(nan_and_resume)(make_trainer, init_tree, batches,
                                           nan_batch)
    log(f'[train] {name} checks: card against CPU {cpu_check} (bars '
        f'{TRAIN_CARD_BAR}, float32 {FLOAT32_CARD_BAR}); {checks}')
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return {'trained_parameters': n_params, 'step_ms': ms, 'median_ms': med,
            'steps_per_s': 1e3 / med, 'peak_bytes': peak, 'profile': prof,
            'losses': losses, 'card_vs_cpu': cpu_check, **checks}


def pool_root(tmp: str) -> str:
    """A data root of POOL_PARSES painted 512 px parses in two datasets
    (faces of different places and sizes), written as PNG."""
    from ctrlhair_tpu_torch.utils.image import write_png
    rng = np.random.default_rng(SEED)
    for d, ds in enumerate(('ffhq', 'CelebaMask_HQ')):
        os.makedirs(os.path.join(tmp, ds, 'images_256'))
        os.makedirs(os.path.join(tmp, ds, 'label'))
        for i in range(POOL_PARSES // 2):
            lab = paint_face(512, rng.uniform(0.44, 0.56),
                             rng.uniform(0.46, 0.56), rng.uniform(0.8, 1.05),
                             'cuda')
            write_png(os.path.join(tmp, ds, 'label', f'{i:05d}.png'),
                      lab.cpu().numpy().astype(np.uint8))
            write_png(os.path.join(tmp, ds, 'images_256', f'{i:05d}.png'),
                      np.zeros((8, 8, 3), np.uint8))
    return tmp


def phase_train_pool(tmp: str, smi: str):
    """(d) generate_warp_pool on cuda:0 (K2 once a warp), each mask against
    the same pair through the host route, then ShapeDataset batches from
    it."""
    from ctrlhair_tpu_torch.config import ShapeConfig
    from ctrlhair_tpu_torch.data.catalog import DataCatalog
    from ctrlhair_tpu_torch.data.shape_dataset import (
        ShapeDataset, generate_warp_pool)
    from ctrlhair_tpu_torch.ops.landmarks import estimate_landmarks_81
    from ctrlhair_tpu_torch.ops.raster_pallas import RASTER_UV
    from ctrlhair_tpu_torch.ops.warp import hair_mask_transfer_warp
    from ctrlhair_tpu_torch.utils.image import read_png
    root = pool_root(tmp)
    cat = DataCatalog(root, ['ffhq', 'CelebaMask_HQ'], validity_check=False)
    out = os.path.join(root, 'shape_training_wrap_pool')
    before = RASTER_UV.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    written = generate_warp_pool(cat, out, POOL_WARPS,
                                 num_threads=POOL_THREADS, device='cuda')
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launched = RASTER_UV.launches - before
    names = sorted(os.listdir(out))
    if written != POOL_WARPS or len(names) != POOL_WARPS or \
            launched < POOL_WARPS:
        raise AssertionError(f'warp pool: {written} written, {len(names)} '
                             f'files, {launched} K2 launches, expected '
                             f'{POOL_WARPS}')
    agree = []
    for name in names:
        parts = name[:-len('.png')].split('___')
        hair, face = (read_png(cat.label_path(f'{parts[a]}___{parts[a + 1]}'
                                              )).astype(np.int32)
                      for a in (0, 2))
        host = hair_mask_transfer_warp(hair, face,
                                       estimate_landmarks_81(hair),
                                       estimate_landmarks_81(face),
                                       raster='host')
        agree.append(float((read_png(os.path.join(out, name)) == host)
                           .mean()))
    if min(agree) < ROUTES_AGREE:
        raise AssertionError(f'warp pool against the host route: '
                             f'{min(agree):.6f} of labels equal (bar '
                             f'{ROUTES_AGREE})')
    ds = ShapeDataset(ShapeConfig(), root)
    batches = [{k: torch.from_numpy(v).to('cuda') for k, v in
                ds.training_batch(SHAPE_BATCH).items()}
               for _ in range(TRAIN_STEPS)]
    if any(tuple(b['target'].shape) != (SHAPE_BATCH, 256, 256, 19)
           for b in batches):
        raise AssertionError('ShapeDataset batch of the wrong shape')
    log(f'[train] warp pool: {POOL_PARSES} painted 512 px parses, '
        f'generate_warp_pool(count={POOL_WARPS}, num_threads={POOL_THREADS})'
        f' on cuda:0: {written} written in {wall:.1f} ms, '
        f'{wall / POOL_WARPS:.3f} ms a warp; {launched} K2 launches; against '
        f'the host route: min {min(agree):.6f}, mean {np.mean(agree):.6f} of '
        f'labels equal; ShapeDataset(ShapeConfig()).training_batch('
        f'{SHAPE_BATCH}) x {TRAIN_STEPS} ({smi})')
    return root, batches, {'warps': written, 'wall_ms': wall,
                           'ms_per_warp': wall / POOL_WARPS,
                           'raster_uv_launches': launched,
                           'min_labels_equal': min(agree),
                           'mean_labels_equal': float(np.mean(agree))}


def phase_train_shape(batches, smi: str, dp_cases: dict) -> dict:
    """(e) The shape trainer at ShapeConfig() with the soak's recipe
    (kl_free_bits 0.25, lambda_geo 30, lambda_info 1), batch 4 from the
    pool."""
    import dataclasses
    from ctrlhair_tpu_torch.config import ShapeConfig
    from ctrlhair_tpu_torch.training.shape_trainer import ShapeTrainer
    cfg = dataclasses.replace(ShapeConfig(), kl_free_bits=0.25,
                              lambda_geo=30.0, lambda_info=1.0)

    def make_trainer(device, mesh=None):
        trainer = ShapeTrainer(cfg, device=device, seed=SEED, mesh=mesh)
        return trainer, trainer.init_state(SEED), lambda st: ()

    nan_batch = {k: v.clone() for k, v in batches[0].items()}
    nan_batch['face'][1, 3, 4, 0] = float('nan')
    # the check at 128 px: every layer and width, the maps half the side
    small = dataclasses.replace(cfg, img_size=SHAPE_CHECK_SIZE)

    def make_small(device):
        trainer = ShapeTrainer(small, device=device, seed=SEED)
        return trainer, trainer.init_state(SEED), lambda st: ()

    step = cfg.img_size // SHAPE_CHECK_SIZE
    rec = trainer_phase(
        'shape ShapeConfig() kl_free_bits=0.25 lambda_geo=30 lambda_info=1,'
        f' batch {SHAPE_BATCH}',
        make_trainer, batches, nan_batch,
        ShapeTrainer(cfg, device='cuda', seed=SEED).draws(0, SHAPE_BATCH),
        {'gen': cfg.lr_g, 'dis': cfg.lr_d, 'dis_noise': cfg.lr_dz}, smi,
        check=(make_small, {k: v[:, ::step, ::step]
                            for k, v in batches[0].items()},
               ShapeTrainer(small, device='cuda', seed=SEED).draws(
                   0, SHAPE_BATCH)))
    dp_cases['shape'] = (make_trainer, batches)
    label = 'ShapeConfig(), kl_free_bits=0.25, lambda_geo=30, lambda_info=1'
    dp_cases.setdefault('tp', {})['shape'] = {
        'family': 'shape', 'cfg': cfg, 'label': label,
        'batches': batches[:TP_STEPS], 'batch': SHAPE_BATCH,
        'lr': {'gen': cfg.lr_g, 'dis': cfg.lr_d, 'dis_noise': cfg.lr_dz}}
    return {'config': label, 'batch': SHAPE_BATCH, **rec}


def phase_train_bisenet(smi: str, dp_cases: dict) -> dict:
    """(f) The face parser at BiSeNetConfig() (ResNet-18, 512 px), batch 16
    of synthetic batches drawn as run_bisenet draws them."""
    from ctrlhair_tpu_torch.config import BiSeNetConfig
    from ctrlhair_tpu_torch.training.bisenet_trainer import BiSeNetTrainer
    cfg = BiSeNetConfig()
    s = cfg.input_size
    host_rng = np.random.default_rng(SEED)
    batches = []
    for _ in range(TRAIN_STEPS):
        image = host_rng.standard_normal((BISENET_BATCH, s, s, 3))
        label = host_rng.integers(0, 19, (BISENET_BATCH, s, s))
        batches.append({
            'image': torch.from_numpy(image.astype(np.float32)).cuda(),
            'label': torch.from_numpy(label.astype(np.int32)).cuda()})

    def make_trainer(device, mesh=None):
        trainer = BiSeNetTrainer(cfg, device=device, mesh=mesh)
        return trainer, trainer.init_state(SEED), lambda st: ()

    nan_batch = {k: v.clone() for k, v in batches[0].items()}
    nan_batch['image'][2, 7, 9, 1] = float('nan')
    rec = trainer_phase(f'bisenet BiSeNetConfig(), batch {BISENET_BATCH}',
                        make_trainer, batches, nan_batch, None, {}, smi)
    dp_cases['bisenet'] = (make_trainer, batches)
    return {'config': 'BiSeNetConfig()', 'batch': BISENET_BATCH, **rec}


def phase_train_landmark(smi: str) -> dict:
    """(g) The landmark regressor at LandmarkNetConfig() (128 px), batch 64
    from the port's renderer."""
    from ctrlhair_tpu_torch.data.landmark_dataset import training_batch
    from ctrlhair_tpu_torch.models.landmark_net import LandmarkNetConfig
    from ctrlhair_tpu_torch.training.landmark_trainer import LandmarkTrainer
    cfg = LandmarkNetConfig()
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    batches = [{k: torch.from_numpy(v).cuda() for k, v in training_batch(
        rng, LANDMARK_BATCH, cfg.input_size).items()}
        for _ in range(TRAIN_STEPS)]
    render_ms = (time.perf_counter() - t0) * 1e3

    def make_trainer(device):
        trainer = LandmarkTrainer(cfg, device=device)
        return trainer, trainer.init_state(SEED), lambda st: ()

    nan_batch = {k: v.clone() for k, v in batches[0].items()}
    nan_batch['image'][5, 3, 4, 0] = float('nan')
    log(f'[time] landmark renderer: {TRAIN_STEPS} x {LANDMARK_BATCH} faces '
        f'and backgrounds at {cfg.input_size} px in {render_ms:.1f} ms on '
        f'the host, {render_ms / (TRAIN_STEPS * LANDMARK_BATCH):.3f} ms a '
        f'sample')
    rec = trainer_phase(f'landmark LandmarkNetConfig(), batch '
                        f'{LANDMARK_BATCH}', make_trainer, batches,
                        nan_batch, None, {'model': cfg.lr}, smi)
    return {'config': 'LandmarkNetConfig()', 'batch': LANDMARK_BATCH,
            'render_ms_per_sample': render_ms / (TRAIN_STEPS
                                                 * LANDMARK_BATCH), **rec}


# The SEAN trainer: batch 4 (run_sean's default) at SEANConfig(); its checks
# (card against CPU, NaN, resume) at crop 64, every width kept, batch 4 (the
# CPU's float64 step of the full 256 px width takes minutes, deterministic
# cuDNN at full width 4 s a step).  Not at batch 2: the style codes are
# pooled in float32 on both devices (as JAX pools them), and the first
# block's batch statistics over 2 x 2 x 2 values magnify their 2e-7 apart
# to 7.0e-4 of a gradient's scale even with float64 models (measured on the
# H100, the forward activations 2e-7 apart); over 4 images, 9.1e-7.
SEAN_BATCH, SEAN_CHECK_CROP = 4, 64


def sn_power_iteration(w_tree, u_tree, path=()):
    """{path: u'} of one power iteration from u over each kernel of a flax
    tree (HWIO, as [kh*kw*in, out]), in numpy float64."""
    out = {}
    for k, u in u_tree.items():
        if isinstance(u, dict):
            out.update(sn_power_iteration(w_tree[k], u, path + (k,)))
        elif u is not None:
            w = np.asarray(w_tree[k], np.float64)
            mat = w.reshape(-1, w.shape[-1])
            v = mat.T @ np.asarray(u, np.float64)
            v /= np.linalg.norm(v) + 1e-12
            new = mat @ v
            out[path + (k,)] = new / (np.linalg.norm(new) + 1e-12)
    return out


def sean_u_moved(before, after):
    """A NaN step of the SEAN trainer: each u vector is one power iteration
    on from the unchanged weights (JAX's rule), within 1e-5."""
    for key, part in (('sn_u', 'gen'), ('dis_sn_u', 'dis')):
        want = sn_power_iteration(before[part]['params']['params'],
                                  before[key])
        got = dict(tree_leaves(after[key]))
        if set(got) != set(want) or any(
                not np.abs(got[p] - want[p]).max() <= 1e-5 for p in want):
            raise AssertionError(f'a NaN step moved {key} other than by one '
                                 'power iteration')
    return ('sn_u', 'dis_sn_u')


def phase_train_sean(smi: str, dp_cases: dict) -> dict:
    """(i) The SEAN trainer at SEANConfig() against the default two-scale
    PatchGAN and a seeded random VGG19 (nothing downloaded), batch 4 of
    run_sean's synthetic batches: five steps timed, a profiler reading and
    the peak memory at full width; then at crop 64: the card against the CPU
    (float64 models on both devices, and the card's float32 step against
    the CPU's float64 one), a NaN batch and a resume after step 2."""
    import dataclasses
    from ctrlhair_tpu_torch.config import SEANConfig
    from ctrlhair_tpu_torch.models.layers import init_parameters_
    from ctrlhair_tpu_torch.models.sean_discriminator import VGG19Features
    from ctrlhair_tpu_torch.training.sean_trainer import (
        SEANTrainer, synthetic_batch)
    cfg = SEANConfig()
    vgg = VGG19Features()
    init_parameters_(vgg, torch.Generator().manual_seed(SEED))
    vgg_state = vgg.state_dict()

    def maker(c):
        def make_trainer(device, mesh=None):
            trainer = SEANTrainer(c, vgg_state=vgg_state, device=device,
                                  seed=SEED, mesh=mesh)
            return trainer, trainer.init_state(SEED), lambda st: ()
        return make_trainer

    host_rng = np.random.default_rng(SEED)
    batches = [synthetic_batch(host_rng, cfg, SEAN_BATCH, 'cuda')
               for _ in range(TRAIN_STEPS)]
    trainer, state, _ = maker(cfg)('cuda')
    n_params = sum(p.numel() for m in trained_modules(state)
                   for p in m.parameters())
    torch.cuda.reset_peak_memory_stats()
    state, metrics, ms = train_steps(trainer.train_step, state, batches)
    peak = torch.cuda.max_memory_allocated()
    if not bool(metrics['finite']):
        raise AssertionError(f'SEAN step: {metrics}')
    med = float(np.median(ms[1:]))
    prof = profile_step(lambda: trainer.train_step(state, batches[0]), med)
    losses = {k: round(float(v), 5) for k, v in metrics.items()
              if v.numel() == 1 and 'finite' not in k}
    name = f'sean SEANConfig(), batch {SEAN_BATCH}'
    log(f'[time] train {name} ({n_params} trained parameters, VGG19 '
        f'frozen): {len(batches)} steps {", ".join(f"{t:.3f}" for t in ms)} '
        f'ms; {med:.3f} ms a step, {1e3 / med:.2f} steps/s; peak device '
        f'memory {peak} B; a step: {prof["device_ms"]:.3f} ms of kernels in '
        f'{prof["launches"]} launches, card idle '
        f'{100 * prof["idle_share"]:.1f}%; top: '
        + ', '.join(f'{n} {t:.3f} ms' for n, t in prof['top'])
        + f'; losses {losses} ({smi})')
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    dp_cases['sean'] = (maker(cfg), batches)
    small = dataclasses.replace(cfg, crop_size=SEAN_CHECK_CROP)
    make_small = maker(small)
    small_tree = make_small('cuda')[1].to_tree()
    check_rng = np.random.default_rng(SEED + 1)
    small_batches = [synthetic_batch(check_rng, small, SEAN_BATCH, 'cuda')
                     for _ in range(4)]
    nan_batch = {k: v.clone() for k, v in small_batches[0].items()}
    nan_batch['image'][1, 3, 4, 0] = float('nan')
    lr = {'gen': 1e-4, 'dis': 4e-4}
    t0 = time.perf_counter()
    cpu_check = deterministic(card_against_cpu)(
        make_small, small_tree,
        {k: v.cpu() for k, v in small_batches[0].items()}, None, lr,
        dtype=torch.float64, float32=True)
    t1 = time.perf_counter()
    checks = deterministic(nan_and_resume)(make_small, small_tree,
                                           small_batches, nan_batch,
                                           moved=sean_u_moved)
    check_s = {'card_vs_cpu': t1 - t0, 'nan_and_resume':
               time.perf_counter() - t1}
    log(f'[train] {name} checks at crop {SEAN_CHECK_CROP}: card against '
        f'CPU {cpu_check} (bars {TRAIN_CARD_BAR}, float32 '
        f'{FLOAT32_CARD_BAR}); {checks}; '
        f'seconds {check_s}')
    gc.collect()
    torch.cuda.empty_cache()
    return {'config': 'SEANConfig(), MultiscaleDiscriminator(2, 64, 4), '
                      'random VGG19', 'batch': SEAN_BATCH,
            'trained_parameters': n_params, 'step_ms': ms, 'median_ms': med,
            'steps_per_s': 1e3 / med, 'peak_bytes': peak, 'profile': prof,
            'losses': losses, 'card_vs_cpu_crop': SEAN_CHECK_CROP,
            'card_vs_cpu': cpu_check, 'check_seconds': check_s, **checks}


def phase_canvas_prep(tmp: str, smi: str) -> dict:
    """(j) On Backend()'s editor (cuda:0, model_trained/ loaded): the
    transfer-matrix canvas of samples/input.png and its mirror image, then
    a data-prep pass over a folder of the two: crop, parse, SEAN codes,
    colour statistics and variance, median codes, landmarks; each timed,
    its outputs held to their shapes, finite, the parse holding hair."""
    from ctrlhair_tpu_torch.constants import HAIR_IDX
    from ctrlhair_tpu_torch.data import prep
    from ctrlhair_tpu_torch.data.catalog import DataCatalog
    from ctrlhair_tpu_torch.pipeline.backend import Backend
    from ctrlhair_tpu_torch.training.validation import transfer_matrix_canvas
    from ctrlhair_tpu_torch.utils.image import read_png, read_rgb, write_rgb
    editor = Backend().editor
    photo = read_rgb(os.path.join(ROOT, 'samples', 'input.png'))
    photos = [photo, np.ascontiguousarray(photo[:, ::-1])]
    ms = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    canvas = timed('transfer_matrix_canvas',
                   lambda: transfer_matrix_canvas(editor, photos))
    cell = editor.cfg.edit_size + 2
    if canvas.shape != (2 * cell + 2, 2 * cell + 2, 3) or \
            canvas[2:cell, 2:cell].std() < 1.0:
        raise AssertionError(f'transfer matrix canvas: {canvas.shape}')
    raw = os.path.join(tmp, 'raw')
    os.makedirs(raw)
    for i, img in enumerate(photos):
        write_rgb(os.path.join(raw, f'{i:05d}.png'), img)
    ds = os.path.join(tmp, 'ffhq')
    n = timed('crop_images', lambda: prep.crop_images(
        editor, raw, os.path.join(ds, 'images_256'), 256))
    m = timed('compute_masks', lambda: prep.compute_masks(
        editor, os.path.join(ds, 'images_256'), os.path.join(ds, 'label')))
    hair = [float((read_png(os.path.join(ds, 'label', f'{i:05d}.png'))
                   == HAIR_IDX).mean()) for i in range(2)]
    cat = DataCatalog(tmp, ['ffhq'], validity_check=False)
    codes = timed('compute_sean_codes', lambda: prep.compute_sean_codes(
        editor, cat, os.path.join(tmp, 'sean_code_dict.pkl')))
    rgb = timed('compute_color_stats', lambda: prep.compute_color_stats(
        cat, os.path.join(tmp, 'rgb.pkl'), os.path.join(tmp, 'hsv.pkl')))
    var = timed('compute_color_variance', lambda: prep.compute_color_variance(
        cat, os.path.join(tmp, 'var.pkl')))
    med = timed('compute_mean_style_codes',
                lambda: prep.compute_mean_style_codes(codes, tmp))
    lms = timed('compute_landmarks', lambda: prep.compute_landmarks(
        editor, cat, os.path.join(tmp, 'landmark81.pkl')))
    style = editor.cfg.sean.style_dim
    if (n, m, len(codes), len(rgb), len(var), len(lms)) != (2,) * 6 or \
            min(hair) < 0.1 or med.shape != (19, style) or \
            not np.isfinite(med).all() or any(
                c.shape != (19, style) for c in codes.values()) or any(
                l.shape != (81, 2) or not np.isfinite(l).all()
                for l in lms.values()):
        raise AssertionError(f'prep pass: {n} crops, {m} masks (hair '
                             f'{hair}), {len(codes)} codes, {len(rgb)} '
                             f'colours, {len(var)} variances, {len(lms)} '
                             'landmark sets')
    log('[train] canvas and prep on Backend()\'s editor, samples/input.png '
        'and its mirror image: '
        + ', '.join(f'{k} {v:.3f} ms' for k, v in ms.items())
        + f'; parsed hair shares {[round(h, 4) for h in hair]} ({smi})')
    del editor
    gc.collect()
    torch.cuda.empty_cache()
    return {'ms': ms, 'hair_share': hair}


def phase_train_entry_points(root: str, smi: str) -> dict:
    """(h) run_shape.main on the pool, run_bisenet.main --synthetic,
    run_sean.main --synthetic and run_landmark.main, 3 steps each on
    cuda:0; each checkpoint read back
    equal; the landmark checkpoint loaded by load_landmark_net, which
    predicts finite points."""
    import tempfile
    from ctrlhair_tpu_torch.data.landmark_dataset import (
        render_face, transform_landmarks)
    from ctrlhair_tpu_torch.ops import landmarks
    from ctrlhair_tpu_torch.training import (run_bisenet, run_landmark,
                                             run_sean, run_shape)
    from ctrlhair_tpu_torch.utils.checkpoint import load_checkpoint
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, main, argv in (
                ('run_shape', run_shape.main, ['--data-root', root]),
                ('run_bisenet', run_bisenet.main, ['--synthetic']),
                ('run_sean', run_sean.main, ['--synthetic'])):
            d = os.path.join(tmp, name)
            t0 = time.perf_counter()
            state = main(argv + ['--steps', '3', '--out-dir', d])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            tree, step = load_checkpoint(os.path.join(d, 'checkpoints'))
            module = (state.model if name == 'run_bisenet' else state.gen
                      ).module
            if step != 2 or state.step != 3 or \
                    not bit_equal(tree, state.to_tree()) or \
                    next(module.parameters()).device.type != 'cuda':
                raise AssertionError(f'{name}: step {step}, state step '
                                     f'{state.step}, checkpoint not equal '
                                     'or not on the card')
            out[name] = {'wall_ms': wall, 'checkpoint_step': step}
            del state, module
            gc.collect()
        d = os.path.join(tmp, 'landmark')
        t0 = time.perf_counter()
        state, _, ev = run_landmark.main(['--steps', '3', '--pool', '256',
                                          '--out-dir', d])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        tree, step = load_checkpoint(d)
        if step != 3 or not bit_equal(tree, state.model.to_tree()['params']):
            raise AssertionError('run_landmark\'s checkpoint does not read '
                                 'back as its parameters')
        try:
            if not landmarks.load_landmark_net(d, device='cuda'):
                raise AssertionError('load_landmark_net found no checkpoint')
            img = render_face(transform_landmarks(np.random.default_rng(1)),
                              np.random.default_rng(2), 256)
            pts = landmarks.net_landmarks_81(img, min_presence=0.0,
                                             device='cuda')
            if pts is None or not np.isfinite(pts[0]).all():
                raise AssertionError('the trained landmark net predicts no '
                                     'finite points')
        finally:
            landmarks.unload_landmark_net()
        out['run_landmark'] = {'wall_ms': wall, 'checkpoint_step': step,
                               'held_out': {k: float(v)
                                            for k, v in ev.items()}}
    log(f'[train] entry points on cuda:0, 3 steps each, checkpoints read '
        f'back equal: run_shape (its pool) {out["run_shape"]["wall_ms"]:.1f}'
        f' ms, run_bisenet --synthetic {out["run_bisenet"]["wall_ms"]:.1f} '
        f'ms, run_sean --synthetic {out["run_sean"]["wall_ms"]:.1f} ms, '
        f'run_landmark (pool 256) {out["run_landmark"]["wall_ms"]:.1f} '
        f'ms, each with its set-up; the landmark checkpoint loaded by '
        f'load_landmark_net and predicting finite points ({smi})')
    return out


# ------------------------------------------------------------- parallel
# Phase (k), data parallelism (ctrlhair_tpu_torch/parallel/).  (k1) a
# one-rank NCCL group in this process: each of the four data-parallel
# trainers of the training phase, at its published config and batch, takes
# DP_CHECK_STEPS steps through the group (every collective of --dp runs)
# and DP_CHECK_STEPS plain steps from the same state, with deterministic
# cuDNN; the two states must be bit-identical (a one-rank sum is a copy and
# x / 1 is x), else their gap is stated and held to DP_GAP_BAR of each
# leaf's scale.  Then DP_TIME_STEPS more steps of each, in turns, with
# cuDNN's defaults, timed; the gradient reduce alone by CUDA events.  (k2)
# two ranks on the one card over gloo, whose CUDA support covers the two
# collectives the face parser's step needs (all_reduce and broadcast;
# NCCL takes one rank a card): the parser at a small config, one step,
# against the single process on the global batch.  (k3) run_bisenet under
# python -m torch.distributed.run, resumed in this process.
DP_CHECK_STEPS, DP_TIME_STEPS, DP_GAP_BAR = 2, 4, 1e-6
K2_WORLD, K2_BATCH, K2_BAR = 2, 8, 1e-5
K2_CFG = dict(input_size=32, blocks_per_stage=1)


def k2_rank(mesh, batch):
    """(k2) One face-parser step on this rank's rows of `batch` (numpy),
    float32 with TF32 off: (state tree, finite, collectives)."""
    from ctrlhair_tpu_torch.config import BiSeNetConfig
    from ctrlhair_tpu_torch.parallel.mesh import replicated, shard_batch
    from ctrlhair_tpu_torch.training.bisenet_trainer import BiSeNetTrainer
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    trainer = BiSeNetTrainer(BiSeNetConfig(**K2_CFG), device=mesh.device,
                             mesh=mesh)
    state = replicated(trainer.init_state(SEED), mesh)
    rows = shard_batch({k: torch.from_numpy(v).to(mesh.device)
                        for k, v in batch.items()}, mesh)
    state, metrics = trainer.train_step(state, rows)
    return state.to_tree(), bool(metrics['finite']), mesh.collectives


def dp_trainer_case(name, make, batches, mesh, smi) -> dict:
    """(k1) for one trainer: the plain and the one-rank DP trainer from the
    same seeded state, DP_CHECK_STEPS steps each with deterministic cuDNN
    (held bit-equal), then DP_TIME_STEPS each in turns, timed."""
    from ctrlhair_tpu_torch.parallel.mesh import (
        all_reduce_grads, replicated, shard_batch)
    sides = {}
    for key, m in (('plain', None), ('dp', mesh)):
        trainer, state, args = make('cuda', mesh=m)
        sides[key] = [trainer, replicated(state, m), args]

    def step(key, batch):
        trainer, state, args = sides[key]
        m = mesh if key == 'dp' else None
        before = mesh.collectives
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sides[key][1], metrics = trainer.train_step(
            state, shard_batch(batch, m), *args(state))
        torch.cuda.synchronize()
        if not bool(metrics['finite']):
            raise AssertionError(f'{name}: non-finite {key} step')
        return (time.perf_counter() - t0) * 1e3, mesh.collectives - before

    @deterministic
    def checked_steps():
        for b in batches[:DP_CHECK_STEPS]:
            for key in ('plain', 'dp'):
                step(key, b)
        return sides['plain'][1].to_tree(), sides['dp'][1].to_tree()

    plain_tree, dp_tree = checked_steps()
    same = bit_equal(dp_tree, plain_tree)
    gap, where = (0.0, None) if same else tree_diff(dp_tree, plain_tree)
    if not same and not gap <= DP_GAP_BAR:
        raise AssertionError(f'{name}: the one-rank DP state stands {gap:.3g} '
                             f'from the plain one at {where} (bar '
                             f'{DP_GAP_BAR})')
    ms = {'plain': [], 'dp': []}
    collectives = 0
    for i in range(DP_TIME_STEPS):
        order = ('plain', 'dp') if i % 2 == 0 else ('dp', 'plain')
        for key in order:
            t, c = step(key, batches[(DP_CHECK_STEPS + i) % len(batches)])
            ms[key].append(t)
            if key == 'dp':
                collectives = c
    params = [p for part in trained_modules(sides['dp'][1])
              for p in part.parameters()]
    n_params = sum(p.numel() for p in params)
    del sides
    gc.collect()
    torch.cuda.empty_cache()
    grads = [torch.randn_like(p) for p in params]
    reduce_ms = cuda_ms(lambda: all_reduce_grads(grads, mesh), 5)
    del grads, params
    gc.collect()
    torch.cuda.empty_cache()
    plain_ms = float(np.median(ms['plain'][1:]))
    dp_ms = float(np.median(ms['dp'][1:]))
    rec = {'trained_parameters': n_params, 'grad_bytes': 4 * n_params,
           'bit_equal': same, 'gap': gap, 'gap_leaf': where,
           'reduce_ms': reduce_ms, 'reduce_share': reduce_ms / dp_ms,
           'plain_step_ms': ms['plain'], 'dp_step_ms': ms['dp'],
           'plain_median_ms': plain_ms, 'dp_median_ms': dp_ms,
           'collectives_per_step': collectives}
    log(f'[parallel] k1 {name}: {DP_CHECK_STEPS} one-rank NCCL DP steps '
        f'against {DP_CHECK_STEPS} plain steps: '
        + ('bit-identical' if same else f'gap {gap:.3g} at {where}')
        + f'; {n_params} trained parameters, {4 * n_params} B of gradient '
        f'reduced a step in {reduce_ms:.3f} ms (CUDA events, '
        f'{100 * reduce_ms / dp_ms:.2f}% of a DP step); DP step '
        f'{dp_ms:.3f} ms against plain {plain_ms:.3f} ms (median of steps '
        f'2 to {DP_TIME_STEPS}); {collectives} collectives a step ({smi})')
    return rec


def phase_parallel(dp_cases: dict, smi: str):
    """Phase (k): (k1), (k2) and (k3) as the comment above them says; the
    launch counts set to 0 before it and read after it (no kernel of the
    port runs on this path)."""
    import contextlib
    import io
    import tempfile
    import torch.distributed as dist
    from ctrlhair_tpu_torch.parallel.dryrun import run_on_ranks
    from ctrlhair_tpu_torch.parallel.mesh import initialize_runtime, make_mesh
    from ctrlhair_tpu_torch.training import run_bisenet
    from ctrlhair_tpu_torch.utils.checkpoint import load_checkpoint
    reset_launches()
    rec, seconds = {}, {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        device = initialize_runtime(
            'cuda', init_method=f'file://{os.path.join(tmp, "store")}',
            world_size=1, rank=0, timeout=300.0)
        try:
            mesh = make_mesh(1, device=device)
            for name in ('color_texture', 'shape', 'bisenet', 'sean'):
                make, batches = dp_cases.pop(name)
                rec[name] = dp_trainer_case(name, make, batches, mesh, smi)
                del make, batches
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    seconds['k1'] = time.perf_counter() - t0

    # (k2) two ranks on the one card over gloo
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    s = K2_CFG['input_size']
    batch = {'image': rng.standard_normal((K2_BATCH, s, s, 3)).astype(
                 np.float32),
             'label': rng.integers(0, 19, (K2_BATCH, s, s)).astype(np.int32)}
    per_rank = run_on_ranks(k2_rank, K2_WORLD, batch, device='cuda:0',
                            backend='gloo', deadline_s=300.0)

    from ctrlhair_tpu_torch.config import BiSeNetConfig
    from ctrlhair_tpu_torch.training.bisenet_trainer import BiSeNetTrainer
    trainer = BiSeNetTrainer(BiSeNetConfig(**K2_CFG), device='cuda')
    state = trainer.init_state(SEED)
    state, metrics = deterministic(trainer.train_step)(
        state, {k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    ref = state.to_tree()
    gaps = [tree_diff(tree, ref) for tree, _, _ in per_rank]
    if not all(finite for _, finite, _ in per_rank) or not bool(
            metrics['finite']) or not all(
            bit_equal(tree, per_rank[0][0]) for tree, _, _ in per_rank) \
            or not max(g for g, _ in gaps) <= K2_BAR:
        raise AssertionError(f'(k2) {K2_WORLD} gloo ranks on the card '
                             f'against one process: gaps {gaps} (bar '
                             f'{K2_BAR}), finite {[f for _, f, _ in per_rank]}')
    rec['k2'] = {'world': K2_WORLD, 'backend': 'gloo', 'batch': K2_BATCH,
                 'config': f'BiSeNetConfig({K2_CFG})', 'gap': gaps[0][0],
                 'gap_leaf': gaps[0][1], 'collectives': per_rank[0][2]}
    seconds['k2'] = time.perf_counter() - t0
    log(f'[parallel] k2 face parser BiSeNetConfig({K2_CFG}), global batch '
        f'{K2_BATCH} on {K2_WORLD} gloo ranks on cuda:0: ranks '
        f'bit-identical, {gaps[0][0]:.3g} from one process at {gaps[0][1]} '
        f'(bar {K2_BAR}); {per_rank[0][2]} collectives in the run')

    # (k3) run_bisenet under the launcher, then resumed in this process
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'bisenet')
        env = {k: v for k, v in os.environ.items() if k not in (
            'WORLD_SIZE', 'RANK', 'LOCAL_RANK', 'MASTER_ADDR',
            'MASTER_PORT')}
        proc = subprocess.run(
            [sys.executable, '-m', 'torch.distributed.run', '--standalone',
             '--nproc_per_node', '1', '-m',
             'ctrlhair_tpu_torch.training.run_bisenet', '--dp', '1',
             '--synthetic', '--steps', '3', '--out-dir', out],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        launched_ms = (time.perf_counter() - t0) * 1e3
        if proc.returncode != 0:
            raise AssertionError('run_bisenet under torch.distributed.run '
                                 f'exited {proc.returncode}:\n'
                                 + proc.stderr[-4000:])
        _, step = load_checkpoint(os.path.join(out, 'checkpoints'))
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            state = run_bisenet.main(['--synthetic', '--steps', '4',
                                      '--out-dir', out])
        tree, last = load_checkpoint(os.path.join(out, 'checkpoints'))
        if step != 2 or last != 3 or state.step != 4 or \
                'resumed from step 2' not in said.getvalue() or \
                not bit_equal(tree, state.to_tree()):
            raise AssertionError(f'(k3) launched checkpoint at step {step}, '
                                 f'resumed run at {last} / {state.step}: '
                                 f'{said.getvalue()[-500:]}')
        del state
    seconds['k3'] = time.perf_counter() - t0
    rec['k3'] = {'launched_ms': launched_ms, 'checkpoint_step': step,
                 'resumed_to_step': last}
    log(f'[parallel] k3 python -m torch.distributed.run --standalone '
        f'--nproc_per_node 1 -m ctrlhair_tpu_torch.training.run_bisenet --dp '
        f'1 --synthetic --steps 3: exit 0 in {launched_ms:.1f} ms with its '
        f'start, checkpoint at step {step}, resumed in process to step '
        f'{last} ({smi})')
    rec['seconds'] = seconds
    log('[time] parallel phases, seconds: '
        + ', '.join(f'{k} {v:.1f}' for k, v in seconds.items()))
    gc.collect()
    torch.cuda.empty_cache()
    return read_launches('parallel', 0, 0), rec


# ----------------------------------------------- tensor parallelism (l)
# Phase (l): two gloo ranks on cuda:0 as make_mesh(2, tp=2) (dp 1; NCCL
# takes one rank a card), the shape trainer at phase (e)'s config on its
# first batches, and the colour/texture trainer at ColorTextureConfig(),
# batch CT_BATCH, lambda_rec_img off (no SEAN: the frozen SEAN is not what
# tp shards, and two copies of its step on one card buy nothing), the
# batches of phase (a).  For each: rank 0 first takes TP_STEPS plain steps
# in one process (float32, timed), then both ranks take TP_STEPS
# tensor-parallel steps (float32, timed), the two ranks' gathered trees
# bit-identical (a digest each); a NaN batch must leave the state
# bit-identical on both ranks, and the whole tree after step 1 (gathered,
# as rank 0 writes it in run_training; the disk round trip is the CPU
# tests') read into a new state on both ranks and stepped on must equal
# the unbroken run bit for bit (each rank's own slices compared: equal
# slices are equal gathered trees, and a gather of the shape state over
# gloo takes seconds).  The steps are held to one process with the models
# computing in float64 on both sides, as the training phase holds the
# shape step (trainer_phase): in float32 the shape step's own error
# reaches the bar; TP_BAR of each leaf's scale, the noise exemption of
# held_to_cpu.  Deterministic cuDNN, TF32 off.
TP_WORLD, TP_SIZE, TP_STEPS, TP_BAR = 2, 2, 2, 1e-4


def tp_trainer(family: str, cfg, device, mesh):
    """(trainer, state, extra step arguments) of phase (l)'s families."""
    from ctrlhair_tpu_torch.training.color_texture_trainer import (
        ColorTextureTrainer)
    from ctrlhair_tpu_torch.training.shape_trainer import ShapeTrainer
    if family == 'shape':
        trainer = ShapeTrainer(cfg, device=device, seed=SEED, mesh=mesh)
        return trainer, trainer.init_state(SEED), ()
    trainer = ColorTextureTrainer(cfg, device=device, seed=SEED, mesh=mesh)
    state, preds = trainer.init_state(SEED)
    return trainer, state, (preds,)


def tp_batches(spec, device):
    """Phase (l)'s batches of one family on `device`, and its NaN batch."""
    if spec['family'] == 'shape':
        with np.load(spec['batches']) as f:
            batches = [{k: torch.from_numpy(f[f'{i}/{k}']).to(device)
                        for k in ('target', 'face', 'hair', 'real')}
                       for i in range(TP_STEPS)]
        nan_at = ('face', (1, 3, 4, 0))
    else:
        from ctrlhair_tpu_torch.training.color_texture_trainer import (
            synthetic_batch)
        batches = [synthetic_batch(torch.Generator().manual_seed(100 + i),
                                   spec['cfg'], spec['batch'], device)
                   for i in range(TP_STEPS)]
        nan_at = ('code', (3, 7))
    nan_batch = {k: v.clone() for k, v in batches[0].items()}
    nan_batch[nan_at[0]][nan_at[1]] = float('nan')
    return batches, nan_batch


def tree_digest(tree) -> str:
    import hashlib
    h = hashlib.sha256()
    for path, a in tree_leaves(tree):
        h.update('/'.join(path).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def param_bytes(state) -> int:
    return sum(p.numel() * p.element_size() for m in trained_modules(state)
               for p in m.parameters())


def local_snapshot(state) -> list:
    """A copy of every tensor of a train state (this rank's slices)."""
    return [t.detach().clone() for t in state.tensors()]


def same_tensors(state, snapshot) -> bool:
    return all(torch.equal(a, b) for a, b in zip(state.tensors(), snapshot,
                                                 strict=True))


def timed_steps(trainer, state, extra, batches, mesh=None):
    """(state, metrics of the last, host ms a step, collectives a step)."""
    ms, coll, metrics = [], [], None
    for b in batches:
        before = 0 if mesh is None else mesh.collectives
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = trainer.train_step(state, b, *extra)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        coll.append(0 if mesh is None else mesh.collectives - before)
    return state, metrics, ms, coll


def l_rank(mesh, specs):
    """Phase (l) on one rank: for each family, on rank 0 the plain steps in
    one process (float32, timed; then with the models in float64, the
    reference), on both ranks the tensor-parallel steps (float32, timed;
    the NaN batch; the resume from the gathered tree after step 1; then in
    float64, held to the reference on rank 0); the readings."""
    from ctrlhair_tpu_torch.models.layers import set_compute_dtype
    from ctrlhair_tpu_torch.parallel.mesh import is_main
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    main = is_main(mesh)
    out = {}

    def float64(trainer, state, extra):
        for module in trained_modules(state):
            set_compute_dtype(module, torch.float64)
        return trainer, state, extra

    for name, spec in specs.items():
        family, cfg, dev = spec['family'], spec['cfg'], mesh.device
        batches, nan_batch = tp_batches(spec, dev)
        rec, seconds = {}, {}
        t0 = time.perf_counter()

        def lap(key):
            nonlocal t0
            torch.cuda.synchronize()
            seconds[key] = time.perf_counter() - t0
            t0 = time.perf_counter()

        def free():
            gc.collect()
            torch.cuda.empty_cache()

        if main:        # one process, on this rank alone
            trainer, state, extra = tp_trainer(family, cfg, dev, None)
            rec['plain_param_bytes'] = param_bytes(state)
            torch.cuda.reset_peak_memory_stats()
            state, _, rec['plain_ms'], _ = timed_steps(
                trainer, state, extra, batches)
            rec['plain_peak_bytes'] = torch.cuda.max_memory_allocated()
            trainer, state, extra = float64(*tp_trainer(family, cfg, dev,
                                                        None))
            init_tree = state.to_tree()
            state, plain_m, _, _ = timed_steps(trainer, state, extra,
                                               batches)
            plain_tree = state.to_tree()
            plain_m = {k: v.cpu() for k, v in plain_m.items()}
            del trainer, state, extra
            free()
            lap('plain')
        trainer, state, extra = tp_trainer(family, cfg, dev, mesh)
        rec['tp_param_bytes'] = param_bytes(state)
        torch.cuda.reset_peak_memory_stats()
        state, tp_m, rec['tp_ms'], rec['collectives'] = timed_steps(
            trainer, state, extra, batches, mesh)
        rec['tp_peak_bytes'] = torch.cuda.max_memory_allocated()
        if not bool(tp_m['finite']):
            raise AssertionError(f'(l) {name}: non-finite tp step')
        lap('tp_steps')
        rec['digest'] = tree_digest(state.to_tree())
        # the checks below compare this rank's own tensors (its slices):
        # equal slices on every rank are equal gathered trees
        unbroken = local_snapshot(state)
        lap('tp_gather')
        state, m = trainer.train_step(state, nan_batch, *extra)
        rec['nan_bit_identical'] = (
            not bool(m['finite']) and state.step == TP_STEPS + 1
            and same_tensors(state, unbroken))
        del trainer, state, extra
        free()
        lap('nan')
        # the whole tree after step 1 (gathered on every rank, as rank 0
        # writes it) read into a new state, which takes its slices and the
        # second step
        trainer, state, extra = tp_trainer(family, cfg, dev, mesh)
        state, _ = trainer.train_step(state, batches[0], *extra)
        tree = state.to_tree()
        trainer, state, extra = tp_trainer(family, cfg, dev, mesh)
        state.load_tree(tree)
        del tree
        for b in batches[1:]:
            state, _ = trainer.train_step(state, b, *extra)
        rec['resume_bit_identical'] = (state.step == TP_STEPS
                                       and same_tensors(state, unbroken))
        del trainer, state, extra, unbroken
        free()
        lap('resume')
        trainer, state, extra = float64(*tp_trainer(family, cfg, dev, mesh))
        state, tp_m, _, _ = timed_steps(trainer, state, extra, batches,
                                        mesh)
        tp_tree = state.to_tree()
        del trainer, state, extra
        free()
        if main:
            rec['held'] = held_to_cpu(
                tp_tree, {k: v.cpu() for k, v in tp_m.items()}, plain_tree,
                plain_m, init_tree, spec['lr'], gate=False, bar=TP_BAR)
            del plain_tree, init_tree
        del tp_tree
        free()
        lap('float64_held')
        rec['seconds'] = seconds
        out[name] = rec
    return out


def phase_tensor_parallel(tp_cases: dict, smi: str):
    """Phase (l), as the comment above says; the launch counts set to 0
    before it and read after it (no kernel of the port runs on this
    path)."""
    import tempfile
    from ctrlhair_tpu_torch.parallel.dryrun import run_on_ranks
    reset_launches()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        specs = {}
        for name, case in tp_cases.items():
            spec = {k: case[k] for k in ('family', 'cfg', 'lr', 'batch')}
            spec['tmp'] = tmp
            if case.get('batches') is not None:
                spec['batches'] = os.path.join(tmp, f'{name}.npz')
                np.savez(spec['batches'], **{
                    f'{i}/{k}': v.cpu().numpy()
                    for i, b in enumerate(case['batches'][:TP_STEPS])
                    for k, v in b.items()})
            specs[name] = spec
        per_rank = run_on_ranks(l_rank, TP_WORLD, specs, device='cuda:0',
                                backend='gloo', tp=TP_SIZE,
                                deadline_s=900.0, rank_timeout_s=600.0)
    seconds = time.perf_counter() - t0
    rec = {}
    for name in specs:
        r0, r1 = (r[name] for r in per_rank)
        held = r0['held']
        if r0['digest'] != r1['digest'] or not all(
                r[k] for r in (r0, r1) for k in (
                    'nan_bit_identical', 'resume_bit_identical')) or \
                not held['state_max_scaled_err'] <= TP_BAR or \
                not held['loss_max_scaled_err'] <= TP_BAR:
            raise AssertionError(f'(l) {name}: ranks {r0["digest"][:12]} / '
                                 f'{r1["digest"][:12]}, held {held}, NaN '
                                 f'{r0["nan_bit_identical"]} / '
                                 f'{r1["nan_bit_identical"]}, resume '
                                 f'{r0["resume_bit_identical"]} / '
                                 f'{r1["resume_bit_identical"]}')
        plain = float(np.median(r0['plain_ms'][1:]))
        tp_ms = float(np.median(r0['tp_ms'][1:]))
        rec[name] = {
            'config': tp_cases[name]['label'],
            'batch': tp_cases[name]['batch'], 'held': held,
            'param_bytes': {'one_process': r0['plain_param_bytes'],
                            'rank0': r0['tp_param_bytes'],
                            'rank1': r1['tp_param_bytes']},
            'collectives_per_step': r0['collectives'][-1],
            'plain_step_ms': r0['plain_ms'], 'tp_step_ms': r0['tp_ms'],
            'plain_ms': plain, 'tp_ms': tp_ms,
            'peak_bytes': {'one_process': r0['plain_peak_bytes'],
                           'rank0': r0['tp_peak_bytes'],
                           'rank1': r1['tp_peak_bytes']},
            'seconds': r0['seconds']}
        log(f'[tensor parallel] l {name} {rec[name]["config"]}, batch '
            f'{rec[name]["batch"]}, make_mesh({TP_WORLD}, tp={TP_SIZE}) on '
            f'{TP_WORLD} gloo ranks on cuda:0: {TP_STEPS} steps with the '
            'models in float64 held to one process '
            f'{held["state_max_scaled_err"]:.3g} at {held["worst_leaf"]} '
            f'(losses {held["loss_max_scaled_err"]:.3g}; bar {TP_BAR}; '
            f'{held["noise_gradient_entries"]} noise entries), ranks '
            'bit-identical, NaN batch and resume bit-identical on both; '
            f'trained parameter bytes rank 0 {r0["tp_param_bytes"]}, rank 1 '
            f'{r1["tp_param_bytes"]} against {r0["plain_param_bytes"]} in '
            f'one process; {r0["collectives"][-1]} collectives a step; tp '
            f'step {tp_ms:.3f} ms against plain {plain:.3f} ms (step '
            f'{TP_STEPS} of {TP_STEPS}, deterministic cuDNN); peak memory '
            f'rank 0 {r0["tp_peak_bytes"]} B, rank 1 {r1["tp_peak_bytes"]} '
            f'B, one process {r0["plain_peak_bytes"]} B; seconds '
            + ', '.join(f'{k} {v:.1f}' for k, v in r0['seconds'].items())
            + f' ({smi})')
    rec['seconds'] = seconds
    log(f'[time] tensor parallel phase (l): {seconds:.1f} s')
    return read_launches('tensor_parallel', 0, 0), rec


def phase_training(smi: str, dp_cases: dict):
    """The training slice: (d) the warp pool, whose warps launch K2, (e)
    the shape trainer on it, (a) colour/texture, (b) predictors, (f) the
    face parser, (g) the landmark regressor, (i) SEAN, (j) a canvas and a
    prep pass, (c) and (h) the entry points.
    Timed with cuDNN's defaults, as the entry points run; the checks run
    with deterministic cuDNN algorithms (deterministic)."""
    import tempfile
    reset_launches()
    rec, seconds = {}, {}

    def run(key, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[key] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
        return out

    with tempfile.TemporaryDirectory() as tmp:
        root, shape_batches, rec['warp_pool'] = run(
            'warp_pool', phase_train_pool, tmp, smi)
        rec['shape'] = run('shape', phase_train_shape, shape_batches, smi,
                           dp_cases)
        del shape_batches
        for key, fn, args in (
                ('color_texture', phase_train_ct, (dp_cases,)),
                ('predictors', phase_train_predictors, ()),
                ('bisenet', phase_train_bisenet, (dp_cases,)),
                ('landmark', phase_train_landmark, ()),
                ('sean', phase_train_sean, (dp_cases,))):
            rec[key] = run(key, fn, smi, *args)
        rec['canvas_prep'] = run('canvas_prep', phase_canvas_prep,
                                 os.path.join(tmp, 'prep'), smi)
        rec['run_color_texture'] = run('run_color_texture',
                                       phase_train_script, smi)
        rec['entry_points'] = run('entry_points', phase_train_entry_points,
                                  root, smi)
    rec['seconds'] = seconds
    log('[time] training phases, seconds: '
        + ', '.join(f'{k} {v:.1f}' for k, v in seconds.items()))
    return read_launches('training', 0, POOL_WARPS), rec


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
    t_phase = {'until_deployment': time.perf_counter() - t_start}
    d_launches, deployment = phase_deployment()
    t_phase['deployment'] = time.perf_counter() - t_start - sum(
        t_phase.values())
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
    t_phase['serving'] = time.perf_counter() - t_start - sum(
        t_phase.values())
    gc.collect()
    torch.cuda.empty_cache()

    # 9. the training slice: both counts set to 0 before it and read after
    # it; the warp pool launches K2 once a warp
    dp_cases = {}
    t_launches, training = phase_training(smi, dp_cases)
    t_phase['training'] = time.perf_counter() - t_start - sum(
        t_phase.values())

    # 10. phase (k), data parallelism: both counts set to 0 before it and
    # read after it
    p_launches, parallel = phase_parallel(dp_cases, smi)
    t_phase['parallel'] = time.perf_counter() - t_start - sum(
        t_phase.values())

    # 11. phase (l), tensor parallelism: both counts set to 0 before it and
    # read after it
    l_launches, tensor_parallel = phase_tensor_parallel(dp_cases.pop('tp'),
                                                        smi)
    t_phase['tensor_parallel'] = time.perf_counter() - t_start - sum(
        t_phase.values())
    log('[time] phases, seconds: '
        + ', '.join(f'{k} {v:.1f}' for k, v in t_phase.items()))
    cg_entry['case']['ptxas'] = {k: v for k, v in ptxas.items()
                                 if k.startswith('masked_cg')}
    raster_entry['case']['ptxas'] = ptxas['raster_uv']
    kernels = [{
        'name': 'masked_cg', 'route': 'cuda',
        'source': 'ctrlhair_tpu_torch/csrc/masked_cg.cu',
        'replaces': 'ctrlhair_tpu/ops/poisson_pallas.py:33',
        'launches': launches + b_launches['masked_cg']
        + d_launches['masked_cg'] + sum(s_launches['masked_cg'].values())
        + t_launches['masked_cg'] + p_launches['masked_cg']
        + l_launches['masked_cg'],
        'launches_by_path': {'editor': launches,
                             'backend': b_launches['masked_cg'],
                             'deployment': d_launches['masked_cg'],
                             **s_launches['masked_cg'],
                             'training': t_launches['masked_cg'],
                             'parallel': p_launches['masked_cg'],
                             'tensor_parallel': l_launches['masked_cg']},
        **cg_entry,
    }, {
        'name': 'raster_uv', 'route': 'cuda',
        'source': 'ctrlhair_tpu_torch/csrc/raster_uv.cu',
        'replaces': 'ctrlhair_tpu/ops/raster_pallas.py:146',
        'launches': raster_launches + b_launches['raster_uv']
        + d_launches['raster_uv'] + sum(s_launches['raster_uv'].values())
        + t_launches['raster_uv'] + p_launches['raster_uv']
        + l_launches['raster_uv'],
        'launches_by_path': {'editor': raster_launches,
                             'backend': b_launches['raster_uv'],
                             'deployment': d_launches['raster_uv'],
                             **s_launches['raster_uv'],
                             'training': t_launches['raster_uv'],
                             'parallel': p_launches['raster_uv'],
                             'tensor_parallel': l_launches['raster_uv']},
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
        'training': training, 'parallel': parallel,
        'tensor_parallel': tensor_parallel,
        'phase_seconds': t_phase,
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
