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
     builds it, its worker warmed first (HairEditor.warm_start at batch 1
     on zero inputs, its K1 launches counted apart), served on 127.0.0.1
     and driven over HTTP (both photos, every slider, the three transfers
     and random draws, the images, one bad request of each kind; the
     served PNGs decode to the held arrays), the first Backend.output on a
     new warmed worker against one on an unwarmed worker, then
     auto_curate('texture') and render_candidate_grids on its session;
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
     state bit-identical, and to its tree after step 2 loaded into a new
     state, whose run must equal the unbroken one bit for bit; then (c)
     run_color_texture.main([--synthetic, --steps 3]) and (h)
     run_shape.main on the pool, run_bisenet.main --synthetic and
     run_landmark.main, 3 steps each, in this process, each
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
     editor; then phase (n), the curation entry point
     (pipeline.find_directions.main) in this process on cuda:0, each route
     with its launch counts set to 0 before it and read after it: --pool-dir
     on the pool of (d), --auto for the texture slots, and the candidate
     grids with --choose, every directory temporary, model_trained/ held
     unchanged;
  6. data parallelism, phase (k), its launch counts set to 0 before it and
     read after it: (k1) a one-rank NCCL group in this process, the
     colour/texture, shape, face-parser and SEAN trainers of the training
     phase at their configs and batches, two steps through the group held
     bit-equal to two plain steps, then timed against them, the gradient
     reduce alone by CUDA events, and the face parser through
     ChunkRunner over the NCCL group after eager steps through it, its
     collectives captured in the CUDA graph, bit-identical to the same
     steps taken eagerly; (k2) the face parser at
     32 px on two gloo ranks on cuda:0 against one process on the global
     batch (run in the two ranks phase (l) spawns); (k3) run_bisenet under
     python -m torch.distributed.run --nproc_per_node 1, resumed in this
     process;
  7. tensor parallelism, phase (l), its launch counts set to 0 before it
     and read after it: two gloo ranks on cuda:0 as make_mesh(2, tp=2)
     (dp 1), the shape trainer of (e) on its first batches and the
     colour/texture trainer at ColorTextureConfig() (batch 128,
     lambda_rec_img off), each generator and discriminator sharded as
     JAX's dry run shards them; two steps held to one process on the
     card (in float64), the ranks' gathered trees bit-identical, a NaN
     batch and a resume after step 1 bit-identical on both ranks; the bytes of trained
     parameters a rank holds, collectives a step, tp against plain step ms
     and each rank's peak memory;
  8. chunked training, phase (m), its launch counts set to 0 before it and
     read after it: training/chunked.ChunkRunner with each step captured
     once as a CUDA graph and replayed, one host read of the metrics a
     chunk: the shape trainer of (e), batch 4 gathered on the card from
     the warp pool of (d), 5 steps in chunks of 2, the landmark trainer
     of (g), batch 64 gathered on the card from (g)'s rendered faces, 9
     steps in chunks of 4, then from pools on the card the colour/texture
     trainer at ColorTextureConfig(), batch 128, lambda_rec_img off (9 in
     chunks of 4) and on through a frozen seeded SEANConfig() SEAN (5 in
     chunks of 2), both predictor trainers, batch 256 (17 in chunks of
     8), the face parser at BiSeNetConfig(), batch 16 (9 in chunks of 4)
     and the SEAN trainer at SEANConfig(), batch 4 (5 in chunks of 2);
     each held to the eager per-step loop from the same state and streams
     (bit-identical with deterministic cuDNN, SEAN's u vectors bit for
     bit; the graph captured under cuDNN's defaults within 1e-3 after its
     first step), with a NaN batch inside the second chunk (one trip), a
     run resumed inside the run bit-identical to the straight one, and one
     capture a runner; eager and chunked ms a step, capture ms, kernels
     and runtime calls a step, the idle share of one chunk and peak
     memory.
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


# host seconds of the training phase's checks by part, summed over calls
# and keyed by the trainer they belong to (printed once at the end): where
# the smoke's time goes, for the next cut of its depth
LAPS: dict = {}
LAP_SCOPE = ['']


class lap:
    """with lap('part'): adds the block's host seconds to LAPS."""

    def __init__(self, part: str):
        self.key = f'{LAP_SCOPE[0]}: {part}'

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        LAPS[self.key] = LAPS.get(self.key, 0.0) + (
            time.perf_counter() - self.t0)


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


DEPLOYMENT_REPS = 2
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

    reset_launches()
    t0 = time.perf_counter()
    editor = web.build_web_editor()
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    # the worker's first job, the editor's warm-up on zero inputs at batch
    # 1: a blend in output and one in output_refresh
    warm_ms = editor.join_warm()
    warm_launches = read_launches('web warm-up', 2, 0)
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
        first = first_worker_outputs(web.WebEditor, be)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    record = {'build_ms': build_ms, 'requests': len(steps),
              'warm_up': {'ms': warm_ms, 'launches': warm_launches, **first},
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
    log(f'[web] warm-up: the worker\'s first job, warm_start() at batch 1 '
        f'on zero inputs, {warm_ms:.3f} ms, launches {warm_launches}; the '
        'first Backend.output on a new worker thread, warmed: '
        + ', '.join(f'{v:.3f}' for v in first['first_output_ms']['warmed'])
        + ' ms (its warm-up '
        + ', '.join(f'{v:.3f}' for v in first['warm_up_ms'])
        + ' ms), unwarmed: '
        + ', '.join(f'{v:.3f}' for v in first['first_output_ms']['unwarmed'])
        + ' ms; in this process that is the per-thread cost only: the '
        'libraries and cuDNN\'s start-up were paid by earlier phases '
        f'({smi})')
    return editor, launches, record


def first_worker_outputs(web_editor, be) -> dict:
    """The first Backend.output on the worker thread of a new WebEditor
    over `be`, with its warm-up (warm=True) and without, in turns (warmed,
    unwarmed, unwarmed, warmed): host ms, each ended by
    torch.cuda.synchronize(), and the warm-ups' ms."""
    def first_output():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        be.output()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    out = {'warmed': [], 'unwarmed': []}
    warm_ms = []
    for warm in (True, False, False, True):
        w = web_editor(be, warm=warm)
        try:
            if warm:
                warm_ms.append(w.join_warm())
            out['warmed' if warm else 'unwarmed'].append(
                w._worker.submit(first_output).result())
        finally:
            w.close()
    return {'first_output_ms': out, 'warm_up_ms': warm_ms}


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
    warm = web_rec['warm_up']['launches']
    launches = {
        'masked_cg': {'web_warm_up': warm['masked_cg'],
                      'web': web_launches['masked_cg'],
                      'curation': cur_launches,
                      'demo': demo_launches['masked_cg']},
        'raster_uv': {'web_warm_up': warm['raster_uv'],
                      'web': web_launches['raster_uv'], 'curation': 0,
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


def abs_max(a: np.ndarray) -> float:
    """The largest magnitude of an array, without a temporary (the checks
    compare trees of up to 6 GB; a temporary costs its page faults)."""
    if a.dtype.kind != 'f':
        return float(np.abs(a).max())
    return float(max(a.max(), -a.min()))


def tree_diff(got, ref) -> tuple:
    """(worst scaled difference, its leaf) between two state trees of the
    same keys: each leaf's largest difference over max(1, its largest
    magnitude in ref), in float64."""
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
        diff = np.asarray(np.subtract(a, b, dtype=np.float64))
        d = float(np.abs(diff, out=diff).max()) / max(1.0, abs_max(b))
        if not d <= worst:
            worst, where = d, '/'.join(path)
    return worst, where


def bit_equal(got, ref) -> bool:
    g, r = list(tree_leaves(got)), list(tree_leaves(ref))
    return [p for p, _ in g] == [p for p, _ in r] and all(
        a.shape == b.shape and np.array_equal(a, b, equal_nan=False)
        for (_, a), (_, b) in zip(g, r))


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
    masks = {}
    for path, a in mus[1].items():
        diff = np.asarray(np.subtract(mus[0][path], a))
        bar = np.asarray(np.abs(a))
        bar *= 1e-2
        masks[path] = np.abs(diff, out=diff) > bar
    return masks


def trained_modules(state) -> list:
    """The modules a train state trains: a GAN state's three parts or the
    one model of the others."""
    parts = state.parts().values() if hasattr(state, 'parts') \
        else [state.model]
    return [part.module for part in parts]


def state_parts(state) -> dict:
    """{part: its ModelOpt or SGDModelOpt} of a train state."""
    return state.parts() if hasattr(state, 'parts') else \
        {'model': state.model}


def tensor_names(state) -> list:
    """A name for each tensor of state.tensors(), in its order."""
    names = []
    for part, m in state_parts(state).items():
        names += [f'{part}/{n}' for n, _ in m.module.named_parameters()]
        names += [f'{part}/{n}' for n, _ in m.module.named_buffers()]
        for key in ('mu', 'nu', 'trace'):
            names += [f'{part}/{key}/{n}' for n in getattr(m, key, {})]
        if hasattr(m, 'count'):
            names.append(f'{part}/count')
    for key in ('sn_u', 'dis_sn_u'):
        names += [f'{key}/{n}' for n in (getattr(state, key, None) or {})]
    return names


def one_step(make_trainer, init_tree, batch, draws, device, dtype=None):
    """(state, metrics, {part: its parameters before the step}) after one
    step on `device` from `init_tree`, the models computing in `dtype`
    (None: as built); `draws` None for a trainer whose step draws
    nothing."""
    from ctrlhair_tpu_torch.models.layers import set_compute_dtype
    with lap(f'check build {device}'):
        trainer, state, args = make_trainer(device)
        state.load_tree(init_tree)
    if dtype is not None:
        frozen = [m for m in (getattr(trainer, 'vgg', None),) if m is not None]
        for module in trained_modules(state) + frozen:
            set_compute_dtype(module, dtype)
    init = {k: [p.detach().clone() for p in m.params()]
            for k, m in state_parts(state).items()}
    b = to_device(batch, device)
    extra = () if draws is None else ({
        k: ([m.to(device) for m in v] if isinstance(v, list)
            else v.to(device)) for k, v in draws.items()},)
    with lap(f'check step {device}'):
        state, metrics = trainer.train_step(state, b, *args(state), *extra)
        metrics = {k: v.cpu() for k, v in metrics.items()}
    return state, metrics, init


@torch.no_grad()
def held_on_card(card, card_m, ref, cpu_m, init, lr: dict,
                 bar: float = TRAIN_CARD_BAR) -> dict:
    """held_to_cpu, computed on the card over the live states: `card` the
    card's state, `ref` the CPU state's tensors copied to the card (in
    state.tensors()'s order), `init` {part: the parameters before the
    step} on the card.  The same values as held_to_cpu over the two
    states' trees, without a copy of the card's state to the host."""
    loss_err = check_metrics(card_m, cpu_m, 'card against CPU', True, bar)
    got = list(card.tensors())
    ref = list(ref)
    index = {id(t): i for i, t in enumerate(got)}
    noisy = 0
    for part, part_lr in lr.items():
        m = state_parts(card)[part]
        for p, mu, p0 in zip(m.params(), m.mu.values(), init[part]):
            i, j = index[id(p)], index[id(mu)]
            mask = (mu - ref[j]).abs() > 1e-2 * ref[j].abs()
            if not bool(mask.any()):
                continue
            for side in (got[i], ref[i]):
                moved = float((side - p0).abs()[mask].max())
                if moved > 2 * part_lr:
                    raise AssertionError(
                        f'{part}: an entry with a noise gradient moved '
                        f'{moved:.3g} > 2 lr')
            got[i] = torch.where(mask, 0.0, got[i])
            ref[i] = torch.where(mask, 0.0, ref[i])
            noisy += int(mask.sum())
    names = tensor_names(card)
    worst, where = 0.0, None
    for k, (a, b) in enumerate(zip(got, ref, strict=True)):
        if b.numel() == 0:
            continue
        d = float((a.double() - b.double()).abs().max()) / max(
            1.0, float(b.double().abs().max()))
        if not d <= worst:
            worst, where = d, names[k] if len(names) == len(got) else k
    if not worst <= bar:
        raise AssertionError(f'card against CPU: {where} differs by '
                             f'{worst:.3g} (bar {bar})')
    return {'state_max_scaled_err': worst, 'worst_leaf': where,
            'loss_max_scaled_err': loss_err,
            'noise_gradient_entries': noisy}


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
            if not mask.any():
                continue
            for side in sides:
                moved = np.abs(side[path][mask] - init[path][mask])
                if gate and moved.max() > 2 * part_lr:
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
    held as held_to_cpu says (held_on_card: the CPU's state is copied to
    the card and the two compared there).  With `float32`, the card's
    step as built (float32) is held against that CPU step to
    FLOAT32_CARD_BAR under 'float32'."""
    cpu, cpu_m = one_step(make_trainer, init_tree, batch, draws, 'cpu',
                          dtype)[:2]
    with lap('check copy'):
        ref = [t.to('cuda') for t in cpu.tensors()]
    del cpu
    out = {}
    for key, dt, bar in (('', dtype, TRAIN_CARD_BAR),
                         ('float32', None, FLOAT32_CARD_BAR)):
        if key and not float32:
            continue
        card, m, init = one_step(make_trainer, init_tree, batch, draws,
                                 'cuda', dt)
        with lap('check compare'):
            held = held_on_card(card, m, ref, cpu_m, init, lr, bar)
        del card, init
        if key:
            out[key] = held
        else:
            out.update(held)
    return out


def nan_and_resume(make_trainer, init_tree, batches, nan_batch,
                   moved=None):
    """A NaN batch leaves the state bit-identical (its step aside); the
    state's tree after step 2 loaded into a new trainer's state and run to
    the end equals the unbroken run bit for bit.  The tree stays in memory:
    the entry points of (c) and (h) write the colour/texture, shape,
    face-parser, landmark and SEAN checkpoints at these widths and read
    them back equal (the predictors' few MB are the CPU tests'), so the
    disk would add nothing here but seconds.  The states are compared
    tensor for tensor on the card (state.tensors(): every leaf of the
    tree), which copies nothing to the host.
    `moved(state, before)`: for a state that a NaN step rightly moves in
    part (the SEAN trainer's u vectors), checks those tensors against the
    state's tensors before the step and returns the names of the state's
    dicts of them, which the bit identity leaves out."""
    def same(state, ref, skip=()):
        left_out = {id(t) for k in skip for t in getattr(state, k).values()}
        return all(torch.equal(a, b) for a, b in zip(state.tensors(), ref,
                                                     strict=True)
                   if id(a) not in left_out)

    with lap('nan_resume build'):
        trainer, state, args = make_trainer('cuda')
        state.load_tree(init_tree)
    with lap('nan_resume steps'):
        for b in batches:
            state, _ = trainer.train_step(state, b, *args(state))
        unbroken = [t.clone() for t in state.tensors()]
        step = state.step
        state, m = trainer.train_step(state, nan_batch, *args(state))
    with lap('nan_resume compare'):
        skip = moved(state, unbroken) if moved else ()
        if bool(m['finite']) or state.step != step + 1 or \
                not same(state, unbroken, skip):
            raise AssertionError('a NaN batch moved the training state')
    with lap('nan_resume build'):
        trainer, state, args = make_trainer('cuda')
        state.load_tree(init_tree)
    last = 2
    with lap('nan_resume steps'):
        for b in batches[:last + 1]:
            state, _ = trainer.train_step(state, b, *args(state))
    with lap('nan_resume to_tree'):
        tree = state.to_tree()
    with lap('nan_resume build'):
        trainer, state, args = make_trainer('cuda')
        state.load_tree(tree)
    del tree
    with lap('nan_resume steps'):
        for b in batches[last + 1:]:
            state, _ = trainer.train_step(state, b, *args(state))
    with lap('nan_resume compare'):
        if state.step != step or not same(state, unbroken):
            raise AssertionError('the run resumed after step 2 differs from '
                                 'the unbroken run')
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
    sean_ms = wall_ms(sean_fn, 3)
    sean_ms_det = deterministic(wall_ms)(sean_fn, 3)
    sean_ms_tuned = autotuned(wall_ms)(sean_fn, 3)
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
    LAP_SCOPE[0] = name.split()[0]
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
    t0 = time.perf_counter()
    cpu_check = deterministic(card_against_cpu)(
        make_check, make_check('cuda')[1].to_tree() if check else init_tree,
        first_samples({k: v.cpu() for k, v in batch.items()}, n_all,
                      CHECK_BATCH),
        None if check_draws is None else first_samples(
            {k: v.cpu() for k, v in check_draws.items()}, n_all,
            CHECK_BATCH),
        lr, dtype=torch.float64, float32=True)
    t1 = time.perf_counter()
    checks = deterministic(nan_and_resume)(make_trainer, init_tree, batches,
                                           nan_batch)
    check_s = {'card_vs_cpu': t1 - t0,
               'nan_and_resume': time.perf_counter() - t1}
    log(f'[train] {name} checks: card against CPU {cpu_check} (bars '
        f'{TRAIN_CARD_BAR}, float32 {FLOAT32_CARD_BAR}); {checks}; seconds '
        f'{check_s}')
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return {'trained_parameters': n_params, 'step_ms': ms, 'median_ms': med,
            'steps_per_s': 1e3 / med, 'peak_bytes': peak, 'profile': prof,
            'losses': losses, 'card_vs_cpu': cpu_check,
            'check_seconds': check_s, **checks}


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


def phase_train_landmark(smi: str, dp_cases: dict) -> dict:
    """(g) The landmark regressor at LandmarkNetConfig() (128 px), batch 64
    from the port's renderer; its batches, stacked, are phase (m)'s pool."""
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
    dp_cases['chunked']['landmark_pool'] = {
        k: torch.cat([b[k] for b in batches]) for k in batches[0]}
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


# The Zencoder's transposed convolution (up_0) alone: the port's forward,
# which takes cuDNN's deterministic algorithms whatever the global flag
# (models/layers.ConvTranspose), against F.conv_transpose2d under cuDNN's
# defaults (the forward before the repair of the float32 SEAN step), at the
# editor's shape (one image, bfloat16, forward: analyze_image) and the
# SEAN trainer's (batch 4, float32, forward and backward); mean ms by CUDA
# events, the two taken in turns.
CONV_T_REPS, CONV_T_ROUNDS = 20, 3


def conv_transpose_times(smi: str) -> dict:
    from ctrlhair_tpu_torch.config import SEANConfig
    from ctrlhair_tpu_torch.models.layers import (
        TorchConvTranspose, init_parameters_, set_compute_dtype)
    import torch.nn.functional as F
    cfg = SEANConfig()
    cin, side = cfg.zencoder_ngf * 4, cfg.crop_size // 4
    up = TorchConvTranspose(cin, cfg.zencoder_ngf * 8, 3, 2, 1, 1)
    init_parameters_(up, torch.Generator().manual_seed(SEED))
    up.cuda()
    conv = up.conv
    gen = torch.Generator('cuda').manual_seed(SEED)
    out = {}
    for name, n, dtype, backward in (
            ('editor', 1, torch.bfloat16, False),
            ('trainer', SEAN_BATCH, torch.float32, True)):
        set_compute_dtype(up, dtype)
        x = torch.randn((n, cin, side, side), generator=gen,
                        device='cuda').to(dtype).requires_grad_(backward)

        def timed(forward):
            def call():
                y = forward(x)
                if backward:
                    torch.autograd.grad(y.float().square().sum(),
                                        (x, conv.weight))
            return call

        def plain(x):
            return F.conv_transpose2d(
                x, conv.weight.to(dtype), conv.bias.to(dtype), conv.stride,
                conv.padding, conv.output_padding)

        fns = {'port_deterministic': timed(up), 'plain_defaults': timed(plain)}
        ms = {k: [] for k in fns}
        for _ in range(CONV_T_ROUNDS):
            for k, fn in fns.items():
                ms[k].append(cuda_ms(fn, CONV_T_REPS))
        out[name] = {'input': [n, cin, side, side], 'dtype': str(dtype),
                     'backward': backward,
                     **{k: float(np.median(v)) for k, v in ms.items()}}
    log('[time] ConvTranspose (SEAN Zencoder up_0) alone, median of '
        f'{CONV_T_ROUNDS} means of {CONV_T_REPS}: ' + '; '.join(
            f'{k} {v["input"]} {v["dtype"]}'
            f'{" forward+backward" if v["backward"] else " forward"}: port '
            f'(deterministic) {v["port_deterministic"]:.4f} ms, '
            f'F.conv_transpose2d (defaults) {v["plain_defaults"]:.4f} ms'
            for k, v in out.items()) + f' ({smi})')
    return out


@torch.no_grad()
def sean_u_moved(state, before: list):
    """A NaN step of the SEAN trainer: each u vector is one power iteration
    on from the unchanged weights (JAX's rule), within 1e-5, computed in
    float64 on the card over each kernel as [kh*kw*in, out], as JAX lays
    it out; `before` the state's tensors before the step."""
    index = {id(t): i for i, t in enumerate(state.tensors())}
    for key, part in (('sn_u', state.gen), ('dis_sn_u', state.dis)):
        params = dict(part.module.named_parameters())
        for name, u in getattr(state, key).items():
            w = params[name].double()
            mat = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])
            v = mat.t() @ before[index[id(u)]].double()
            v /= torch.linalg.vector_norm(v) + 1e-12
            want = mat @ v
            want /= torch.linalg.vector_norm(want) + 1e-12
            if not float((u.double() - want).abs().max()) <= 1e-5:
                raise AssertionError(f'a NaN step moved {key} other than '
                                     'by one power iteration')
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
    LAP_SCOPE[0] = 'sean'
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
    conv_t = conv_transpose_times(smi)
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
            'card_vs_cpu': cpu_check, 'check_seconds': check_s,
            'conv_transpose_ms': conv_t, **checks}


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
            LAP_SCOPE[0] = 'entry points'
            with lap(f'{name} checkpoint read back'):
                tree, step = load_checkpoint(os.path.join(d, 'checkpoints'))
                equal = bit_equal(tree, state.to_tree())
            module = (state.model if name == 'run_bisenet' else state.gen
                      ).module
            if step != 2 or state.step != 3 or not equal or \
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
# against the single process on the global batch; it runs in the two ranks
# that phase (l) spawns, as a dp mesh of its own, before (l)'s steps (a
# spawn of two ranks costs seconds).  (k3) run_bisenet under
# python -m torch.distributed.run, resumed in this process.  And in (k1),
# the face parser over the group through ChunkRunner: K1_CHUNK_STEPS eager
# steps through the group, then K1_CHUNK_STEPS more of that same state in
# chunks of K1_CHUNK_SIZE, its collectives (the gradient buckets, the
# metrics' mean, synced batch norm) captured in the CUDA graph, against
# 2 * K1_CHUNK_STEPS steps taken eagerly through the group, bit for bit
# (deterministic cuDNN).
DP_CHECK_STEPS, DP_TIME_STEPS, DP_GAP_BAR = 2, 3, 1e-6
K1_CHUNKED, K1_CHUNK_STEPS, K1_CHUNK_SIZE = 'bisenet', 5, 2
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
        """The two states after the checked steps, compared tensor for
        tensor on the card: (bit-identical, worst scaled gap)."""
        for b in batches[:DP_CHECK_STEPS]:
            for key in ('plain', 'dp'):
                step(key, b)
        return state_gap(sides['dp'][1].tensors(),
                         sides['plain'][1].tensors())

    same, gap = checked_steps()
    if not same and not gap <= DP_GAP_BAR:
        raise AssertionError(f'{name}: the one-rank DP state stands {gap:.3g} '
                             f'from the plain one (bar {DP_GAP_BAR})')
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
           'bit_equal': same, 'gap': gap,
           'reduce_ms': reduce_ms, 'reduce_share': reduce_ms / dp_ms,
           'plain_step_ms': ms['plain'], 'dp_step_ms': ms['dp'],
           'plain_median_ms': plain_ms, 'dp_median_ms': dp_ms,
           'collectives_per_step': collectives}
    log(f'[parallel] k1 {name}: {DP_CHECK_STEPS} one-rank NCCL DP steps '
        f'against {DP_CHECK_STEPS} plain steps: '
        + ('bit-identical' if same else f'gap {gap:.3g}')
        + f'; {n_params} trained parameters, {4 * n_params} B of gradient '
        f'reduced a step in {reduce_ms:.3f} ms (CUDA events, '
        f'{100 * reduce_ms / dp_ms:.2f}% of a DP step); DP step '
        f'{dp_ms:.3f} ms against plain {plain_ms:.3f} ms (median of steps '
        f'2 to {DP_TIME_STEPS}); {collectives} collectives a step ({smi})')
    return rec


@deterministic
def k1_chunked_case(name, make, batches, mesh, smi) -> dict:
    """(k1) one trainer over the one-rank NCCL group through ChunkRunner,
    as the comment above says: K1_CHUNK_STEPS eager steps through the
    group, then K1_CHUNK_STEPS more chunked from that same state (its
    tensors put back after the eager reference's next K1_CHUNK_STEPS
    steps), against the 2 * K1_CHUNK_STEPS eager steps."""
    from ctrlhair_tpu_torch.parallel.mesh import replicated, shard_batch
    from ctrlhair_tpu_torch.training.chunked import WARMUP_STEPS, ChunkRunner
    def make_batch(seed):
        return shard_batch(batches[seed % len(batches)], mesh)

    k = K1_CHUNK_STEPS
    trainer, state, args = make('cuda', mesh=mesh)
    replicated(state, mesh)
    for s in range(2 * k):
        if s == k:
            at_k = [t.clone() for t in state.tensors()]
        state, _ = trainer.train_step(state, make_batch(s), *args(state))
    eager = [t.clone() for t in state.tensors()]
    with torch.no_grad():
        for t, v in zip(state.tensors(), at_k):
            t.copy_(v)
    state.step = k
    del at_k
    runner = ChunkRunner(trainer.train_step, make_batch)
    before = mesh.collectives
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, rows, trips = runner.run(state, k, 2 * k,
                                    chunk_size=K1_CHUNK_SIZE, record_every=1)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    per_step = (mesh.collectives - before) / (WARMUP_STEPS + 1)
    identical, gap = state_gap(state.tensors(), eager)
    if not identical or trips != 0 or runner.captures != 1 or \
            state.step != 2 * k or not per_step:
        raise AssertionError(
            f'(k1) {name} chunked over the NCCL group after {k} eager '
            f'steps: bit-identical {identical} (gap {gap:.3g}), {trips} '
            f'trips, {runner.captures} captures, {per_step} collectives a '
            'step')
    log(f'[parallel] k1 {name} through ChunkRunner over the one-rank NCCL '
        f'group: {k} eager steps through the group, then steps {k} to '
        f'{2 * k - 1} of the same state in chunks of {K1_CHUNK_SIZE}, '
        f'{per_step:.0f} collectives a step captured in the graph, '
        f'bit-identical to {2 * k} eager steps; {wall:.1f} ms with the '
        f'capture of {runner.capture_ms[0]:.1f} ms (deterministic cuDNN; '
        f'{smi})')
    return {'eager_steps': k, 'steps': k, 'chunk_size': K1_CHUNK_SIZE,
            'bit_identical': identical, 'finite_trips': trips,
            'captures': runner.captures,
            'collectives_per_step': per_step, 'wall_ms': wall,
            'capture_ms': runner.capture_ms[0]}


def k2_batch() -> dict:
    """(k2)'s global batch, from the seed (numpy)."""
    rng = np.random.default_rng(SEED)
    s = K2_CFG['input_size']
    return {'image': rng.standard_normal((K2_BATCH, s, s, 3)).astype(
                np.float32),
            'label': rng.integers(0, 19, (K2_BATCH, s, s)).astype(np.int32)}


def k2_check(per_rank: list, batch: dict) -> dict:
    """(k2): the ranks' face-parser steps (k2_rank's readings) against one
    process on the global batch."""
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
    log(f'[parallel] k2 face parser BiSeNetConfig({K2_CFG}), global batch '
        f'{K2_BATCH} on {K2_WORLD} gloo ranks on cuda:0 (the ranks of phase '
        f'(l), as a dp mesh): ranks bit-identical, {gaps[0][0]:.3g} from one '
        f'process at {gaps[0][1]} (bar {K2_BAR}); {per_rank[0][2]} '
        'collectives in the run')
    return {'world': K2_WORLD, 'backend': 'gloo', 'batch': K2_BATCH,
            'config': f'BiSeNetConfig({K2_CFG})', 'gap': gaps[0][0],
            'gap_leaf': gaps[0][1], 'collectives': per_rank[0][2]}


def phase_parallel(dp_cases: dict, smi: str):
    """Phase (k): (k1) and (k3) as the comment above them says ((k2) runs
    in phase (l)'s ranks); the launch counts set to 0 before it and read
    after it (no kernel of the port runs on this path)."""
    import contextlib
    import io
    import tempfile
    import torch.distributed as dist
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
                if name == K1_CHUNKED:
                    rec[f'{name}_chunked'] = k1_chunked_case(
                        name, make, batches, mesh, smi)
                del make, batches
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    seconds['k1'] = time.perf_counter() - t0

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
# tensor-parallel steps (float32, timed); a NaN batch must leave the state
# bit-identical on both ranks, and the whole tree after step 1 (gathered,
# as rank 0 writes it in run_training; the disk round trip is the CPU
# tests') read into a new state on both ranks and stepped on must equal
# the unbroken run bit for bit (each rank's own slices compared: equal
# slices are equal gathered trees, and a gather of the shape state over
# gloo takes seconds).  The first TP_HELD_STEPS steps are held to one
# process with the models computing in float64 on both sides (the two
# ranks' gathered trees of these steps bit-identical, a digest each), as
# the training phase holds the shape step (trainer_phase): in float32 the
# shape step's own error
# reaches the bar; TP_BAR of each leaf's scale, the noise exemption of
# held_to_cpu.  Deterministic cuDNN, TF32 off.
TP_WORLD, TP_SIZE, TP_STEPS, TP_BAR = 2, 2, 2, 1e-4
# steps of the float64 hold (two until PR 11; one for room in the smoke)
TP_HELD_STEPS = 1


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
        h.update(memoryview(np.ascontiguousarray(a)).cast('B'))
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


def l_rank(mesh, payload):
    """Phase (l) on one rank, after (k2)'s step over the same two ranks as
    a dp mesh (one spawn for both: a rank takes seconds to start): for
    each family, on rank 0 the plain steps in one process (float32, timed;
    then with the models in float64, the reference), on both ranks the
    tensor-parallel steps (float32, timed; the NaN batch; the resume from
    the gathered tree after step 1; then in float64, held to the reference
    on rank 0); the readings."""
    from ctrlhair_tpu_torch.models.layers import set_compute_dtype
    from ctrlhair_tpu_torch.parallel.mesh import is_main, make_mesh
    out = {'k2': k2_rank(make_mesh(TP_WORLD, tp=1, device=mesh.device),
                         payload['k2'])}
    specs = payload['families']
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    main = is_main(mesh)

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
                                               batches[:TP_HELD_STEPS])
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
        # the checks below compare this rank's own tensors (its slices):
        # equal slices on every rank are equal gathered trees
        unbroken = local_snapshot(state)
        lap('snapshot')
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
        state, tp_m, _, _ = timed_steps(trainer, state, extra,
                                        batches[:TP_HELD_STEPS], mesh)
        tp_tree = state.to_tree()
        rec['digest'] = tree_digest(tp_tree)
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
        batch = k2_batch()
        per_rank = run_on_ranks(l_rank, TP_WORLD,
                                {'families': specs, 'k2': batch},
                                device='cuda:0', backend='gloo', tp=TP_SIZE,
                                deadline_s=900.0, rank_timeout_s=600.0)
    rec = {'k2': k2_check([r['k2'] for r in per_rank], batch)}
    seconds = time.perf_counter() - t0
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
            f'{TP_WORLD} gloo ranks on cuda:0: {TP_HELD_STEPS} step with the '
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


# ------------------------------------------------- chunked training (m)
# Phase (m): ChunkRunner (ctrlhair_tpu_torch/training/chunked.py) on the
# card, each step captured once as a CUDA graph and replayed, one host read
# of the metrics a chunk.  The shape trainer at ShapeConfig() with the
# soak's recipe, batch 4 gathered on the card from the warp pool of (d) (K2
# built it), CHUNK_SHAPE steps in chunks of 2 (2, 2, 1); the landmark
# trainer at LandmarkNetConfig(), batch 64 gathered on the card from the
# faces phase (g) rendered on the host, CHUNK_LANDMARK steps in chunks of 4
# (PR 11 ran 9 in chunks of 4 and 17 in chunks of 8; cut for room).
# For each: the eager per-step loop and the chunked run from the same state
# on the same streams (batch of step s from CHUNK_BATCH_SEED + s, draws from
# step s), a NaN batch inside the second chunk; the two states bit-identical
# (else their gap held to CHUNK_GAP_BAR of each tensor's scale and stated),
# one trip; then the chunked run of 0..k and k..end from the same state
# again (k = CHUNK_RESUME_AT, or CHUNK_SHORT_RESUME_AT for a run of 5),
# bit-identical to the straight chunked run, and each runner's
# graph captured once; eager and chunked ms a
# step, capture ms, runtime calls and kernels a step and the idle share of
# one chunk under torch.profiler, peak memory.  Timed with cuDNN's
# defaults, held bit for bit with deterministic cuDNN: the defaults'
# algorithms do not give the same bits twice even eagerly, and Adam
# amplifies their noise over the steps until no bar can be set.  So the
# graph captured under the defaults, the one that is timed and that
# training uses, is held after its first step: its state (measured as
# held_to_cpu measures a step, the noise entries held to a move of 2 lr)
# and its losses within CHUNK_DEFAULT_BAR of the eager first step under the
# defaults.  The bar lies between two readings (PERF.md): two eager first
# steps under the defaults, which stand apart by their noise alone, and a
# wrong algorithm, which put the float32 SEAN step 4.4e-3 of a gradient's
# scale from float64 (FLOAT32_CARD_BAR is 5e-3).
CHUNK_SHAPE, CHUNK_SHAPE_SIZE = 5, 2
CHUNK_LANDMARK, CHUNK_LANDMARK_SIZE = 9, 4
CHUNK_BATCH_SEED, CHUNK_NAN_STEP, CHUNK_RESUME_AT = 1000, 5, 4
CHUNK_GAP_BAR, CHUNK_DEFAULT_BAR = 1e-6, 1e-3
# The other trainers, each at its published config and batch, from pools on
# the card gathered by seed as the shape and landmark batches are: the
# colour/texture trainer at ColorTextureConfig(), batch CT_BATCH, with
# lambda_rec_img off (the phase JAX's soak chunks) and on from step 0
# through phase (a)'s frozen seeded SEANConfig() SEAN, the frozen predictors
# passed as the runner's extra arguments; both predictor trainers, batch
# PREDICTOR_BATCH; the face parser at BiSeNetConfig(), batch BISENET_BATCH
# (SGD: no noise exemption); the SEAN trainer at SEANConfig(), batch
# SEAN_BATCH (spectral norm on, ACE noise off: no draws), whose u vectors
# after the last step must equal the eager run's bit for bit.  (steps,
# chunk size); the 5-step cases take their NaN batch and their resume at
# step 3, inside the second chunk.
CHUNK_CT, CHUNK_CT_REC = (9, 4), (5, 2)
CHUNK_PREDICTOR, CHUNK_BISENET, CHUNK_SEAN = (17, 8), (9, 4), (5, 2)
CHUNK_SHORT_NAN_STEP, CHUNK_SHORT_RESUME_AT = 3, 3


def device_shape_pool(root: str) -> dict:
    """The warp pool of (d) as uint8 label maps on the card, at
    ShapeConfig().img_size: each pool file's target, face and hair, and
    the real masks of ShapeDataset (its files and resize)."""
    from ctrlhair_tpu_torch.config import ShapeConfig
    from ctrlhair_tpu_torch.data.shape_dataset import (
        ShapeDataset, _load_label)
    ds = ShapeDataset(ShapeConfig(), root)
    maps = {'target': [], 'face': [], 'hair': []}
    for fname in ds.pool_files:
        parts = os.path.splitext(fname)[0].split('___')
        maps['target'].append(_load_label(os.path.join(ds.pool_dir, fname)))
        maps['hair'].append(_load_label(ds.catalog.label_path(
            f'{parts[0]}___{parts[1]}')))
        maps['face'].append(_load_label(ds.catalog.label_path(
            f'{parts[2]}___{parts[3]}')))
    maps['real'] = [_load_label(ds.catalog.label_path(k))
                    for k in ds.real_keys]
    return {k: torch.from_numpy(np.stack([ds._resize(m) for m in v])
                                .astype(np.uint8)).cuda()
            for k, v in maps.items()}


def shape_pool_batches(pool: dict, n: int, nan_seed: int):
    """make_batch(seed) of the shape trainer: n triplets and n real masks
    gathered on the card by indices and mirror bits that a card generator
    seeded by `seed` draws (ShapeDataset's batch, on the card); a NaN in
    the face mask of the batch of nan_seed."""
    from ctrlhair_tpu_torch.utils.masks import label_to_one_hot
    n_pool, n_real = pool['target'].shape[0], pool['real'].shape[0]

    def take(maps, idx, mirror):
        lab = maps[idx].long()
        return label_to_one_hot(torch.where(mirror[:, None, None],
                                            lab.flip(-1), lab))

    def make_batch(seed):
        gen = torch.Generator('cuda').manual_seed(seed)
        idx = torch.randint(0, n_pool, (n,), generator=gen, device='cuda')
        ridx = torch.randint(0, n_real, (n,), generator=gen, device='cuda')
        mirror, rmirror = torch.randint(0, 2, (2, n), generator=gen,
                                        device='cuda').bool()
        batch = {k: take(pool[k], idx, mirror)
                 for k in ('target', 'face', 'hair')}
        batch['real'] = take(pool['real'], ridx, rmirror)
        if seed == nan_seed:
            batch['face'][1, 3, 4, 0] = float('nan')
        return batch

    return make_batch


def pool_batches(pool: dict, n: int, nan_seed: int, nan_key: str,
                 nan_index: tuple):
    """make_batch(seed): n rows gathered on the card from a pool of rows
    by indices a card generator seeded by `seed` draws (as run_landmark
    gathers its samples); a NaN at pool[nan_key][nan_index] in the batch
    of nan_seed."""
    n_pool = pool[nan_key].shape[0]

    def make_batch(seed):
        gen = torch.Generator('cuda').manual_seed(seed)
        idx = torch.randint(0, n_pool, (n,), generator=gen, device='cuda')
        batch = {k: v[idx] for k, v in pool.items()}
        if seed == nan_seed:
            batch[nan_key][nan_index] = float('nan')
        return batch

    return make_batch


def landmark_pool_batches(pool: dict, n: int, nan_seed: int):
    """make_batch(seed) of the landmark trainer from the rendered pool; a
    NaN in one pixel of the batch of nan_seed."""
    return pool_batches(pool, n, nan_seed, 'image', (5, 3, 4, 0))


def profile_chunk(fn, steps: int, step_ms: float) -> dict:
    """torch.profiler over one call of `fn` (a chunk of `steps` steps,
    warm: the caller has run it): kernels a step and their device ms
    (kernel records, as profile_step reads them), the CUDA runtime's launch
    and copy calls a step, and the card's idle share of `steps` x
    `step_ms` (the unprofiled median)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device_ms, kernels, calls = 0.0, 0, {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 \
                and not e.key.startswith(('Activity Buffer', 'Buffer Flush')):
            device_ms += e.self_device_time_total / 1e3
            kernels += e.count
        elif e.device_type == DeviceType.CPU and e.key.startswith('cuda') \
                and ('Launch' in e.key or 'Memcpy' in e.key):
            calls[e.key] = e.count / steps
    wall = steps * step_ms
    return {'device_ms_per_step': device_ms / steps,
            'kernels_per_step': kernels / steps,
            'runtime_calls_per_step': calls,
            'idle_share': max(0.0, 1.0 - device_ms / wall) if device_ms
            else None}


@torch.no_grad()
def state_gap(got: list, ref: list) -> tuple:
    """(bit-identical, worst difference scaled by max(1, |ref|max)) of two
    states' tensor lists."""
    worst = 0.0
    for a, b in zip(got, ref):
        if not torch.equal(a, b):
            d = (a.double() - b.double()).abs().max() / max(
                1.0, float(b.abs().max()))
            worst = max(worst, float(d))
    return all(torch.equal(a, b) for a, b in zip(got, ref)), worst


def opt_snapshot(state) -> list:
    """Copies of each trained part's parameters, buffers and optimiser
    state: [(params, buffers, Adam's mu or SGD's trace, Adam's nu or
    nothing)] in the state's part order."""
    return [tuple([t.detach().clone() for t in ts] for ts in (
        m.params(), m.module.buffers(),
        *((m.mu.values(), m.nu.values()) if hasattr(m, 'mu')
          else (m.trace.values(), ()))))
        for m in (state.parts().values() if hasattr(state, 'parts')
                  else [state.model])]


@torch.no_grad()
def opt_gap(got: list, ref: list, init: list, lrs: list) -> float:
    """The largest difference of two opt_snapshots after one step from
    `init`, each tensor's scaled by max(1, its largest magnitude in ref),
    as held_to_cpu measures a step: a parameter entry whose gradient (mu)
    the two do not reproduce to 1% is rounding noise, which Adam turns
    into a move of about lr of either sign; such entries must have moved at
    most 2 lr on both sides and are left out of the parameters' gap.  An
    lr of None (SGD, whose step is linear in the gradient) exempts
    nothing."""
    worst = 0.0

    def scaled(a, b):
        return float((a.double() - b.double()).abs().max()) / max(
            1.0, float(b.abs().max())) if b.numel() else 0.0

    for (gp, gb, gm, gn), (rp, rb, rm, rn), (ip, _, _, _), lr in zip(
            got, ref, init, lrs):
        for a, b, a0, mg, mr in zip(gp, rp, ip, gm, rm):
            if lr is None:
                worst = max(worst, scaled(a, b))
                continue
            noisy = (mg - mr).abs() > 1e-2 * mr.abs()
            for side in (a, b):
                if bool(((side - a0).abs() > 2 * lr)[noisy].any()):
                    return float('inf')
            worst = max(worst, scaled(torch.where(noisy, 0.0, a),
                                      torch.where(noisy, 0.0, b)))
        for a, b in zip(gb + gm + gn, rb + rm + rn):
            worst = max(worst, scaled(a, b))
    return worst


def chunked_case(name: str, trainer, make_state, make_batch, make_draws,
                 lrs: list, steps: int, chunk: int, smi: str, *,
                 step_fn=None, extra=(), nan_step=CHUNK_NAN_STEP,
                 resume_at=CHUNK_RESUME_AT, same=None) -> dict:
    """The eager loop and the chunked runs of one trainer, as the comment
    above says: timed with cuDNN's defaults, the graph captured under them
    held after its first step to the eager first step (the gap of two
    eager first steps beside it; the gap after all the steps stated),
    then held bit for bit with deterministic cuDNN, through a graph
    captured under it.  `lrs`: the learning rate of each trained part, in
    the state's part order (None for SGD).  `step_fn(state, batch,
    [draws], *extra)`: the step the runner takes (the trainer's
    train_step); `extra`: its trailing arguments.  The batch of
    CHUNK_BATCH_SEED + nan_step holds a NaN; the resume starts at
    resume_at.  `same(chunked state, eager state)`: a check of the
    deterministic runs' end states beside the bit identity, whose result
    the record keeps."""
    from ctrlhair_tpu_torch.training.chunked import ChunkRunner
    bseed = CHUNK_BATCH_SEED
    step_fn = step_fn or trainer.train_step
    t_case = time.perf_counter()

    def restart(state):
        with torch.no_grad():
            for t, s0 in zip(state.tensors(), init):
                t.copy_(s0)
        state.step = 0
        return state

    def eager(state, n=steps, first=None):
        """n eager steps; `first`, a list, gets the opt_snapshot and the
        losses after the first."""
        times, finite = [], []
        for s in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step_fn(state, make_batch(bseed + s), *(
                () if make_draws is None else (make_draws(s),)), *extra)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            finite.append(bool(m['finite']))
            if first is not None and s == 0:
                first += [opt_snapshot(state), {
                    k: float(v) for k, v in m.items() if k != 'finite'}]
        return times, finite

    def chunked(state, runner, **kw):
        return runner.run(state, 0, steps, chunk_size=chunk,
                          extra_args=extra, **kw)

    def runner_of():
        return ChunkRunner(step_fn, make_batch, make_draws=make_draws,
                           batch_seed=bseed)

    want_finite = [s != nan_step for s in range(steps)]
    eager_state = make_state()
    init = [t.clone() for t in eager_state.tensors()]
    init_opt = opt_snapshot(eager_state)
    # timed, cuDNN's defaults
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    eager_ms, finite = eager(eager_state)
    eager_peak = torch.cuda.max_memory_allocated()
    eager_over = eager_peak - base
    eager_med = float(np.median(eager_ms[1:]))
    eager_default = [t.clone() for t in eager_state.tensors()]
    # the first step again, twice, for the hold of the graph captured
    # under the defaults (outside the peak above: a snapshot is a state)
    first, again = [], []
    eager(restart(eager_state), 1, first)
    eager(restart(eager_state), 1, again)
    eager_twice_gap = opt_gap(again[0], first[0], init_opt, lrs)
    del again
    eager_prof = profile_chunk(lambda: step_fn(
        eager_state, make_batch(bseed), *(
            () if make_draws is None else (make_draws(0),)), *extra), 1,
        eager_med)
    state = restart(make_state())
    runner = runner_of()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    stamps = [time.perf_counter()]
    state, rows, trips = chunked(state, runner, record_every=1, on_chunk=(
        lambda s, st, r: stamps.append(time.perf_counter())))
    chunked_peak = torch.cuda.max_memory_allocated()
    chunked_over = chunked_peak - base
    sizes = [min(chunk, steps - i) for i in range(0, steps, chunk)]
    chunk_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    chunked_med = float(np.median([ms / n for ms, n in
                                   zip(chunk_ms[1:], sizes[1:])]))
    _, default_gap = state_gap(state.tensors(), eager_default)
    if finite != want_finite or trips != 1 or \
            [bool(r['finite']) for r in rows] != want_finite:
        raise AssertionError(f'{name}: trips {trips}, finite flags '
                             f'{[r["finite"] for r in rows]}, eager '
                             f'{finite}; one NaN batch at step '
                             f'{nan_step} expected')
    capture_ms = runner.capture_ms[0]
    prof = profile_chunk(
        lambda: runner.run(state, state.step, state.step + chunk,
                           chunk_size=chunk, extra_args=extra), chunk,
        chunked_med)
    # the graph captured under the defaults, after its first step
    state, rows, _ = runner.run(restart(state), 0, 1, chunk_size=chunk,
                                extra_args=extra)
    graph_gap = opt_gap(opt_snapshot(state), first[0], init_opt, lrs)
    loss_gap = max(abs(rows[0][k] - v) / max(1.0, abs(v))
                   for k, v in first[1].items())
    if runner.captures != 1 or not graph_gap <= CHUNK_DEFAULT_BAR or \
            not loss_gap <= CHUNK_DEFAULT_BAR:
        raise AssertionError(
            f'{name}: after one step the graph captured under cuDNN\'s '
            f'defaults stands {graph_gap:.3g} from the eager step (losses '
            f'{loss_gap:.3g}; bar {CHUNK_DEFAULT_BAR}; two eager steps '
            f'{eager_twice_gap:.3g}; {runner.captures} captures)')
    captures = [runner.captures]
    del runner, eager_default, first, init_opt
    gc.collect()
    torch.cuda.empty_cache()

    @deterministic
    def held():
        """The eager loop and a chunked run from a graph captured with
        deterministic cuDNN: bit-identical (else within CHUNK_GAP_BAR);
        the NaN step one trip; 0..resume_at then on to the end through
        the same graph, bit-identical to the straight run."""
        eager(restart(eager_state))
        runner = runner_of()
        st, _, trips = chunked(restart(state), runner)
        identical, gap = state_gap(st.tensors(), eager_state.tensors())
        if st.step != steps or trips != 1 or not gap <= CHUNK_GAP_BAR:
            names = tensor_names(st)
            apart = [names[i] for i, (a, b) in enumerate(zip(
                st.tensors(), eager_state.tensors())) if not torch.equal(a, b)]
            free, total = torch.cuda.mem_get_info()
            raise AssertionError(
                f'{name}: the chunked state at step {st.step} ({trips} '
                f'trips) stands {gap:.3g} from the eager one (bar '
                f'{CHUNK_GAP_BAR}, deterministic cuDNN); {len(apart)} '
                f'tensors differ, the first {apart[:8]}; card memory free '
                f'{free} of {total} B, reserved '
                f'{torch.cuda.memory_reserved()} B, allocated at most '
                f'{torch.cuda.max_memory_allocated()} B')
        also = None if same is None else same(st, eager_state)
        straight = [t.clone() for t in st.tensors()]
        st, _, _ = runner.run(restart(st), 0, resume_at, chunk_size=chunk,
                              extra_args=extra)
        st, _, _ = runner.run(st, resume_at, steps, chunk_size=chunk,
                              extra_args=extra)
        resumed, _ = state_gap(st.tensors(), straight)
        captures.append(runner.captures)
        if not resumed or runner.captures != 1:
            raise AssertionError(f'{name}: the run resumed at step '
                                 f'{resume_at} differs from the '
                                 f'straight one ({runner.captures} '
                                 'captures)')
        return identical, gap, resumed, also

    identical, gap, resumed, also = held()
    rec = {'steps': steps, 'chunk_size': chunk, 'chunk_sizes': sizes,
           'eager_ms': eager_ms, 'eager_median_ms': eager_med,
           'chunk_ms': chunk_ms, 'chunked_median_ms_per_step': chunked_med,
           'capture_ms': capture_ms,
           'eager_profile': eager_prof, 'chunked_profile': prof,
           'eager_peak_bytes': eager_peak,
           'chunked_peak_bytes': chunked_peak,
           'eager_peak_over_start_bytes': eager_over,
           'chunked_peak_over_start_bytes': chunked_over,
           'default_cudnn_gap': {
               'first_step': {'eager_twice': eager_twice_gap,
                              'graph_vs_eager': graph_gap,
                              'losses_graph_vs_eager': loss_gap,
                              'bar': CHUNK_DEFAULT_BAR},
               'all_steps_graph_vs_eager': default_gap},
           'bit_identical': identical, 'max_scaled_gap': gap,
           'finite_trips': trips, 'nan_step': nan_step,
           'resume_at': resume_at, 'resume_bit_identical': resumed,
           'captures': captures, 'also': also,
           'seconds': time.perf_counter() - t_case}
    log(f'[chunked] {name}: {steps} steps in chunks of {chunk} '
        f'({sizes}); eager {eager_med:.3f} ms a step, chunked '
        f'{chunked_med:.3f} ms a step (chunks '
        f'{", ".join(f"{t:.3f}" for t in chunk_ms)} ms, the first with the '
        f'capture of {capture_ms:.1f} ms); kernels a step eager '
        f'{eager_prof["kernels_per_step"]:.0f}, chunked '
        f'{prof["kernels_per_step"]:.0f}; runtime calls a step eager '
        f'{eager_prof["runtime_calls_per_step"]}, chunked '
        f'{prof["runtime_calls_per_step"]}; device ms a step eager '
        f'{eager_prof["device_ms_per_step"]:.3f}, chunked '
        f'{prof["device_ms_per_step"]:.3f}; idle eager '
        f'{eager_prof["idle_share"]}, chunked {prof["idle_share"]}; peak '
        f'{eager_peak} B eager, {chunked_peak} B chunked (over the memory '
        f'held at the run\'s start: {eager_over} B, {chunked_over} B); '
        f'with cuDNN\'s defaults after the first step two eager runs stand '
        f'{eager_twice_gap:.3g} apart and the graph {graph_gap:.3g} from '
        f'the eager one (losses {loss_gap:.3g}; bar {CHUNK_DEFAULT_BAR}), '
        f'after {steps} steps the chunked run {default_gap:.3g} from the '
        f'eager one; deterministic: '
        f'bit-identical {identical} (worst {gap:.3g}), NaN step '
        f'{nan_step} one trip, resume at {resume_at} bit-identical '
        f'{resumed}' + ('' if also is None else f', {also}')
        + f'; captures {captures}; {rec["seconds"]:.1f} s ({smi})')
    return rec


def phase_chunked(cases: dict, smi: str):
    """Phase (m), as the comment above says; the launch counts set to 0
    before it and read after it (the pool it reads was built by K2 in (d);
    no kernel of the port runs here)."""
    import dataclasses
    from ctrlhair_tpu_torch.config import ShapeConfig
    from ctrlhair_tpu_torch.models.landmark_net import LandmarkNetConfig
    from ctrlhair_tpu_torch.training.landmark_trainer import LandmarkTrainer
    from ctrlhair_tpu_torch.training.shape_trainer import ShapeTrainer
    reset_launches()
    t0 = time.perf_counter()
    rec = {}
    cfg = dataclasses.replace(ShapeConfig(), kl_free_bits=0.25,
                              lambda_geo=30.0, lambda_info=1.0)
    trainer = ShapeTrainer(cfg, device='cuda', seed=SEED)
    rec['shape'] = chunked_case(
        f'shape ShapeConfig() soak recipe, batch {SHAPE_BATCH}', trainer,
        lambda: trainer.init_state(SEED),
        shape_pool_batches(cases['shape_pool'], SHAPE_BATCH,
                           CHUNK_BATCH_SEED + CHUNK_SHORT_NAN_STEP),
        lambda s: trainer.draws(s, SHAPE_BATCH),
        [cfg.lr_g, cfg.lr_d, cfg.lr_dz], CHUNK_SHAPE, CHUNK_SHAPE_SIZE, smi,
        nan_step=CHUNK_SHORT_NAN_STEP, resume_at=CHUNK_SHORT_RESUME_AT)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    lcfg = LandmarkNetConfig()
    ltrainer = LandmarkTrainer(lcfg, device='cuda')
    rec['landmark'] = chunked_case(
        f'landmark LandmarkNetConfig(), batch {LANDMARK_BATCH}', ltrainer,
        lambda: ltrainer.init_state(SEED),
        landmark_pool_batches(cases['landmark_pool'], LANDMARK_BATCH,
                              CHUNK_BATCH_SEED + CHUNK_NAN_STEP),
        None, [lcfg.lr], CHUNK_LANDMARK, CHUNK_LANDMARK_SIZE, smi)
    del ltrainer
    gc.collect()
    torch.cuda.empty_cache()
    rec.update(chunked_other_trainers(smi))
    rec['seconds'] = time.perf_counter() - t0
    return read_launches('chunked', 0, 0), rec


def ct_chunk_step(trainer):
    """The colour/texture step in the runner's argument order (state,
    batch, draws, predictors), as JAX's soak wraps its own."""
    @functools.wraps(trainer.train_step)
    def step(state, batch, draws, predictors):
        return trainer.train_step(state, batch, predictors, draws)
    return step


def sean_u_bit_identical(chunked, eager) -> dict:
    """The SEAN trainer's u vectors after the chunked and the eager run,
    bit for bit."""
    for key in ('sn_u', 'dis_sn_u'):
        a, b = getattr(chunked, key), getattr(eager, key)
        if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError(f'SEAN chunked: {key} differs from the '
                                 'eager run\'s')
    return {'u_vectors_bit_identical': len(chunked.sn_u)
            + len(chunked.dis_sn_u)}


def chunked_other_trainers(smi: str) -> dict:
    """Phase (m)'s colour/texture, predictor, face-parser and SEAN cases,
    as the comment above says, each freed before the next."""
    import dataclasses
    from ctrlhair_tpu_torch.config import (
        BiSeNetConfig, ColorTextureConfig, SEANConfig,
        curliness_predictor_config, rgb_predictor_config)
    from ctrlhair_tpu_torch.models.layers import init_parameters_
    from ctrlhair_tpu_torch.models.sean import SEAN
    from ctrlhair_tpu_torch.training import sean_trainer
    from ctrlhair_tpu_torch.training.bisenet_trainer import BiSeNetTrainer
    from ctrlhair_tpu_torch.training.color_texture_trainer import (
        ColorTextureTrainer, synthetic_batch as ct_synthetic)
    from ctrlhair_tpu_torch.training.predictor_trainer import (
        PredictorTrainer)
    rec = {}
    nan_seed = CHUNK_BATCH_SEED + CHUNK_NAN_STEP
    short_nan_seed = CHUNK_BATCH_SEED + CHUNK_SHORT_NAN_STEP
    short = {'nan_step': CHUNK_SHORT_NAN_STEP,
             'resume_at': CHUNK_SHORT_RESUME_AT}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # colour/texture, lambda_rec_img off and on
    scfg = SEANConfig()
    with torch.device('cuda'):
        sean = SEAN(scfg)
    init_parameters_(sean, torch.Generator('cuda').manual_seed(SEED))
    for rec_img in (False, True):
        cfg = ColorTextureConfig()
        if rec_img:
            cfg = dataclasses.replace(cfg, lambda_rec_img={0: 1000.0})
        trainer = ColorTextureTrainer(cfg, sean=sean if rec_img else None,
                                      rec_img_subset=4, device='cuda',
                                      seed=SEED)
        _, preds = trainer.init_state(SEED)
        pool = ct_synthetic(torch.Generator().manual_seed(SEED + 7), cfg,
                            2 * CT_BATCH, 'cuda')
        if rec_img:
            pool.update(ct_rec_batch(cfg, scfg, torch.Generator(
                'cuda').manual_seed(SEED + 7), 2 * CT_BATCH))
        steps, chunk = CHUNK_CT_REC if rec_img else CHUNK_CT
        key = 'color_texture_rec_img' if rec_img else 'color_texture'
        rec[key] = chunked_case(
            f'colour/texture ColorTextureConfig(), lambda_rec_img '
            f'{"on (frozen SEANConfig() SEAN)" if rec_img else "off"}, '
            f'batch {CT_BATCH}', trainer,
            lambda: trainer.init_state(SEED)[0],
            pool_batches(pool, CT_BATCH,
                         short_nan_seed if rec_img else nan_seed, 'code',
                         (3, 7)),
            lambda s: trainer.draws(s, CT_BATCH),
            [cfg.lr_g, cfg.lr_d, cfg.lr_g], steps, chunk, smi,
            step_fn=ct_chunk_step(trainer), extra=(preds,),
            **(short if rec_img else {}))
        del trainer, preds, pool
        free()
    del sean
    free()

    # the two predictors
    for which, cfg in (('rgb', rgb_predictor_config()),
                       ('curliness', curliness_predictor_config())):
        trainer = PredictorTrainer(cfg, device='cuda', seed=SEED)
        g = torch.Generator().manual_seed(SEED + 8)
        code = torch.randn((4 * PREDICTOR_BATCH, cfg.style_dim), generator=g)
        pool = {'code': code}
        if which == 'curliness':
            pool['curliness_label'] = torch.where(
                code[:, :1] + code[:, 1:2] > 0, 1.0, -1.0)
        else:
            pool['rgb_mean'] = code[:, :3] * 40 + 128
            pool['pca_std'] = code[:, 3:4].abs() * 30 + 20
        rec[which] = chunked_case(
            f'{which} predictor ({cfg.name}), batch {PREDICTOR_BATCH}',
            trainer, lambda: trainer.init_state(SEED),
            pool_batches(to_device(pool, 'cuda'), PREDICTOR_BATCH, nan_seed,
                         'code', (5, 9)),
            lambda s: trainer.draws(s, PREDICTOR_BATCH), [cfg.lr],
            *CHUNK_PREDICTOR, smi)
        del trainer, pool
        free()

    # the face parser
    cfg = BiSeNetConfig()
    trainer = BiSeNetTrainer(cfg, device='cuda')
    rng = np.random.default_rng(SEED + 9)
    s = cfg.input_size
    pool = {'image': torch.from_numpy(rng.standard_normal(
                (2 * BISENET_BATCH, s, s, 3)).astype(np.float32)).cuda(),
            'label': torch.from_numpy(rng.integers(
                0, 19, (2 * BISENET_BATCH, s, s)).astype(np.int32)).cuda()}
    rec['bisenet'] = chunked_case(
        f'face parser BiSeNetConfig(), batch {BISENET_BATCH}', trainer,
        lambda: trainer.init_state(SEED),
        pool_batches(pool, BISENET_BATCH, nan_seed, 'image', (2, 7, 9, 1)),
        None, [None], *CHUNK_BISENET, smi)
    del trainer, pool
    free()

    # SEAN
    cfg = SEANConfig()
    trainer = sean_trainer.SEANTrainer(cfg, device='cuda', seed=SEED)
    pool = sean_trainer.synthetic_batch(np.random.default_rng(SEED + 10),
                                        cfg, 2 * SEAN_BATCH, 'cuda')
    rec['sean'] = chunked_case(
        f'sean SEANConfig(), batch {SEAN_BATCH}', trainer,
        lambda: trainer.init_state(SEED),
        pool_batches(pool, SEAN_BATCH, short_nan_seed, 'image',
                     (1, 3, 4, 0)),
        None, [1e-4, 4e-4], *CHUNK_SEAN, smi, same=sean_u_bit_identical,
        **short)
    del trainer, pool
    free()
    return rec


def phase_training(smi: str, dp_cases: dict):
    """The training slice: (d) the warp pool, whose warps launch K2, (e)
    the shape trainer on it, (a) colour/texture, (b) predictors, (f) the
    face parser, (g) the landmark regressor, (i) SEAN, (j) a canvas and a
    prep pass, (c) and (h) the entry points.
    Timed with cuDNN's defaults, as the entry points run; the checks run
    with deterministic cuDNN algorithms (deterministic)."""
    import shutil
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
        dp_cases['chunked'] = {'shape_pool': device_shape_pool(root)}
        # phase (n) reads the pool after this folder is gone
        dp_cases['curation_pool'] = shutil.copytree(
            os.path.join(root, 'shape_training_wrap_pool'),
            tempfile.mkdtemp(prefix='curation_pool_'), dirs_exist_ok=True)
        rec['shape'] = run('shape', phase_train_shape, shape_batches, smi,
                           dp_cases)
        del shape_batches
        for key, fn, args in (
                ('color_texture', phase_train_ct, (dp_cases,)),
                ('predictors', phase_train_predictors, ()),
                ('bisenet', phase_train_bisenet, (dp_cases,)),
                ('landmark', phase_train_landmark, (dp_cases,)),
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
    log('[time] training checks by part, seconds: ' + ', '.join(
        f'{k} {v:.1f}' for k, v in sorted(LAPS.items(),
                                          key=lambda kv: -kv[1])))
    return read_launches('training', 0, POOL_WARPS), rec


# ------------------------------------------------------- curation tool
# Phase (n), the curation entry point as a user runs it (python -m
# ctrlhair_tpu_torch.pipeline.find_directions), each route in this process
# on cuda:0 (Backend() from model_trained/, blending off, samples/input.png
# cropped), its launch counts set to 0 before it and read after it, every
# --out-dir and --save-dir in a temporary folder: --att shape --pool-dir
# on the warp pool of (d) (24 masks: more than the 16-d latent needs, fewer
# than the 64 below which the tool warns), --att texture --auto --n 3, and
# --att shape --n 2 --choose 1 --index 0.  Each route writes the files
# the JAX script writes, and load_directions reads its slots back; with
# blending off no route launches K1, and none warps, so none launches K2.
# model_trained/ is held unchanged across the phase.
CURATION_ROUTES = (
    ('pool_dir', ['--att', 'shape', '--pool-dir', None], 4,
     ['shape_dir_regression.json'] + [f'slot_{i}_shape.png'
                                      for i in range(4)]),
    ('auto', ['--att', 'texture', '--auto', '--n', '3'], 2,
     ['slot_0_texture.png', 'slot_1_texture.png', 'texture_curation.json']),
    ('choose', ['--att', 'shape', '--n', '2', '--choose', '1', '--index',
                '0'], 1, ['candidate_000.png', 'candidate_001.png']))


def tree_listing(root: str) -> list:
    """(path, size, mtime_ns) of every file under root."""
    out = []
    for d, _, files in os.walk(root):
        for f in files:
            st = os.stat(os.path.join(d, f))
            out.append((os.path.join(d, f), st.st_size, st.st_mtime_ns))
    return sorted(out)


def phase_curation_tool(pool_dir: str, smi: str):
    """Phase (n), as the comment above says.  Returns (launches by route,
    record)."""
    import contextlib
    import io
    import shutil
    import tempfile
    import warnings
    from ctrlhair_tpu_torch.pipeline import find_directions
    from ctrlhair_tpu_torch.pipeline.direction_finder import load_directions
    sample = os.path.join(ROOT, 'samples', 'input.png')
    trained = tree_listing(os.path.join(ROOT, 'model_trained'))
    launches, rec = {}, {}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            for name, argv, slots, files in CURATION_ROUTES:
                out_dir = os.path.join(tmp, name, 'out')
                save_dir = os.path.join(tmp, name, 'dirs')
                argv = [pool_dir if a is None else a for a in argv] + [
                    '--input', sample, '--out-dir', out_dir,
                    '--save-dir', save_dir]
                said = io.StringIO()
                reset_launches()
                t0 = time.perf_counter()
                with warnings.catch_warnings(record=True) as caught, \
                        contextlib.redirect_stdout(said):
                    warnings.simplefilter('always')
                    find_directions.main(argv)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                launches[name] = read_launches(f'find_directions {name}', 0,
                                               0)
                dirs = load_directions(save_dir)
                norms = [float(np.linalg.norm(d)) for d in dirs or []]
                lines = said.getvalue().splitlines()
                inflated = [str(w.message) for w in caught
                            if 'R^2 may be inflated' in str(w.message)]
                if dirs is None or len(dirs) != slots or \
                        sorted(os.listdir(out_dir)) != sorted(files) or \
                        not all(abs(n - 1.0) < 1e-4 for n in norms) or \
                        bool(inflated) != (name == 'pool_dir'):
                    raise AssertionError(
                        f'find_directions {name}: slots {norms}, files '
                        f'{sorted(os.listdir(out_dir))}, warnings '
                        f'{inflated}, said {lines}')
                rec[name] = {'argv': argv[:-6], 'ms': ms,
                             'launches': launches[name], 'slots': len(dirs),
                             'files': sorted(files), 'printed': lines}
                log(f'[curation tool] find_directions '
                    f'{" ".join(argv[:-6])}: {ms:.3f} ms in this process, '
                    f'Backend() build included; launches {launches[name]}; '
                    f'{len(dirs)} slots read back by load_directions; '
                    f'printed {lines} ({smi})')
    finally:
        shutil.rmtree(pool_dir, ignore_errors=True)
    if tree_listing(os.path.join(ROOT, 'model_trained')) != trained:
        raise AssertionError('the curation routes changed model_trained/')
    return launches, rec


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

    # 9b. phase (n), the curation entry point: the counts set to 0 before
    # each route and read after it
    n_launches, curation_tool = phase_curation_tool(
        dp_cases.pop('curation_pool'), smi)
    t_phase['curation_tool'] = time.perf_counter() - t_start - sum(
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

    # 12. phase (m), chunked training through CUDA graphs: both counts set
    # to 0 before it and read after it
    m_launches, chunked = phase_chunked(dp_cases.pop('chunked'), smi)
    t_phase['chunked'] = time.perf_counter() - t_start - sum(
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
        + l_launches['masked_cg'] + m_launches['masked_cg']
        + sum(n['masked_cg'] for n in n_launches.values()),
        'launches_by_path': {'editor': launches,
                             'backend': b_launches['masked_cg'],
                             'deployment': d_launches['masked_cg'],
                             **s_launches['masked_cg'],
                             'training': t_launches['masked_cg'],
                             **{f'find_directions_{k}': n['masked_cg']
                                for k, n in n_launches.items()},
                             'parallel': p_launches['masked_cg'],
                             'tensor_parallel': l_launches['masked_cg'],
                             'chunked': m_launches['masked_cg']},
        **cg_entry,
    }, {
        'name': 'raster_uv', 'route': 'cuda',
        'source': 'ctrlhair_tpu_torch/csrc/raster_uv.cu',
        'replaces': 'ctrlhair_tpu/ops/raster_pallas.py:146',
        'launches': raster_launches + b_launches['raster_uv']
        + d_launches['raster_uv'] + sum(s_launches['raster_uv'].values())
        + t_launches['raster_uv'] + p_launches['raster_uv']
        + l_launches['raster_uv'] + m_launches['raster_uv']
        + sum(n['raster_uv'] for n in n_launches.values()),
        'launches_by_path': {'editor': raster_launches,
                             'backend': b_launches['raster_uv'],
                             'deployment': d_launches['raster_uv'],
                             **s_launches['raster_uv'],
                             'training': t_launches['raster_uv'],
                             **{f'find_directions_{k}': n['raster_uv']
                                for k, n in n_launches.items()},
                             'parallel': p_launches['raster_uv'],
                             'tensor_parallel': l_launches['raster_uv'],
                             'chunked': m_launches['raster_uv']},
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
        'training': training, 'curation_tool': curation_tool,
        'parallel': parallel,
        'tensor_parallel': tensor_parallel, 'chunked': chunked,
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
