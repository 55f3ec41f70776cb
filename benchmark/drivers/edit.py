"""Editing sessions on ctrlhair_tpu_torch's Backend, driven in a closed
loop by one client: each request waits for the image(s) of the one
before.

The traffic file names the request kind and its parameters:
  kind 'slider'  one session; a request is ui.app.apply_slider(backend,
                 group, idx, value) then Backend.output(), the image read
                 back.  Ticks come in runs of `run_length` on one slider,
                 the sliders of ui.app.SLIDER_SPECS in their order; values
                 uniform in `value_range` from the seed.
  kind 'sweep'   `sessions` sessions sharing one HairEditor, taken round
                 robin; a request is Backend.interpolation_sweep(current
                 latent, a seeded target latent, `alphas` evenly spaced
                 in [0, 1]), the images read back.
  warmup         requests per slider (or per session) before the window;
                 the request stream starts with them, untimed.
  sample_rate    the share of the window's requests whose images the
                 reference checks, drawn from the seed (trace_sample_rate
                 in a traced run).
  trace_requests the requests of a `--trace 1` run's window.

A session is a painted face, its parse, a latent and the SEAN codes of
the face, all from the seed (the codes by the program's own encode, as an
analysis would make them); the editor's weights are drawn by
benchmark/weights.py.  The reference (benchmark/reference/edit.py)
replays every tick from the same inputs and renders the sampled requests
again in float32; `image_gap` is the largest mean absolute difference,
in uint8 levels, between a sampled image and its reference.
"""

from __future__ import annotations

import gc
import os
import sys
import time
import traceback

import numpy as np
import torch

from benchmark import harness, inputs, weights
from benchmark.flops import edit as flops
from benchmark.reference import edit as ref
from benchmark.reference import sean as ref_sean
from benchmark.reference.nn import Numerics, sub
from benchmark.trace import Tracer, span

from ctrlhair_tpu_torch import config as C
from ctrlhair_tpu_torch.pipeline.backend import Backend
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.pipeline.latent import Latent
from ctrlhair_tpu_torch.ui import app

SUBCONFIGS = {'sean': C.SEANConfig, 'bisenet': C.BiSeNetConfig,
              'color_texture': C.ColorTextureConfig, 'shape': C.ShapeConfig,
              'rgb_predictor': C.PredictorConfig,
              'curliness_predictor': C.PredictorConfig}
STREAM_LENGTH = 50_000      # requests a stream holds, beyond any window
TARGETS = 8192              # seeded target latents of the sweeps


def _int_keys(v):
    """JSON's string keys of a {step: value} schedule back to ints."""
    if isinstance(v, dict) and v and all(k.isdigit() for k in v):
        return {int(k): x for k, x in v.items()}
    return v


def pipeline_config(d) -> C.PipelineConfig:
    kw = {}
    for k, v in d.items():
        if k in SUBCONFIGS:
            v = SUBCONFIGS[k](**{f: _int_keys(x) for f, x in v.items()})
        kw[k] = v
    return C.PipelineConfig(**kw)


def latent_dims(pc: C.PipelineConfig):
    return {'curliness': pc.color_texture.curliness_dim,
            'texture': pc.color_texture.noise_dim,
            'shape': pc.shape.hair_dim, 'face': pc.shape.face_dim}


class Stream:
    """The requests of a run, from the seed: slider ticks (group, idx,
    value), or sweeps (session, target row)."""

    def __init__(self, traffic, rng: np.random.Generator, sessions: int):
        self.kind = traffic['kind']
        self.warm = traffic['warmup']
        if self.kind == 'slider':
            lo, hi = traffic['value_range']
            ticks = [(g, i) for g, _, i in app.SLIDER_SPECS] * self.warm
            self.warm_count = len(ticks)
            run = traffic['run_length']
            while len(ticks) < STREAM_LENGTH:
                for g, _, i in app.SLIDER_SPECS:
                    ticks += [(g, i)] * run
            ticks = ticks[:STREAM_LENGTH]
            values = rng.uniform(lo, hi, len(ticks))
            self.items = [(g, i, float(v)) for (g, i), v in zip(ticks,
                                                                 values)]
        elif self.kind == 'sweep':
            self.warm_count = self.warm * sessions
            self.items = [(i % sessions, i % TARGETS)
                          for i in range(STREAM_LENGTH)]
        else:
            raise ValueError(f'unknown request kind {self.kind!r}')


def open_session(be: Backend, editor: HairEditor, face, label, lat, device):
    """A session as an analysis leaves it: the face and its parse, the
    latent, the SEAN codes of the face (the program's encode) and the mask
    the latent decodes to."""
    be.input_img = face.cpu().numpy()
    be.input_mask = label.cpu().numpy()
    be.cur_latent = Latent(**{k: torch.as_tensor(v, device=device)
                              for k, v in lat.items()})
    with torch.inference_mode():
        img_f = face[None].to(torch.float32) / 127.5 - 1.0
        be.input_sean_code = editor.sean.encode(img_f, label[None]).float()
    be.refresh_cur_mask()


def _wrap_spans(editor: HairEditor):
    """Harness spans around the editor's render, blend and mask decode, on
    this instance only."""
    for attr, name in (('_edit_render', 'render'), ('_blend', 'blend'),
                       ('_decode_mask', 'decode_mask')):
        fn = getattr(editor, attr)

        def wrapped(*a, _fn=fn, _name=name, **k):
            with span(_name):
                return _fn(*a, **k)
        setattr(editor, attr, wrapped)


def run(ctx: harness.Context) -> harness.Outcome:
    device, traffic = ctx.device, ctx.traffic
    pc = pipeline_config(ctx.config['pipeline'])
    s = pc.edit_size
    ss = np.random.SeedSequence(ctx.seed)
    rng_in, rng_stream, rng_sample = (np.random.default_rng(x)
                                      for x in ss.spawn(3))
    w_seed = int(ss.generate_state(1, np.uint64)[0])
    n_sessions = traffic.get('sessions', 1)
    dims = latent_dims(pc)

    # ---------------------------------------------------------- set-up
    editor = HairEditor(pc, device=device)
    specs = weights.specs_of(editor.state_dict())
    editor.load_state_dict(weights.draw(specs, w_seed, device), strict=True)
    table = inputs.hsv_table()
    shape_dirs = inputs.directions(rng_in, dims['shape'], 4)
    texture_dirs = inputs.directions(rng_in, dims['texture'], 2)
    no_root = os.path.join(ctx.root, '.bench_cache', 'no_trained_weights')
    sessions, backends = [], []
    for _ in range(n_sessions):
        face, label = inputs.session_face(s, rng_in, device)
        lat = inputs.latent(rng_in, dims)
        be = Backend(cfg=pc, editor=editor, hsv_table=table,
                     trained_root=no_root, blending=pc.blending)
        be.shape_dirs, be.texture_dirs = list(shape_dirs), list(texture_dirs)
        open_session(be, editor, face, label, lat, device)
        sessions.append((face, label, lat))
        backends.append(be)
    stream = Stream(traffic, rng_stream, n_sessions)
    targets = inputs.latent(rng_in, dims, n=TARGETS) \
        if stream.kind == 'sweep' else None
    if targets is not None:
        t_dev = {k: torch.as_tensor(v, device=device)
                 for k, v in targets.items()}
    alphas = np.linspace(0.0, 1.0, traffic.get('alphas', 1),
                         dtype=np.float32)

    def request(i):
        if stream.kind == 'slider':
            g, idx, val = stream.items[i]
            app.apply_slider(backends[0], g, idx, val)
            return backends[0].output()
        k, row = stream.items[i]
        l2 = Latent(**{f: v[row:row + 1] for f, v in t_dev.items()})
        be = backends[k]
        return be.interpolation_sweep(be.cur_latent, l2, alphas)

    for i in range(stream.warm_count):
        request(i)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)

    # ---------------------------------------------------------- window
    rate = traffic['trace_sample_rate'] if ctx.trace else \
        traffic['sample_rate']
    keep = rng_sample.random(STREAM_LENGTH) < rate
    kept, latencies, failed = {}, [], 0
    first = stream.warm_count
    tracer = None
    if ctx.trace:
        _wrap_spans(editor)
        tracer = Tracer(device)
    last = {}

    def one(i):
        nonlocal failed
        t0 = time.perf_counter()
        try:
            with span('request'):
                out = request(i)
        except Exception:                      # noqa: BLE001 - counted
            failed += 1
            if failed == 1:
                traceback.print_exc()
            out = None
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if out is not None:
            last.clear()
            last[i] = out
            if keep[i - first]:
                kept[i] = (out, session_mask(i))
        return t1

    def session_mask(i):
        """The label the request rendered under: the session's current
        mask (read back only for the sampled requests, after the clock)."""
        if stream.kind == 'slider':
            return backends[0].cur_mask
        return masks[stream.items[i][0]]

    masks = [be.cur_mask for be in backends]
    harness.quiet_collector()
    i = first
    t_start = time.perf_counter()
    setup_s = t_start - ctx.t_process
    if ctx.trace:
        with tracer:
            for i in range(first, first + traffic['trace_requests']):
                one(i)
        t_end = t_start + tracer.window_s
        i += 1
    else:
        t_end = t_start
        while t_end - t_start < ctx.seconds:
            t_end = one(i)
            i += 1
    # the window's last answer is always among those checked
    for j, out in last.items():
        kept.setdefault(j, (out, session_mask(j)))
    done = i - first
    _report_latencies(stream, first, latencies)
    per_request = traffic.get('alphas', 1) if stream.kind == 'sweep' else 1
    images = (done - failed) * per_request
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == 'cuda' else 0

    trace = None
    if ctx.trace:
        cg = (per_request, 3, s, s, pc.poisson_iterations)
        ops = sum(flops.render(ctx.config['pipeline'], per_request)
                  + flops.cg_work(*cg)[0]
                  + (flops.decode_mask(ctx.config['pipeline'], 1)
                     if stream.kind == 'slider'
                     and stream.items[j][0] == 'shape' else 0)
                  for j in range(first, first + done))
        trace = tracer.finish({'images': images, 'requests': done,
                               'model_flops': ops, 'cg_shape': cg,
                               'latencies_s': list(latencies)})

    # ------------------------------------------------------ the check
    del backends, editor
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    got = _reference(ctx, specs, w_seed, sessions, stream, kept, targets,
                     alphas, shape_dirs, texture_dirs, table)
    checks = {k: harness.check(max(v) if v else float('inf'), ctx.limits[k])
              for k, v in got.items() if not k.startswith('control_')}
    readings = {k: max(v) if v else None for k, v in got.items()} \
        if ctx.control else {}
    return harness.Outcome(
        attempted=done, failed=failed, checks=checks,
        memory_peak_bytes=peak,
        e2e={'setup_s': setup_s,
             'images_per_s': images / (t_end - t_start),
             'request_p95_ms': harness.percentile(latencies, 95) * 1e3},
        trace=trace, readings=readings)


def _report_latencies(stream, first, latencies) -> None:
    """The window's median and 95th-percentile latency by request kind
    (the slider's group), on standard error."""
    by = {}
    for j, lat in enumerate(latencies):
        item = stream.items[first + j]
        key = item[0] if stream.kind == 'slider' else 'sweep'
        by.setdefault(key, []).append(lat * 1e3)
    parts = [f'{k} n={len(v)} p50={harness.percentile(v, 50):.2f} '
             f'p95={harness.percentile(v, 95):.2f}' for k, v in by.items()]
    print('[window] ms by request kind: ' + '; '.join(parts),
          file=sys.stderr)


def _reference(ctx, specs, w_seed, sessions, stream, kept, targets, alphas,
               shape_dirs, texture_dirs, table):
    """Per sampled request, against the float32 reference given the same
    inputs: `label_gap`, by how far the class the program's mask holds lies
    below the reference's best logit at the worst pixel; `image_gap`, the
    mean absolute difference in uint8 levels of each image from the
    reference's render and blend under the program's mask.  When
    calibrating, the same numbers of the control (the reference in float8
    put in the program's place)."""
    device = ctx.device
    cfg = ctx.config['pipeline']
    p = weights.draw(specs, w_seed, device)
    fp8 = Numerics('fp8')
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    sdirs, tdirs = t(shape_dirs), t(texture_dirs)
    table_t = torch.as_tensor(table)
    got = {'label_gap': [], 'image_gap': []}
    if ctx.control:
        got.update(control_label_gap=[], control_image_gap=[])

    def gap(a, b):
        return (a.to(torch.int16) - b.to(torch.int16)).abs().float().mean(
            dim=(1, 2, 3)).tolist()

    def judge(img, mask, lat, codes, face, label):
        """img [N,S,S,3] uint8, mask [S,S] of the program; lat the
        reference's latent of N rows (shape and face those of row 0)."""
        n = img.shape[0]
        logits = ref.mask_logits(p, cfg['shape'], lat['shape'][:1],
                                 lat['face'][:1])
        got['label_gap'].append(ref.label_gap(logits, mask[None]))
        args = (codes.expand(n, -1, -1), lat, face[None].expand(n, -1, -1, -1),
                label[None].expand(n, -1, -1))
        got['image_gap'] += gap(img, ref.edit(p, cfg, *args,
                                              mask[None].expand(n, -1, -1)))
        if ctx.control:
            lc = ref.mask_logits(p, cfg['shape'], lat['shape'][:1],
                                 lat['face'][:1], nx=fp8).argmax(1)
            got['control_label_gap'].append(ref.label_gap(logits, lc))
            lc = lc.expand(n, -1, -1)
            got['control_image_gap'] += gap(
                ref.edit(p, cfg, *args, lc, nx=fp8),
                ref.edit(p, cfg, *args, lc))

    with torch.no_grad():
        enc = []
        for face, label, _ in sessions:
            img = face[None].float() / 127.5 - 1.0
            enc.append(ref_sean.encode(sub(p, 'sean.'), cfg['sean'], img,
                                       label[None]))
        if stream.kind == 'slider':
            face, label, lat0 = sessions[0]
            lat = {k: t(v) for k, v in lat0.items()}
            for i in range(max(kept) + 1 if kept else 0):
                lat = ref.apply_tick(lat, stream.items[i], table_t, sdirs,
                                     tdirs)
                if i in kept:
                    img, mask = kept[i]
                    judge(t(img)[None], t(mask), lat, enc[0], face, label)
        else:
            a = t(alphas)
            for i in sorted(kept):
                k, row = stream.items[i]
                face, label, lat0 = sessions[k]
                l1 = {f: t(v) for f, v in lat0.items()}
                l2 = {f: t(v[row:row + 1]) for f, v in targets.items()}
                img, mask = kept[i]
                judge(t(img), t(mask), ref.interpolate(l1, l2, a), enc[k],
                      face, label)
    print(f'[check] {len(got["image_gap"])} images of {len(kept)} sampled '
          'requests', file=sys.stderr)
    return got
