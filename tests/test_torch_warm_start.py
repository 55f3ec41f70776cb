# The port's warm start (HairEditor.warm_start / join_warm / warm_batches,
# ui/web.WebEditor(warm=True)) against the JAX editor's: the same jobs, in
# the same order, on inputs of the same shapes and dtypes, at batch 1 and
# batch 2 (each side's stages replaced by recorders, so nothing compiles);
# on the tiny editor, a warm-up changes no parameter or buffer, and every
# later result equals an unwarmed editor's bit for bit; block=False hands
# back a started thread that join_warm joins; and the web server's worker
# runs the warm-up as its first job, with a request queued behind it.
import threading

import jax
import numpy as np
import pytest
import torch

from ctrlhair_tpu_torch.convert import from_flax
from ctrlhair_tpu_torch.ops.resize import resize_bilinear_nhwc
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.pipeline.latent import Latent
from ctrlhair_tpu_torch.ui.web import WebEditor
from test_torch_backend import sample_photos
from test_torch_convert import port_config

STAGES = ('output', 'output_refresh', 'decode_mask', 'parse',
          'analyze_tail', 'analyze')
FIELDS = ('hsv', 'pca_std', 'curliness', 'texture', 'shape', 'face')


def signature(args):
    """(shape, dtype name) of each array argument, a Latent's fields in
    order."""
    out = []
    for a in args:
        if hasattr(a, 'face'):
            out += signature([getattr(a, f) for f in FIELDS])
        else:
            out.append((tuple(a.shape), str(a.dtype).replace('torch.', '')))
    return out


def recorded_jobs(editor, monkeypatch, batch_sizes, skip_params):
    """The (stage, signature) of each job of editor.warm_start, its stages
    replaced by recorders."""
    jobs = []
    for name in STAGES:
        def record(*args, name=name):
            jobs.append((name, signature(args[1:] if skip_params else args)))
        monkeypatch.setattr(editor, name, record)
    assert editor.warm_start(batch_sizes=batch_sizes, block=True) == []
    monkeypatch.undo()
    return jobs


@pytest.fixture(scope='module')
def port(tiny_editor):
    ed = HairEditor(port_config(tiny_editor.cfg), device='cpu')
    ed.load_state_dict(from_flax(jax.device_get(tiny_editor.params)))
    return ed


@pytest.mark.parametrize('batch_sizes', [(1,), (2,), (1, 2)])
def test_warm_jobs_match_jax(tiny_editor, port, monkeypatch, batch_sizes):
    got = recorded_jobs(port, monkeypatch, batch_sizes, skip_params=False)
    ref = recorded_jobs(tiny_editor, monkeypatch, batch_sizes,
                        skip_params=True)
    assert got == ref
    names = [n for n, _ in got]
    assert names[:3] == ['output', 'output_refresh', 'decode_mask']
    assert ('analyze' in names) == any(b > 1 for b in batch_sizes)


def session(editor):
    """Every stage the warm-up runs, on the sample photo and its edits."""
    photo = sample_photos()[0]
    a = editor.analyze_image(photo)
    s = editor.cfg.edit_size
    lat = a['latent'].replace(shape=a['latent'].shape + 0.5)
    img = torch.clamp(torch.round(resize_bilinear_nhwc(
        torch.as_tensor(photo)[None].float(), (s, s))), 0, 255).to(
            torch.uint8)
    p = editor.cfg.bisenet.input_size
    out = {'analyze_image': a, 'output': editor.output(
               a['sean_codes'], lat, img, a['label'], a['regen_label']),
           'output_refresh': editor.output_refresh(
               a['sean_codes'], lat, img, a['label']),
           'decode_mask': editor.decode_mask(lat.shape, lat.face),
           'parse': editor.parse(img),
           'analyze': editor.analyze(
               img.expand(2, s, s, 3),
               editor._to_parse_size(img).expand(2, p, p, 3))}
    leaves = []
    for k, v in sorted(out.items()):
        stack = [v]
        while stack:
            x = stack.pop()
            if isinstance(x, dict):
                stack += [x[key] for key in sorted(x)]
            elif isinstance(x, (tuple, list)):
                stack += list(x)
            elif isinstance(x, Latent):
                stack += [getattr(x, f) for f in FIELDS]
            else:
                leaves.append((k, x))
    return leaves


def test_warm_start_changes_nothing(port):
    """A warm-up at batch 1 and 2 leaves every parameter and buffer as it
    was, and the results after it equal an unwarmed editor's bit for
    bit."""
    warmed = HairEditor(port.cfg, device='cpu')
    warmed.load_state_dict(port.state_dict())
    before = {k: v.clone() for k, v in warmed.state_dict().items()}
    assert warmed.warm_start(batch_sizes=(1, 2)) == []
    for k, v in warmed.state_dict().items():
        assert torch.equal(v, before[k]), k
    cold = HairEditor(port.cfg, device='cpu')
    cold.load_state_dict(before)
    got, ref = session(warmed), session(cold)
    assert len(got) == len(ref) > 20
    for (k, g), (_, r) in zip(got, ref):
        assert torch.equal(g, r), k


def test_warm_start_on_a_thread(port, monkeypatch):
    """block=False returns the started thread, which runs every job;
    warm_batches starts it at construction and join_warm joins it."""
    ran = []
    gate = threading.Event()

    def record(*args, name):
        gate.wait(30)
        ran.append((name, threading.current_thread().name))

    for name in STAGES:
        monkeypatch.setattr(port, name,
                            lambda *a, name=name: record(*a, name=name))
    threads = port.warm_start(batch_sizes=(1,), block=False)
    assert len(threads) == 1 and threads[0].is_alive()
    assert threads[0].daemon and ran == []
    gate.set()
    threads[0].join(30)
    assert not threads[0].is_alive()
    assert [n for n, _ in ran] == ['output', 'output_refresh',
                                   'decode_mask', 'parse', 'analyze_tail']
    assert {t for _, t in ran} == {threads[0].name}
    monkeypatch.undo()

    ed = HairEditor(port.cfg, device='cpu', warm_batches=(1,))
    assert len(ed._warm_threads) == 1
    ed.join_warm()
    assert ed._warm_threads == []
    assert HairEditor(port.cfg, device='cpu')._warm_threads == []


class _StubEditor:
    """An editor whose warm_start records its thread and waits on a gate."""

    def __init__(self):
        self.calls = []
        self.gate = threading.Event()

    def warm_start(self, batch_sizes=(1,), block=True):
        self.calls.append(('warm_start', batch_sizes, block,
                           threading.current_thread().name,
                           torch.is_grad_enabled()))
        assert self.gate.wait(30)
        return []


class _StubBackend:
    def __init__(self):
        self.editor = _StubEditor()
        self.cur_latent = None


def test_web_worker_warms_first(monkeypatch):
    """WebEditor(warm=True): the worker's first job is warm_start(block=
    True), and a request waits behind it; without warm nothing runs."""
    backend = _StubBackend()
    web = WebEditor(backend, warm=True)
    try:
        answer = []
        request = threading.Thread(target=lambda: answer.append(
            (web.state(), threading.current_thread().name)))
        request.start()
        request.join(0.5)
        assert request.is_alive() and answer == []
        assert not web.warm.done()
        backend.editor.gate.set()
        request.join(30)
        assert not request.is_alive()
        assert answer[0][0] == {'sliders': {}, 'has_input': False,
                                'has_target': False}
        assert web.join_warm() >= 0.0
        [(name, sizes, block, thread, grad)] = backend.editor.calls
        assert (name, sizes, block, grad) == ('warm_start', (1,), True,
                                              False)
        assert thread.startswith('web-editor')
    finally:
        web.close()
    cold = WebEditor(_StubBackend())
    try:
        assert cold.warm is None and cold.join_warm() is None
        cold.state()
        assert cold.backend.editor.calls == []
    finally:
        cold.close()


def test_build_web_editor_warms(monkeypatch):
    """build_web_editor, which main calls, warms the worker first, as
    JAX's main always warms."""
    from ctrlhair_tpu_torch.pipeline import backend as backend_mod
    from ctrlhair_tpu_torch.ui import web
    built = []

    def stub(**kwargs):
        built.append(kwargs)
        b = _StubBackend()
        b.editor.gate.set()
        return b

    monkeypatch.setattr(backend_mod, 'Backend', stub)
    ed = web.build_web_editor(device='cpu')
    try:
        assert ed.join_warm() >= 0.0
        [(name, sizes, block, thread, _)] = ed.backend.editor.calls
        assert (name, sizes, block) == ('warm_start', (1,), True)
        assert thread.startswith('web-editor')
    finally:
        ed.close()
    assert built == [{'maximum_value_fe': 2.0, 'blending': True,
                      'device': 'cpu'}]
