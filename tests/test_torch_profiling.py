# The port's spans (ctrlhair_tpu_torch/utils/profiling.py) on the edit path:
# off, a span records nothing and opens no profiler range; inside
# recording() each request on the Backend, and a slider move, is one root
# with its stages and readbacks nested under it; a second thread starts its
# own root; past the bound records are dropped and counted, also from many
# threads at once; and under torch.profiler the spans record without
# recording(), on the clock of the profiler's own host events.  A tiny
# editor with drawn weights, on the CPU.  Also the suite's rule that torch
# runs on one thread in every test process (conftest.py at the root).
import sys
import threading

import numpy as np
import pytest
import torch

from ctrlhair_tpu_torch import config as C
from ctrlhair_tpu_torch.pipeline.backend import Backend
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.pipeline.latent import Latent
from ctrlhair_tpu_torch.ui import app
from ctrlhair_tpu_torch.utils import profiling

STAGES = {'render', 'decode_mask', 'blend'}


def tiny_config() -> C.PipelineConfig:
    return C.PipelineConfig(
        sean=C.SEANConfig(crop_size=64, ngf=4, zencoder_ngf=4, style_dim=64),
        bisenet=C.BiSeNetConfig(input_size=128),
        color_texture=C.ColorTextureConfig(style_dim=64),
        shape=C.ShapeConfig(img_size=64, layer_num=5, max_channel=64,
                            hidden_in_channel=8),
        edit_size=64, poisson_iterations=10, compute_dtype='float32')


@pytest.fixture(scope='module')
def backend():
    """A session as an analysis leaves it: a face, its parse, a latent and
    the face's SEAN codes."""
    cfg = tiny_config()
    editor = HairEditor(cfg, device='cpu', seed=3)
    be = Backend(cfg=cfg, editor=editor, trained_root=None)
    rng = np.random.default_rng(5)
    s = cfg.edit_size
    label = np.zeros((s, s), np.int32)
    label[8:40, 12:52] = 13
    label[24:60, 20:44] = 1
    be.input_img = rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
    be.input_mask = label
    be.cur_latent = random_latent(rng, cfg, 1)
    with torch.inference_mode():
        img = torch.as_tensor(be.input_img)[None].float() / 127.5 - 1.0
        be.input_sean_code = editor.sean.encode(
            img, torch.as_tensor(label)[None]).float()
    be.refresh_cur_mask()
    return be


def random_latent(rng, cfg, n) -> Latent:
    draw = lambda *shape: torch.as_tensor(
        rng.standard_normal(shape), dtype=torch.float32)
    return Latent(hsv=torch.tensor([[20.0, 120.0, 90.0]] * n),
                  pca_std=torch.full((n, 1), 60.0), curliness=draw(n, 1),
                  texture=draw(n, cfg.color_texture.noise_dim),
                  shape=draw(n, cfg.shape.hair_dim),
                  face=draw(n, cfg.shape.face_dim))


@pytest.fixture(autouse=True)
def empty_store():
    profiling.clear()
    yield
    profiling.clear()


REQUESTS = {
    'output': ('backend.output', 1, lambda be: be.output()),
    'slider_shape': ('slider.apply', None,
                     lambda be: app.apply_slider(be, 'shape', 1, 0.7)),
    'sweep': ('backend.sweep', 3, lambda be: be.interpolation_sweep(
        be.cur_latent, be.cur_latent.replace(
            texture=-be.cur_latent.texture), np.linspace(0, 1, 3))),
    'output_batch': ('backend.output_batch', 2, lambda be: be.output_batch(
        random_latent(np.random.default_rng(9), be.cfg, 2))),
}


def test_off_records_nothing_and_opens_no_range(backend, monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, 'record_function', Counting)
    assert not torch.autograd._profiler_enabled()
    out = backend.output()
    app.apply_slider(backend, 'shape', 0, 0.3)
    assert out.shape == (64, 64, 3)
    assert profiling.records() == [] and entered == []
    with profiling.recording():
        backend.output()
    assert entered and entered[0] == 'ctrlhair.backend.output'
    assert len(profiling.records()) == len(entered)


@pytest.mark.parametrize('kind', list(REQUESTS))
def test_one_root_per_request(backend, kind):
    name, images, call = REQUESTS[kind]
    with profiling.recording():
        call(backend)
    recs = profiling.records()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [name]
    root = roots[0]
    assert root.attrs.get('images') == images
    by_id = {r.id: r for r in recs}
    for r in recs:
        assert r.request == root.request
        assert r.thread == threading.get_ident()
        assert r.start_ns <= r.end_ns
        if r is not root:
            parent = by_id[r.parent]
            assert parent.start_ns <= r.start_ns <= r.end_ns <= \
                parent.end_ns
    names = [r.name for r in recs if r is not root]
    want = {'output': {'render', 'blend', 'readback'},
            'slider_shape': {'decode_mask'},
            'sweep': {'render', 'blend', 'readback'},
            'output_batch': {'render', 'blend', 'readback'}}[kind]
    assert set(names) == want
    assert names.count('readback') == (0 if kind == 'slider_shape' else 1)
    # the stages hang straight off the root; nothing records twice
    assert all(by_id[r.parent] is root for r in recs if r.name in STAGES)
    assert len({r.id for r in recs}) == len(recs)


def test_lazy_mask_read_is_a_readback_of_its_own_request(backend):
    app.apply_slider(backend, 'shape', 2, -0.4)
    with profiling.recording():
        backend.cur_mask
    (rec,) = profiling.records()
    assert rec.name == 'readback' and rec.parent is None


def test_a_second_thread_starts_its_own_root():
    seen = {}

    def worker():
        with profiling.span('inner'):
            pass
        seen['thread'] = threading.get_ident()
    with profiling.recording():
        with profiling.span('outer', images=1):
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            with profiling.span('child'):
                pass
    recs = {r.name: r for r in profiling.records()}
    assert recs['inner'].parent is None
    assert recs['inner'].thread == seen['thread']
    assert recs['inner'].request != recs['outer'].request
    assert recs['child'].parent == recs['outer'].id
    assert recs['child'].request == recs['outer'].request
    assert recs['outer'].attrs == {'images': 1}


def test_records_past_the_bound_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling, 'MAX_RECORDS', 3)
    with profiling.recording():
        for i in range(5):
            with profiling.span(f's{i}'):
                pass
    assert [r.name for r in profiling.records()] == ['s0', 's1', 's2']
    assert profiling.dropped() == 2
    snapshot = profiling.records()
    snapshot.clear()
    assert len(profiling.records()) == 3
    profiling.clear()
    assert profiling.records() == [] and profiling.dropped() == 0


def test_threads_lose_no_span_at_the_bound(monkeypatch):
    """More threads than cores, each nesting spans, with a short switch
    interval: every span is kept or counted as dropped, none twice, and
    each thread's spans carry its own roots' request ids."""
    monkeypatch.setattr(profiling, 'MAX_RECORDS', 1000)
    threads, rounds = 16, 40

    def worker():
        for _ in range(rounds):
            with profiling.span('root'):
                with profiling.span('child'):
                    pass
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profiling.recording():
            pool = [threading.Thread(target=worker) for _ in range(threads)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    recs = profiling.records()
    assert len(recs) == 1000
    assert len(recs) + profiling.dropped() == threads * rounds * 2
    assert len({r.id for r in recs}) == len(recs)
    roots = {r.id: r for r in recs if r.parent is None}
    for r in recs:
        if r.parent in roots:
            assert r.request == roots[r.parent].request
            assert r.thread == roots[r.parent].thread
    assert len({r.request for r in roots.values()}) == len(roots)


def test_spans_share_the_profilers_host_clock():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span('warm'):
            pass
        for i in range(4):
            with profiling.span('outer', i=i):
                torch.ones(32, 32).sum()
                with profiling.span('inner'):
                    torch.ones(32, 32).mul(2)
    recs = [r for r in profiling.records() if r.name != 'warm']
    assert len(recs) == 8
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            events.setdefault(e.name()[len(profiling.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    for name in ('outer', 'inner'):
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs) == 4
        for (s, e), (ks, ke) in zip(mine, theirs):
            assert abs(s - ks) <= 1_000_000 and abs(e - ke) <= 1_000_000
    assert not torch.autograd._profiler_enabled()
    with profiling.span('after'):
        pass
    assert all(r.name != 'after' for r in profiling.records())


def test_torch_runs_on_one_thread_in_every_test_process():
    """conftest.py at the root pins torch to one CPU thread in each pytest
    process, xdist's workers included, so that the suite's six workers do
    not oversubscribe the cores and no test module has to ask for it."""
    assert torch.get_num_threads() == 1
