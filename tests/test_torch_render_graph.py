# The render's CUDA graph cache (pipeline/stage_graph.py) on the CPU, the
# capture stubbed: a stub graph copies into the real input slots and
# recomputes the render into the graph's output on each replay, so the
# cache's policy and its copies run as on a card.  The first sight of a
# signature runs eagerly, the second captures and later calls replay; keys
# on the batch size and on whether the feature is given; the least
# recently used graph is evicted past the bound; a rebound tensor drops the
# graphs while load_state_dict keeps them; a CPU editor never captures.
# Each call's mode is read from the `graph` attribute of its render span.
# The same on a card: tests/test_torch_cuda.py.
import numpy as np
import pytest
import torch

from ctrlhair_tpu_torch import config as C
from ctrlhair_tpu_torch.constants import NUM_CLASSES
from ctrlhair_tpu_torch.models.layers import set_compute_dtype
from ctrlhair_tpu_torch.pipeline import stage_graph
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.pipeline.latent import Latent
from ctrlhair_tpu_torch.utils import profiling

EAGER, REPLAY, CAPTURE = (stage_graph.EAGER, stage_graph.REPLAY,
                          stage_graph.CAPTURE)
CFG = C.PipelineConfig(
    sean=C.SEANConfig(crop_size=64, ngf=4, zencoder_ngf=4, style_dim=16,
                      spade_hidden=8),
    bisenet=C.BiSeNetConfig(input_size=64),
    color_texture=C.ColorTextureConfig(style_dim=16),
    shape=C.ShapeConfig(img_size=64, layer_num=3, max_channel=64,
                        hidden_in_channel=8, face_dim=32),
    edit_size=64, poisson_iterations=10, compute_dtype='float32')


class StubGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay recomputes the captured
    call from its slots into its output."""

    def __init__(self, fn, slots, out):
        self.fn, self.slots, self.out = fn, slots, out

    def replay(self):
        self.out.copy_(self.fn(*self.slots))


def stub_capture(self, fn, inputs):
    slots = stage_graph._Slots(inputs)
    out = fn(*slots.views)
    return stage_graph._Graph(StubGraph(fn, slots.views, out), slots, out)


@pytest.fixture
def editor(monkeypatch):
    torch.manual_seed(0)
    ed = HairEditor(CFG, device='cpu', seed=3)
    monkeypatch.setattr(stage_graph.StageGraphs, '_capture', stub_capture)
    ed._render_graphs.enabled = True
    return ed


def inputs(n, seed=0, expand=False):
    """(codes, label, latent) of a batch of n; expand: codes and label as
    views of one row expanded to n, as output_sweep passes them."""
    g = torch.Generator().manual_seed(seed)
    s, d = CFG.edit_size, CFG.sean.style_dim
    rows = 1 if expand else n
    codes = torch.randn(rows, NUM_CLASSES, d, generator=g)
    label = torch.randint(0, NUM_CLASSES, (rows, s, s), generator=g,
                          dtype=torch.int32)
    if expand:
        codes, label = codes.expand(n, -1, -1), label.expand(n, -1, -1)
    lat = Latent(hsv=torch.rand(n, 3, generator=g) * 170,
                 pca_std=torch.rand(n, 1, generator=g),
                 curliness=torch.randn(n, CFG.color_texture.curliness_dim,
                                       generator=g),
                 texture=torch.randn(n, CFG.color_texture.noise_dim,
                                     generator=g),
                 shape=torch.randn(n, CFG.shape.hair_dim, generator=g),
                 face=torch.randn(n, CFG.shape.face_dim, generator=g))
    return codes, label, lat


def render(editor, n, seed=0, feature=False, expand=False):
    """One edit_render; -> (image, the `graph` attribute of its span)."""
    codes, label, lat = inputs(n, seed, expand)
    feat = torch.randn(n, CFG.sean.style_dim,
                       generator=torch.Generator().manual_seed(seed + 1)) \
        if feature else None
    profiling.clear()
    with profiling.recording():
        img = editor.edit_render(codes, label, lat, feat)
    spans = [r for r in profiling.records() if r.name == 'render']
    profiling.clear()
    assert len(spans) == 1
    return img, spans[0].attrs['graph']


def modes(editor, calls):
    return [render(editor, *c)[1] for c in calls]


@pytest.mark.parametrize('expand', [False, True])
def test_eager_then_capture_then_replay(editor, expand):
    n = 3 if expand else 1
    graphs = editor._render_graphs
    eager, mode = render(editor, n, 0, expand=expand)
    assert mode == EAGER and graphs.captures == 0
    got = [render(editor, n, seed, expand=expand) for seed in (0, 0, 5)]
    assert [m for _, m in got] == [CAPTURE, REPLAY, REPLAY]
    assert graphs.captures == 1 and len(graphs) == 1
    # the capture's replay and the next are the eager render bit for bit;
    # other inputs give the eager render of those inputs
    assert torch.equal(got[0][0], eager) and torch.equal(got[1][0], eager)
    editor._render_graphs.enabled = False
    assert torch.equal(got[2][0], render(editor, n, 5, expand=expand)[0])
    # no two calls hand back the same memory, nor the graph's output
    ptrs = {img.data_ptr() for img, _ in got}
    assert len(ptrs) == 3
    assert graphs._graphs and all(
        g.out.data_ptr() not in ptrs for g in graphs._graphs.values())


def test_keyed_on_batch_size_and_feature(editor):
    calls = [(1, 0, False), (2, 0, False), (1, 0, True), (2, 0, True)]
    assert modes(editor, calls) == [EAGER] * 4
    assert modes(editor, calls) == [CAPTURE] * 4
    assert modes(editor, calls) == [REPLAY] * 4
    assert editor._render_graphs.captures == 4
    # the feature's render replays with the feature it is given
    a, _ = render(editor, 2, 7, True)
    editor._render_graphs.enabled = False
    assert torch.equal(a, render(editor, 2, 7, True)[0])


def test_least_recently_used_graph_evicted(editor):
    graphs = editor._render_graphs
    assert stage_graph.MAX_GRAPHS == 4
    for n in (1, 2, 3, 4):
        modes(editor, [(n,), (n,)])
    assert len(graphs) == 4 and graphs.captures == 4
    assert modes(editor, [(1,)]) == [REPLAY]      # 2 is now the oldest
    assert modes(editor, [(5,), (5,)]) == [EAGER, CAPTURE]
    assert len(graphs) == 4
    # 2 was evicted: seen before, so it captures at once
    assert modes(editor, [(1,), (3,), (4,), (5,), (2,)]) == \
        [REPLAY] * 4 + [CAPTURE]
    assert graphs.captures == 6 and len(graphs) == 4
    # 2's capture evicted 1, the least recently used
    assert modes(editor, [(1,)]) == [CAPTURE]


def test_rebinding_drops_the_graphs_and_loading_keeps_them(editor):
    graphs = editor._render_graphs
    assert modes(editor, [(1,), (1,)]) == [EAGER, CAPTURE]
    # load_state_dict and init_params copy in place: the graph stays and
    # follows the new values
    ptrs = [t.data_ptr() for t in editor.state_dict().values()]
    editor.load_state_dict({k: v.clone()
                            for k, v in editor.state_dict().items()})
    editor.init_params(seed=11)
    assert [t.data_ptr() for t in editor.state_dict().values()] == ptrs
    img, mode = render(editor, 1)
    assert mode == REPLAY and len(graphs) == 1
    graphs.enabled = False
    assert torch.equal(img, render(editor, 1)[0])
    graphs.enabled = True
    # assign=True rebinds the tensors
    editor.load_state_dict({k: v.clone()
                            for k, v in editor.state_dict().items()},
                           assign=True)
    assert len(graphs) == 0
    assert modes(editor, [(1,), (1,)]) == [EAGER, CAPTURE]
    # so does every cast or move, whatever it changes
    for rebind in (lambda: editor.to(torch.float32), editor.float,
                   lambda: editor._apply(lambda t: t.clone())):
        rebind()
        assert len(graphs) == 0
        assert modes(editor, [(1,), (1,), (1,)]) == [EAGER, CAPTURE, REPLAY]
    # another compute dtype is another signature
    set_compute_dtype(editor, torch.float64)
    assert modes(editor, [(1,), (1,), (1,)]) == [EAGER, CAPTURE, REPLAY]
    assert len(graphs) == 2


def test_a_call_that_records_gradients_runs_eagerly(editor):
    codes, label, lat = inputs(1)
    for _ in range(3):
        profiling.clear()
        with profiling.recording():
            editor._edit_render(codes, label, lat)
        assert [r.attrs['graph'] for r in profiling.records()
                if r.name == 'render'] == [EAGER]
    assert len(editor._render_graphs) == 0


def test_cpu_editor_never_captures():
    ed = HairEditor(CFG, device='cpu', seed=3)
    graphs = ed._render_graphs
    assert not graphs.enabled
    assert modes(ed, [(1,), (1,), (1,), (2,), (2,)]) == [EAGER] * 5
    assert graphs.captures == 0 and len(graphs) == 0
    # the output path and the sweep render through the same stage
    codes, label, lat = inputs(1)
    face = torch.zeros(1, CFG.edit_size, CFG.edit_size, 3, dtype=torch.uint8)
    profiling.clear()
    with profiling.recording():
        ed.output(codes, lat, face, label, label)
        ed.output_sweep(codes, lat, lat,
                        np.linspace(0, 1, 3, dtype=np.float32), face, label,
                        label)
    assert [r.attrs['graph'] for r in profiling.records()
            if r.name == 'render'] == [EAGER, EAGER]
    profiling.clear()


def test_threads_share_the_cache_without_a_lost_update(editor):
    """Eight threads render at three batch sizes with a short switch
    interval: each gets the eager render of its own inputs, each signature
    is captured once, the bound holds.  Torch runs on one thread in every
    test process (conftest.py at the root), so that the eager references
    sum in the same order."""
    import sys
    import threading
    errors = []

    def work(k, cases):
        try:
            for i in range(3):
                n, seed = 1 + (k + i) % 3, (k * i) % 2
                got = editor.edit_render(*inputs(n, seed))
                if not torch.equal(got, cases[n, seed]):
                    errors.append((k, i, n, seed))
        except Exception as e:                   # noqa: BLE001 - reported
            errors.append(e)

    old = sys.getswitchinterval()
    try:
        editor._render_graphs.enabled = False
        cases = {(n, seed): render(editor, n, seed)[0]
                 for n in (1, 2, 3) for seed in (0, 1)}
        editor._render_graphs.enabled = True
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=work, args=(k, cases))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    graphs = editor._render_graphs
    assert graphs.captures == 3 and len(graphs) == 3
