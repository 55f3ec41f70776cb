# The spans of training/chunked.ChunkRunner (utils/profiling.span): one
# `train.chunk` a chunk, with its `steps` and its `graph` attribute (EAGER
# on the CPU's eager path; on the card's path, with the capture stubbed as
# tests/test_torch_render_graph.py stubs the render's, CAPTURE on the chunk
# that captures and REPLAY after), and one `train.inputs` a step nested in
# its chunk; nothing recorded outside a profiler or recording(); and the
# state after two chunks bit-equal with the spans recorded or not.  The
# steps are the tiny shape trainer's, with its host draws.
import pytest
import torch

from ctrlhair_tpu_torch.config import ShapeConfig
from ctrlhair_tpu_torch.training import chunked
from ctrlhair_tpu_torch.training.chunked import (
    CAPTURE, EAGER, REPLAY, ChunkRunner)
from ctrlhair_tpu_torch.training.shape_trainer import (
    ShapeTrainer, synthetic_batch)
from ctrlhair_tpu_torch.utils import profiling

CFG = ShapeConfig(img_size=32, layer_num=3, max_channel=32,
                  hidden_in_channel=8, d_hidden_in_channel=8, face_dim=32,
                  d_hidden_dim=32)


def case():
    """(runner, state) of the tiny shape trainer, batch 2."""
    tr = ShapeTrainer(CFG, device='cpu', seed=3)

    def make_batch(seed):
        return synthetic_batch(torch.Generator().manual_seed(seed), CFG, 2)

    runner = ChunkRunner(tr.train_step, make_batch,
                         make_draws=lambda s: tr.draws(s, 2))
    return runner, tr.init_state(0)


class StubGraph:
    """Stands in for torch.cuda.CUDAGraph: a replay runs the step eagerly
    on the input slots, as the captured graph would, and writes its
    metric row."""

    def __init__(self, fn):
        self.replay = fn


def stub_capture(self, state, tensors, inputs, extra, key):
    """The capture's bookkeeping without a card: the step tensor, the input
    slots, one step taken and undone to learn the metrics' keys."""
    self._step_t = torch.zeros((), dtype=torch.int64)
    slots = [t.detach().clone() for t in chunked._flatten(inputs)[0]]
    inputs = chunked._with_tensors(inputs, slots)
    host_step = state.step
    with torch.no_grad():
        saved = [t.clone() for t in tensors]
    self._step_t.fill_(host_step)
    state.step = self._step_t
    _, metrics = self._call(state, inputs, extra)
    keys = list(metrics)
    row = chunked._metric_row(metrics, keys)
    state.step = host_step
    with torch.no_grad():
        for t, s in zip(tensors, saved):
            t.copy_(s)

    def replay():
        state.step = self._step_t
        _, m = self._call(state, inputs, extra)
        row.copy_(chunked._metric_row(m, keys))
    return chunked._Graph(StubGraph(replay), slots, row, keys, key)


@pytest.fixture
def stubbed(monkeypatch):
    monkeypatch.setattr(ChunkRunner, '_on_card', staticmethod(lambda s: True))
    monkeypatch.setattr(ChunkRunner, '_capture', stub_capture)


@pytest.fixture
def store():
    profiling.clear()
    yield
    profiling.clear()


def recorded(runner, state, start, stop, chunk_size):
    with profiling.recording():
        state, rows, _ = runner.run(state, start, stop,
                                    chunk_size=chunk_size, record_every=1)
    return state, rows, [r for r in profiling.records()
                         if r.name.startswith('train.')]


def check_nesting(spans, steps, modes):
    """One train.chunk a chunk, with its steps and graph attribute, each
    holding one train.inputs a step inside its own time."""
    chunks = sorted((r for r in spans if r.name == 'train.chunk'),
                    key=lambda r: r.start_ns)
    assert [c.attrs for c in chunks] == [
        {'steps': n, 'graph': m} for n, m in zip(steps, modes)]
    assert all(c.parent is None for c in chunks)
    inputs = [r for r in spans if r.name == 'train.inputs']
    assert len(inputs) == sum(steps)
    for c, n in zip(chunks, steps):
        mine = [r for r in inputs if r.parent == c.id]
        assert len(mine) == n
        assert all(c.start_ns <= r.start_ns <= r.end_ns <= c.end_ns
                   and r.request == c.request and not r.attrs
                   for r in mine)


def test_eager_chunks(store):
    runner, state = case()
    _, rows, spans = recorded(runner, state, 0, 5, 2)
    assert len(rows) == 5
    check_nesting(spans, [2, 2, 1], [EAGER] * 3)


def test_card_path_captures_then_replays(store, stubbed):
    runner, state = case()
    eager_runner, eager_state = case()
    state, rows, spans = recorded(runner, state, 0, 6, 3)
    assert runner._graph is not None
    check_nesting(spans, [3, 3], [CAPTURE, REPLAY])
    # the stub replays the step the eager loop takes
    eager_state, eager_rows, _ = eager_runner.run(eager_state, 0, 6,
                                                  chunk_size=3,
                                                  record_every=1)
    assert rows == eager_rows
    for a, b in zip(state.tensors(), eager_state.tensors()):
        assert torch.equal(a, b)


def test_nothing_recorded_without_a_profiler(store):
    runner, state = case()
    runner.run(state, 0, 3, chunk_size=2, record_every=1)
    assert not [r for r in profiling.records()
                if r.name.startswith('train.')]


def test_spans_leave_the_state_unchanged(store):
    runner, state = case()
    state, _, spans = recorded(runner, state, 0, 4, 2)
    assert spans
    plain_runner, plain = case()
    plain, _, _ = plain_runner.run(plain, 0, 4, chunk_size=2, record_every=1)
    assert state.step == plain.step == 4
    for a, b in zip(state.tensors(), plain.tensors()):
        assert torch.equal(a, b)
