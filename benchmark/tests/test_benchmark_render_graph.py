"""The reader of render_graph_share.edit on synthetic records: the share of
the window's outermost render spans whose `graph` attribute reads 1 (a
replay of the render's CUDA graph), all replays, a mix of eager renders,
a capture and replays, and nothing where no render span carries the
attribute (a program without the graphs) or the window holds no render.
A traced CPU run of each edit cell reads it as well
(test_benchmark_spans.test_cpu_run_of_an_edit_cell)."""

import pytest

from benchmark import spans
from benchmark.tests.test_benchmark_spans import (
    HARNESS, OPS, RECORDS, read, rec)
from benchmark.trace import Trace

NAME = 'render_graph_share.edit'


def with_graph(records, modes):
    """RECORDS with the attribute `graph` on each window render span in
    turn; the earlier window's render (request 9) reads 1 throughout."""
    modes = iter(modes)
    out = []
    for r in records:
        if r.name == 'render':
            attrs = dict(r.attrs, graph=1 if r.request == 9 else next(modes))
            r = r._replace(attrs=attrs)
        out.append(r)
    return out


def read_with(monkeypatch, records):
    monkeypatch.setattr(spans, 'program_records', lambda: list(records))
    return read(NAME, Trace(OPS, 0.3e-3, HARNESS, {}))


@pytest.mark.parametrize('modes,share', [
    ((1, 1), 1.0), ((0, 1), 0.5), ((2, 1), 0.5), ((0, 2), 0.0),
    ((0, 0), 0.0)])
def test_share_of_replays(monkeypatch, modes, share):
    assert read_with(monkeypatch, with_graph(RECORDS, modes)) == share


def test_a_nested_render_and_other_stages_do_not_count(monkeypatch):
    """A render inside another stage is not outermost, and a stage other
    than the render carries no weight, whatever its attribute."""
    extra = [rec('backend.output', 5, 20, None, 250, 300, images=1),
             rec('blend', 5, 21, 20, 255, 290, graph=1),
             rec('render', 5, 22, 21, 260, 280, graph=0)]
    records = with_graph(RECORDS, (1, 1)) + extra
    assert read_with(monkeypatch, records) == 1.0


def test_nothing_without_the_attribute(monkeypatch):
    assert read_with(monkeypatch, RECORDS) is None
    assert read_with(monkeypatch, []) is None
    no_render = [r for r in with_graph(RECORDS, (1, 1))
                 if r.name != 'render' or r.request == 9]
    assert read_with(monkeypatch, no_render) is None
