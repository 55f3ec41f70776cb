"""Share of the window's outermost render spans that replayed the render's
CUDA graph: the program's span attribute `graph` reads 1 (0 an eager
render, 2 a capture followed by its replay; benchmark/spans.py,
ctrlhair_tpu_torch/pipeline/stage_graph.py).  Nothing where no render span
carries the attribute, as in a program without the graphs."""

from benchmark.spans import Window


def read(trace):
    renders = [r for r in Window(trace).stages if r.name == 'render']
    if not any('graph' in r.attrs for r in renders):
        return None
    return sum(r.attrs.get('graph') == 1 for r in renders) / len(renders)
