# CUDA-graph capture for pipeline/stage_graph.StageGraphs and
# training/chunked.ChunkRunner: a warm-up on a side stream, as
# torch.cuda.graph asks (what the captured work initialises lazily, such as
# cuBLAS's handles, cuDNN's algorithm choice, NCCL's communicator and
# autograd's gradient accumulators, is made before the capture and off the
# legacy default stream), then the capture, with fresh_memory around both.
# The callers own what the warm-up and the body do and what the graph reads
# and writes.  EAGER, REPLAY and CAPTURE are the values of the integer
# attribute `graph` on both callers' spans (utils/profiling.span).

from __future__ import annotations

import gc
from typing import Any, Callable, Tuple

import torch

EAGER, REPLAY, CAPTURE = 0, 1, 2        # the `graph` attribute of a span


def fresh_memory(device) -> None:
    """Called before the warm-up, before the capture and after it.  cuBLAS
    keeps a workspace per stream; one made during a capture lies in that
    graph's private pool, and once the graph is freed (a recapture, a new
    runner) the next capture or eager step would still write to it while
    the allocator hands the same memory to other tensors: the workspaces
    are dropped, as torch.compile's CUDA graphs drop them.  A SEANConfig()
    step captured after another graph of it had been freed stood 0.0183
    from its eager loop with deterministic cuDNN until they were.  Garbage
    is collected too, so that an earlier step's autograd graph that is no
    longer referenced lets go of its gradient accumulators."""
    torch.cuda.synchronize(device)
    torch._C._cuda_clearCublasWorkspaces()
    gc.collect()
    torch.cuda.empty_cache()


def capture(device, warmup: Callable[[], Any], body: Callable[[], Any], *,
            pool=None, capture_error_mode: str = 'global'
            ) -> Tuple[torch.cuda.CUDAGraph, Any]:
    """Run warmup() on a new side stream, then capture body() as a CUDA
    graph on `device`, with fresh_memory before the warm-up, before the
    capture and after it; -> (graph, body's result).  `pool` and
    `capture_error_mode` go to torch.cuda.graph: a pool handle shared with
    other graphs, and 'thread_local' to let other threads run eagerly
    during the capture."""
    fresh_memory(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    try:
        with torch.cuda.stream(side):
            warmup()
    finally:
        torch.cuda.current_stream(device).wait_stream(side)
    fresh_memory(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool,
                          capture_error_mode=capture_error_mode):
        out = body()
    fresh_memory(device)
    return graph, out
