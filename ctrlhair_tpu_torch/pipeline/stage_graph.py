# CUDA graphs of an editor stage, one per input signature.
#
# On a card the editor's render is a chain of about 1,260 small kernels, and
# one host core cannot issue their launches as fast as the card runs them.
# The render's inputs have fixed shapes for a given batch size and it reads
# nothing back to the host, so it is captured once as a CUDA graph and
# replayed: a call copies its tensors into the graph's input slots, replays
# the graph, and returns a clone of the graph's output, so that no caller's
# tensor aliases memory the next replay overwrites.  A slot has its input's
# strides, and an input expanded along a dimension (a stride of 0, as
# output_sweep broadcasts the session's one row) has a slot of one row there
# that the graph reads expanded: the captured kernels are those the eager
# call runs on the same views (cuDNN picks its kernels by the layout).
#
# The signature is read off the call: each input's shape, strides, dtype and
# device, whether inference mode is on, and a key of the owner's (the
# models' compute dtypes).  The first call with a signature runs eagerly,
# which lets cuDNN and cuBLAS choose their algorithms.  The second captures
# through utils/cuda_graphs.capture, which warms up once more on a side
# stream and keeps the capture's memory hygiene (cuBLAS's workspaces dropped
# before and after); that call and every later one replay.  This module owns
# the cache's policy: the signatures, the input slots, the bound and the
# lock.  At most MAX_GRAPHS graphs are kept, the least
# recently used evicted first, all in one private memory pool.  A lock
# serialises capture and replay, and a capture runs with
# capture_error_mode='thread_local', so another thread may run eagerly
# meanwhile (HairEditor(warm_batches=...) warms on a daemon thread while the
# caller renders).  A call that records gradients, and every call off a
# card, runs eagerly.  A capture that fails raises.
#
# Each call opens the stage's span (utils/profiling.span) around the eager
# run or the replay, with the integer attribute `graph`: EAGER, REPLAY, or
# CAPTURE for a capture followed by its replay (utils/cuda_graphs).
#
# A graph reads the owner's parameters and buffers at the addresses they
# had when it was captured, so values copied into them in place
# (load_state_dict, init_params) are read by the next replay.  An owner
# whose tensors are rebound calls clear(), which drops every graph.

from __future__ import annotations

import functools
import threading
from collections import OrderedDict
from typing import Callable, Hashable, Sequence, Tuple

import torch

from ctrlhair_tpu_torch.utils import cuda_graphs
from ctrlhair_tpu_torch.utils.cuda_graphs import CAPTURE, EAGER, REPLAY
from ctrlhair_tpu_torch.utils.profiling import span

MAX_GRAPHS = 4


def _expanded_dims(t: torch.Tensor) -> Tuple[int, ...]:
    return tuple(d for d, (n, s) in enumerate(zip(t.shape, t.stride()))
                 if s == 0 and n > 1)


def _unexpanded(t: torch.Tensor, dims: Tuple[int, ...]) -> torch.Tensor:
    for d in dims:
        t = t.narrow(d, 0, 1)
    return t


class _Slots:
    """A call's input slots: for each input a tensor of its strides, of
    one row along each dimension the input is expanded in, and the views
    of them that the graph reads (the slots expanded as the inputs are)."""

    def __init__(self, inputs: Sequence[torch.Tensor]):
        self.dims = [_expanded_dims(t) for t in inputs]
        self.slots = [torch.empty_like(_unexpanded(t, d))
                      for t, d in zip(inputs, self.dims)]
        self.views = [s.expand(t.shape) for s, t in zip(self.slots, inputs)]
        self.fill(inputs)

    def fill(self, inputs: Sequence[torch.Tensor]) -> None:
        for slot, d, t in zip(self.slots, self.dims, inputs):
            slot.copy_(_unexpanded(t, d))


class _Graph:
    """One captured call: the CUDA graph, its input slots, its output."""

    def __init__(self, graph, slots: _Slots, out: torch.Tensor):
        self.graph, self.slots, self.out = graph, slots, out

    def run(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        self.slots.fill(inputs)
        self.graph.replay()
        return self.out.clone()


class StageGraphs:
    """The graphs of one stage: stage(fn, inputs, key) -> fn(*inputs), a
    single tensor, eagerly or by a replay (see the header)."""

    def __init__(self, name: str, device):
        self.name = name
        self.device = torch.device(device)
        self.enabled = self.device.type == 'cuda'
        self.captures = 0
        self._lock = threading.Lock()
        self._seen = set()
        self._graphs: OrderedDict = OrderedDict()
        self._pool = None

    def __len__(self) -> int:
        return len(self._graphs)

    def clear(self) -> None:
        """Drop every graph; the next call of each signature runs eagerly
        again."""
        with self._lock:
            self._graphs.clear()
            self._seen.clear()

    def __call__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 key: Hashable = ()) -> torch.Tensor:
        if not self.enabled or torch.is_grad_enabled():
            with span(self.name, graph=EAGER):
                return fn(*inputs)
        sig = (key, torch.is_inference_mode_enabled(),
               tuple((t.shape, t.stride(), t.dtype, t.device)
                     for t in inputs))
        with self._lock:
            first = sig not in self._seen
            self._seen.add(sig)
        if first:
            with span(self.name, graph=EAGER):
                return fn(*inputs)
        with self._lock:
            g = self._graphs.get(sig)
            with span(self.name, graph=REPLAY if g is not None else CAPTURE):
                if g is None:
                    while len(self._graphs) >= MAX_GRAPHS:
                        self._graphs.popitem(last=False)
                    g = self._graphs[sig] = self._capture(fn, inputs)
                    self.captures += 1
                else:
                    self._graphs.move_to_end(sig)
                return g.run(inputs)

    def _capture(self, fn: Callable, inputs) -> _Graph:
        """Warm fn up on a side stream over the new input slots, then
        capture it over them into the shared pool."""
        slots = _Slots(inputs)
        with torch.cuda.device(self.device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            call = functools.partial(fn, *slots.views)
            graph, out = cuda_graphs.capture(
                self.device, call, call, pool=self._pool,
                capture_error_mode='thread_local')
        return _Graph(graph, slots, out)
