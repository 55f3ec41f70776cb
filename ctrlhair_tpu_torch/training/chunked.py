# Chunked training: K optimizer steps per chunk with one host sync.
#
# Port of ctrlhair_tpu/training/chunked.py, which wraps any trainer's step
# (JAX's soak runs SEAN, the face parser, both predictors, colour/texture
# and shape through it).  There, K steps run as one jitted lax.scan, one
# dispatch and one host sync per chunk.  Here a step is a trainer's
# train_step, which already runs on the card without a host read (the
# finite gate is a torch.where); what a step costs beyond its kernels is
# the host issuing thousands of launches.  So on the card the step is
# captured once as a CUDA graph and replayed K times a chunk: the host
# copies each step's batch and draws into the graph's input slots, replays
# the graph, and copies the step's metrics into a device buffer of K rows,
# which it reads once when the chunk ends.  On the CPU (the tests) the
# steps run eagerly, and their metrics are stacked and read once a chunk as
# well.
#
# The contract is JAX's: the batch of step s comes only from
# make_batch(batch_seed + s) and its draws only from make_draws(step_seed +
# s), so a chunked run equals the per-step loop whatever the chunk size, and
# a run resumed at any step continues the same streams; rows are recorded
# every `record_every` steps and at the last step, finite-gate trips are
# counted over every step, and on_chunk(step, state, rows) after each chunk
# may stop the run early.
#
# The graph reads and writes the state's own tensors, so a step must update
# every tensor of the state in place (training/train_state.py; the SEAN
# trainer's power-iteration vectors too), and the state must expose them
# (tensors()).  The step index is a device tensor: during capture and
# replay state.step is that tensor, which the step's `state.step += 1`
# advances in place and its loss schedule reads on the device; the host
# sets state.step back to an int after each chunk.  A step that would draw
# for itself from state.step raises there (predictor_trainer.
# step_generator), so a step that draws takes make_draws.  The eager
# warm-up steps that capture needs advance the state, so the state is
# copied before them and restored in place after.  Any state may be
# captured, also one that has taken eager steps and whose tensors the
# caller still holds copies of: before the warm-up each trainable leaf
# gets a new autograd identity over the same storage (_fresh_leaves), so
# that the capture's backward meets no gradient accumulator made earlier
# on the default stream.  The capture's sequence (the warm-up on a side
# stream, the memory hygiene around it) is utils/cuda_graphs.capture's; this
# module owns what the step needs of it: the input slots, the step tensor,
# the state saved and restored (on the warm-up's stream, which the capture
# waits for), the fresh leaves.  The runner holds one graph, which serves
# every chunk, the remainder included; it is captured
# anew when the structure or shapes of the batch and draws, or the tensors
# of the state or of the extra arguments (a module's parameters and
# buffers among them), change.  A capture or replay that fails raises:
# there is no fall-back to eager steps.
#
# A trainer over a mesh (parallel/mesh.py) runs too.  On the CPU its chunk
# takes the steps eagerly, collectives and all, as the per-step loop does.
# On the card the graph captures the step's NCCL collectives (the gradient
# buckets, the global sums, synced batch norm, the tp copies and gathers);
# the warm-up steps have created the communicator before the capture, and
# the buckets the host builds each step are allocated from the graph's
# pool.  Every rank must run the same chunks.  gloo's collectives run on
# the host and cannot be captured: on the card a trainer whose mesh is
# over gloo is refused (the mesh found through functools.partial and
# functools.wraps to the bound method's trainer).
#
# Spans (utils/profiling.span, recorded only while a profiler runs or
# inside recording()): `train.chunk` around each chunk, from its first
# step's inputs to the host's read of its metrics, with the integer
# attributes `steps` and `graph` (utils/cuda_graphs: EAGER on the CPU,
# REPLAY, or CAPTURE for a capture followed by its replays); `train.inputs`
# inside it around each step's make_batch, make_draws and copies into the
# graph's slots.  On the chunk that captures, the first step's copies
# follow the capture, outside its `train.inputs`.  The spans launch
# nothing.

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

from ctrlhair_tpu_torch.utils import cuda_graphs
from ctrlhair_tpu_torch.utils.cuda_graphs import CAPTURE, EAGER, REPLAY
from ctrlhair_tpu_torch.utils.profiling import span

WARMUP_STEPS = 2


def _flatten(tree) -> Tuple[list, tuple]:
    """(tensor leaves, signature) of a tree of dicts, lists and tuples: the
    signature holds its structure, each tensor's shape, dtype and device
    and every other leaf as it is."""
    leaves, spec = tree_flatten(tree)
    tensors = [v for v in leaves if isinstance(v, torch.Tensor)]
    return tensors, (spec, tuple(
        (tuple(v.shape), v.dtype, v.device) if isinstance(v, torch.Tensor)
        else v for v in leaves))


def _with_tensors(tree, tensors: list):
    """`tree` with its tensor leaves replaced, in order, by `tensors`."""
    leaves, spec = tree_flatten(tree)
    it = iter(tensors)
    return tree_unflatten([next(it) if isinstance(v, torch.Tensor) else v
                           for v in leaves], spec)


def _mesh_of(step_fn):
    """The mesh of the trainer whose step `step_fn` is, looked for through
    functools.partial and functools.wraps to the bound method's trainer."""
    fn = step_fn
    while fn is not None:
        mesh = getattr(getattr(fn, '__self__', None), 'mesh', None)
        if mesh is not None:
            return mesh
        fn = getattr(fn, 'func', None) or getattr(fn, '__wrapped__', None)
    return None


def _over_gloo(mesh) -> bool:
    """Whether a mesh's dp or tp group runs over gloo."""
    if mesh is None:
        return False
    groups = [mesh.group] + ([mesh.tp_group] if mesh.tp > 1 else [])
    return any(torch.distributed.get_backend(g) == 'gloo' for g in groups)


def _module_tensors(tree) -> list:
    """The parameters and buffers of every module among a tree's leaves
    (the frozen predictors the colour/texture step takes as arguments)."""
    return [t for v in tree_flatten(tree)[0] if isinstance(v, torch.nn.Module)
            for t in (*v.parameters(), *v.buffers())]


def _fresh_leaves(tensors) -> None:
    """Give each trainable leaf among `tensors` a new autograd identity
    over the same storage (torch.utils.swap_tensors: the object, its
    attributes, its pointer and its values stay).  A leaf's gradient
    accumulator is made on the stream current when the leaf first enters
    an autograd graph, and lives as long as any graph that reaches the
    leaf: a copy of a parameter taken with gradients on (p.clone()) keeps
    one made on the legacy default stream.  A capture whose backward went
    through such accumulators over an NCCL group was invalidated in every
    run (the face parser's state copied after eager steps:
    tests/test_torch_cuda.py).  With a new identity the warm-up makes the
    accumulators anew on its own stream; an old one raises if a backward
    ever reaches it."""
    for t in tensors:
        if t.requires_grad and t.is_leaf:
            fresh = (torch.nn.Parameter(t.detach(), requires_grad=True)
                     if isinstance(t, torch.nn.Parameter)
                     else t.detach().requires_grad_())
            fresh.__dict__.update(t.__dict__)
            torch.utils.swap_tensors(t, fresh)


def _metric_row(metrics: Dict[str, torch.Tensor], keys) -> torch.Tensor:
    """The step's metrics as one float64 vector in `keys` order (float64
    holds a float32 or float64 metric and a bool flag exactly)."""
    bad = [k for k in keys if metrics[k].numel() != 1]
    if bad:
        raise ValueError(f'ChunkRunner records scalar metrics only: {bad}')
    return torch.stack([metrics[k].reshape(()).to(torch.float64)
                        for k in keys])


class _Graph:
    """One captured step: its input slots, its metric vector, and what it
    was captured for (the inputs' signatures and the pointers of the
    state's and the extra arguments' tensors)."""

    def __init__(self, graph, slots, row, keys, key):
        self.graph, self.slots = graph, slots
        self.row, self.keys, self.key = row, keys, key


class ChunkRunner:
    """K steps of a trainer per chunk, one host read of the metrics a
    chunk.

    step_fn(state, batch, draws, *extra) -> (state, metrics): a trainer's
        train_step (step_fn(state, batch, *extra) when make_draws is None,
        as for the landmark trainer, whose step draws nothing).  It must
        update the state in place and return scalar metrics.
    make_batch(seed) -> the batch of the step whose seed is batch_seed +
        step: tensors on the state's device, or nested dicts and lists of
        them.
    make_draws(seed) -> the draws of the step whose seed is step_seed +
        step (e.g. lambda s: trainer.draws(s, n)); None for a step that
        takes none (the landmark step, the face parser's, and SEAN's
        without ACE noise).
    run(extra_args=...) -> the step's trailing arguments, as JAX's soak
        passes the colour/texture step its frozen predictors.

    On the card the graph reads every tensor the step reads at the address
    it had when the graph was captured.  The runner tracks the state's
    tensors and the extra arguments' (captured anew when they change);
    what the step reads from elsewhere, such as the frozen SEAN on the
    colour/texture trainer that renders lambda_rec_img, it does not track:
    that must stay the same tensors, and frozen, for the runner's life
    (values written into them in place are read by the next replay).
    """

    def __init__(self, step_fn: Callable, make_batch: Callable, *,
                 make_draws: Optional[Callable] = None, batch_seed: int = 0,
                 step_seed: int = 0):
        self.step_fn, self.make_batch = step_fn, make_batch
        self.make_draws = make_draws
        self.batch_seed, self.step_seed = batch_seed, step_seed
        self._graph: Optional[_Graph] = None
        self._step_t: Optional[torch.Tensor] = None
        self.capture_ms: List[float] = []   # host ms of each capture

    @property
    def captures(self) -> int:
        """The number of graphs this runner has captured."""
        return len(self.capture_ms)

    # ------------------------------------------------------------ one step
    def _inputs(self, step: int):
        batch = self.make_batch(self.batch_seed + step)
        if self.make_draws is None:
            return (batch,)
        return (batch, self.make_draws(self.step_seed + step))

    def _call(self, state, inputs, extra):
        return self.step_fn(state, *inputs, *extra)

    # ---------------------------------------------------------------- CPU
    def _eager_chunk(self, state, step: int, n: int, extra, keys):
        rows = []
        for i in range(n):
            with span('train.inputs'):
                inputs = self._inputs(step + i)
            state, metrics = self._call(state, inputs, extra)
            keys = keys or list(metrics)
            rows.append(_metric_row(metrics, keys))
        return state, keys, torch.stack(rows)

    # --------------------------------------------------------------- card
    def _capture(self, state, tensors, inputs, extra, key) -> _Graph:
        """Warm the step up eagerly on a side stream (the state restored in
        place after it), then capture it over copies of the inputs, which
        become the graph's input slots (utils/cuda_graphs.capture)."""
        device = tensors[0].device
        if self._step_t is None or self._step_t.device != device:
            self._step_t = torch.zeros((), dtype=torch.int64, device=device)
        slots = [t.detach().clone() for t in _flatten(inputs)[0]]
        inputs = _with_tensors(inputs, slots)
        host_step = state.step
        _fresh_leaves(tensors)
        with torch.no_grad():
            saved = [t.clone() for t in tensors]
        keys = []

        def warmup():
            nonlocal state
            try:
                for _ in range(WARMUP_STEPS):
                    self._step_t.fill_(host_step)
                    state.step = self._step_t
                    state, metrics = self._call(state, inputs, extra)
                keys.extend(metrics)
            finally:
                state.step = host_step
                with torch.no_grad():
                    for t, s in zip(tensors, saved):
                        t.copy_(s)
                saved.clear()

        def body():
            nonlocal state
            state.step = self._step_t
            try:
                state, metrics = self._call(state, inputs, extra)
                row = _metric_row(metrics, keys)
                rebound = state.step is not self._step_t
            finally:
                state.step = host_step
            if rebound:
                raise RuntimeError('the step rebound state.step; it must '
                                   'advance it in place (state.step += 1)')
            return row

        t0 = time.perf_counter()
        graph, row = cuda_graphs.capture(device, warmup, body)
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        return _Graph(graph, slots, row, keys, key)

    def _graph_chunk(self, state, step: int, n: int, extra):
        """n steps through the runner's one graph, captured anew when the
        inputs' signatures or the pointers of the state's or the extra
        arguments' tensors are not those it was captured for; -> (state,
        keys, metric rows, REPLAY or CAPTURE)."""
        tensors = list(state.tensors())
        extra_t, extra_sig = _flatten(tuple(extra))
        extra_t += _module_tensors(tuple(extra))
        ptrs = [t.data_ptr() for t in tensors + extra_t]
        with span('train.inputs'):
            inputs = self._inputs(step)
            leaves, sig = _flatten(inputs)
            key = (sig, extra_sig, ptrs)
            g = self._graph
            if g is not None and g.key == key:
                self._step_t.fill_(step)
                self._fill(g, leaves)
        mode = REPLAY
        if g is None or g.key != key:
            device = tensors[0].device
            if any(t.device != device for t in leaves):
                raise ValueError('the batch and draws must lie on the '
                                 f'state\'s device, {device}')
            self._graph = None          # the old graph's memory freed first
            g = self._graph = self._capture(state, tensors, inputs, extra,
                                            key)
            mode = CAPTURE
            self._step_t.fill_(step)
            self._fill(g, leaves)
        buf = torch.empty((n, len(g.keys)), dtype=torch.float64,
                          device=g.row.device)
        for i in range(n):
            if i:
                with span('train.inputs'):
                    leaves, got = _flatten(self._inputs(step + i))
                    if got != sig:
                        raise ValueError(f'the batch or draws of step '
                                         f'{step + i} differ in structure or '
                                         'shape from the captured step\'s')
                    self._fill(g, leaves)
            g.graph.replay()
            buf[i].copy_(g.row)
        state.step = step + n
        return state, g.keys, buf, mode

    @staticmethod
    def _fill(g: _Graph, leaves) -> None:
        """Copy one step's batch and draws into the graph's input slots."""
        for slot, t in zip(g.slots, leaves):
            slot.copy_(t, non_blocking=True)

    @staticmethod
    def _on_card(state) -> bool:
        """Whether the steps run as the graph's replays (the state on a
        card) or eagerly."""
        return state.tensors()[0].device.type == 'cuda'

    # ----------------------------------------------------------------- run
    def run(self, state, start: int, stop: int, *, chunk_size: int = 256,
            record_every: int = 250, extra_args: Tuple = (),
            on_chunk: Optional[Callable[[int, Any, List[Dict]], Any]] = None
            ) -> Tuple[Any, List[Dict[str, float]], int]:
        """Run steps [start, stop); returns (state, rows, finite_trips).

        Rows at the per-step loops' cadence (every `record_every` steps and
        the final step), finite-gate trips counted over every step.
        `on_chunk(step, state, rows)` fires after each chunk, `step` the
        next step to run; a truthy return stops the loop, and the returned
        state resumes exactly.  The state's step must be `start`."""
        if int(state.step) != start:
            raise ValueError(f'the state is at step {state.step}, the run '
                             f'starts at {start}')
        on_card = self._on_card(state)
        if on_card and _over_gloo(_mesh_of(self.step_fn)):
            raise ValueError('ChunkRunner does not capture a step over a '
                             'gloo mesh: gloo\'s collectives run on the '
                             'host; use NCCL on the card')
        rows: List[Dict[str, float]] = []
        finite_trips = 0
        keys = None
        step = start
        while step < stop:
            n = min(chunk_size, stop - step)
            with span('train.chunk', steps=n, graph=EAGER) as chunk:
                if on_card:
                    state, keys, ms, mode = self._graph_chunk(
                        state, step, n, extra_args)
                    if chunk is not None:
                        chunk.attrs['graph'] = mode
                else:
                    state, keys, ms = self._eager_chunk(state, step, n,
                                                        extra_args, keys)
                ms = ms.cpu()           # one host sync per chunk
            if 'finite' in keys:
                finite_trips += int(n - ms[:, keys.index('finite')].sum())
            values = ms.tolist()
            for i in range(n):
                s = step + i
                if s % record_every == 0 or s == stop - 1:
                    rows.append({'step': s, **dict(zip(keys, values[i]))})
            step += n
            if on_chunk is not None and on_chunk(step, state, rows):
                break
        return state, rows, finite_trips
