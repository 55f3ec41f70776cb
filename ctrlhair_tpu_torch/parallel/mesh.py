# Data and tensor parallelism for the port's trainers: the process group,
# this rank's rows of the global batch, its slices of the sharded weights,
# and the collectives the trainers need.
#
# Port of ctrlhair_tpu/parallel/mesh.py.  The JAX package shards the global
# batch of a jitted step over the 'dp' axis of a ('dp', 'tp') mesh, and the
# wide kernels' last (output-feature) axis over 'tp', and lets GSPMD compute
# the global-batch step, collectives included, so a sharded step equals the
# single-device step on the whole batch.  The port keeps that meaning with
# one process a rank (torch.distributed); rank r sits at dp index r // tp
# and tp index r % tp, as make_mesh's reshape(n // tp, tp) places devices.
#
# Data parallelism, over the dp axis (Mesh.group / rank / world):
#   * every rank builds the same global batch and takes its contiguous rows
#     (shard_batch), and the step's draws are made for the global batch and
#     sliced (local_rows); the tp ranks of one dp index hold the same rows;
#   * a loss term that is a mean of per-sample terms stays local (the mean
#     of equal shards' means is the global mean); a term that is not (a
#     function of a batch mean, a ratio of batch sums) is computed from
#     global sums (global_sum, batch_mean), whose backward sums the
#     cotangents over the ranks, so rank r holds W f'(S) dS_r/dtheta and the
#     mean over ranks is f'(S) dS/dtheta;
#   * the gradients are averaged over the ranks in flat buckets
#     (all_reduce_grads) before the finite gate, so a NaN on one rank skips
#     the update on every rank;
#   * batch-norm statistics are global (layers.set_sync): flax's
#     BatchNorm(axis_name='dp').
# Tensor parallelism, over the tp axis (Mesh.tp / tp_rank / tp_group):
#   * _tp_spec_for is JAX's placement rule, read on the flax path and shape
#     of each parameter (param_shardings); shard_params keeps this rank's
#     slice of each sharded weight's output features and switches its
#     layer to the column-parallel mode of layers.set_tp:
#     y = tp_gather(op(tp_copy(x), W_local)) + bias, so every activation
#     outside the layer is whole on every tp rank and the step computes
#     what the single process does, as JAX's placement does;
#   * tp_copy / tp_reduce and tp_gather / tp_slice are two pairs of
#     autograd.Functions, each the other's backward, so the gradient
#     penalties' double backward runs through them;
#   * the finite flag is reduced over the tp ranks (tp_all), whose sharded
#     gradients differ; the replicated ones are equal there.
# The trainers take their gradients with torch.autograd.grad, never
# .backward(), so DistributedDataParallel's reducer hooks would not fire;
# the collectives here are explicit.  Every helper is the identity for
# mesh None, the single-process path, which stays bit-equal to a trainer
# built without a mesh.  A one-rank group runs every collective too, and
# its step equals the plain one bit for bit (a one-rank sum is a copy and
# x / 1 is x).  With tp = 1 the dp axis is the default group, and no
# group is created.

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# flat buffers of at most this many bytes a collective (one tensor larger
# than this goes alone)
BUCKET_BYTES = 64 << 20


@dataclasses.dataclass
class Mesh:
    """One rank's view of the ('dp', 'tp') mesh: the dp axis's group (None
    for the default one), this rank's dp index and the dp size, this rank's
    device, the number of collectives issued through the mesh (forward and
    backward, both axes), and the tp size, this rank's tp index and the tp
    axis's group."""
    group: Any
    rank: int
    world: int
    device: torch.device
    collectives: int = 0
    tp: int = 1
    tp_rank: int = 0
    tp_group: Any = None


def initialize_runtime(device=None, init_method: str = 'env://',
                       world_size: Optional[int] = None,
                       rank: Optional[int] = None,
                       backend: Optional[str] = None,
                       timeout: float = 600.0) -> torch.device:
    """torch.distributed.init_process_group for this process; returns its
    device.  `device` 'cpu' trains on the CPU over gloo; anything else
    ('cuda', None) on cuda:<LOCAL_RANK> over NCCL.  init_method 'env://'
    reads RANK, WORLD_SIZE and the rendezvous from the environment that
    `python -m torch.distributed.run` sets (one host or many); a
    'file://<path>' store takes world_size and rank.  `backend` names
    another backend for the device (gloo over CUDA tensors).  A collective
    that waits longer than `timeout` seconds fails the run."""
    if dist.is_initialized():
        raise RuntimeError('initialize_runtime: a process group is already '
                           'set up in this process')
    dev = torch.device(device if device is not None else 'cuda')
    cpu = dev.type == 'cpu'
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError('initialize_runtime: no CUDA device; pass '
                               "device='cpu' to train on the CPU")
        if dev.index is None:
            dev = torch.device('cuda', int(os.environ.get(
                'LOCAL_RANK', 0 if rank is None else rank)))
        torch.cuda.set_device(dev)
    backend = backend or ('gloo' if cpu else 'nccl')
    kwargs = {}
    if backend == 'nccl':
        if not dist.is_nccl_available():
            raise RuntimeError('initialize_runtime: this torch has no NCCL')
        kwargs['device_id'] = dev
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None
                            else world_size,
                            rank=-1 if rank is None else rank,
                            timeout=datetime.timedelta(seconds=timeout),
                            **kwargs)
    return dev


def make_mesh(n_devices: Optional[int] = None, tp: int = 1,
              device=None) -> Mesh:
    """The ('dp', 'tp') mesh over the process group that initialize_runtime
    set up, whose world size must be n_devices (None: any): rank r at dp
    index r // tp and tp index r % tp.  `device`: this rank's device
    (default: the current CUDA device under NCCL, else the CPU)."""
    if tp < 1 or (n_devices is not None and n_devices % tp != 0):
        raise ValueError(f'{n_devices} devices not divisible by tp={tp}')
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs a process group: call '
                           'initialize_runtime first')
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f'make_mesh({n_devices}): the process group has '
                         f'{world} ranks')
    if world % tp != 0:
        raise ValueError(f'{world} devices not divisible by tp={tp}')
    if device is None:
        device = (torch.device('cuda', torch.cuda.current_device())
                  if dist.get_backend() == 'nccl' else torch.device('cpu'))
    rank = dist.get_rank()
    if tp == 1:
        return Mesh(group=None, rank=rank, world=world,
                    device=torch.device(device))
    # every rank creates every group, in one order
    dp_groups = [dist.new_group(list(range(t, world, tp)))
                 for t in range(tp)]
    tp_groups = [dist.new_group(list(range(d * tp, (d + 1) * tp)))
                 for d in range(world // tp)]
    return Mesh(group=dp_groups[rank % tp], rank=rank // tp,
                world=world // tp, device=torch.device(device), tp=tp,
                tp_rank=rank % tp, tp_group=tp_groups[rank // tp])


def world_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.world


def tp_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.tp


def is_main(mesh: Optional[Mesh]) -> bool:
    """Rank 0, or the single process: the one that writes files."""
    return mesh is None or (mesh.rank == 0 and mesh.tp_rank == 0)


def batch_sharding(mesh: Optional[Mesh], n: int) -> slice:
    """The rows of a global batch of n that this rank holds: the dp
    index's contiguous share (the tp ranks of one dp index hold the same
    rows), as JAX's batch_sharding places the leading axis over 'dp'.  A
    batch that does not split evenly is refused, as JAX's sharding refuses
    it."""
    if mesh is None:
        return slice(0, n)
    if n % mesh.world:
        raise ValueError(f'a batch of {n} does not split over '
                         f'{mesh.world} ranks')
    k = n // mesh.world
    return slice(mesh.rank * k, (mesh.rank + 1) * k)


def local_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's contiguous rows of a global-batch tensor (a draw made
    for the global batch)."""
    if mesh is None:
        return x
    return x[batch_sharding(mesh, x.shape[0])]


def shard_batch(batch: Dict[str, Any], mesh: Optional[Mesh]
                ) -> Dict[str, Any]:
    """This rank's rows of every tensor of a global batch (leading dim the
    batch); 0-d entries and non-tensors as they are.  A batch that does not
    split evenly is refused, as JAX's sharding refuses it."""
    if mesh is None:
        return batch
    return {k: local_rows(v, mesh)
            if isinstance(v, torch.Tensor) and v.dim() else v
            for k, v in batch.items()}


def _buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Consecutive index runs of one dtype and device, at most BUCKET_BYTES
    each."""
    out, cur, size, key = [], [], 0, None
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if cur and ((t.dtype, t.device) != key
                    or size + nbytes > BUCKET_BYTES):
            out.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += nbytes
        key = (t.dtype, t.device)
    if cur:
        out.append(cur)
    return out


def _all_reduce(t: torch.Tensor, mesh: Mesh) -> None:
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    mesh.collectives += 1


def all_reduce_grads(grads: Sequence[torch.Tensor], mesh: Optional[Mesh]
                     ) -> List[torch.Tensor]:
    """The mean over the ranks of each gradient, reduced in flat buckets
    (views of them come back)."""
    out = list(grads)
    if mesh is None:
        return out
    for idx in _buckets(out):
        flat = torch.cat([out[i].reshape(-1) for i in idx])
        _all_reduce(flat, mesh)
        flat.div_(mesh.world)
        offset = 0
        for i in idx:
            n = out[i].numel()
            out[i] = flat[offset:offset + n].view_as(grads[i])
            offset += n
    return out


class _GlobalSum(torch.autograd.Function):
    """y = the sum of x over the ranks; its backward sums the cotangents
    over the ranks (written out, so it does not rest on how the installed
    torch.distributed.nn differentiates)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.contiguous().clone()
        _all_reduce(y, mesh)
        return y

    @staticmethod
    def backward(ctx, g):
        return _GlobalSum.apply(g, ctx.mesh), None


def global_sum(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of x over the ranks, differentiable.  Every rank must call
    it in the same order, and its input must need a gradient on every rank
    or on none (the backward is a collective too)."""
    if mesh is None:
        return x
    return _GlobalSum.apply(x, mesh)


def batch_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """torch.mean(x, dim=0) over the global batch: each rank's mean over
    its equal shard, averaged over the ranks."""
    mean = torch.mean(x, dim=0)
    if mesh is None:
        return mean
    return global_sum(mean / mesh.world, mesh)


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global batch of a per-rank tensor (rank order), without a
    gradient."""
    if mesh is None:
        return x
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x, group=mesh.group)
    mesh.collectives += 1
    return torch.cat(parts)


def all_gather_fields(fields: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                      ) -> Dict[str, torch.Tensor]:
    """all_gather_rows of several [n, ...] tensors in one collective:
    packed as float64 (exact for float32 and int32 values), unpacked to
    their own dtypes."""
    if mesh is None:
        return dict(fields)
    flat = {k: v.reshape(v.shape[0], -1) for k, v in fields.items()}
    packed = all_gather_rows(torch.cat([v.double() for v in flat.values()],
                                       dim=1), mesh)
    out, offset = {}, 0
    for k, v in flat.items():
        w = v.shape[1]
        out[k] = packed[:, offset:offset + w].to(v.dtype).reshape(
            (-1,) + tuple(fields[k].shape[1:]))
        offset += w
    return out


def global_metrics(metrics: Dict[str, Any], mesh: Optional[Mesh]
                   ) -> Dict[str, Any]:
    """The step's scalar float metrics averaged over the ranks (one
    collective): a per-sample mean becomes the global mean, a global term
    stays what every rank has."""
    if mesh is None:
        return metrics
    keys = [k for k, v in metrics.items()
            if isinstance(v, torch.Tensor) and v.numel() == 1
            and v.dtype.is_floating_point]
    if not keys:
        return metrics
    stacked = torch.stack([metrics[k].detach().double().reshape(())
                           for k in keys])
    _all_reduce(stacked, mesh)
    stacked /= mesh.world
    return {**metrics, **{k: stacked[i].to(metrics[k].dtype)
                          for i, k in enumerate(keys)}}


def replicated(state, mesh: Optional[Mesh]):
    """Every tensor of a train state (state.tensors()) broadcast over the
    dp axis from dp index 0, in flat buckets, as DistributedDataParallel
    does at its start (each tp rank its own slices)."""
    if mesh is None:
        return state
    tensors = state.tensors()
    with torch.no_grad():
        for idx in _buckets(tensors):
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            # from dp index 0 of this rank's tp index: global rank tp_rank
            dist.broadcast(flat, src=mesh.tp_rank, group=mesh.group)
            mesh.collectives += 1
            offset = 0
            for i in idx:
                n = tensors[i].numel()
                tensors[i].copy_(flat[offset:offset + n].view_as(
                    tensors[i]))
                offset += n
    return state


def barrier(mesh: Optional[Mesh]) -> None:
    """Every rank of the mesh, both axes."""
    if mesh is not None:
        kwargs = {'device_ids': [mesh.device.index]} \
            if dist.get_backend() == 'nccl' else {}
        dist.barrier(**kwargs)


# ------------------------------------------------------ tensor parallelism
def _tp_spec_for(path: str, shape: Sequence[int], tp: int
                 ) -> Optional[int]:
    """JAX's TP sharding rule, on a parameter's flax path (its keys joined
    as JAX joins them) and its shape in flax's layout: the last (output-
    feature) axis of a wide kernel is sharded over 'tp' when divisible,
    everything else replicated.  Returns the sharded flax axis, or None."""
    if len(shape) < 2:
        return None
    last = shape[-1]
    if last % tp != 0 or last < 2 * tp:
        return None
    if 'kernel' in path or 'fc_mu' in path:
        return len(shape) - 1
    return None


def _sharded(module, tp: int) -> List[Tuple[str, Tuple[str, ...],
                                             Optional[int]]]:
    """(torch name, flax path, torch dim or None) of every parameter of
    `module`: the dim of the torch tensor that holds the flax axis
    _tp_spec_for shards."""
    from ctrlhair_tpu_torch.convert import flax_param_layout
    out = []
    for name, (path, shape, last_dim) in flax_param_layout(module).items():
        joined = '/'.join(f"['{p}']" for p in path)
        axis = _tp_spec_for(joined, shape, tp) if tp > 1 else None
        out.append((name, path, None if axis is None else last_dim))
    return out


def param_shardings(module, mesh: Optional[Mesh]
                    ) -> Dict[Tuple[str, ...], Optional[int]]:
    """{flax path of each parameter ('params', ..., leaf): the dim of the
    torch tensor sharded over tp, or None (replicated)}, as JAX's
    param_shardings places the module's flax tree on `mesh`."""
    return {path: dim for _, path, dim in _sharded(module, tp_size(mesh))}


def sharded_params(module, mesh: Optional[Mesh]) -> Dict[str, int]:
    """{torch parameter name: dim} of the parameters param_shardings
    shards."""
    if tp_size(mesh) == 1:
        return {}
    return {name: dim for name, _, dim in _sharded(module, tp_size(mesh))
            if dim is not None}


def shard_params(module, mesh: Optional[Mesh]):
    """Keep this rank's slice of each weight param_shardings shards and
    switch its layer to the column-parallel mode (layers.set_tp); the
    module, in place.  The identity for tp = 1."""
    from ctrlhair_tpu_torch.models.layers import set_tp
    set_tp(module, mesh)
    return module


def tp_local(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """This rank's slice of x along `dim` (a view)."""
    k = x.shape[dim] // mesh.tp
    return x.narrow(dim, mesh.tp_rank * k, k)


def tp_full(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The tp ranks' slices of x concatenated along `dim`, in tp order,
    without a gradient (a checkpoint's whole leaf)."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.tp)]
    dist.all_gather(parts, x, group=mesh.tp_group)
    mesh.collectives += 1
    return torch.cat(parts, dim)


class _TPCopy(torch.autograd.Function):
    """Identity on an input every tp rank holds whole; the backward sums
    the ranks' partial cotangents (_TPReduce)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _TPReduce.apply(g, ctx.mesh), None


class _TPReduce(torch.autograd.Function):
    """The sum over the tp ranks of partial values; its backward hands the
    whole cotangent to every partial (_TPCopy)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.tp_group)
        mesh.collectives += 1
        return y

    @staticmethod
    def backward(ctx, g):
        return _TPCopy.apply(g, ctx.mesh), None


class _TPGather(torch.autograd.Function):
    """The tp ranks' slices concatenated along `dim`; the backward keeps
    this rank's slice of the cotangent (_TPSlice)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return tp_full(x, mesh, dim)

    @staticmethod
    def backward(ctx, g):
        return _TPSlice.apply(g, ctx.mesh, ctx.dim), None, None


class _TPSlice(torch.autograd.Function):
    """This rank's slice along `dim` of a tensor every tp rank holds whole;
    the backward gathers the slices' cotangents (_TPGather)."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return tp_local(x, mesh, dim).contiguous().clone()

    @staticmethod
    def backward(ctx, g):
        return _TPGather.apply(g, ctx.mesh, ctx.dim), None, None


def tp_copy(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """x, whose gradient is summed over the tp ranks (the input of a
    column-parallel layer: each rank's weight slice gives part of it)."""
    return _TPCopy.apply(x, mesh)


def tp_gather(x: torch.Tensor, mesh: Mesh, dim: int) -> torch.Tensor:
    """The whole tensor from each tp rank's slice along `dim`,
    differentiable (the output of a column-parallel layer)."""
    return _TPGather.apply(x, mesh, dim)


def tp_all(flag: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """A bool flag true on every tp rank (a MIN over the tp group): a
    sharded gradient's NaN gates every rank's update."""
    if tp_size(mesh) == 1:
        return flag
    t = flag.to(torch.int32).reshape(1)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=mesh.tp_group)
    mesh.collectives += 1
    return t[0].bool()
