# Data parallelism for the port's trainers: the process group, this rank's
# rows of the global batch, and the collectives the trainers need.
#
# Port of ctrlhair_tpu/parallel/mesh.py (data parallelism; its tensor-
# parallel half is not ported yet).  The JAX package shards the global
# batch of a jitted step over a ('dp', 'tp') mesh and lets GSPMD compute
# the global-batch step, collectives included, so a --dp N step equals the
# single-device step on the whole batch.  The port keeps that meaning with
# one process a rank (torch.distributed):
#   * every rank builds the same global batch and takes its contiguous rows
#     (shard_batch), and the step's draws are made for the global batch and
#     sliced (local_rows);
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
# The trainers take their gradients with torch.autograd.grad, never
# .backward(), so DistributedDataParallel's reducer hooks would not fire;
# the collectives here are explicit.  Every helper is the identity for
# mesh None, the single-process path, which stays bit-equal to a trainer
# built without a mesh.  A one-rank group runs every collective too, and
# its step equals the plain one bit for bit (a one-rank sum is a copy and
# x / 1 is x).

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

# flat buffers of at most this many bytes a collective (one tensor larger
# than this goes alone)
BUCKET_BYTES = 64 << 20


@dataclasses.dataclass
class Mesh:
    """One rank's view of the data-parallel group: the group (None for the
    default one), this rank, the world size, this rank's device, and the
    number of collectives issued through it (forward and backward)."""
    group: Any
    rank: int
    world: int
    device: torch.device
    collectives: int = 0


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
    """The data-parallel mesh over the process group that
    initialize_runtime set up, whose world size must be n_devices (None:
    any).  `device`: this rank's device (default: the current CUDA device
    under NCCL, else the CPU)."""
    if tp != 1:
        raise NotImplementedError(
            f'make_mesh(tp={tp}): tensor parallelism is not ported yet '
            '(ROADMAP.md, section 1, "Tensor parallelism"); use tp=1')
    if not dist.is_initialized():
        raise RuntimeError('make_mesh needs a process group: call '
                           'initialize_runtime first')
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f'make_mesh({n_devices}): the process group has '
                         f'{world} ranks')
    if device is None:
        device = (torch.device('cuda', torch.cuda.current_device())
                  if dist.get_backend() == 'nccl' else torch.device('cpu'))
    return Mesh(group=None, rank=dist.get_rank(), world=world,
                device=torch.device(device))


def world_size(mesh: Optional[Mesh]) -> int:
    return 1 if mesh is None else mesh.world


def is_main(mesh: Optional[Mesh]) -> bool:
    """Rank 0, or the single process: the one that writes files."""
    return mesh is None or mesh.rank == 0


def local_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's contiguous rows of a global-batch tensor (a draw made
    for the global batch)."""
    if mesh is None:
        return x
    n = x.shape[0]
    if n % mesh.world:
        raise ValueError(f'a batch of {n} does not split over '
                         f'{mesh.world} ranks')
    k = n // mesh.world
    return x[mesh.rank * k:(mesh.rank + 1) * k]


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
    """Every tensor of a train state (state.tensors()) broadcast from rank
    0, in flat buckets, as DistributedDataParallel does at its start."""
    if mesh is None:
        return state
    tensors = state.tensors()
    with torch.no_grad():
        for idx in _buckets(tensors):
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            dist.broadcast(flat, src=0, group=mesh.group)
            mesh.collectives += 1
            offset = 0
            for i in idx:
                n = tensors[i].numel()
                tensors[i].copy_(flat[offset:offset + n].view_as(
                    tensors[i]))
                offset += n
    return state


def barrier(mesh: Optional[Mesh]) -> None:
    if mesh is not None:
        kwargs = {'device_ids': [mesh.device.index]} \
            if dist.get_backend(mesh.group) == 'nccl' else {}
        dist.barrier(group=mesh.group, **kwargs)
