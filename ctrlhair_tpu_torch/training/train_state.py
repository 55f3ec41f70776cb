# Training state: Adam and SGD with a finite guard, and the state
# containers.
#
# Port of ctrlhair_tpu/training/train_state.py.  The JAX package applies
# optax updates that are skipped whole when any gradient of the step is
# non-finite.  torch.optim cannot be gated that way: its optimisers advance
# their own state inside step(), on the host.  So each update is written
# out by hand, as optax computes it, and every new value passes through
# torch.where(finite, new, old).  The flag stays on the device, so the
# guard costs no host read.
#   Adam  optax.adam: mu = (1-b1) g + b1 mu, nu likewise on g^2, bias
#         corrections 1 - b^count in float32, mu_hat / (sqrt(nu_hat) +
#         1e-8), times -lr; parameters, both moments and the count gated.
#   SGD   optax.chain(add_decayed_weights(wd), sgd(lr, momentum)), the
#         face parser's optimiser: g' = g + wd p, trace = g' + m trace
#         (trace starts at 0, so the first step's trace is g'),
#         p -= lr trace; parameters and the trace gated.
#
# The containers hold torch modules and their optimiser state.  to_tree()
# writes flax's state-dict layout of the JAX containers
# (flax.serialization.to_state_dict of ModelOpt / GANTrainState /
# PredictorTrainState / BiSeNetTrainState / LandmarkTrainState) and
# load_tree() reads it, so a checkpoint crosses between the packages both
# ways:
#   ModelOpt            {'params': variables, 'opt_state': {'0': {'count',
#                        'mu', 'nu'}, '1': {} or, for a {step: lr}
#                        schedule, {'count'}}}
#   SGDModelOpt         {'params': variables, 'opt_state': {'0': {},
#                        '1': {'0': {'trace'}, '1': {}}}} (the outer
#                        chain's empty decay state, then optax.sgd's own
#                        chain of the trace and the empty lr scale)
#   GANTrainState       {'step', 'gen', 'dis', 'dis_noise'}
#   PredictorTrainState {'step', 'model', 'stats'} (also the face parser's)
#   LandmarkTrainState  {'step', 'model'}
# `step` and the counts are int32 0-d arrays there; here `step` is a Python
# int (every step advances it, finite or not, so the host always knows it)
# and the count a 0-d int32 tensor on the module's device.  tensors() lists
# every tensor of a state in a fixed order, for the data-parallel broadcast
# from rank 0 (parallel/mesh.replicated).  Under tensor parallelism
# (layers.set_tp) a sharded weight and its moments hold this tp rank's
# slice: to_tree gathers them into flax's whole leaves (a collective over
# the tp ranks, which every one of them must call) and load_tree takes
# this rank's slice of the whole leaves it reads, so a checkpoint is the
# same whatever the tp size that wrote or reads it.

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch
import torch.nn as nn

from ctrlhair_tpu_torch.convert import from_flax, to_flax
from ctrlhair_tpu_torch.models.layers import tp_shards
from ctrlhair_tpu_torch.parallel.mesh import (
    all_reduce_grads, tp_full, tp_local)

EPS = 1e-8


class Adam:
    """optax.adam(lr, b1=beta1, b2=beta2) with eps 1e-8.  `lr` is a float
    or a {step: lr} dict: piecewise constant in the number of updates
    already applied (optax's schedule count, searchsorted side='right')."""

    def __init__(self, lr, beta1: float = 0.5, beta2: float = 0.999):
        self.beta1, self.beta2 = beta1, beta2
        self.schedule = isinstance(lr, Mapping)
        if self.schedule:
            items = sorted(lr.items())
            self.bounds = [s for s, _ in items[1:]]
            self.values = [float(v) for _, v in items]
            self._tables = {}
        else:
            self.lr = float(lr)

    def lr_at(self, count: torch.Tensor):
        """The learning rate after `count` applied updates: the float, or
        for a schedule a float32 tensor on count's device (its tables are
        copied there once, so no step waits on a host copy)."""
        if not self.schedule:
            return self.lr
        key = str(count.device)
        if key not in self._tables:
            self._tables[key] = (
                torch.tensor(self.values, dtype=torch.float32,
                             device=count.device),
                torch.tensor(self.bounds, dtype=torch.int32,
                             device=count.device))
        values, bounds = self._tables[key]
        return values[torch.searchsorted(bounds, count.reshape(1),
                                         right=True)[0]]


class ModelOpt:
    """A module, its Adam and Adam's state (count, mu and nu by parameter
    name)."""

    def __init__(self, module: nn.Module, tx: Adam, family: str):
        self.module = module
        self.tx = tx
        self.family = family        # the editor family, for to_flax
        device = next(module.parameters()).device
        self.count = torch.zeros((), dtype=torch.int32, device=device)
        self.mu = {k: torch.zeros_like(p)
                   for k, p in module.named_parameters()}
        self.nu = {k: torch.zeros_like(p)
                   for k, p in module.named_parameters()}

    def params(self) -> List[torch.nn.Parameter]:
        return [p for _, p in self.module.named_parameters()]

    def tensors(self) -> List[torch.Tensor]:
        """Parameters, buffers (running statistics), Adam's moments and
        count."""
        return [*self.module.parameters(), *self.module.buffers(),
                *self.mu.values(), *self.nu.values(), self.count]

    # ------------------------------------------------------- flax layout
    def _params_tree(self, values) -> Dict[str, Any]:
        """flax's 'params' tree of tensors laid out like the parameters,
        the tp-sharded ones gathered whole."""
        shards = tp_shards(self.module)
        whole = {k: tp_full(v, *shards[k]) if k in shards else v
                 for k, v in values.items()}
        return {'params': to_flax(self.module, self.family, whole)['params']}

    def to_tree(self) -> Dict[str, Any]:
        count = np.asarray(self.count.cpu().numpy(), np.int32)
        params = dict(self.module.named_parameters())
        return {'params': self._params_tree(params),
                'opt_state': {
                    '0': {'count': count,
                          'mu': self._params_tree(self.mu),
                          'nu': self._params_tree(self.nu)},
                    '1': {'count': count.copy()} if self.tx.schedule
                    else {}}}

    def _named(self, tree) -> Dict[str, torch.Tensor]:
        """{torch name: tensor} of a flax tree, this tp rank's slice of
        each sharded parameter."""
        prefix = self.family + '.'
        shards = tp_shards(self.module)
        out = {k[len(prefix):]: v for k, v in
               from_flax({self.family: tree}).items()}
        return {k: tp_local(v, *shards[k]).clone() if k in shards else v
                for k, v in out.items()}

    def load_tree(self, tree: Mapping[str, Any]) -> None:
        """Restore from a ModelOpt state-dict tree (JAX's or to_tree's);
        parameters strictly, moments and count as they are."""
        device = self.count.device
        params = self._named(tree['params'])
        self.module.load_state_dict(
            {**params, **{k: v for k, v in self.module.state_dict().items()
                          if k not in params}}, strict=True)
        adam = tree['opt_state']['0']
        with torch.no_grad():
            for store, key in ((self.mu, 'mu'), (self.nu, 'nu')):
                values = self._named(adam[key])
                if set(values) != set(store):
                    raise ValueError(f'{self.family}: Adam {key} does not '
                                     'match the module\'s parameters')
                for k, v in values.items():
                    store[k].copy_(v.to(device))
        self.count = torch.tensor(int(np.asarray(adam['count'])),
                                  dtype=torch.int32, device=device)


class SGD:
    """optax.chain(add_decayed_weights(weight_decay), sgd(lr,
    momentum=momentum))."""

    def __init__(self, lr: float, momentum: float = 0.9,
                 weight_decay: float = 5e-4):
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)


class SGDModelOpt(ModelOpt):
    """A module, its SGD and SGD's momentum trace by parameter name."""

    def __init__(self, module: nn.Module, tx: SGD, family: str):
        self.module = module
        self.tx = tx
        self.family = family
        self.trace = {k: torch.zeros_like(p)
                      for k, p in module.named_parameters()}

    def tensors(self) -> List[torch.Tensor]:
        """Parameters, buffers (running statistics) and the trace."""
        return [*self.module.parameters(), *self.module.buffers(),
                *self.trace.values()]

    def to_tree(self) -> Dict[str, Any]:
        params = dict(self.module.named_parameters())
        return {'params': self._params_tree(params),
                'opt_state': {'0': {},
                              '1': {'0': {'trace': self._params_tree(
                                  self.trace)}, '1': {}}}}

    def load_tree(self, tree: Mapping[str, Any]) -> None:
        """Restore from an SGD ModelOpt state-dict tree; parameters
        strictly, the trace as it is."""
        params = self._named(tree['params'])
        self.module.load_state_dict(
            {**params, **{k: v for k, v in self.module.state_dict().items()
                          if k not in params}}, strict=True)
        values = self._named(tree['opt_state']['1']['0']['trace'])
        if set(values) != set(self.trace):
            raise ValueError(f'{self.family}: the SGD trace does not match '
                             'the module\'s parameters')
        with torch.no_grad():
            for k, v in values.items():
                self.trace[k].copy_(v.to(self.trace[k].device))


@torch.no_grad()
def _sgd_update(model: SGDModelOpt, grads: Sequence[torch.Tensor],
                finite: torch.Tensor) -> None:
    tx = model.tx
    for (name, p), g in zip(model.module.named_parameters(), grads):
        trace = (g + tx.weight_decay * p) + tx.momentum * model.trace[name]
        p.copy_(torch.where(finite, p + (-tx.lr) * trace, p))
        model.trace[name].copy_(torch.where(finite, trace, model.trace[name]))


def param_grads(loss: torch.Tensor, params, retain: bool = False
                ) -> List[torch.Tensor]:
    """d loss / d params, a zero tensor for a parameter the loss does not
    reach (as jax.grad gives one)."""
    grads = torch.autograd.grad(loss, params, retain_graph=retain,
                                allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def reduce_grads(mesh, *grad_lists: Sequence[torch.Tensor]
                 ) -> List[List[torch.Tensor]]:
    """Each gradient list averaged over the data-parallel ranks, all of
    them in one set of buckets (parallel/mesh.all_reduce_grads); the lists
    as they are for mesh None.  Called before the finite gate, so a NaN on
    one rank gates every rank's update."""
    flat = all_reduce_grads([g for grads in grad_lists for g in grads],
                            mesh)
    out, i = [], 0
    for grads in grad_lists:
        out.append(flat[i:i + len(grads)])
        i += len(grads)
    return out


def grads_finite(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """One bool tensor: every gradient entry of this rank is finite (under
    tensor parallelism, reduce it over the tp ranks: mesh.tp_all)."""
    return torch.stack([torch.isfinite(g).all() for g in grads]).all()


@torch.no_grad()
def safe_apply_updates(model: ModelOpt, grads: Sequence[torch.Tensor],
                       finite: torch.Tensor) -> None:
    """One update of `model` in place when `finite`, else nothing changes:
    Adam (parameters, mu, nu and count) or, for an SGDModelOpt, SGD with
    momentum (parameters and trace)."""
    if isinstance(model, SGDModelOpt):
        _sgd_update(model, grads, finite)
        return
    tx = model.tx
    count_inc = model.count + 1
    c = count_inc.float()
    bc1 = 1 - torch.pow(tx.beta1, c)
    bc2 = 1 - torch.pow(tx.beta2, c)
    step_size = -tx.lr_at(model.count)
    for (name, p), g in zip(model.module.named_parameters(), grads):
        mu = (1 - tx.beta1) * g + tx.beta1 * model.mu[name]
        nu = (1 - tx.beta2) * (g * g) + tx.beta2 * model.nu[name]
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
        p.copy_(torch.where(finite, p + step_size * update, p))
        model.mu[name].copy_(torch.where(finite, mu, model.mu[name]))
        model.nu[name].copy_(torch.where(finite, nu, model.nu[name]))
    model.count = torch.where(finite, count_inc, model.count)


def adam(lr, beta1: float = 0.5, beta2: float = 0.999) -> Adam:
    """Adam with the GAN-standard betas."""
    return Adam(lr, beta1, beta2)


def batch_stats(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's BatchNorm running statistics, by buffer name."""
    return {k: b for k, b in module.named_buffers()
            if k.endswith(('running_mean', 'running_var'))}


class GANTrainState:
    """step, the generator, the discriminator and the latent-prior
    discriminator."""

    def __init__(self, step: int, gen: ModelOpt, dis: ModelOpt,
                 dis_noise: ModelOpt):
        self.step = step
        self.gen, self.dis, self.dis_noise = gen, dis, dis_noise

    def parts(self) -> Dict[str, ModelOpt]:
        return {'gen': self.gen, 'dis': self.dis, 'dis_noise': self.dis_noise}

    def tensors(self) -> List[torch.Tensor]:
        return [t for m in self.parts().values() for t in m.tensors()]

    def to_tree(self) -> Dict[str, Any]:
        return {'step': np.asarray(self.step, np.int32),
                **{k: m.to_tree() for k, m in self.parts().items()}}

    def load_tree(self, tree: Mapping[str, Any]) -> None:
        for k, m in self.parts().items():
            m.load_tree(tree[k])
        self.step = int(np.asarray(tree['step']))


class PredictorTrainState:
    """step, the model (parameters and Adam) and its running statistics,
    which live in the module's buffers."""

    def __init__(self, step: int, model: ModelOpt):
        self.step = step
        self.model = model

    def tensors(self) -> List[torch.Tensor]:
        return self.model.tensors()

    def to_tree(self) -> Dict[str, Any]:
        stats = batch_stats(self.model.module)
        return {'step': np.asarray(self.step, np.int32),
                'model': self.model.to_tree(),
                'stats': to_flax(self.model.module, self.model.family,
                                 stats).get('batch_stats', {})}

    def load_tree(self, tree: Mapping[str, Any]) -> None:
        self.model.load_tree(tree['model'])
        if tree['stats']:
            stats = self.model._named({'params': {},
                                       'batch_stats': tree['stats']})
            with torch.no_grad():
                for k, b in batch_stats(self.model.module).items():
                    b.copy_(stats[k])
        self.step = int(np.asarray(tree['step']))


class LandmarkTrainState:
    """step and the model (parameters and Adam); the landmark net keeps no
    running statistics."""

    def __init__(self, step: int, model: ModelOpt):
        self.step = step
        self.model = model

    def to_tree(self) -> Dict[str, Any]:
        return {'step': np.asarray(self.step, np.int32),
                'model': self.model.to_tree()}

    def load_tree(self, tree: Mapping[str, Any]) -> None:
        self.model.load_tree(tree['model'])
        self.step = int(np.asarray(tree['step']))


def restore_where(finite: torch.Tensor,
                  saved: Mapping[str, torch.Tensor],
                  live: Mapping[str, torch.Tensor]) -> None:
    """live[k] <- live[k] if finite else saved[k], in place (the running
    statistics a non-finite step must not move)."""
    with torch.no_grad():
        for k, t in live.items():
            t.copy_(torch.where(finite, t, saved[k]))
