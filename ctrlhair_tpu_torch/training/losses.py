# Loss zoo and step-scheduled loss weights.
#
# Port of ctrlhair_tpu/training/losses.py: the GAN losses of both branch
# solvers, the two gradient penalties, the KL and moment terms, the
# weighted BCE, the {start_step: weight} schedule and the finite flag.  The
# penalties differentiate the critic through torch.autograd.grad with
# create_graph=True, so their own gradient reaches the critic's weights as
# jax.grad inside jax.grad does; the interpolation weights are an argument,
# drawn by the caller.
#
# Under data parallelism (`mesh`, parallel/mesh.py) each rank holds its rows
# of the global batch.  The terms that are means of per-sample terms stay
# local: the mean over ranks of equal shards' means is the global mean.  The
# free-bits KL (a clamp of a per-dimension batch mean), the moment losses
# (squares of batch means) and the normaliser of the weighted BCE are not,
# and take their batch statistics from global sums.  A critic under a
# double-backward penalty must not couple the samples of a sharded batch
# (assert_penalty_critic).

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ctrlhair_tpu_torch.models.layers import RunningBatchNorm
from ctrlhair_tpu_torch.parallel.mesh import (
    batch_mean, global_sum, world_size)


def gan_loss_g(gan_type: str, dis_fake: torch.Tensor) -> torch.Tensor:
    """Generator-side adversarial loss."""
    if gan_type == 'lsgan':
        return torch.mean((dis_fake - 1.0) ** 2)
    if gan_type == 'nsgan':
        return torch.mean(-F.logsigmoid(dis_fake))
    if gan_type in ('wgan_gp', 'hinge'):
        return -torch.mean(dis_fake)
    if gan_type == 'hinge2':
        return torch.mean(torch.clamp_min(1.0 - dis_fake, 0.0))
    raise NotImplementedError(gan_type)


def gan_loss_d(gan_type: str, dis_real: torch.Tensor,
               dis_fake: torch.Tensor) -> torch.Tensor:
    """Discriminator-side adversarial loss."""
    if gan_type == 'lsgan':
        return torch.mean(dis_fake ** 2) + torch.mean((dis_real - 1.0) ** 2)
    if gan_type == 'nsgan':
        return torch.mean(-F.logsigmoid(-dis_fake)) + \
            torch.mean(-F.logsigmoid(dis_real))
    if gan_type == 'wgan_gp':
        return torch.mean(dis_fake) - torch.mean(dis_real)
    if gan_type in ('hinge', 'hinge2'):
        return torch.mean(torch.clamp_min(1.0 - dis_real, 0.0)) + \
            torch.mean(torch.clamp_min(1.0 + dis_fake, 0.0))
    raise NotImplementedError(gan_type)


def _input_grads(adv_fn: Callable[[torch.Tensor], torch.Tensor],
                 x: torch.Tensor) -> torch.Tensor:
    """d sum(adv_fn(x)) / dx, itself differentiable (create_graph)."""
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    return torch.autograd.grad(adv_fn(x).sum(), x, create_graph=True)[0]


def wgan_gradient_penalty(adv_fn: Callable[[torch.Tensor], torch.Tensor],
                          real: torch.Tensor, fake: torch.Tensor,
                          alpha: torch.Tensor) -> torch.Tensor:
    """mean((|grad_x D(x_hat)|_2 - 1)^2) at x_hat = alpha*real +
    (1-alpha)*fake; alpha is [N, 1, ...], uniform in [0, 1)."""
    x_hat = alpha * real + (1.0 - alpha) * fake
    grads = _input_grads(adv_fn, x_hat)
    norms = torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2,
                                 dim=1) + 1e-12)
    return torch.mean((norms - 1.0) ** 2)


def r0_gradient_penalty(adv_fn: Callable[[torch.Tensor], torch.Tensor],
                        real: torch.Tensor) -> torch.Tensor:
    """mean(|grad_x D(x)|^2) on real inputs (the shape branch's
    lambda_gp_0)."""
    grads = _input_grads(adv_fn, real)
    return torch.mean(torch.sum(grads.reshape(grads.shape[0], -1) ** 2,
                                dim=1))


def kl_loss(mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """VAE KL in the reference's var-log form."""
    var = std ** 2
    return 0.5 * torch.mean(mean ** 2 + var - 1.0 - torch.log(var + 1e-4))


def kl_loss_free_bits(mean: torch.Tensor, std: torch.Tensor,
                      free_bits: float, mesh=None) -> torch.Tensor:
    """Per-dimension free-bits KL: a latent dimension whose batch-mean KL is
    below `free_bits` nats contributes the floor instead.  free_bits=0 is
    kl_loss.  The batch mean is the global batch's over `mesh`."""
    var = std ** 2
    kl_per_dim = 0.5 * batch_mean(
        mean ** 2 + var - 1.0 - torch.log(var + 1e-4), mesh)
    return torch.mean(torch.clamp_min(kl_per_dim, free_bits))


def moment_losses(noise: torch.Tensor, second_moment_target: float = 1.0,
                  mesh=None):
    """Batch latent moments against the prior's: (first, second), over the
    global batch of `mesh`."""
    m1 = torch.mean(batch_mean(noise, mesh) ** 2)
    m2 = torch.mean((batch_mean(noise ** 2, mesh)
                     - second_moment_target) ** 2)
    return m1, m2


def assert_penalty_critic(critic: nn.Module, mesh) -> None:
    """A critic whose input gradient is penalised (WGAN-GP, R0) holds no
    batch norm when the batch is sharded: its statistics would need a
    collective under create_graph=True, and every critic of the trainers
    has d_norm='none'."""
    if mesh is None:
        return
    if any(isinstance(m, RunningBatchNorm) for m in critic.modules()):
        raise ValueError(f'{type(critic).__name__} has a batch norm under a '
                         'gradient penalty; data-parallel training needs '
                         "d_norm='none' there")


def weighted_bce_with_logits(logits: torch.Tensor, targets01: torch.Tensor,
                             weights: Optional[torch.Tensor] = None,
                             mesh=None) -> torch.Tensor:
    """BCE(sigmoid(logits), targets), the probability clipped to
    [1e-7, 1-1e-7], with optional per-sample weights normalised to mean 1
    over the global batch of `mesh`."""
    p = torch.clamp(torch.sigmoid(logits), 1e-7, 1 - 1e-7)
    bce = -(targets01 * torch.log(p) + (1 - targets01) * torch.log(1 - p))
    if weights is not None:
        weights = weights / global_sum(torch.sum(weights), mesh) * (
            weights.shape[0] * world_size(mesh))
        bce = bce * weights
    return torch.mean(bce)


class LossSchedule:
    """Step-scheduled scalar weights: every `lambda_*` field of a config, a
    number (static) or a {start_step: weight} mapping (scheduled); None
    leaves the loss out."""

    def __init__(self, cfg):
        self.static: Dict[str, float] = {}
        self.scheduled: Dict[str, Mapping[int, float]] = {}
        self._device_tables: Dict[tuple, tuple] = {}
        for name in dir(cfg):
            if not name.startswith('lambda_'):
                continue
            val = getattr(cfg, name)
            if isinstance(val, Mapping):
                self.scheduled[name] = dict(sorted(val.items()))
            elif isinstance(val, (int, float)):
                self.static[name] = float(val)

    def weight(self, name: str, step) -> torch.Tensor:
        """The weight at `step` as a float32 tensor; a step tensor stays on
        its device (no host read).  The tables are copied to that device
        once, so later calls copy nothing from the host and a CUDA graph
        can capture them (training/chunked.py)."""
        if not isinstance(step, torch.Tensor):
            return torch.tensor(self.weight_host(name, int(step)),
                                dtype=torch.float32)
        values, bounds = self._tables(name, step)
        if bounds is None:
            return values
        # a 1-element index: a 0-d tensor index would be read on the host
        return values.index_select(0, torch.searchsorted(
            bounds, step.reshape(1), right=True)).reshape(())

    def _tables(self, name: str, step: torch.Tensor):
        """(values, bounds) of one weight on step's device: a 0-d value and
        None for a static weight; for a schedule its weights and the start
        steps after the first, in step's dtype (searchsorted's rule)."""
        key = (name, str(step.device), step.dtype)
        if key not in self._device_tables:
            if name in self.static:
                values = torch.tensor(self.static[name], dtype=torch.float32)
                bounds = None
            else:
                items = list(self.scheduled[name].items())
                values = torch.tensor([v for _, v in items],
                                      dtype=torch.float32)
                bounds = torch.tensor([s for s, _ in items[1:]],
                                      dtype=step.dtype).to(step.device)
            self._device_tables[key] = (values.to(step.device), bounds)
        return self._device_tables[key]

    def weight_host(self, name: str, step: int) -> float:
        """The weight at a step the host knows, as a Python float."""
        if name in self.static:
            return self.static[name]
        out = None
        for s, v in self.scheduled[name].items():       # sorted
            if out is None or step >= s:
                out = v
        return float(out)

    def total(self, loss_dict: Dict[str, torch.Tensor], step
              ) -> torch.Tensor:
        """Weighted float32 sum; keys the config does not name are
        skipped."""
        device = next(iter(loss_dict.values())).device if loss_dict \
            else None
        tot = torch.zeros((), dtype=torch.float32, device=device)
        for key, val in loss_dict.items():
            if key in self.static or key in self.scheduled:
                # a host step gives a Python weight: no host-to-device copy
                w = self.weight(key, step) if isinstance(step, torch.Tensor) \
                    else self.weight_host(key, int(step))
                tot = tot + w * val.float()
        return tot


def check_finite(loss_dict: Dict[str, torch.Tensor]) -> torch.Tensor:
    """All-finite flag over a loss dict (a bool tensor, no host read)."""
    return torch.stack([torch.isfinite(v).all()
                        for v in loss_dict.values()]).all()
