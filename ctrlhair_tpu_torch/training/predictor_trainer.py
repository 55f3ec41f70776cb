# Supervised predictor trainer (curliness classifier / colour encoder).
#
# Port of ctrlhair_tpu/training/predictor_trainer.py: BCE for
# cls_curliness, MSE for rgb_mean / pca_std, Adam, step-scheduled loss
# weights, BatchNorm running statistics carried through the step (flax's
# rule, models/layers.py), eval metrics with test/accuracy.  A non-finite
# gradient leaves the parameters, Adam's state and the running statistics
# as they were.
#
# Randomness: the dropout keep masks are an argument of the step (`draws`);
# given none, the step draws them on the host from a generator seeded by
# (seed, state.step), so they do not depend on the device and a resumed run
# draws what an unbroken one does.

from __future__ import annotations

from typing import Dict, Optional

import torch

from ctrlhair_tpu_torch.config import PredictorConfig
from ctrlhair_tpu_torch.models.color_texture import Predictor
from ctrlhair_tpu_torch.models.layers import (
    init_parameters_, keep_masks_like, set_train)
from ctrlhair_tpu_torch.pipeline.editor import resolve_device
from ctrlhair_tpu_torch.training import losses as L
from ctrlhair_tpu_torch.training.train_state import (
    ModelOpt, PredictorTrainState, adam, batch_stats, grads_finite,
    restore_where, safe_apply_updates)


def to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host draw on the trainer's device; to a card through pinned memory
    without waiting, so the host can queue the step behind it."""
    if device.type != 'cuda':
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def step_seed(seed: int, step: int) -> int:
    """The seed of one training step's draws."""
    return (seed * 0x9E3779B1 + step) % (1 << 63)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The host generator of one training step's draws."""
    return torch.Generator().manual_seed(step_seed(seed, step))


class PredictorTrainer:
    def __init__(self, cfg: PredictorConfig, device=None, seed: int = 0):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = seed
        self.schedule = L.LossSchedule(cfg)
        self.tx = adam(cfg.lr, cfg.beta1, cfg.beta2)

    def init_state(self, seed: int = 0) -> PredictorTrainState:
        """A train-mode Predictor drawn from its initialisers with one
        seeded generator, Adam at count 0."""
        with torch.device(self.device):
            model = Predictor(self.cfg, train=True)
        init_parameters_(model, torch.Generator(self.device).manual_seed(
            seed))
        return PredictorTrainState(
            step=0, model=ModelOpt(model, self.tx, 'model'))

    def draws(self, step: int, n: int) -> Dict[str, list]:
        """The step's dropout keep masks, one [n, hidden] a hidden layer."""
        masks = keep_masks_like(n, self.cfg.hidden_dim,
                                self.cfg.hidden_layer_num, self.cfg.dropout,
                                step_generator(self.seed, step))
        return {'dropout': [to_device(m, self.device) for m in masks]}

    def _losses(self, out: Dict[str, torch.Tensor],
                batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        losses = {}
        if 'cls_curliness' in out and 'curliness_label' in batch:
            losses['lambda_cls_curliness'] = L.weighted_bce_with_logits(
                out['cls_curliness'],
                batch['curliness_label'].float() / 2 + 0.5)
        if 'rgb_mean' in out and 'rgb_mean' in batch:
            losses['lambda_rgb'] = torch.mean(
                (out['rgb_mean'] - batch['rgb_mean']) ** 2)
        if 'pca_std' in out and 'pca_std' in batch:
            losses['lambda_pca_std'] = torch.mean(
                (out['pca_std'] - batch['pca_std']) ** 2)
        return losses

    def train_step(self, state: PredictorTrainState,
                   batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, list]] = None):
        """One step in place; returns (state, metrics).  `draws`: the
        dropout keep masks ({'dropout': [...]}), drawn here when None."""
        model = state.model.module
        if draws is None:
            draws = self.draws(state.step, batch['code'].shape[0])
        saved = {k: b.clone() for k, b in batch_stats(model).items()}
        out = model({'code': batch['code']}, draws['dropout'])
        losses = self._losses(out, batch)
        total = self.schedule.total(losses, state.step)
        params = state.model.params()
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        finite = grads_finite(grads)
        safe_apply_updates(state.model, grads, finite)
        restore_where(finite, saved, batch_stats(model))
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(total=total.detach(), finite=finite)
        return state, metrics

    @torch.no_grad()
    def eval_metrics(self, state: PredictorTrainState,
                     batch: Dict[str, torch.Tensor]):
        """Held-out losses (running statistics, no dropout) as 'test/*',
        and test/accuracy of the curliness sign."""
        model = state.model.module
        set_train(model, False)
        try:
            out = model({'code': batch['code']})
        finally:
            set_train(model, True)
        metrics = {f'test/{k}': v
                   for k, v in self._losses(out, batch).items()}
        if 'cls_curliness' in out and 'curliness_label' in batch:
            pred = out['cls_curliness'] > 0
            truth = batch['curliness_label'] > 0
            metrics['test/accuracy'] = (pred == truth).float().mean()
        return metrics
