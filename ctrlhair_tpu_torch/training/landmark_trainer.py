# Trainer of the landmark regressor (the dlib shape-predictor stand-in).
#
# Port of ctrlhair_tpu/training/landmark_trainer.py: supervised regression
# with the predictor trainer's skeleton.  The losses are the smooth-L1
# (beta 0.02) of the normalised landmark coordinates, averaged over the
# samples that hold a face, and the binary cross-entropy of the presence
# logit (optax.sigmoid_binary_cross_entropy's log-sigmoid form); plain Adam
# (b1 0.9), one finite flag gating the update.  eval_metrics reports the
# mean landmark distance in normalised units and in pixels of the net's
# input, and the presence accuracy.  The step draws nothing.

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ctrlhair_tpu_torch.models.landmark_net import (LandmarkNet,
                                                    LandmarkNetConfig)
from ctrlhair_tpu_torch.models.layers import init_parameters_
from ctrlhair_tpu_torch.pipeline.editor import resolve_device
from ctrlhair_tpu_torch.training.train_state import (
    Adam, LandmarkTrainState, ModelOpt, grads_finite, param_grads,
    safe_apply_updates)


def smooth_l1(x: torch.Tensor, beta: float = 0.02) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, elementwise."""
    return -labels * F.logsigmoid(logits) - \
        (1.0 - labels) * F.logsigmoid(-logits)


class LandmarkTrainer:
    def __init__(self, cfg: LandmarkNetConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tx = Adam(cfg.lr, cfg.beta1, cfg.beta2)

    def init_state(self, seed: int = 0) -> LandmarkTrainState:
        """A LandmarkNet drawn from its initialisers by one seeded
        generator, Adam at count 0."""
        with torch.device(self.device):
            model = LandmarkNet(self.cfg)
        init_parameters_(model, torch.Generator(self.device).manual_seed(
            seed))
        return LandmarkTrainState(
            step=0, model=ModelOpt(model, self.tx, 'net'))

    def _losses(self, out, batch) -> Dict[str, torch.Tensor]:
        pres = batch['presence']
        per_pt = smooth_l1(out['landmarks'] - batch['landmarks']).sum(-1)
        coord = (per_pt.mean(-1) * pres).sum() / torch.clamp_min(
            pres.sum(), 1)
        bce = sigmoid_bce(out['presence'], pres)
        return {'coord': coord, 'presence': bce.mean()}

    def train_step(self, state: LandmarkTrainState,
                   batch: Dict[str, torch.Tensor]):
        """One step in place; returns (state, metrics).  batch: 'image'
        [N,S,S,3] in [-1,1], 'landmarks' [N,81,2], 'presence' [N]."""
        out = state.model.module(batch['image'])
        losses = self._losses(out, batch)
        total = losses['coord'] + losses['presence']
        grads = param_grads(total, state.model.params())
        finite = grads_finite(grads)
        safe_apply_updates(state.model, grads, finite)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(total=total.detach(), finite=finite)
        return state, metrics

    @torch.no_grad()
    def eval_metrics(self, state: LandmarkTrainState,
                     batch: Dict[str, torch.Tensor]):
        out = state.model.module(batch['image'])
        pres = batch['presence']
        dist = torch.linalg.vector_norm(
            out['landmarks'] - batch['landmarks'], dim=-1).mean(-1)
        mean_norm = (dist * pres).sum() / torch.clamp_min(pres.sum(), 1)
        acc = ((out['presence'] > 0) == (pres > 0.5)).float().mean()
        return {'test/mean_dist_norm': mean_norm,
                'test/mean_dist_px': mean_norm * self.cfg.input_size,
                'test/presence_accuracy': acc}
