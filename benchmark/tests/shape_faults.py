"""Faults planted in the shape trainer under a CPU run of shape.train
(benchmark/tests/test_benchmark_shape_train.py): each breaks the timed
step the way a faulty program could, and `correct` has to come out
false."""

from __future__ import annotations

import torch


def plant(name: str) -> None:
    from ctrlhair_tpu_torch.models.shape import ShapeDiscriminator
    from ctrlhair_tpu_torch.training import shape_trainer

    if name == 'shape_unchanged':
        # a step that computes its losses and leaves the state unchanged
        shape_trainer.safe_apply_updates = lambda *a, **k: None
    elif name == 'shape_half_batch':
        # the step's means taken over the first half of the batch and draws
        step = shape_trainer.ShapeTrainer.train_step

        def half(self, state, batch, draws=None):
            n = batch['target'].shape[0] // 2
            draws = {k: v[:n] if v.dim() else v for k, v in draws.items()}
            return step(self, state, {k: v[:n] for k, v in batch.items()},
                        draws)
        shape_trainer.ShapeTrainer.train_step = half
    elif name == 'shape_r0_first_order':
        # D's R0 input gradient taken without create_graph: the penalty
        # gives D no gradient
        losses = shape_trainer.L
        penalty = losses.r0_gradient_penalty

        def first_order(adv_fn, real):
            if not isinstance(adv_fn, ShapeDiscriminator):
                return penalty(adv_fn, real)
            x = real.detach().requires_grad_(True)
            g = torch.autograd.grad(adv_fn(x).sum(), x)[0]
            return torch.mean(torch.sum(g.reshape(g.shape[0], -1) ** 2, 1))
        losses.r0_gradient_penalty = first_order
    else:
        raise ValueError(name)
