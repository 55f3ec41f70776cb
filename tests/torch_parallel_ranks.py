# Rank-side code of the port's data-parallel tests (tests/test_torch_
# parallel*.py), run in the ranks that ctrlhair_tpu_torch.parallel.dryrun.
# run_on_ranks spawns, and in the test process itself with mesh None for
# the single-process references.  It imports torch and the port only: a
# spawned rank imports this module, not the test modules (which import
# JAX).  Inputs and results are numpy arrays and flax-layout trees.

from __future__ import annotations

import os

import numpy as np
import torch

from ctrlhair_tpu_torch import config as cfg_mod
from ctrlhair_tpu_torch.models.bisenet import BiSeNet
from ctrlhair_tpu_torch.models.layers import (
    RunningBatchNorm, set_compute_dtype, set_sync)
from ctrlhair_tpu_torch.models.sean import SEAN
from ctrlhair_tpu_torch.parallel.mesh import (
    all_gather_fields, all_gather_rows, local_rows, shard_batch)
from ctrlhair_tpu_torch.pipeline.editor import HairEditor
from ctrlhair_tpu_torch.pipeline.latent import Latent
from ctrlhair_tpu_torch.training import losses as L
from ctrlhair_tpu_torch.training import shape_trainer as sht
from ctrlhair_tpu_torch.training.color_texture_trainer import (
    ColorTextureTrainer)
from ctrlhair_tpu_torch.training.train_state import param_grads, reduce_grads


def tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def numpy_tree(t):
    return t.detach().cpu().numpy().copy()


# ------------------------------------------------------------ sync BN
def sync_bn(mesh, x):
    """An affine-free train-mode RunningBatchNorm on this rank's rows of x
    [N,C,H,W]: (output rows, running mean, running var)."""
    bn = RunningBatchNorm(x.shape[1], affine=False, train=True)
    set_sync(bn, mesh)
    out = bn(local_rows(torch.from_numpy(x), mesh))
    return numpy_tree(out), numpy_tree(bn.running_mean), \
        numpy_tree(bn.running_var)


def bisenet_train(mesh, cfg, state, x):
    """BiSeNet(train=True) with synced BatchNorm on this rank's rows of x:
    (output rows, {buffer: running statistic})."""
    model = BiSeNet(cfg, train=True)
    model.load_state_dict(tensors(state))
    set_sync(model, mesh)
    with torch.no_grad():
        out = model(local_rows(torch.from_numpy(x), mesh))
    return numpy_tree(out), {k: numpy_tree(b)
                             for k, b in model.named_buffers()}


# ------------------------------------------------------------- losses
def loss_cases(mesh, data):
    """{name: (value, gradients averaged over the ranks)} of every loss
    term the trainers compute from global sums, each a function of
    replicated parameters (A, B, C) applied to this rank's rows, as in a
    training step; 'p3' is the colour/texture step's shuffled-condition
    gather (values only: its gradient is stopped)."""
    params = {k: torch.tensor(data[k], requires_grad=True)
              for k in ('A', 'B', 'C')}
    rows = shard_batch(tensors(data['batch']), mesh)
    x = rows['x']
    z = x @ params['A']
    std = torch.exp(0.3 * (x @ params['B']))
    out = {}

    def case(name, value, which):
        grads, = reduce_grads(mesh, param_grads(
            value, [params[k] for k in which], retain=True))
        out[name] = (float(value.detach()), [numpy_tree(g) for g in grads])

    case('kl_loss_free_bits', L.kl_loss_free_bits(
        z, std, data['free_bits'], mesh=mesh), 'AB')
    m1, m2 = L.moment_losses(z, mesh=mesh)
    case('moment_1', m1, 'A')
    case('moment_2', m2, 'A')
    case('masked_mean', sht._masked_mean(z, rows['mask'] > 0, mesh), 'A')
    case('weighted_bce', L.weighted_bce_with_logits(
        z[:, :1], rows['target'], rows['weight'], mesh=mesh), 'A')
    trainer = ColorTextureTrainer(
        cfg_mod.ColorTextureConfig(**data['ct_cfg']), sean=rec_sean(data),
        rec_img_subset=data['rec_img_subset'], device='cpu', mesh=mesh)
    ae_code = rows['code'] @ params['C']
    case('rec_img_hair_mse', trainer._rec_img_hair_mse(ae_code, rows), 'C')
    src = all_gather_fields({'enc_noise': z.detach(),
                             'noise': rows['noise']}, mesh)
    p3 = local_rows(torch.from_numpy(data['p3']), mesh)
    picked = torch.where(torch.tensor(data['use_enc']),
                         src['enc_noise'][p3], src['noise'][p3])
    out['p3'] = (numpy_tree(all_gather_rows(picked, mesh)),
                 picked.requires_grad)
    return out


def rec_sean(data):
    sean = SEAN(cfg_mod.SEANConfig(**data['sean_cfg']))
    sean.load_state_dict(tensors(data['sean_state']))
    return sean


# -------------------------------------------------------- edit render
def edit_render(mesh, cfg, inputs):
    """The editor of `cfg` (a PipelineConfig; seed 0): edit_render of this
    rank's rows, gathered over the ranks."""
    editor = HairEditor(cfg, device='cpu', seed=0)
    rows = shard_batch(tensors(inputs), mesh)
    latent = Latent(**{k: rows[k] for k in (
        'hsv', 'pca_std', 'curliness', 'texture', 'shape', 'face')})
    out = editor.edit_render(rows['codes'], rows['label'], latent)
    return numpy_tree(all_gather_rows(out, mesh))


def parallel_checks(mesh, payload):
    """Every rank-side computation of tests/test_torch_parallel.py."""
    return {'sync_bn': sync_bn(mesh, payload['bn_x']),
            'sync_bn_shifted': sync_bn(mesh, payload['bn_x_shifted']),
            'bisenet': bisenet_train(mesh, payload['bisenet_cfg'],
                                     payload['bisenet_state'],
                                     payload['bisenet_x']),
            'losses': loss_cases(mesh, payload['losses']),
            'edit_render': edit_render(mesh, payload['editor_cfg'],
                                       payload['edit_inputs'])}



# ----------------------------------------------------------- trainers
def make_trainer(family, spec, mesh, dtype=None):
    """(trainer, state, extra step arguments) of one trainer family at
    spec's config on the CPU, its state loaded from spec['init_tree'], its
    trained models computing in `dtype` (None: float32)."""
    from ctrlhair_tpu_torch.training.bisenet_trainer import BiSeNetTrainer
    from ctrlhair_tpu_torch.training.sean_trainer import SEANTrainer
    cfg, extra = spec['cfg'], ()
    if family == 'color_texture':
        sean = SEAN(spec['sean_cfg'])
        sean.load_state_dict(tensors(spec['sean_state']))
        trainer = ColorTextureTrainer(cfg, sean=sean, device='cpu',
                                      mesh=mesh)
        state, preds = trainer.init_state()
        for k, p in preds.items():
            p.load_state_dict(tensors(spec['pred_states'][k]))
        extra = (preds,)
    elif family == 'shape':
        trainer = sht.ShapeTrainer(cfg, device='cpu', mesh=mesh)
        state = trainer.init_state()
    elif family == 'bisenet':
        trainer = BiSeNetTrainer(cfg, device='cpu', mesh=mesh)
        state = trainer.init_state()
    else:
        trainer = SEANTrainer(cfg, device='cpu', mesh=mesh,
                              **spec['trainer_kwargs'])
        state = trainer.init_state()
    state.load_tree(spec['init_tree'])
    if dtype is not None:
        parts = state.parts().values() if hasattr(state, 'parts') \
            else [state.model]
        for part in parts:
            set_compute_dtype(part.module, dtype)
    return trainer, state, extra


def scalars(metrics):
    return {k: float(v.detach()) for k, v in metrics.items()
            if v.numel() == 1}


def trainer_checks(mesh, family, spec, full=True):
    """One trainer family on this rank (mesh None: the whole batch in one
    process): 'step', the state tree and metrics after one step from the
    initial state on the first batch with the given global draws, and
    'step64' the same with the models computing in float64 (unless
    spec['float64'] is False); 'collectives',
    the collectives of one step; with `full` also 'nan', the initial tree,
    the tree after a step on a batch with a NaN in the last rank's rows,
    and its finite flag; 'unbroken', the tree after two steps of
    run_training (the trainer's own draws); 'resumed', the same two steps
    checkpointed after the first (by rank 0) and resumed in a new
    trainer."""
    from ctrlhair_tpu_torch.parallel.mesh import replicated
    from ctrlhair_tpu_torch.training.loop import run_training
    batches = [tensors(b) for b in spec['batches']]

    def rows(batch):
        return shard_batch(batch, mesh)

    out = {}
    dtypes = (('step', None), ('step64', torch.float64))
    for key, dtype in dtypes[:2 if spec.get('float64', True) else 1]:
        trainer, state, extra = make_trainer(family, spec, mesh, dtype)
        replicated(state, mesh)
        draws = spec['draws']
        args = extra + (() if draws is None else (tensors(draws),))
        before = 0 if mesh is None else mesh.collectives
        state, metrics = trainer.train_step(state, rows(batches[0]), *args)
        out[key] = (state.to_tree(), scalars(metrics))
        out['collectives'] = 0 if mesh is None else \
            mesh.collectives - before

    if not full:
        return out
    trainer, state, extra = make_trainer(family, spec, mesh)
    state, metrics = trainer.train_step(
        state, rows(tensors(spec['nan_batch'])), *extra)
    out['nan'] = (spec['init_tree'], state.to_tree(),
                  bool(metrics['finite']))

    def training(total, ckpt_dir):
        trainer, state, extra = make_trainer(family, spec, mesh)
        state, _ = run_training(
            state, trainer.train_step, lambda step: rows(batches[step]),
            total, step_args=lambda: extra, ckpt_dir=ckpt_dir,
            verbose=False, mesh=mesh)
        return state.to_tree()

    out['unbroken'] = training(2, None)
    ckpt = os.path.join(spec['tmp'], 'single' if mesh is None
                        else f'world{mesh.world}', family)
    training(1, ckpt)
    out['resumed'] = training(2, ckpt)
    return out


def families_on_rank(mesh, specs):
    """trainer_checks of each case of {name: spec} (its family
    spec['family'], else its name; all of it unless spec['full'] is
    False)."""
    return {name: trainer_checks(mesh, spec.get('family', name), spec,
                                 spec.get('full', True))
            for name, spec in specs.items()}



# ------------------------------------------------- tensor parallelism
def nan_in_one_shard(mesh, family, spec):
    """A step whose gradient is NaN in one entry of tp rank 1's slice of
    the generator's first sharded weight, nowhere else: (the tree before,
    the tree after, this rank's finite flag)."""
    import importlib
    from ctrlhair_tpu_torch.models.layers import tp_shards
    trainer, state, extra = make_trainer(family, spec, mesh)
    module = importlib.import_module(type(trainer).__module__)
    names = [n for n, _ in state.gen.module.named_parameters()]
    poisoned = names.index(sorted(tp_shards(state.gen.module))[0])
    real = module.reduce_grads

    def reduce_then_poison(m, d_grads, g_grads, dz_grads):
        d_grads, g_grads, dz_grads = real(m, d_grads, g_grads, dz_grads)
        if m.tp_rank == 1:
            g_grads = list(g_grads)
            g_grads[poisoned] = g_grads[poisoned].clone()
            g_grads[poisoned].view(-1)[0] = float('nan')
        return d_grads, g_grads, dz_grads

    before = state.to_tree()
    draws = spec['draws']
    module.reduce_grads = reduce_then_poison
    try:
        state, metrics = trainer.train_step(
            state, shard_batch(tensors(spec['batches'][0]), mesh), *extra,
            *(() if draws is None else (tensors(draws),)))
    finally:
        module.reduce_grads = real
    return before, state.to_tree(), bool(metrics['finite'])


def checkpoints_across_tp(mesh, family, spec, read_dir, write_dir):
    """The tree of `read_dir`'s checkpoint (written by one process) after
    this mesh's state loads it; and run_training's one step on this mesh
    checkpointed into `write_dir` (by rank 0)."""
    from ctrlhair_tpu_torch.training.loop import run_training
    from ctrlhair_tpu_torch.utils.checkpoint import load_checkpoint
    trainer, state, extra = make_trainer(family, spec, mesh)
    state.load_tree(load_checkpoint(read_dir)[0])
    loaded = state.to_tree()
    trainer, state, extra = make_trainer(family, spec, mesh)
    run_training(state, trainer.train_step,
                 lambda step: shard_batch(tensors(spec['batches'][step]),
                                          mesh),
                 1, step_args=lambda: extra, ckpt_dir=write_dir,
                 verbose=False, mesh=mesh)
    return loaded


def critic_under_penalty(mesh, seed=0):
    """A float64 critic of every column-parallel kind (Conv, ConvTranspose,
    Dense, and a Dense that stays whole) under a penalty on its input
    gradient, as WGAN-GP and R0 take it: the loss mean(D(x)) +
    mean(|dD/dx|^2), its input gradient and its parameter gradients by
    double backward, on this mesh's tp ranks and, for reference, with the
    same weights unsharded in this process.  Returns {'x_grad', 'loss',
    'grads'}: the largest differences, each scaled by max(1, |ref|)."""
    import copy
    import torch.nn.functional as F
    from ctrlhair_tpu_torch.models.layers import (
        Conv, ConvTranspose, Dense, init_parameters_, set_compute_dtype,
        set_tp, tp_shards)
    from ctrlhair_tpu_torch.parallel.mesh import tp_full

    class Critic(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = Conv(3, 4, 3, 1, 1)
            self.up = ConvTranspose(4, 4, 3, 2, 1, 1)
            self.fc = Dense(4 * 8 * 8, 6)
            self.head = Dense(6, 1)

        def forward(self, x):
            x = F.leaky_relu(self.conv(x), 0.2)
            x = F.leaky_relu(self.up(x), 0.2)
            x = F.leaky_relu(self.fc(x.reshape(x.shape[0], -1)), 0.2)
            return self.head(x)

    ref = Critic().double()
    init_parameters_(ref, torch.Generator().manual_seed(seed))
    set_compute_dtype(ref, torch.float64)
    net = copy.deepcopy(ref)
    set_tp(net, mesh)
    shards = tp_shards(net)
    assert sorted(shards) == ['conv.weight', 'fc.weight', 'up.weight']
    x0 = torch.randn((3, 3, 4, 4), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(seed + 1))

    def run(model):
        x = x0.clone().requires_grad_(True)
        adv = model(x)
        gx = torch.autograd.grad(adv.sum(), x, create_graph=True)[0]
        loss = adv.mean() + torch.mean(torch.sum(gx.reshape(3, -1) ** 2, 1))
        names = [n for n, _ in model.named_parameters()]
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return gx.detach(), loss.detach(), dict(zip(names, grads))

    gx, loss, grads = run(net)
    gx_ref, loss_ref, grads_ref = run(ref)
    grads = {k: tp_full(g, *shards[k]) if k in shards else g
             for k, g in grads.items()}

    def gap(a, b):
        return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))

    return {'x_grad': gap(gx, gx_ref), 'loss': gap(loss, loss_ref),
            'grads': max(gap(grads[k], grads_ref[k]) for k in grads_ref)}


def tp_on_rank(mesh, payload):
    """Every rank-side computation of tests/test_torch_tensor_parallel.py:
    trainer_checks of each family, the NaN in one shard, the checkpoints
    across tp sizes, and the critic under a penalty."""
    out = families_on_rank(mesh, payload['specs'])
    for family, spec in payload['specs'].items():
        out[family]['nan_shard'] = nan_in_one_shard(mesh, family, spec)
        out[family]['loaded'] = checkpoints_across_tp(
            mesh, family, spec, payload['single_dirs'][family],
            payload['tp_dirs'][family])
    out['critic'] = critic_under_penalty(mesh)
    out['mesh'] = (mesh.rank, mesh.tp_rank, mesh.world, mesh.tp)
    return out
