# The port's data-parallel SEAN trainer against the JAX package's sharded
# step: the SEAN case of tests/test_multichip_training.py, as
# tests/test_torch_parallel_trainers.py holds the other three trainers
# (its header has the bars; this file shares its helpers).  The entries
# exempt as noise are those of tests/test_torch_sean_trainer.py: a conv
# bias in front of a normalisation has a gradient of exactly zero, so its
# whole leaf is noise, held to "moved at most 2 lr" (at most 1% of the
# entries).
#
# The config is that test's (crop 32, ngf 4, style 32, no VGG19) with ACE
# noise on (JAX's global-batch noise, handed to the port and sliced by each
# rank; every noise_var drawn non-zero so that the noise counts), four
# upsamples and one middle block as in tests/test_torch_sean_trainer.py
# (the first block's statistics then run over 2x2 maps: over 1x1 maps
# they are 8 values, and the float32 sums of the whole batch and of its
# halves stood 4e-5 of a gradient apart), and a two-scale PatchGAN of two
# layers, 8 filters.  The syncbatch norms take
# the global batch's statistics; spectral norm's u vectors advance on every
# rank from the same weights and stay bit-identical across the ranks.  With
# remat_blocks the recompute in the backward issues the synced norms'
# collectives again on both ranks, and the step equals the one without.
# With the models computing in float64 the step is held to the single
# process at 1e-6, as the other trainers are.
import dataclasses

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from ctrlhair_tpu import config as jcfg_mod
from ctrlhair_tpu.training.sean_trainer import SEANTrainer as JaxSEANTrainer
from ctrlhair_tpu_torch.training.sean_trainer import SEANTrainer
from test_torch_convert import one_torch_thread  # noqa: F401 (autouse)
from test_torch_parallel_trainers import (
    N, check_nan_and_resume, check_step, jax_sharded_step, numpy_draws,
    run_families, template, with_nan)
from test_torch_sean_trainer import jax_noise, noise_entries
from test_torch_trainers import assert_trees, port_cfg

SEAN = jcfg_mod.SEANConfig(crop_size=32, ngf=4, zencoder_ngf=4,
                           style_dim=32, use_ace_noise=True,
                           num_up_layers=4, num_middle_blocks=1)
DIS = dict(dis_ndf=8, dis_n_layers=2)
LRS = {'gen': 1e-4, 'dis': 4e-4}
# the share of exempt entries tests/test_torch_sean_trainer.py allows
NOISE_SHARE_MAX = 1e-2


def sean_spec(remat=False):
    cfg = port_cfg(dataclasses.replace(SEAN, remat_blocks=remat))
    state = SEANTrainer(cfg, use_vgg=False, device='cpu', **DIS).init_state(5)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in state.gen.module.named_parameters():
            if name.endswith('noise_var'):
                p.normal_(0.0, 0.5, generator=gen)
    rng = np.random.default_rng(5)
    batches = [{'image': (rng.standard_normal((N, 32, 32, 3)) * 0.5).astype(
                    np.float32),
                'label': rng.integers(0, 19, (N, 32, 32)).astype(np.int32)}
               for _ in range(3)]
    key = jax.random.PRNGKey(2)
    spec = {'family': 'sean', 'cfg': cfg,
            'trainer_kwargs': dict(use_vgg=False, **DIS),
            'init_tree': state.to_tree(), 'batches': batches,
            'nan_batch': with_nan(batches[0], 'image', (N - 1, 3, 4, 0)),
            'draws': numpy_draws(jax_noise(key, SEAN, N)),
            'full': not remat}

    def jax_step():
        jtr = JaxSEANTrainer(SEAN, use_vgg=False, **DIS)
        jstate = flax.serialization.from_state_dict(
            template(lambda: jtr.init_state(jax.random.PRNGKey(0))),
            spec['init_tree'])
        return jax_sharded_step(jtr, jstate, batches[0], [], key)
    return spec, None if remat else jax_step, (LRS, 0.0)


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    return run_families({'sean': sean_spec,
                         'sean_remat': lambda: sean_spec(remat=True)},
                        tmp_path_factory.mktemp('ckpt'))


def test_sean_dp_step_equals_jax_sharded_and_single(run):
    """On 2 ranks the SEAN step equals JAX's step sharded over
    make_mesh(2, tp=1) and the port's single-process step, gen_stats (the
    global batch's) and the u vectors included; every rank holds the same
    state, the u vectors bit for bit."""
    check_step(run, 'sean', noise_entries, NOISE_SHARE_MAX)


def test_sean_nan_in_one_rank_and_resume_on_ranks(run):
    """A NaN in the last rank's rows leaves every rank's weights, moments
    and statistics as they were (the u vectors take their power iteration,
    as in JAX, alike on both ranks); the resumed run equals the unbroken
    one bit for bit."""
    check_nan_and_resume(run, 'sean', moved=('sn_u', 'dis_sn_u'))


def test_sean_remat_blocks_on_ranks(run):
    """With remat_blocks the synced norms run again in the backward on
    both ranks: the step equals the one without remat (1e-6, the noise
    exemption as in check_step) and keeps the running statistics its
    forward left, bit for bit; the ranks agree bit for bit."""
    from test_torch_parallel_trainers import (
        SINGLE, assert_trees_noise_exempt)
    per_rank = [r['sean_remat']['step'][0] for r in run['ranks']]
    for tree in per_rank[1:]:
        assert_trees(tree, per_rank[0], 0)
    plain = run['ranks'][0]['sean']['step'][0]
    assert_trees(per_rank[0]['gen_stats'], plain['gen_stats'], 0)
    init = run['specs']['sean']['init_tree']
    total = sum(np.asarray(v).size for part in LRS for v in
                jax.tree_util.tree_leaves(init[part]['params']))
    exempt = {}
    noise_entries(per_rank[0], plain, exempt)
    count = assert_trees_noise_exempt(per_rank[0], plain, init, init, LRS,
                                      0.0, SINGLE, exempt)
    assert count <= NOISE_SHARE_MAX * total
