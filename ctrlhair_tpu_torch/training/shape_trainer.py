# Shape branch (hair-mask VAE-GAN) trainer: one D / G / Dz step per call.
#
# Port of ctrlhair_tpu/training/shape_trainer.py.  A batch is a triplet of
# one-hot masks (the warped target, the face it was warped onto, the donor
# of the hair) plus a batch of real masks.  As there, one step is: the
# shared forward (the VAE encode of the target's hair, sampled; the face
# encode; the AE decode; the decode of prior noise through the same face
# code; a coin that picks the AE or the prior decode for the
# discriminator), the discriminator's hinge loss with the R0 gradient
# penalty on the reals, the generator's loss against the PRE-update
# discriminator (per-pixel cross-entropies, the self-reconstruction through
# the donor mask, the KL, and the optional lambda_geo, lambda_moment_1/2
# and lambda_info terms), then the latent-prior discriminator's loss on the
# hair code with its gradient stopped; one finite flag over all three
# gradients gates all three Adam updates.  JAX evaluates the D and G losses
# in two forwards at the same parameters and draws; here one forward serves
# both, the D loss seeing the fake with its gradient stopped.  The coin is
# torch.where on a device tensor, as jnp.where sends a zero cotangent to
# the branch it does not pick; no host read decides it.
#
# With lambda_geo the geometry head (`geo_head`, a [hair_dim, 7] Dense of
# zeros at init) rides in the generator's parameter tree, so the train state
# and the checkpoint carry it, in flax's layout, both ways; the editor's
# loader drops it (convert/load.py).
#
# Randomness: the VAE and lambda_info noise, the prior noise, the coin and
# the disturb_real uniforms are an argument of the step (`draws`); given
# none, the step draws them on the host from a generator seeded by (seed,
# state.step), so they do not depend on the device and a resumed run draws
# what an unbroken one does.
#
# Data parallelism (`mesh`, parallel/mesh.py): the batch is this rank's rows
# of the global batch, and the step equals the single-process step on the
# global batch.  The draws are made for the global batch and each rank
# takes its rows; the masked cross-entropies (ratios of batch sums), the
# free-bits KL and the moment terms come from global sums, the other terms
# are per-sample means and stay local.

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ctrlhair_tpu_torch.config import ShapeConfig
from ctrlhair_tpu_torch.models.layers import Dense, init_parameters_
from ctrlhair_tpu_torch.models.shape import (
    ShapeDiscriminator, ShapeDiscriminatorNoise, ShapeGenerator)
from ctrlhair_tpu_torch.parallel.mesh import (
    batch_mean, global_metrics, global_sum, local_rows, world_size)
from ctrlhair_tpu_torch.pipeline.editor import resolve_device
from ctrlhair_tpu_torch.training import losses as L
from ctrlhair_tpu_torch.training.predictor_trainer import (
    step_generator, to_device)
from ctrlhair_tpu_torch.training.train_state import (
    GANTrainState, ModelOpt, adam, grads_finite, param_grads, reduce_grads,
    safe_apply_updates)
from ctrlhair_tpu_torch.utils.masks import label_to_one_hot, split_hair_face

N_GEO_STATS = 7


def _masked_mean(values: torch.Tensor, mask: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """The mean of `values` where `mask` holds, over the global batch of
    `mesh`: the ratio of the two global sums."""
    m = mask.float()
    total, count = torch.sum(values * m), torch.sum(m)
    if mesh is not None:
        total, count = global_sum(torch.stack(
            [total, count.to(total.dtype)]), mesh)
    return total / torch.clamp_min(count, 1.0)


def disturb_real(mask: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
    """Uniform-noise mask disturbance, renormalised over the label channel;
    `uniform` is U[0,1) of the mask's shape."""
    cur = uniform * 0.03 + mask
    return cur / torch.sum(cur, dim=-1, keepdim=True)


def geo_stats(hair: torch.Tensor) -> torch.Tensor:
    """[B,S,S,1] soft hair mask -> [B, 7] geometry statistics: area,
    lowest hair row (length), first hair row (top), forehead-band coverage
    (bangs), left/right mass asymmetry, column extent (width), band-
    normalised left/right asymmetry; the targets of the lambda_geo head."""
    h = hair[..., 0].float()                        # [B,S,S]
    s = h.shape[1]
    present = (h > 0.5).float()
    row_any = torch.amax(present, dim=2)            # [B,S]
    col_any = torch.amax(present, dim=1)            # [B,S]
    idx = torch.arange(s, dtype=torch.float32, device=h.device) / s
    rev = torch.arange(s - 1, -1, -1, dtype=torch.float32,
                       device=h.device) / s
    area = torch.mean(h, dim=(1, 2))
    length = torch.amax(row_any * idx[None], dim=1)
    # first hair row r == (s-1)/s - max over the descending ramp (s-1-r)/s;
    # (s-1)/s when there is no hair at all
    top = (s - 1.0) / s - torch.amax(row_any * rev[None], dim=1)
    fore = h[:, int(0.30 * s):int(0.42 * s), int(0.35 * s):int(0.65 * s)]
    bangs = torch.mean(fore, dim=(1, 2))
    half = s // 2
    asym = torch.mean(h[:, :, :half], dim=(1, 2)) - \
        torch.mean(h[:, :, half:], dim=(1, 2))
    width = torch.amax(col_any * idx[None], dim=1) - \
        ((s - 1.0) / s - torch.amax(col_any * rev[None], dim=1))
    fhalf = fore.shape[2] // 2
    fl = torch.sum(fore[:, :, :fhalf], dim=(1, 2))
    fr = torch.sum(fore[:, :, fhalf:], dim=(1, 2))
    band_asym = (fl - fr) / (fl + fr + 1e-3)
    return torch.stack([area, length, top, bangs, asym, width, band_asym],
                       dim=1)


class ShapeTrainGenerator(ShapeGenerator):
    """The generator of the train state: the editor's ShapeGenerator, plus
    the geometry head when lambda_geo > 0."""

    def __init__(self, cfg: ShapeConfig):
        super().__init__(cfg)
        if cfg.lambda_geo > 0:
            self.geo_head = Dense(cfg.hair_dim, N_GEO_STATS)


class ShapeTrainer:
    """`mesh`: the data-parallel mesh (None: one process)."""

    def __init__(self, cfg: ShapeConfig, device=None, seed: int = 0,
                 mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = seed
        self.mesh = mesh
        self.schedule = L.LossSchedule(cfg)
        self.tx_g = adam(cfg.lr_g, cfg.beta1, cfg.beta2)
        self.tx_d = adam(cfg.lr_d, cfg.beta1, cfg.beta2)
        self.tx_dz = adam(cfg.lr_dz, cfg.beta1, cfg.beta2)

    def init_state(self, seed: int = 0) -> GANTrainState:
        """Fresh models, each drawn from its initialisers by one seeded
        generator (the geometry head zero), with Adam at count 0."""
        gen = torch.Generator(self.device).manual_seed(seed)
        with torch.device(self.device):
            g = ShapeTrainGenerator(self.cfg)
            d = ShapeDiscriminator(self.cfg)
            dz = ShapeDiscriminatorNoise(self.cfg)
        for m in (g, d, dz):
            init_parameters_(m, gen)
        for critic, weight in ((d, self.cfg.lambda_gp_0),
                               (dz, self.cfg.lambda_gp_0_noise)):
            if weight > 0:
                L.assert_penalty_critic(critic, self.mesh)
        if self.cfg.lambda_geo > 0:
            with torch.no_grad():
                for p in g.geo_head.parameters():
                    p.zero_()
        return GANTrainState(
            step=0, gen=ModelOpt(g, self.tx_g, 'shape'),
            dis=ModelOpt(d, self.tx_d, 'shape_dis'),
            dis_noise=ModelOpt(dz, self.tx_dz, 'shape_dis_noise'))

    def ae_prob(self) -> float:
        """The chance that the discriminator sees the AE decode: a fair coin
        with lambda_info, else random_ae_prob."""
        return 0.5 if self.cfg.lambda_info > 0 else self.cfg.random_ae_prob

    def draws(self, step: int, n: int) -> Dict[str, torch.Tensor]:
        """The step's random draws for a global batch of n: the VAE noise,
        the prior noise and the
        AE-or-prior coin; with disturb_real_batch_mask the uniforms of the
        target, face and real masks; with lambda_info the re-encode's VAE
        noise."""
        cfg = self.cfg
        gen = step_generator(self.seed, step)
        out = {'eps_vae': torch.randn((n, cfg.hair_dim), generator=gen),
               'real_noise': torch.randn((n, cfg.hair_dim), generator=gen),
               'use_ae': torch.rand((), generator=gen) < self.ae_prob()}
        if cfg.disturb_real_batch_mask:
            shape = (n, cfg.img_size, cfg.img_size, 19)
            for k in ('dist_target', 'dist_face', 'dist_real'):
                out[k] = torch.rand(shape, generator=gen)
        if cfg.lambda_info > 0:
            out['eps_info'] = torch.randn((n, cfg.hair_dim), generator=gen)
        return {k: to_device(v, self.device) for k, v in out.items()}

    # ------------------------------------------------------------------ step
    @staticmethod
    def _sample(gen: ShapeGenerator, hair: torch.Tensor, eps: torch.Tensor):
        """The VAE encode of `hair` sampled with the noise `eps`: (code,
        mean, std)."""
        _, mean, std = gen.encode_hair(hair)
        if std is None:
            return mean, mean, None
        return eps * std + mean, mean, std

    def _forward(self, gen: ShapeGenerator, batch, draws):
        cfg = self.cfg
        target, face_mask = batch['target'], batch['face']
        if cfg.disturb_real_batch_mask:
            target = disturb_real(target, draws['dist_target'])
            face_mask = disturb_real(face_mask, draws['dist_face'])
        ae_in_hair, ae_in_target_face = split_hair_face(target)
        _, ae_in_face = split_hair_face(face_mask)
        hair_code, hair_mean, hair_std = self._sample(gen, ae_in_hair,
                                                      draws['eps_vae'])
        face_code = gen.encode_face(ae_in_face)
        ae_hair_logit, ae_face_logit = gen.decode_logits(hair_code,
                                                         face_code)
        ae_out_mask = gen.merge_logits(ae_hair_logit, ae_face_logit)
        real_noise = draws['real_noise']
        gan_mid_mask = gen.merge_logits(
            gen.decode_hair_logit(real_noise, face_code), ae_face_logit)
        out = dict(ae_in_hair=ae_in_hair,
                   ae_in_target_face=ae_in_target_face,
                   hair_code=hair_code, hair_mean=hair_mean,
                   hair_std=hair_std, ae_out_mask=ae_out_mask,
                   real_noise=real_noise,
                   fake_for_dis=torch.where(draws['use_ae'], ae_out_mask,
                                            gan_mid_mask))
        if cfg.lambda_info > 0:
            # the prior decode's hair channel, re-encoded with sampling on
            gan_mid_hair, _ = split_hair_face(gan_mid_mask)
            out['gan_out_hair_code'] = self._sample(
                gen, gan_mid_hair, draws['eps_info'])[0]
        return out

    def _g_losses(self, gen, dis, dz, f, batch) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        mesh = self.mesh
        lg = {'lambda_adv': L.gan_loss_g(cfg.gan_type,
                                         dis(f['fake_for_dis']))}
        hair, face = split_hair_face(f['ae_out_mask'])
        lg['lambda_hair'] = _masked_mean(-torch.log(hair + 1e-5),
                                         f['ae_in_hair'] > 0.5, mesh)
        lg['lambda_non_hair'] = _masked_mean(-torch.log(1 - hair + 1e-5),
                                             f['ae_in_hair'] < 0.5, mesh)
        lg['lambda_face'] = _masked_mean(-torch.log(face + 1e-5),
                                         f['ae_in_target_face'] > 0.5, mesh)
        # self-reconstruction through the donor mask, at the posterior mean
        hair_hair, hair_face = split_hair_face(batch['hair'])
        donor_mask = gen.decode(gen.encode_hair(hair_hair)[1],
                                gen.encode_face(hair_face))
        lg['lambda_self_rec'] = _masked_mean(-torch.log(donor_mask + 1e-5),
                                             batch['hair'] > 0.5, mesh)
        lg['lambda_kl'] = (
            L.kl_loss_free_bits(f['hair_mean'], f['hair_std'],
                                cfg.kl_free_bits, mesh=mesh)
            if cfg.kl_free_bits > 0
            else L.kl_loss(f['hair_mean'], f['hair_std']))
        if cfg.lambda_geo > 0:
            pred = gen.geo_head(f['hair_mean'])
            target = geo_stats(f['ae_in_hair']).detach()
            lg['lambda_geo'] = torch.mean((pred - target) ** 2)
        if cfg.lambda_moment_1 > 0:
            lg['lambda_moment_1'] = torch.mean(
                batch_mean(f['hair_code'], mesh) ** 2)
        if cfg.lambda_moment_2 > 0:
            lg['lambda_moment_2'] = torch.mean(
                (batch_mean(f['hair_code'] ** 2, mesh) - 0.973) ** 2)
        if cfg.lambda_info > 0:
            lg['lambda_info'] = torch.mean(
                (f['gan_out_hair_code'] - f['real_noise']) ** 2)
        lg['lambda_adv_noise'] = L.gan_loss_g(cfg.gan_type,
                                              dz(f['hair_code']))
        return lg

    def train_step(self, state: GANTrainState,
                   batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]] = None):
        """One step in place; returns (state, metrics).  batch: one-hot
        masks 'target', 'face', 'hair', 'real' [N,S,S,19]."""
        cfg = self.cfg
        sch = self.schedule
        step = state.step
        gen, dis, dz = (state.gen.module, state.dis.module,
                        state.dis_noise.module)
        mesh = self.mesh
        if draws is None:
            draws = self.draws(step, batch['target'].shape[0]
                               * world_size(mesh))
        draws = {k: local_rows(v, mesh) if v.dim() else v
                 for k, v in draws.items()}
        real_batch = batch['real']
        if cfg.disturb_real_batch_mask:
            real_batch = disturb_real(real_batch, draws['dist_real'])

        f = self._forward(gen, batch, draws)

        # D step
        ld = {'lambda_adv': L.gan_loss_d(cfg.gan_type, dis(real_batch),
                                         dis(f['fake_for_dis'].detach()))}
        if cfg.lambda_gp_0 > 0:
            ld['lambda_gp_0'] = L.r0_gradient_penalty(dis, real_batch)
        d_total = sch.total(ld, step)
        d_grads = param_grads(d_total, state.dis.params())

        # G step against the pre-update discriminators
        lg = self._g_losses(gen, dis, dz, f, batch)
        g_total = sch.total(lg, step)
        g_grads = param_grads(g_total, state.gen.params())

        # latent-prior discriminator step
        real_noise = f['real_noise']
        fake_code = f['hair_code'].detach()
        dz_total = L.gan_loss_d(cfg.gan_type, dz(real_noise), dz(fake_code))
        if cfg.lambda_gp_0_noise > 0:
            dz_total = dz_total + cfg.lambda_gp_0_noise * \
                L.r0_gradient_penalty(dz, real_noise)
        dz_grads = param_grads(dz_total, state.dis_noise.params())

        d_grads, g_grads, dz_grads = reduce_grads(mesh, d_grads, g_grads,
                                                  dz_grads)
        finite = grads_finite(d_grads) & grads_finite(g_grads) & \
            grads_finite(dz_grads)
        safe_apply_updates(state.gen, g_grads, finite)
        safe_apply_updates(state.dis, d_grads, finite)
        safe_apply_updates(state.dis_noise, dz_grads, finite)
        state.step += 1
        metrics: Dict[str, Any] = {'d_total': d_total.detach(),
                                   'g_total': g_total.detach(),
                                   'dz_total': dz_total.detach(),
                                   'finite': finite}
        metrics.update({f'g/{k}': v.detach() for k, v in lg.items()})
        return state, global_metrics(metrics, mesh)


def synthetic_batch(gen: torch.Generator, cfg: ShapeConfig,
                    batch_size: int, device=None) -> Dict[str, torch.Tensor]:
    """Random one-hot masks with the warp pool's contract: 'target',
    'face', 'hair' and 'real' [N,S,S,19], each the one-hot of the argmax of
    normal logits."""
    s = cfg.img_size

    def one_hot_mask():
        logits = torch.randn((batch_size, s, s, 19), generator=gen,
                             device=gen.device)
        return label_to_one_hot(torch.argmax(logits, dim=-1)).to(device)

    return {k: one_hot_mask() for k in ('target', 'face', 'hair', 'real')}
