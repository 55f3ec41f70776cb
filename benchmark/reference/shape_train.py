"""CtrlHair's shape branch (the hair-mask VAE-GAN, config 054__shape_final)
in one training step, in float32 over the state dict of the families
`gen.` (the hair VAE, the face encoder and the two mask decoders), `dis.`
(the mask discriminator) and `dis_noise.` (the latent-prior MLP).

Masks are NHWC one-hot [N, S, S, 19]; channel 13 is the hair.  A mask
encoder concatenates the mask with a Fourier positional grid (sin then
cos, 10 orders, the x and y coordinates in [0, 1)), then `layer_num`
strided 4x4 convs (pad 1), each followed by the sample layer norm in the
generator (none in the discriminator) and a leaky ReLU of slope 0.2,
flattens in NHWC order and applies a dense head (the hair VAE also a
second head whose absolute value is the std).  A mask decoder maps its
code by a dense layer to a [s, s, C] grid (NHWC order), then `layer_num`
times a nearest 2x upsample, a 3x3 conv (pad 1), the sample layer norm and
the leaky ReLU, and a last 3x3 conv to its logits.  The mask is the
softmax over the face decoder's 18 logits with the hair decoder's logit
put in at channel 13.

One step, from the weights and the step's draws (`eps_vae`,
`real_noise`, `use_ae`):
  forward  the VAE encode of the target's hair, sampled by eps_vae; the
           encode of the face mask's face; the AE decode; the prior decode
           of real_noise through the same face code, with the AE's face
           logits; `use_ae` picks which of the two D sees;
  D        hinge on D(real) and D(fake, gradient stopped), plus
           lambda_gp_0 x R0 on the reals: mean over samples of
           |d sum D(x) / dx|^2, its gradient taken through a double
           backward;
  G        against the pre-update D: hinge2 on D(fake), the masked
           cross-entropies of the hair channel where the target holds hair
           and where it does not, of the face channels where the target's
           face holds, the self-reconstruction of the donor mask at its
           posterior mean, the KL of the hair posterior in its var-log form,
           and hinge2 of the latent-prior D on the sampled hair code;
  Dz       hinge on Dz(real_noise) and Dz(hair code, gradient stopped),
           plus lambda_gp_0_noise x R0 on real_noise;
then one Adam step each (bias-corrected, eps 1e-8), all three behind one
flag that every gradient is finite.

Departures from the published description: the masks of a batch are the
benchmark's synthetic one-hot masks, not warped CelebAMask-HQ parsings;
the options CtrlHair's config leaves off (`lambda_info`, the two moment
losses, `disturb_real_batch_mask`, and the port's own `kl_free_bits` and
`lambda_geo`) are not modelled, and a configuration that turns one on is
refused; the losses' weights are constants, as 054 schedules none.
`r0_first_order` takes D's R0 input gradient without create_graph, so the
penalty gives D no gradient (a planted fault of the calibration).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping

import numpy as np
import torch

from benchmark.reference.nn import (
    FLOAT32, conv, dense, lrelu, sample_layer_norm, upsample2x)

HAIR = 13
FAMILIES = ('gen.', 'dis.', 'dis_noise.')
OFF = {'lambda_info': 0.0, 'lambda_moment_1': 0.0, 'lambda_moment_2': 0.0,
       'disturb_real_batch_mask': False, 'kl_free_bits': 0.0,
       'lambda_geo': 0.0}
REQUIRED = {'g_norm': 'ln', 'd_norm': 'none', 'gan_type': 'hinge2',
            'vae_hair_mode': True}


def check_config(cfg: Mapping) -> None:
    """Refuse what the reference does not model."""
    for k, v in OFF.items():
        if cfg.get(k, v) != v:
            raise ValueError(f'the reference models no {k}={cfg[k]!r}')
    for k, v in REQUIRED.items():
        if cfg.get(k, v) != v:
            raise ValueError(f'the reference models only {k}={v!r}')


def pos_grid(size: int, order: int, device) -> torch.Tensor:
    """[4 * order, S, S] float32: sin(2^k pi c) then cos(2^k pi c), k over
    the orders, c the x then the y coordinate of each pixel (i / S),
    computed in float64."""
    c = np.linspace(0.0, 1.0, size, endpoint=False)
    xy = np.stack(np.meshgrid(c, c), 0)                 # [2, S, S]
    f = (2.0 ** np.arange(order) * math.pi)[:, None, None, None]
    grid = np.concatenate([np.sin(f * xy), np.cos(f * xy)], 0)
    return torch.tensor(grid.reshape(-1, size, size).astype(np.float32),
                        device=device)


def split(mask: torch.Tensor):
    """(hair [..., 1], face [..., 18]) of a 19-channel NHWC mask."""
    return (mask[..., HAIR:HAIR + 1],
            torch.cat([mask[..., :HAIR], mask[..., HAIR + 1:]], -1))


def encoder(p, pre: str, cfg: Mapping, mask, norm: bool, vae: bool):
    """-> (mean, std or None)."""
    n = mask.shape[0]
    pos = pos_grid(cfg['img_size'], cfg['pos_encoding_order'], mask.device)
    x = torch.cat([mask.permute(0, 3, 1, 2), pos.expand(n, -1, -1, -1)], 1)
    for i in range(cfg['layer_num']):
        x = conv(FLOAT32, p, f'{pre}.down_{i}.conv.conv', x, 2, 1)
        if norm:
            x = sample_layer_norm(p, f'{pre}.down_{i}.norm', x)
        x = lrelu(x)
    x = x.permute(0, 2, 3, 1).reshape(n, -1)
    mean = dense(FLOAT32, p, f'{pre}.out.fc', x)
    if not vae:
        return mean, None
    return mean, torch.abs(dense(FLOAT32, p, f'{pre}.std_out.fc', x))


def decoder(p, pre: str, cfg: Mapping, code):
    """-> logits NCHW."""
    layers = cfg['layer_num']
    ch = min(32 * 2 ** layers, cfg['max_channel'])
    s = cfg['img_size'] // 2 ** layers
    x = dense(FLOAT32, p, f'{pre}.in_layer.fc', code)
    x = x.reshape(-1, s, s, ch).permute(0, 3, 1, 2)
    for i in range(layers):
        x = conv(FLOAT32, p, f'{pre}.up_{i}.conv.conv', upsample2x(x), 1, 1)
        x = lrelu(sample_layer_norm(p, f'{pre}.up_{i}.norm', x))
    return conv(FLOAT32, p, f'{pre}.out.conv.conv', x, 1, 1)


def mask_of(g, cfg, hair_code, face_code, face_logit=None):
    """The decoded soft mask, NHWC, the softmax taken over the channels of
    the merged NHWC logits; `face_logit` the face decoder's NHWC logits
    when already computed -> (mask, face_logit)."""
    if face_logit is None:
        face_logit = decoder(g, 'gen.face_decoder', cfg,
                             face_code).permute(0, 2, 3, 1)
    hair = decoder(g, 'gen.hair_decoder', cfg,
                   torch.cat([face_code, hair_code], -1)).permute(0, 2, 3, 1)
    logit = torch.cat([face_logit[..., :HAIR], hair, face_logit[..., HAIR:]],
                      -1)
    return torch.softmax(logit, -1), face_logit


def dis(p, cfg, mask):
    return encoder(p, 'dis.dis', cfg, mask, False, False)[0]


def dis_noise(p, cfg, code):
    x = code
    for i in range(cfg['d_noise_hidden_layer_num']):
        x = lrelu(dense(FLOAT32, p, f'dis_noise.net.layer_{i}.fc', x))
    return dense(FLOAT32, p, 'dis_noise.net.head.fc', x)


def hinge_d(real, fake):
    return torch.mean(torch.clamp_min(1 - real, 0.0)) \
        + torch.mean(torch.clamp_min(1 + fake, 0.0))


def hinge2_g(fake):
    return torch.mean(torch.clamp_min(1 - fake, 0.0))


def r0(critic, x, create_graph: bool = True):
    """mean over samples of |d sum critic(x) / dx|^2."""
    x = x.detach().requires_grad_(True)
    g = torch.autograd.grad(critic(x).sum(), x, create_graph=create_graph)[0]
    return torch.mean(torch.sum(g.reshape(g.shape[0], -1) ** 2, 1))


def masked_mean(values, mask):
    m = mask.float()
    return torch.sum(values * m) / torch.clamp_min(torch.sum(m), 1.0)


def trained_names(p: Mapping[str, torch.Tensor]) -> Dict[str, List[str]]:
    return {fam: sorted(k for k in p if k.startswith(fam))
            for fam in FAMILIES}


class State:
    """Parameters, and Adam's moments and count a family."""

    def __init__(self, p: Mapping[str, torch.Tensor]):
        self.p = {k: v.detach().clone() for k, v in p.items()}
        self.names = trained_names(self.p)
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0


def adam(state: State, names, grads, lr: float, b1: float, b2: float):
    """Bias-corrected Adam, eps 1e-8; the corrections 1 - beta^count in
    float32, as optax takes the power of its int32 count."""
    c = torch.tensor(float(state.count + 1), dtype=torch.float32,
                     device=grads[0].device)
    bc1, bc2 = 1 - torch.pow(b1, c), 1 - torch.pow(b2, c)
    for k, gr in zip(names, grads):
        state.mu[k] = (1 - b1) * gr + b1 * state.mu[k]
        state.nu[k] = (1 - b2) * (gr * gr) + b2 * state.nu[k]
        state.p[k] = state.p[k] - lr * ((state.mu[k] / bc1) / (
            torch.sqrt(state.nu[k] / bc2) + 1e-8))


def step(state: State, cfg: Mapping, batch: Mapping[str, torch.Tensor],
         draws: Mapping[str, torch.Tensor], r0_first_order: bool = False
         ) -> Dict[str, float]:
    """One D, G and Dz update of `state` in place -> the three losses and
    G's terms (`g/<weight's name>`), unweighted.  `cfg` holds ShapeConfig's
    fields."""
    check_config(cfg)
    names = state.names
    p = {k: state.p[k].detach().requires_grad_(True)
         for fam in FAMILIES for k in names[fam]}
    target, real = batch['target'], batch['real']
    t_hair, t_face = split(target)
    _, f_face = split(batch['face'])

    # the shared forward
    mean, std = encoder(p, 'gen.hair_encoder', cfg, t_hair, True, True)
    code = draws['eps_vae'] * std + mean
    face_code = encoder(p, 'gen.face_encoder', cfg, f_face, True, False)[0]
    ae, face_logit = mask_of(p, cfg, code, face_code)
    prior, _ = mask_of(p, cfg, draws['real_noise'], face_code, face_logit)
    fake = torch.where(draws['use_ae'], ae, prior)

    # D
    crit = lambda x: dis(p, cfg, x)
    d_total = hinge_d(crit(real), crit(fake.detach())) + cfg['lambda_gp_0'] \
        * r0(crit, real, create_graph=not r0_first_order)

    # G, against the pre-update D
    hair, face = split(ae)
    d_hair, d_face = split(batch['hair'])
    d_mean = encoder(p, 'gen.hair_encoder', cfg, d_hair, True, True)[0]
    d_code = encoder(p, 'gen.face_encoder', cfg, d_face, True, False)[0]
    donor, _ = mask_of(p, cfg, d_mean, d_code)
    var = std ** 2
    terms = (
        ('lambda_adv', hinge2_g(crit(fake))),
        ('lambda_hair', masked_mean(-torch.log(hair + 1e-5), t_hair > 0.5)),
        ('lambda_non_hair', masked_mean(-torch.log(1 - hair + 1e-5),
                                        t_hair < 0.5)),
        ('lambda_face', masked_mean(-torch.log(face + 1e-5), t_face > 0.5)),
        ('lambda_self_rec', masked_mean(-torch.log(donor + 1e-5),
                                        batch['hair'] > 0.5)),
        ('lambda_kl', 0.5 * torch.mean(mean ** 2 + var - 1.0
                                       - torch.log(var + 1e-4))),
        ('lambda_adv_noise', hinge2_g(dis_noise(p, cfg, code))))
    g_total = sum(cfg[k] * v for k, v in terms)

    # Dz
    zcrit = lambda x: dis_noise(p, cfg, x)
    dz_total = hinge_d(zcrit(draws['real_noise']), zcrit(code.detach())) \
        + cfg['lambda_gp_0_noise'] * r0(zcrit, draws['real_noise'])

    grads = {}
    for fam, loss in (('dis.', d_total), ('gen.', g_total),
                      ('dis_noise.', dz_total)):
        got = torch.autograd.grad(loss, [p[k] for k in names[fam]],
                                  retain_graph=True, allow_unused=True)
        grads[fam] = [torch.zeros_like(p[k]) if gr is None else gr
                      for k, gr in zip(names[fam], got)]
    finite = all(bool(torch.isfinite(gr).all())
                 for fam in FAMILIES for gr in grads[fam])
    if finite:
        with torch.no_grad():
            for fam, lr in (('gen.', cfg['lr_g']), ('dis.', cfg['lr_d']),
                            ('dis_noise.', cfg['lr_dz'])):
                adam(state, names[fam], grads[fam], lr, cfg['beta1'],
                     cfg['beta2'])
        state.count += 1
    out = {'g_total': g_total, 'd_total': d_total, 'dz_total': dz_total,
           **{f'g/{k}': v for k, v in terms}}
    return {k: float(v.detach()) for k, v in out.items()}
