"""SEAN's training step (pix2pix losses, TTUR Adam) in float32 over the
state dict of the families `sean.`, `dis.` and `vgg.`.

G: encode the batch, decode it in train mode under spectrally normalised
   conv_0 / conv_1 / conv_s kernels; the hinge loss of the two-scale
   PatchGAN on (one-hot label ++ image), feature matching over every
   discriminator layer but the last with the real side held fixed, and
   the VGG19 term over relu1_1 ... relu5_1 with weights 1/32 ... 1.
D: the hinge loss on the same real and fake pairs, every kernel
   spectrally normalised.
Each side takes one Adam step (bias-corrected, eps 1e-8) on its own
gradient; each power-iteration vector u advances by one iteration from
the weights before the update.  The gradient flows through the
normalisation (v, u and sigma), as the configuration's trainer defines it.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference import sean
from benchmark.reference.nn import FLOAT32, conv, instance_norm, lrelu, one_hot, sub

VGG_PLAN = (0, 1, 'M', 2, 3, 'M', 4, 5, 6, 7, 'M', 8, 9, 10, 11, 'M', 12)
VGG_SLICES = (0, 2, 4, 8, 12)            # relu1_1, 2_1, 3_1, 4_1, 5_1
VGG_WEIGHTS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1.0)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
G_SN_LAYERS = ('conv_0', 'conv_1', 'conv_s')


def g_sn_names(p: Mapping[str, torch.Tensor]) -> List[str]:
    """The generator kernels under spectral norm: every 4-d weight of a
    layer named conv_0, conv_1 or conv_s (names without the family)."""
    return [k for k, v in sub(p, 'sean.').items()
            if v.dim() == 4 and k.endswith('.weight')
            and any(part in G_SN_LAYERS for part in k.split('.'))]


def d_sn_names(p: Mapping[str, torch.Tensor]) -> List[str]:
    return [k for k, v in sub(p, 'dis.').items() if v.dim() == 4]


def sn_matrix(w: torch.Tensor) -> torch.Tensor:
    """An OIHW kernel as the [kh*kw*in, out] matrix whose top singular
    value divides it."""
    return w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])


def spectral_normalize(w, u) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w / sigma, the advanced u) by one power iteration, 1e-12 guards."""
    mat = sn_matrix(w)
    v = mat.t() @ u
    v = v / (torch.linalg.vector_norm(v) + 1e-12)
    u = mat @ v
    u = u / (torch.linalg.vector_norm(u) + 1e-12)
    return w / (u @ (mat @ v)), u.detach()


def discriminator(p, x, num_d: int, n_layers: int):
    """Per scale, the PatchGAN's features: C64 ... C512 (4x4, pad 2,
    stride 2 but the last), instance norm after the first, then a 1-channel
    conv; the input average-pooled (3x3, stride 2, pad 1, the padding not
    counted) between scales."""
    outs = []
    for i in range(num_d):
        pre = f'scale_{i}'
        h = lrelu(conv(FLOAT32, p, f'{pre}.layer0.conv', x, 2, 2))
        feats = [h]
        for j in range(1, n_layers):
            stride = 1 if j == n_layers - 1 else 2
            h = lrelu(instance_norm(conv(FLOAT32, p, f'{pre}.layer{j}.conv',
                                         h, stride, 2)))
            feats.append(h)
        feats.append(conv(FLOAT32, p, f'{pre}.out.conv', h, 1, 2))
        outs.append(feats)
        if i != num_d - 1:
            x = F.avg_pool2d(x.contiguous(), 3, 2, 1,
                             count_include_pad=False)
    return outs


def vgg19(p, img_m11):
    """[-1,1] NHWC -> the five VGG19 slices of the ImageNet-normalised
    image."""
    mean = torch.tensor(IMAGENET_MEAN, device=img_m11.device)
    std = torch.tensor(IMAGENET_STD, device=img_m11.device)
    x = (((img_m11 + 1) / 2 - mean) / std).permute(0, 3, 1, 2)
    out = []
    for step in VGG_PLAN:
        if step == 'M':
            x = F.max_pool2d(x, 2, 2)
            continue
        x = torch.relu(conv(FLOAT32, p, f'conv_{step}.conv', x, 1, 1))
        if step in VGG_SLICES:
            out.append(x)
    return out


def losses(p, g_sn, d_sn, cfg: Mapping, img, label):
    """(G's total, D's total) of one batch; `g_sn`, `d_sn` the normalised
    kernels by name (families dropped)."""
    scfg, tr = cfg['sean'], cfg['trainer']
    g = {**sub(p, 'sean.'), **g_sn}
    d = {**sub(p, 'dis.'), **d_sn}
    fake = sean.decode(g, scfg, label, sean.encode(g, scfg, img, label),
                       train=True)
    lab = one_hot(label, scfg['semantic_nc'])
    num_d, n_layers = tr['dis_num_d'], tr['dis_n_layers']
    ff = discriminator(d, torch.cat([lab, fake.permute(0, 3, 1, 2)], 1),
                       num_d, n_layers)
    fr = discriminator(d, torch.cat([lab, img.permute(0, 3, 1, 2)], 1),
                       num_d, n_layers)
    adv = sum(-torch.mean(f[-1]) for f in ff) / num_d
    fm = sum(torch.mean(torch.abs(a - b.detach()))
             for f, r in zip(ff, fr) for a, b in zip(f[:-1], r[:-1])) / num_d
    vggp = sub(p, 'vgg.')
    vf = vgg19(vggp, fake)
    with torch.no_grad():
        vr = vgg19(vggp, img)
    vgg = sum(w * torch.mean(torch.abs(a - b))
              for w, a, b in zip(VGG_WEIGHTS, vf, vr))
    g_total = adv + tr['lambda_feat'] * fm + tr['lambda_vgg'] * vgg
    d_total = sum(torch.mean(torch.relu(1 - r[-1]))
                  + torch.mean(torch.relu(1 + f[-1]))
                  for r, f in zip(fr, ff)) / num_d
    return g_total, d_total


def trained_names(p: Mapping[str, torch.Tensor]) -> Tuple[List[str], List[str]]:
    """(generator, discriminator) parameter names, families kept: every
    float leaf but the running statistics."""
    stats = ('running_mean', 'running_var')
    gen = [k for k in p if k.startswith('sean.') and not k.endswith(stats)]
    dis = [k for k in p if k.startswith('dis.')]
    return gen, dis


class State:
    """Parameters, Adam's moments and count, and the u vectors (by name,
    families kept)."""

    def __init__(self, p: Mapping[str, torch.Tensor],
                 u: Mapping[str, torch.Tensor]):
        self.p = {k: v.detach().clone() for k, v in p.items()}
        self.u = {k: v.detach().clone() for k, v in u.items()}
        self.gen, self.dis = trained_names(self.p)
        self.mu = {k: torch.zeros_like(self.p[k]) for k in self.gen + self.dis}
        self.nu = {k: torch.zeros_like(self.p[k]) for k in self.gen + self.dis}
        self.count = 0


def adam(state: State, names, grads, lr: float, b1: float, b2: float):
    c = state.count + 1
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    for k, gr in zip(names, grads):
        state.mu[k] = (1 - b1) * gr + b1 * state.mu[k]
        state.nu[k] = (1 - b2) * gr * gr + b2 * state.nu[k]
        state.p[k] = state.p[k] - lr * (state.mu[k] / bc1) / (
            torch.sqrt(state.nu[k] / bc2) + 1e-8)


def step(state: State, cfg: Mapping, batch: Mapping[str, torch.Tensor]
         ) -> Dict[str, float]:
    """One G and one D update of `state` in place -> the two losses."""
    tr = cfg['trainer']
    leaves = {k: state.p[k].detach().requires_grad_(True)
              for k in state.gen + state.dis}
    p = {**state.p, **leaves}
    g_sn, d_sn, new_u = {}, {}, {}
    for name in g_sn_names(p):
        g_sn[name], new_u['sean.' + name] = spectral_normalize(
            p['sean.' + name], state.u['sean.' + name])
    for name in d_sn_names(p):
        d_sn[name], new_u['dis.' + name] = spectral_normalize(
            p['dis.' + name], state.u['dis.' + name])
    g_total, d_total = losses(p, g_sn, d_sn, cfg, batch['image'],
                              batch['label'])
    g_grads = torch.autograd.grad(g_total, [leaves[k] for k in state.gen],
                                  retain_graph=True, allow_unused=True)
    d_grads = torch.autograd.grad(d_total, [leaves[k] for k in state.dis],
                                  allow_unused=True)
    fill = lambda names, grads: [torch.zeros_like(state.p[k]) if gr is None
                                 else gr for k, gr in zip(names, grads)]
    with torch.no_grad():
        adam(state, state.gen, fill(state.gen, g_grads), tr['lr_g'],
             tr['beta1'], tr['beta2'])
        adam(state, state.dis, fill(state.dis, d_grads), tr['lr_d'],
             tr['beta1'], tr['beta2'])
    state.count += 1
    state.u.update(new_u)
    return {'g_total': float(g_total.detach()),
            'd_total': float(d_total.detach())}
