"""Model operations of one training step of the shape VAE-GAN (054): the
convolutions and dense layers of every pass, a batch of n.

  forward   the hair encoder twice (the target's hair, the donor's), the
            face encoder twice (the face mask's face, the donor's), the
            hair decoder three times (the AE decode, the prior decode, the
            donor's), the face decoder twice (AE, donor); the mask
            discriminator D four times (the reals and the stopped fake in
            D's loss, the reals again under R0, the fake in G's loss); the
            latent-prior MLP Dz four times (the hair code in G's loss,
            real_noise and the stopped code in Dz's loss, real_noise again
            under R0);
  backward  twice the forward of each pass above but the two under R0;
  R0        for D and for Dz, the input gradient taken with create_graph
            (a data gradient a layer: once the pass's forward) and the
            double backward through it (a data and a weight gradient a
            layer: twice its forward), so three times the forward of the
            pass under R0 beyond that forward.
A step is then 3 x the forward passes + D's and Dz's forward once more.
"""

from typing import Mapping

from benchmark.flops.common import conv, dense
from benchmark.flops.edit import _mask_decoder


def encoder(sh: Mapping, n: int, in_ch: int, hidden: int, out_dim: int,
            heads: int = 1) -> int:
    """A mask encoder over in_ch mask channels and the positional grid,
    `heads` dense heads."""
    size, ch = sh['img_size'], in_ch + 4 * sh['pos_encoding_order']
    total = 0
    for i in range(sh['layer_num']):
        out = min(sh['max_channel'], 2 ** i * hidden)
        total += conv(n, ch, out, 4, (size // 2 ** (i + 1)) ** 2)
        ch = out
    flat = ch * (size // 2 ** sh['layer_num']) ** 2
    return total + heads * dense(n, flat, out_dim)


def hair_encoder(sh: Mapping, n: int) -> int:
    return encoder(sh, n, 1, sh['hidden_in_channel'], sh['hair_dim'], 2)


def face_encoder(sh: Mapping, n: int) -> int:
    return encoder(sh, n, 18, sh['hidden_in_channel'], sh['face_dim'])


def hair_decoder(sh: Mapping, n: int) -> int:
    return _mask_decoder(sh, n, sh['face_dim'] + sh['hair_dim'], 1)


def face_decoder(sh: Mapping, n: int) -> int:
    return _mask_decoder(sh, n, sh['face_dim'], 18)


def dis(sh: Mapping, n: int) -> int:
    return encoder(sh, n, 19, sh['d_hidden_in_channel'], 1)


def dis_noise(sh: Mapping, n: int) -> int:
    h, layers = sh['d_hidden_dim'], sh['d_noise_hidden_layer_num']
    return (dense(n, sh['hair_dim'], h) + (layers - 1) * dense(n, h, h)
            + dense(n, h, 1))


def forward(sh: Mapping, n: int) -> int:
    """Every forward pass of a step."""
    return (2 * hair_encoder(sh, n) + 2 * face_encoder(sh, n)
            + 3 * hair_decoder(sh, n) + 2 * face_decoder(sh, n)
            + 4 * dis(sh, n) + 4 * dis_noise(sh, n))


def step(sh: Mapping, n: int) -> int:
    return 3 * forward(sh, n) + dis(sh, n) + dis_noise(sh, n)
