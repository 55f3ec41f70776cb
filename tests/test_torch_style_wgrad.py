# The folded style convolution's weight gradient (models/sean._StyleConv):
# one batched GEMM of the output gradient with the one-hot's 3x3 columns in
# place of autograd through the grouped F.conv2d.  Held to autograd through
# that conv: an ACE's gradients to conv_gamma, conv_beta, fc_mu_kernel and
# the codes (float64 within 1e-12 of each leaf's largest magnitude, float32
# within 1e-5), on batches of 1 to 4, maps of 1x1 to 16x16, labels only on
# the map's border, and a map that is not one-hot; gradcheck in float64; a
# render without gradients takes the grouped conv alone, bit for bit as
# before, and records no span; a differentiated decode records two
# `style_wgrad` spans per styled ACE, also when its blocks are recomputed.
# On the CPU.
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from ctrlhair_tpu_torch.config import SEANConfig
from ctrlhair_tpu_torch.models import sean as S
from ctrlhair_tpu_torch.models.layers import init_parameters_, set_train
from ctrlhair_tpu_torch.utils import profiling
from ctrlhair_tpu_torch.utils.masks import label_to_one_hot

R = 19
TINY = SEANConfig(crop_size=32, ngf=4, zencoder_ngf=4, style_dim=16,
                  spade_hidden=8)


def grouped_conv_autograd(seg, folded):
    """The folded conv as it was differentiated before _StyleConv: autograd
    through the grouped conv (a 1x1 map's view copied contiguous, which the
    CPU's float64 conv needs for its weight gradient)."""
    n, r, h, w = seg.shape
    c = folded.shape[1]
    x = seg.reshape(1, n * r, h, w)
    if h * w == 1:
        x = x.clone(memory_format=torch.contiguous_format)
    out = F.conv2d(x, folded.reshape(n * c, r, 3, 3), padding=1, groups=n)
    return out.reshape(n, c, h, w)


def old_folded_style_conv(self, conv, seg, mu):
    """ACE._folded_style_conv before _StyleConv, line for line."""
    cd = self.dtype
    n, r, h, w = seg.shape
    weight = conv.conv.weight.to(cd)
    c = weight.shape[0]
    folded = torch.einsum('cdyx,nrd->ncryx', weight, mu)
    x = seg.to(cd).reshape(1, n * r, h, w)
    if h * w == 1:
        x = x.clone(memory_format=torch.contiguous_format)
    out = F.conv2d(x, folded.reshape(n * c, r, 3, 3), padding=1, groups=n)
    return out.reshape(n, c, h, w) + conv.conv.bias.to(cd).view(1, c, 1, 1)


def label_map(kind, n, h, w, gen, dtype):
    """[N,R,H,W] as the decode holds it: a permuted one-hot view."""
    lab = torch.randint(0, R, (n, h, w), generator=gen)
    if kind == 'border':
        inner = torch.zeros(h, w, dtype=torch.bool)
        inner[1:-1, 1:-1] = True
        lab = torch.where(inner, torch.full_like(lab, 255), lab)
    seg = label_to_one_hot(lab, R, dtype)
    if kind == 'soft':
        seg = torch.rand(seg.shape, generator=gen, dtype=dtype)
    return seg.permute(0, 3, 1, 2)


def ace_grads(ace, x, seg, codes, go):
    leaves = [ace.conv_gamma.conv.weight, ace.conv_beta.conv.weight,
              ace.fc_mu_kernel, codes]
    out = ace(x, seg, codes)
    return torch.autograd.grad(out, leaves, go)


@pytest.mark.parametrize('kind', ['onehot', 'border', 'soft'])
@pytest.mark.parametrize('n,h,w', [(1, 1, 1), (2, 2, 2), (3, 5, 7),
                                   (4, 16, 16)])
@pytest.mark.parametrize('dtype,bar', [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_ace_gradients_equal_grouped_conv_autograd(monkeypatch, dtype, bar,
                                                   n, h, w, kind):
    gen = torch.Generator().manual_seed(n * 100 + h * 10 + w)
    ace = S.ACE(TINY, 6, dtype=dtype).to(dtype)
    init_parameters_(ace, gen)
    with torch.no_grad():
        ace.blending_gamma.fill_(0.3)
        ace.blending_beta.fill_(-0.2)
    x = torch.randn((n, 6, h, w), generator=gen, dtype=dtype)
    seg = label_map(kind, n, h, w, gen, dtype)
    codes = torch.randn((n, R, TINY.style_dim), generator=gen, dtype=dtype,
                        requires_grad=True)
    go = torch.randn((n, 6, h, w), generator=gen, dtype=dtype)
    got = ace_grads(ace, x, seg, codes, go)
    monkeypatch.setattr(S._StyleConv, 'apply', grouped_conv_autograd)
    want = ace_grads(ace, x, seg, codes, go)
    for name, a, b in zip(('conv_gamma', 'conv_beta', 'fc_mu_kernel',
                           'codes'), got, want):
        scale = float(b.abs().max())
        assert scale > 0, name
        assert float((a - b).abs().max()) <= bar * scale, name


@pytest.mark.parametrize('kind', ['onehot', 'soft'])
def test_style_conv_gradcheck(kind):
    gen = torch.Generator().manual_seed(7)
    seg = label_map(kind, 2, 3, 4, gen, torch.float64)
    folded = torch.randn((2, 3, R, 3, 3), generator=gen, dtype=torch.float64,
                         requires_grad=True)
    assert torch.autograd.gradcheck(lambda f: S._StyleConv.apply(seg, f),
                                    (folded,))
    assert torch.autograd.gradgradcheck(
        lambda f: S._StyleConv.apply(seg, f), (folded,))


def test_style_conv_refuses_a_one_hot_with_gradient():
    seg = torch.rand((1, R, 2, 2), dtype=torch.float64, requires_grad=True)
    folded = torch.randn((1, 2, R, 3, 3), dtype=torch.float64,
                         requires_grad=True)
    with pytest.raises(AssertionError, match='one-hot'):
        S._StyleConv.apply(seg, folded)


def tiny_sean(dtype, remat=False, seed=3):
    model = S.SEAN(dataclasses.replace(TINY, remat_blocks=remat),
                   dtype=dtype)
    init_parameters_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, S.ACE) and m.use_styles:
                m.blending_gamma.fill_(0.4)
                m.blending_beta.fill_(-0.3)
    return model


def decode_inputs(n=2, seed=5):
    gen = torch.Generator().manual_seed(seed)
    label = torch.randint(0, R, (n, 32, 32), generator=gen)
    codes = torch.randn((n, R, TINY.style_dim), generator=gen)
    return label, codes


def styled_aces(model):
    return sum(1 for m in model.modules()
               if isinstance(m, S.ACE) and m.use_styles)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_no_grad_render_is_unchanged_and_records_no_span(monkeypatch, dtype):
    model = tiny_sean(dtype)
    label, codes = decode_inputs()
    profiling.clear()
    with profiling.recording(), torch.no_grad():
        got = model.decode(label, codes)
    assert not [r for r in profiling.records() if r.name == 'style_wgrad']
    monkeypatch.setattr(S.ACE, '_folded_style_conv', old_folded_style_conv)
    with torch.no_grad():
        want = model.decode(label, codes)
    assert torch.equal(got, want)
    profiling.clear()


@pytest.mark.parametrize('remat', [False, True])
def test_differentiated_decode_records_two_spans_per_styled_ace(remat):
    model = tiny_sean(torch.float32, remat=remat)
    set_train(model, True)
    label, codes = decode_inputs(n=3)
    profiling.clear()
    with profiling.recording():
        out = model.decode(label, codes)
        assert not [r for r in profiling.records()
                    if r.name == 'style_wgrad']
        out.square().sum().backward()
    spans = [r for r in profiling.records() if r.name == 'style_wgrad']
    profiling.clear()
    assert styled_aces(model) == 15
    assert len(spans) == 2 * styled_aces(model)
    sizes = {(r.attrs['c'], r.attrs['hw']) for r in spans}
    assert {r.attrs['n'] for r in spans} == {3}
    assert (64, 1) in sizes and (16, 16 * 16) in sizes


def test_decode_gradients_equal_grouped_conv_autograd(monkeypatch):
    """Every generator parameter's gradient through a whole float64 decode
    in train mode, against autograd through the grouped conv."""
    model = tiny_sean(torch.float64).double()
    set_train(model, True)
    label, codes = decode_inputs(n=2)
    codes = codes.double()
    params = [p for _, p in model.generator.named_parameters()]

    def grads():
        out = model.decode(label, codes)
        return torch.autograd.grad(out.sin().sum(), params,
                                   allow_unused=True)
    got = grads()
    monkeypatch.setattr(S._StyleConv, 'apply', grouped_conv_autograd)
    want = grads()
    for (name, _), a, b in zip(model.generator.named_parameters(), got,
                               want):
        if b is None:
            assert a is None, name
            continue
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * max(scale, 1e-30), name
