# The float32 conv split over halves of its output or input channels
# (models/layers.conv_split) and the rule that routes a Conv to it
# (layers.split_axis over layers.FFT_SHAPES).  The rule over named cases:
# it routes SEAN's up_2.conv_0 shape in float32 on cuDNN over its output
# channels and a data-gradient shape over its input channels, and never
# bfloat16, float16, float64, a tensor cuDNN does not take (the CPU), a
# 1x1, 4x4 or strided conv, TF32 on, a batch of 1, or the shapes cuDNN
# runs without FFT.  The split against F.conv2d in forward, data gradient
# and weight gradient (float64 within 1e-12 of the largest magnitude,
# float32 within 1e-5); gradcheck and gradgradcheck in float64; a Conv
# routed to it (the rule forced, as the CPU has no cuDNN) opens one
# `conv_split` span a call, inside recording() only, and a Conv the rule
# leaves alone opens none.  On the CPU.
import pytest
import torch
import torch.nn.functional as F

from ctrlhair_tpu_torch.models import layers
from ctrlhair_tpu_torch.models.layers import (
    FFT_SHAPES, Conv, conv_split, split_axis)
from ctrlhair_tpu_torch.utils import profiling

F32 = torch.float32
UP_2 = ((4, 256, 128, 128), (128, 256, 3, 3))     # SEAN's up_2.conv_0


def case(x=UP_2[0], w=UP_2[1], stride=(1, 1), dtype=F32, on_cudnn=True,
         tf32=False):
    return x, w, stride, dtype, on_cudnn, tf32


ROUTED = {
    'up_2.conv_0': (case(), 'out'),
    'up_2.conv_0 at batch 2': (case(x=(2, 256, 128, 128)), 'out'),
    'up_0.conv_0 (a data gradient)': (
        case(x=(4, 1024, 32, 32), w=(512, 1024, 3, 3)), 'in'),
}
NOT_ROUTED = {
    'bfloat16': case(dtype=torch.bfloat16),
    'float16': case(dtype=torch.float16),
    'float64': case(dtype=torch.float64),
    'not on cuDNN (a CPU tensor)': case(on_cudnn=False),
    'TF32 on': case(tf32=True),
    '1x1 kernel': case(w=(128, 256, 1, 1)),
    '4x4 kernel': case(w=(128, 256, 4, 4)),
    'stride 2': case(stride=(2, 2)),
    'batch 1': case(x=(1, 256, 128, 128)),
    'batch 32': case(x=(32, 256, 128, 128)),
    '96x96 map at batch 2': case(x=(2, 256, 96, 96)),
    '256 to 256 channels': case(w=(256, 256, 3, 3)),
    '256 to 255 channels': case(w=(255, 256, 3, 3)),
    '128 channels in': case(x=(4, 128, 128, 128), w=(64, 128, 3, 3)),
}


@pytest.mark.parametrize('name', sorted(ROUTED))
def test_rule_routes(name):
    args, axis = ROUTED[name]
    assert split_axis(*args) == axis


@pytest.mark.parametrize('name', sorted(NOT_ROUTED))
def test_rule_does_not_route(name):
    assert split_axis(*NOT_ROUTED[name]) is None


def test_rule_lists_even_channel_splits():
    """Every listed class halves evenly along an axis conv_split knows, over
    a batch range that is not empty."""
    for (cin, cout, h, w), (axis, lo, hi) in FFT_SHAPES.items():
        assert axis in ('out', 'in')
        assert (cout if axis == 'out' else cin) % 2 == 0
        assert 1 <= lo <= hi


def grads(fn, x, w, b, go):
    y = fn(x, w, b)
    leaves = (x, w) if b is None else (x, w, b)
    return (y,) + torch.autograd.grad(y, leaves, go)


@pytest.mark.parametrize('shape', [
    ((2, 6, 5, 7), (4, 6, 3, 3), True, 1, 1),
    ((3, 5, 4, 4), (5, 5, 3, 3), False, 1, 0),     # odd channel counts
    ((1, 4, 9, 6), (6, 4, 3, 3), True, 2, 1)])
@pytest.mark.parametrize('axis', ['out', 'in'])
@pytest.mark.parametrize('dtype,bar', [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
def test_split_equals_conv2d(dtype, bar, axis, shape):
    """Forward, data gradient, weight gradient (and bias gradient)."""
    xs, ws, with_bias, stride, pad = shape
    gen = torch.Generator().manual_seed(sum(xs) + sum(ws))
    x = torch.randn(xs, generator=gen, dtype=dtype, requires_grad=True)
    w = torch.randn(ws, generator=gen, dtype=dtype, requires_grad=True)
    b = (torch.randn(ws[0], generator=gen, dtype=dtype, requires_grad=True)
         if with_bias else None)
    with torch.no_grad():
        out_shape = F.conv2d(x, w, b, stride, pad).shape
    go = torch.randn(out_shape, generator=gen, dtype=dtype)
    want = grads(lambda x, w, b: F.conv2d(x, w, b, stride, pad), x, w, b, go)
    got = grads(lambda x, w, b: conv_split(x, w, b, (stride,) * 2,
                                           (pad,) * 2, axis), x, w, b, go)
    for name, a, r in zip(('forward', 'data', 'weight', 'bias'), got, want):
        assert a.shape == r.shape, name
        scale = float(r.detach().abs().max())
        assert scale > 0, name
        assert float((a - r).detach().abs().max()) <= bar * scale, name


@pytest.mark.parametrize('axis', ['out', 'in'])
@pytest.mark.parametrize('with_bias', [False, True])
def test_split_gradcheck(with_bias, axis):
    gen = torch.Generator().manual_seed(11)
    x = torch.randn((2, 4, 4, 5), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn((5, 4, 3, 3), generator=gen, dtype=torch.float64,
                    requires_grad=True)
    b = torch.randn(5, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    args = (x, w, b) if with_bias else (x, w)

    def fn(x, w, b=None):
        return conv_split(x, w, b, (1, 1), (1, 1), axis)
    assert torch.autograd.gradcheck(fn, args)
    assert torch.autograd.gradgradcheck(fn, args)


def small_conv(dtype=torch.float64, bias=True):
    conv = Conv(6, 4, 3, 1, 1, bias=bias, dtype=dtype).to(dtype)
    gen = torch.Generator().manual_seed(5)
    conv.reset_parameters(gen)
    if bias:
        with torch.no_grad():
            conv.bias.normal_(generator=gen)
    return conv


@pytest.mark.parametrize('axis', ['out', 'in'])
@pytest.mark.parametrize('bias', [False, True])
def test_routed_conv_equals_its_plain_conv(monkeypatch, bias, axis):
    """A Conv the rule routes: the same output and parameter gradients as
    F.conv2d through its weight and bias, one span a call."""
    conv = small_conv(bias=bias)
    x = torch.randn((3, 6, 8, 8), generator=torch.Generator().manual_seed(6),
                    dtype=torch.float64, requires_grad=True)
    want = F.conv2d(x, conv.weight, conv.bias, 1, 1)
    gw = torch.autograd.grad(want.sin().sum(), [x] + list(conv.parameters()))
    monkeypatch.setattr(layers, 'split_axis', lambda *a: axis)
    profiling.clear()
    with profiling.recording():
        got = conv(x)
    spans = [r for r in profiling.records() if r.name == 'conv_split']
    profiling.clear()
    gg = torch.autograd.grad(got.sin().sum(), [x] + list(conv.parameters()))
    got, want = got.detach(), want.detach()
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
    for a, r in zip(gg, gw):
        assert float((a - r).abs().max()) <= 1e-12 * float(r.abs().max())
    assert [r.attrs for r in spans] == [
        {'n': 3, 'cin': 6, 'cout': 4, 'hw': 64, 'parts': 2}]


def test_span_a_routed_call_inside_recording_only(monkeypatch):
    conv = small_conv()
    x = torch.randn((2, 6, 5, 5), dtype=torch.float64)
    monkeypatch.setattr(layers, 'split_axis', lambda *a: 'out')
    profiling.clear()
    conv(x)
    assert not profiling.records()
    with profiling.recording():
        conv(x)
        conv(x)
    assert [r.name for r in profiling.records()] == ['conv_split'] * 2
    profiling.clear()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_conv_off_cudnn_is_not_routed(dtype):
    """At up_2.conv_0's widths on a tensor cuDNN does not take (the meta
    device: shapes only), and at a small width on the CPU bit for bit as
    F.conv2d: no span."""
    conv = Conv(256, 128, 3, 1, 1, dtype=dtype).to('meta')
    profiling.clear()
    with profiling.recording():
        y = conv(torch.empty(UP_2[0], device='meta'))
        small = Conv(6, 4, 3, 1, 1, dtype=dtype)
        small.reset_parameters(torch.Generator().manual_seed(8))
        x = torch.randn((2, 6, 7, 7), dtype=dtype)
        got = small(x)
    assert y.shape == (4, 128, 128, 128)
    assert not profiling.records()
    want = F.conv2d(x, small.weight.to(dtype), small.bias.to(dtype), 1, 1)
    assert torch.equal(got, want)
