# The port's losses (ctrlhair_tpu_torch/training/losses.py) against the JAX
# package's on the same arrays: every GAN loss of every gan_type, the KL,
# free-bits, moment and weighted BCE terms, the loss schedule, and both
# gradient penalties by value and by their gradients (with respect to the
# critic's weights and its inputs; the critic is a small MLP with the same
# weights on both sides).  Bar: 1e-6 relative (float32).
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ctrlhair_tpu.config import ColorTextureConfig as JaxCTConfig
from ctrlhair_tpu.training import losses as JL
from ctrlhair_tpu_torch.config import ColorTextureConfig
from ctrlhair_tpu_torch.training import losses as L

RTOL = 1e-6
GAN_TYPES = ['lsgan', 'nsgan', 'wgan_gp', 'hinge', 'hinge2']


def close(got, ref, rtol=RTOL, atol=0.0):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol,
                               atol=atol)


def arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize('gan_type', GAN_TYPES)
def test_gan_losses(gan_type):
    real, fake = arrays(0, (16, 1), (16, 1))
    close(L.gan_loss_g(gan_type, torch.tensor(fake)),
          JL.gan_loss_g(gan_type, jnp.asarray(fake)))
    close(L.gan_loss_d(gan_type, torch.tensor(real), torch.tensor(fake)),
          JL.gan_loss_d(gan_type, jnp.asarray(real), jnp.asarray(fake)))
    with pytest.raises(NotImplementedError):
        L.gan_loss_g('wgan', torch.tensor(fake))


def test_kl_moments_bce():
    mean, std, noise, logits = arrays(1, (8, 5), (8, 5), (32, 9), (32, 1))
    std = np.abs(std) + 0.1
    close(L.kl_loss(torch.tensor(mean), torch.tensor(std)),
          JL.kl_loss(jnp.asarray(mean), jnp.asarray(std)))
    for fb in (0.0, 0.05, 0.5):
        close(L.kl_loss_free_bits(torch.tensor(mean), torch.tensor(std), fb),
              JL.kl_loss_free_bits(jnp.asarray(mean), jnp.asarray(std), fb))
    for target in (1.0, 0.5):
        for g, r in zip(L.moment_losses(torch.tensor(noise), target),
                        JL.moment_losses(jnp.asarray(noise), target)):
            close(g, r)
    t = (np.sign(logits) > 0).astype(np.float32)
    w = np.abs(arrays(2, (32, 1))[0])
    close(L.weighted_bce_with_logits(torch.tensor(logits), torch.tensor(t)),
          JL.weighted_bce_with_logits(jnp.asarray(logits), jnp.asarray(t)))
    close(L.weighted_bce_with_logits(torch.tensor(logits), torch.tensor(t),
                                     torch.tensor(w)),
          JL.weighted_bce_with_logits(jnp.asarray(logits), jnp.asarray(t),
                                      jnp.asarray(w)))
    # saturated logits hit the clip on both sides
    big = np.array([[40.0], [-40.0]], np.float32)
    tb = np.array([[0.0], [1.0]], np.float32)
    close(L.weighted_bce_with_logits(torch.tensor(big), torch.tensor(tb)),
          JL.weighted_bce_with_logits(jnp.asarray(big), jnp.asarray(tb)))


def test_schedule_and_finite():
    import dataclasses
    kw = dict(lambda_cls_curliness={0: 0.1, 5: 2.0, 9: 0.0},
              lambda_rec_img={0: 0.0, 600000: 1000.0})
    port = L.LossSchedule(dataclasses.replace(ColorTextureConfig(), **kw))
    ref = JL.LossSchedule(dataclasses.replace(JaxCTConfig(), **kw))
    assert port.static == ref.static and port.scheduled == ref.scheduled
    losses = dict(zip(['lambda_adv', 'lambda_cls_curliness',
                       'lambda_rec_img', 'not_a_weight'],
                      arrays(3, (), (), (), ())))
    for step in (0, 4, 5, 8, 9, 599999, 600000):
        for name in ('lambda_adv', 'lambda_cls_curliness',
                     'lambda_rec_img'):
            assert port.weight_host(name, step) == ref.weight_host(name,
                                                                   step)
            close(port.weight(name, step), ref.weight(name, step))
            close(port.weight(name, torch.tensor(step)),
                  ref.weight(name, jnp.asarray(step)))
        close(port.total({k: torch.tensor(v) for k, v in losses.items()},
                          step),
              ref.total({k: jnp.asarray(v) for k, v in losses.items()},
                        step))
    bad = {'a': torch.tensor([1.0, np.nan]), 'b': torch.tensor(1.0)}
    assert bool(L.check_finite({'b': torch.tensor(1.0)}))
    assert not bool(L.check_finite(bad))
    assert not bool(L.check_finite({'c': torch.tensor(np.inf)}))


def _grads(out, inputs):
    """d out / d inputs, zeros for an input the value does not use (the
    critic's last bias, as JAX gives)."""
    grads = torch.autograd.grad(out, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for x, g in zip(inputs, grads)]


def _critic(seed: int, cin: int, hidden: int = 16):
    """A two-layer lrelu critic, its weights in both frameworks."""
    w1, b1, w2, b2 = arrays(seed, (cin, hidden), (hidden,), (hidden, 1),
                            (1,))
    jw = [jnp.asarray(a) for a in (w1, b1, w2, b2)]
    tw = [torch.tensor(a, requires_grad=True) for a in (w1, b1, w2, b2)]

    def jax_fn(params, x):
        h = jax.nn.leaky_relu(x.reshape(x.shape[0], -1) @ params[0]
                              + params[1], 0.2)
        return h @ params[2] + params[3]

    def torch_fn(x):
        h = torch.nn.functional.leaky_relu(
            x.reshape(x.shape[0], -1) @ tw[0] + tw[1], 0.2)
        return h @ tw[2] + tw[3]

    return jw, tw, jax_fn, torch_fn


@pytest.mark.parametrize('shape', [(8, 12), (4, 3, 5, 2)])
def test_wgan_gradient_penalty(shape):
    cin = int(np.prod(shape[1:]))
    jw, tw, jax_fn, torch_fn = _critic(4, cin)
    real, fake = arrays(5, shape, shape)
    key = jax.random.PRNGKey(3)
    alpha = np.asarray(jax.random.uniform(
        key, (shape[0],) + (1,) * (len(shape) - 1), jnp.float32))

    def jax_pen(params, r, f):
        return JL.wgan_gradient_penalty(lambda x: jax_fn(params, x), r, f,
                                        key)

    ref, ref_grads = jax.value_and_grad(jax_pen, argnums=(0, 1, 2))(
        jw, jnp.asarray(real), jnp.asarray(fake))
    tr, tf = (torch.tensor(a, requires_grad=True) for a in (real, fake))
    got = L.wgan_gradient_penalty(torch_fn, tr, tf, torch.tensor(alpha))
    close(got, ref)
    grads = _grads(got, tw + [tr, tf])
    for g, r in zip(grads[:4], ref_grads[0]):
        close(g, r, atol=1e-6 * float(np.abs(r).max()))
    for g, r in zip(grads[4:], ref_grads[1:]):
        close(g, r, atol=1e-6 * float(np.abs(r).max()))
    # constants in, a value still out (the penalty makes its own leaf)
    close(L.wgan_gradient_penalty(torch_fn, torch.tensor(real),
                                  torch.tensor(fake), torch.tensor(alpha)),
          ref)


def test_r0_gradient_penalty():
    jw, tw, jax_fn, torch_fn = _critic(6, 10)
    (real,) = arrays(7, (6, 10))
    ref, ref_grads = jax.value_and_grad(
        lambda p, r: JL.r0_gradient_penalty(lambda x: jax_fn(p, x), r),
        argnums=(0, 1))(jw, jnp.asarray(real))
    tr = torch.tensor(real, requires_grad=True)
    got = L.r0_gradient_penalty(torch_fn, tr)
    close(got, ref)
    grads = _grads(got, tw + [tr])
    for g, r in zip(grads, list(ref_grads[0]) + [ref_grads[1]]):
        close(g, r, atol=1e-6 * float(np.abs(r).max()))
