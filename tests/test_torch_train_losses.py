"""Training losses of the port against the JAX package's, on the CPU: the
pixel losses (with and without a weight map, every reduction), every GAN
loss type on either side, the multi-scale GAN loss, the Gram loss, the
quantizer's training losses and straight-through output, and the codebook
perplexity. Seeded numpy inputs go to both (NHWC to JAX, NCHW to the port);
the losses agree to 1e-6 relative. The inputs are small: an f32 mean of n
values summed in another order moves by up to ~sqrt(n) ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch.losses import (CharbonnierLoss, GANLoss, L1Loss, MSELoss,
                                 MultiScaleGANLoss, build_loss)
from femasr_torch.ops.quantize import (codebook_perplexity, gram_loss,
                                       vector_quantize)
from femasr_tpu import losses as jl
from femasr_tpu.ops import quantize as jq
from torch_port_util import nchw, nhwc

RTOL = 1e-6


def _pair(seed, shape=(2, 6, 5, 3)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port.detach() if isinstance(
        port, torch.Tensor) else port, np.float64),
        np.asarray(ref, np.float64), rtol=RTOL, atol=1e-7)


@pytest.mark.parametrize('name', ['L1Loss', 'MSELoss', 'CharbonnierLoss'])
@pytest.mark.parametrize('reduction', ['mean', 'sum', 'none'])
def test_pixel_losses_match_jax(name, reduction):
    # multiples of 1/32 and 1/8: the L1 and MSE terms and their weighted
    # sums are exact in f32 whatever the order of the sum
    rng = np.random.default_rng(0)
    x, y = (rng.integers(-32, 33, (2, 6, 5, 3)).astype(np.float32) / 32
            for _ in range(2))
    w1 = rng.integers(1, 9, (2, 6, 5, 1)).astype(np.float32) / 8
    port = {'L1Loss': L1Loss, 'MSELoss': MSELoss,
            'CharbonnierLoss': CharbonnierLoss}[name](0.7, reduction)
    ref = getattr(jl, name)(0.7, reduction)
    for w in (None, w1, np.broadcast_to(w1, x.shape).copy()):
        out = port(nchw(x), nchw(y), None if w is None else nchw(w))
        want = ref(jnp.asarray(x), jnp.asarray(y),
                   None if w is None else jnp.asarray(w))
        if reduction == 'none':
            out = nhwc(out)
        _close(out, want)


@pytest.mark.parametrize('gan_type', ['vanilla', 'lsgan', 'wgan',
                                      'wgan_softplus', 'hinge'])
def test_gan_losses_match_jax(gan_type):
    pred = np.random.default_rng(2).normal(size=(2, 8, 8, 1)) * 3
    pred = pred.astype(np.float32)
    port = build_loss({'type': 'GANLoss', 'gan_type': gan_type,
                       'real_label_val': 0.9, 'fake_label_val': 0.1,
                       'loss_weight': 0.3})
    assert isinstance(port, GANLoss)
    ref = jl.GANLoss(gan_type, 0.9, 0.1, 0.3)
    for real in (True, False):
        for disc in (True, False):
            _close(port(nchw(pred), real, is_disc=disc),
                   ref(jnp.asarray(pred), real, is_disc=disc))


def test_multiscale_gan_loss_matches_jax():
    rng = np.random.default_rng(3)
    preds = [rng.normal(size=(2, 4, 4, 1)).astype(np.float32),
             [rng.normal(size=(2, 2, 2, 1)).astype(np.float32),
              rng.normal(size=(2, 8, 8, 1)).astype(np.float32)]]
    port = MultiScaleGANLoss('hinge', loss_weight=0.5)
    ref = jl.MultiScaleGANLoss('hinge', loss_weight=0.5)
    tp = [nchw(preds[0]), [nchw(p) for p in preds[1]]]
    jp = [jnp.asarray(preds[0]), [jnp.asarray(p) for p in preds[1]]]
    for real in (True, False):
        for disc in (True, False):
            _close(port(tp, real, disc), ref(jp, real, disc))


def test_gram_loss_matches_jax():
    x, y = _pair(4, (2, 6, 5, 16))
    _close(gram_loss(nchw(x), nchw(y)), jq.gram_loss(jnp.asarray(x),
                                                      jnp.asarray(y)))


@pytest.mark.parametrize('lq_stage', [False, True])
def test_vector_quantize_training_losses_match_jax(lq_stage):
    rng = np.random.default_rng(5)
    z = rng.normal(size=(2, 4, 5, 8)).astype(np.float32)
    cb = rng.normal(size=(16, 8)).astype(np.float32)
    gt = rng.integers(0, 16, (2, 1, 4, 5))
    zq_j, loss_j, idx_j = jq.vector_quantize(
        jnp.asarray(z), jnp.asarray(cb), jnp.asarray(gt), beta=0.25,
        lq_stage=lq_stage)
    zt = nchw(z).requires_grad_(True)
    cbt = torch.from_numpy(cb).requires_grad_(True)
    zq, loss, idx = vector_quantize(zt, cbt, torch.from_numpy(gt), 0.25,
                                    lq_stage)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    _close(loss, loss_j)
    _close(nhwc(zq), zq_j)
    # the straight-through output passes its gradient to z unchanged
    (zq.sum() + loss).backward()
    gz, gcb = jax.grad(lambda a, b: jq.vector_quantize(
        a, b, jnp.asarray(gt), 0.25, lq_stage=lq_stage)[1], (0, 1))(
        jnp.asarray(z), jnp.asarray(cb))
    _close(nhwc(zt.grad), gz + 1.0)
    _close(torch.zeros_like(cbt) if cbt.grad is None else cbt.grad, gcb)


def test_codebook_perplexity_matches_jax():
    idx = np.random.default_rng(6).integers(0, 7, (3, 4, 5))
    idx[0, 0] = 30            # one code of a larger book, the rest unused
    _close(codebook_perplexity(torch.from_numpy(idx), 40),
           jq.codebook_perplexity(jnp.asarray(idx), 40))
