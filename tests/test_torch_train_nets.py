"""The training networks of the port against the JAX package's, on the CPU:
seeded port weights go to JAX through the JAX package's own converters of
the reference checkpoint formats (torchvision VGG, the lpips package,
the reference discriminator), and that tree comes back to the port
through `*_from_flax`. Compared: the VGG feature
extractor, LPIPS and the U-Net discriminator forwards (1e-5 of the
output's max), the discriminator's power iteration (u, v to 1e-6), the
perceptual losses built on them, and a discriminator step's gradients
(real side with a power iteration, fake side with another): the losses to
1e-5, u to 1e-6, each gradient to 1e-3 of its max (the error grows from
~1e-6 at the first SN conv to ~1e-4 at the last, as f32 sums in another
order move the hinge's near-threshold outputs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from femasr_torch.losses import LPIPS, GANLoss, LPIPSLoss, PerceptualLoss
from femasr_torch.losses.lpips import lpips_package_state
from femasr_torch.models.convert import (discriminator_from_flax,
                                         lpips_from_flax, vgg_from_flax)
from femasr_torch.models.discriminator_arch import (UNetDiscriminatorSN,
                                                    init_discriminator)
from femasr_torch.models.vgg_arch import (VGGFeatureExtractor,
                                          torchvision_state,
                                          vgg_truncated_state)
from femasr_tpu import losses as jl
from femasr_tpu.losses.lpips import LPIPS as JLPIPS
from femasr_tpu.losses.lpips import convert_lpips_checkpoint
from femasr_tpu.models.convert import convert_discriminator_checkpoint
from femasr_tpu.models.discriminator_arch import \
    UNetDiscriminatorSN as JUNetD
from femasr_tpu.models.vgg_arch import VGGFeatureExtractor as JVGG
from femasr_tpu.models.vgg_arch import convert_vgg_checkpoint
from torch_port_util import nchw, nhwc

TOL = 1e-5


def _img(seed, n=2, hw=32):
    return np.random.default_rng(seed).random((n, hw, hw, 3),
                                              dtype=np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _numpy(sd):
    # copies: a view would let the port's in-place updates (the power
    # iteration's u and v) reach the JAX reference's inputs, and JAX reads
    # them asynchronously, after the port's next call when the host is busy
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


def _vgg_params(layers, vgg_type, seed):
    """Seeded VGG weights as the JAX package's tree (from a torchvision
    state dict), and the port's extractor loaded back from that tree."""
    src = VGGFeatureExtractor(['pool5'], vgg_type)  # the whole network
    torch.manual_seed(seed)
    for m in src.vgg_net:
        if isinstance(m, torch.nn.Conv2d):
            torch.nn.init.normal_(m.bias, std=0.1)
    params = convert_vgg_checkpoint(_numpy(torchvision_state(src)),
                                    vgg_type)
    net = VGGFeatureExtractor(layers, vgg_type)
    net.load_state_dict(vgg_truncated_state(vgg_from_flax(params), net))
    return params, net


@pytest.fixture(scope='module')
def disc():
    net = init_discriminator(UNetDiscriminatorSN(num_feat=16),
                             torch.Generator().manual_seed(3))
    p, spec = convert_discriminator_checkpoint(_numpy(net.state_dict()))
    var = {'params': p, 'spectral': spec}
    net.load_state_dict(discriminator_from_flax(p, spec))
    return JUNetD(num_feat=16), var, net


@pytest.mark.parametrize('vgg_type,layers', [
    ('vgg19', ['relu1_2', 'relu3_4', 'relu4_4']),
    ('vgg16', ['conv2_1', 'relu5_3'])])
def test_vgg_features_match_jax(vgg_type, layers):
    x = _img(1)
    jv = JVGG(layer_name_list=layers, vgg_type=vgg_type)
    params, net = _vgg_params(layers, vgg_type, 0)
    ref = jax.jit(jv.apply)({'params': params}, jnp.asarray(x))
    with torch.no_grad():
        out = net(nchw(x))
    assert sorted(out) == sorted(layers)
    for k in layers:
        assert _rel(nhwc(out[k]), ref[k]) < TOL, k


def test_lpips_matches_jax():
    x, y = _img(2), _img(3)
    jm = JLPIPS()
    src = LPIPS()
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for i in range(5):       # learned, non-negative channel weights
            w = getattr(src, f'lin{i}')
            w.copy_(torch.from_numpy(rng.random(w.shape, np.float32)) / 64)
    params = convert_lpips_checkpoint(_numpy(lpips_package_state(src)))
    ref = jax.jit(jm.apply)({'params': params}, jnp.asarray(x),
                            jnp.asarray(y))
    net = LPIPS()
    net.load_state_dict(lpips_from_flax(params))
    with torch.no_grad():
        out = net(nchw(x), nchw(y))
    assert _rel(out.numpy(), ref) < TOL
    # the loss class, bound to the same weights: the JAX LPIPSLoss is
    # mean(LPIPS) * loss_weight
    loss, none = LPIPSLoss(0.5).bind_params(net.state_dict())(nchw(x),
                                                              nchw(y))
    assert none is None and _rel(loss.item(), jnp.mean(ref) * 0.5) < TOL


@pytest.mark.parametrize('criterion,style', [('l1', 0.0), ('l2', 0.3)])
def test_perceptual_loss_matches_jax(criterion, style):
    x, y = _img(5), _img(6)
    lw = {'relu1_2': 0.5, 'relu2_2': 1.0}
    jloss = jl.PerceptualLoss(lw, 'vgg19', perceptual_weight=0.7,
                              style_weight=style, criterion=criterion)
    params, _ = _vgg_params(list(lw), 'vgg19', 2)
    jp, js = jax.jit(jloss.bind_params(params).__call__)(jnp.asarray(x),
                                                         jnp.asarray(y))
    port = PerceptualLoss(lw, 'vgg19', perceptual_weight=0.7,
                          style_weight=style, criterion=criterion)
    p, s = port.bind_params(vgg_from_flax(params))(nchw(x), nchw(y))
    # l2 and the Gram style term are quadratic in the features: twice their
    # relative error
    assert _rel(p.item(), jp) < (2 * TOL if criterion == 'l2' else TOL)
    if style:
        assert _rel(s.item(), js) < 2 * TOL
    else:
        assert s is None and js is None


def test_discriminator_forward_and_power_iteration_match_jax(disc):
    jd, var, net = disc
    x = _img(7)
    ref = jax.jit(jd.apply)(var, jnp.asarray(x))
    with torch.no_grad():
        out = net(nchw(x))
    assert _rel(nhwc(out), ref) < TOL
    ref_u, mut = jax.jit(lambda v, x: jd.apply(
        v, x, update_stats=True, mutable=['spectral']))(var, jnp.asarray(x))
    state = {k: v.clone() for k, v in net.state_dict().items()}
    with torch.no_grad():
        out_u = net(nchw(x), update=True)
    assert _rel(nhwc(out_u), ref_u) < TOL
    sd = net.state_dict()
    for i in range(1, 9):
        for leaf in ('u', 'v'):
            np.testing.assert_allclose(
                sd[f'conv{i}.weight_{leaf}'].numpy(),
                np.asarray(mut['spectral'][f'conv{i}'][leaf]), rtol=1e-6,
                atol=1e-6)
    net.load_state_dict(state)      # the module fixture stays as loaded


def test_discriminator_step_gradients_match_jax(disc):
    jd, var, net = disc
    real, fake = _img(8), _img(9)
    crit = jl.GANLoss('hinge')

    def d_fn(pd, spec, x, label):
        pred, mut = jd.apply({'params': pd, 'spectral': spec}, x,
                             update_stats=True, mutable=['spectral'])
        return crit(pred, label, is_disc=True), mut['spectral']

    grad = jax.jit(jax.value_and_grad(d_fn, has_aux=True),
                   static_argnums=3)
    (l_real, spec1), g_real = grad(var['params'], var['spectral'],
                                   jnp.asarray(real), True)
    (l_fake, spec2), g_fake = grad(var['params'], spec1, jnp.asarray(fake),
                                   False)
    state = {k: v.clone() for k, v in net.state_dict().items()}
    hinge = GANLoss('hinge')
    net.zero_grad()
    lr = hinge(net(nchw(real), update=True), True, is_disc=True)
    lr.backward()
    lf = hinge(net(nchw(fake), update=True), False, is_disc=True)
    lf.backward()
    assert _rel(lr.item(), l_real) < TOL and _rel(lf.item(), l_fake) < TOL
    want = discriminator_from_flax(
        jax.tree.map(lambda a, b: a + b, g_real, g_fake), spec2)
    grads = {n: p.grad for n, p in net.named_parameters()}
    assert len(grads) == len(flatten_dict(var['params']))
    for n, g in grads.items():     # through 10 convs in another order
        assert _rel(g.numpy(), want[n].numpy()) < 1e-3, n
    sd = net.state_dict()
    for i in range(1, 9):
        np.testing.assert_allclose(sd[f'conv{i}.weight_u'].numpy(),
                                   want[f'conv{i}.weight_u'].numpy(),
                                   rtol=1e-6, atol=1e-6)
    net.load_state_dict(state)
