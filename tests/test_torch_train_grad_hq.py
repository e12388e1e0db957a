"""HQ-stage generator gradients: the port's trainer against
jax.value_and_grad of the JAX losses on the same weights, on the CPU; and
a checkpoint the port's trainer saves, read by the JAX package.

The port's FeMaSRModel (device: cpu) loads seeded checkpoints in the
reference formats (the generator with `conv_semantic`, the U-Net
discriminator with its spectral vectors, LPIPS-VGG in the lpips package's
keys, VGG19 in torchvision's) and runs its generator forward and backward:
codebook + 0.1 semantic (VGG19 relu4_4) + L1 + LPIPS + 0.1 hinge GAN
through the discriminator (no power iteration, no discriminator
gradient). The JAX side takes the same files through the JAX package's
converters. Loss to 1e-4 relative; every gradient tensor to 5e-3 of its
max. Then one whole trainer iteration, `save_network`, and the saved
net_g .pth through the JAX package's `convert_femasr_checkpoint`: the JAX
forward agrees with the port's to 2e-3 of its max.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from femasr_torch.losses import LPIPS, lpips_package_state
from femasr_torch.models import FeMaSRNet, init_weights
from femasr_torch.models.convert import from_flax
from femasr_torch.models.discriminator_arch import (UNetDiscriminatorSN,
                                                    init_discriminator)
from femasr_torch.models.vgg_arch import (VGGFeatureExtractor,
                                          torchvision_state)
from femasr_torch.train import FeMaSRModel
from femasr_tpu import losses as jl
from femasr_tpu.losses.lpips import convert_lpips_checkpoint
from femasr_tpu.models.convert import (convert_discriminator_checkpoint,
                                       convert_femasr_checkpoint,
                                       load_torch_checkpoint)
from femasr_tpu.models.discriminator_arch import \
    UNetDiscriminatorSN as JUNetD
from femasr_tpu.models.femasr_arch import FeMaSRNet as JFeMaSRNet
from femasr_tpu.models.vgg_arch import VGGFeatureExtractor as JVGG
from femasr_tpu.models.vgg_arch import convert_vgg_checkpoint
from torch_port_util import nchw, nhwc

SMALL = [[32, 16, 32]]


def _numpy(sd):
    return {k: v.detach().numpy() for k, v in sd.items()}


def seeded_files(tmp_path):
    """Seeded weights in the reference formats; returns their paths."""
    g = FeMaSRNet(SMALL, LQ_stage=False, use_semantic_loss=True)
    init_weights(g, torch.Generator().manual_seed(2))
    d = init_discriminator(UNetDiscriminatorSN(num_feat=16),
                           torch.Generator().manual_seed(3))
    lp = LPIPS()
    vgg = VGGFeatureExtractor(['pool5'], 'vgg19')       # the whole net
    torch.manual_seed(4)
    with torch.no_grad():
        for i in range(5):
            getattr(lp, f'lin{i}').uniform_(0, 1 / 32)
        for m in list(lp.net.vgg_net) + list(vgg.vgg_net):
            if isinstance(m, torch.nn.Conv2d):
                m.bias.normal_(std=0.1)
    paths = {k: str(tmp_path / f'{k}.pth') for k in ('g', 'd', 'lpips',
                                                      'vgg')}
    torch.save({'params': g.state_dict()}, paths['g'])
    torch.save({'params': d.state_dict()}, paths['d'])
    torch.save(lpips_package_state(lp), paths['lpips'])
    torch.save(torchvision_state(vgg), paths['vgg'])
    return paths


def hq_options(tmp_path, paths):
    return {
        'name': 'hq', 'model_type': 'FeMaSRModel', 'manual_seed': 0,
        'device': 'cpu', 'is_train': True,
        'network_g': {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                      'LQ_stage': False, 'use_semantic_loss': True},
        'network_d': {'type': 'UNetDiscriminatorSN', 'num_feat': 16},
        'path': {'pretrain_network_g': paths['g'],
                 'pretrain_network_d': paths['d'],
                 'pretrain_lpips': paths['lpips'],
                 'pretrain_vgg': paths['vgg'],
                 'models': str(tmp_path / 'models')},
        'train': {
            'optim_g': {'type': 'Adam', 'lr': 1e-4, 'betas': [0.9, 0.99]},
            'optim_d': {'type': 'Adam', 'lr': 4e-4, 'betas': [0.9, 0.99]},
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
            'perceptual_opt': {'type': 'LPIPSLoss', 'loss_weight': 1.0},
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                        'loss_weight': 0.1},
            'codebook_opt': {'loss_weight': 1.0},
            'semantic_opt': {'loss_weight': 0.1}}}


def test_hq_generator_gradients_and_checkpoint_match_jax(tmp_path):
    paths = seeded_files(tmp_path)
    model = FeMaSRModel(hq_options(tmp_path, paths))
    gt = np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32)
    model.opt_g.zero_grad()
    total, ld, _, _, _ = model.g_backward(None, nchw(gt))
    assert set(ld) == {'l_codebook', 'l_semantic', 'l_pix', 'l_percep',
                       'l_g_gan'}

    params = convert_femasr_checkpoint(
        load_torch_checkpoint(paths['g']), codebook_params=SMALL,
        LQ_stage=False, use_semantic_loss=True)
    pd, spec = convert_discriminator_checkpoint(
        load_torch_checkpoint(paths['d']))
    lpips_p = convert_lpips_checkpoint(load_torch_checkpoint(paths['lpips'],
                                                             None))
    vgg_p = convert_vgg_checkpoint(load_torch_checkpoint(paths['vgg'],
                                                         None), 'vgg19')
    jnet = JFeMaSRNet(codebook_params=SMALL, LQ_stage=False,
                      use_semantic_loss=True)
    jd = JUNetD(num_feat=16)
    lpips_loss = jl.LPIPSLoss(1.0).bind_params(lpips_p)
    gan = jl.GANLoss('hinge', loss_weight=0.1)
    x = jnp.asarray(gt)
    vgg_feat = jax.jit(JVGG(['relu4_4'], 'vgg19').apply)(
        {'params': vgg_p}, x)['relu4_4']

    def loss_fn(p):
        out, l_cb, l_sem, _ = jnet.apply({'params': p}, x,
                                         vgg_feat=vgg_feat, train=True)
        pred = jd.apply({'params': pd, 'spectral': spec}, out)
        return (l_cb + 0.1 * l_sem + jl.L1Loss()(out, x)
                + lpips_loss(out, x)[0] + gan(pred, True, is_disc=False),
                out)

    loss_and_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss_j, _), grads_j = loss_and_grads(params)
    np.testing.assert_allclose(float(total), float(loss_j), rtol=1e-4)
    want = from_flax(grads_j, SMALL, LQ_stage=False, use_semantic_loss=True)
    for name, p in model.net_g.named_parameters():
        ref = want[name].numpy()
        assert np.abs(p.grad.numpy() - ref).max() \
            <= 5e-3 * np.abs(ref).max(), name
    assert len(want) == len(list(model.net_g.parameters()))

    # a trainer iteration, then its saved checkpoint in the JAX package
    model.feed_data({'gt': nchw(gt)})
    model.optimize_parameters(1)
    saved = model.save_network(model.net_g.state_dict(), 'net_g', 1)
    params = convert_femasr_checkpoint(load_torch_checkpoint(saved),
                                       codebook_params=SMALL, LQ_stage=False,
                                       use_semantic_loss=True)
    ref = np.asarray(loss_and_grads(params)[0][1])   # its forward of gt
    with torch.no_grad():
        out = nhwc(model.net_g(nchw(gt))[0])
    assert np.abs(out - ref).max() <= 2e-3 * np.abs(ref).max()
