"""bf16 HQ-stage training on the CPU: the port's generator step (codebook,
semantic through VGG19 in bf16, L1, LPIPS in f32 on the f32 output, hinge
GAN through the bf16 discriminator) and one discriminator step, against
jax.value_and_grad of the JAX networks built with dtype=bfloat16, under
the rules of tests/test_torch_train_bf16.py. Measured here: the
trainee's indices 30 of 32 equal to JAX's own search (gap 6.1e-4); the
weights' gradients median 0.110, worst 0.179, the whole gradient 0.111.
The discriminator has no codebook and no L1 sign to amplify a rounding:
its gradients are held within D_REL_L2 (measured: at most 9.2e-3), its
losses within LOSS_RTOL and its f32 spectral vectors to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from femasr_torch.models.convert import discriminator_from_flax, from_flax
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
from test_torch_train_bf16 import (LOSS_RTOL, NEAR_TIE, SMALL, bf16_options,
                                   check_grads, forced_search,
                                   near_tie_agreement, record_layer_inputs,
                                   strict)
from test_torch_train_grad_hq import hq_options, seeded_files
from torch_port_util import nchw

D_REL_L2 = 5e-2


def test_hq_stage_bf16_generator_and_discriminator_gradients_match_jax(
        tmp_path, monkeypatch):
    paths = seeded_files(tmp_path)
    model = FeMaSRModel(bf16_options(hq_options(tmp_path, paths)))
    assert model.net_d.dtype == torch.bfloat16
    gt = np.random.default_rng(0).random((2, 32, 32, 3), dtype=np.float32)
    seen, hooks = record_layer_inputs(model.net_g)
    seen_d, hooks_d = record_layer_inputs(model.net_d)
    tokens = []
    hooks.append(model.net_g.quantize_group[0].register_forward_hook(
        lambda mod, args, out: tokens.append(args[0].detach())))
    model.opt_g.zero_grad()
    total, ld, out, idx, _ = model.g_backward(None, nchw(gt))
    for h in hooks + hooks_d:
        h.remove()
    assert set(ld) == {'l_codebook', 'l_semantic', 'l_pix', 'l_percep',
                       'l_g_gan'}
    assert set(seen) == {torch.bfloat16} and set(seen_d) == {torch.bfloat16}

    params = convert_femasr_checkpoint(
        load_torch_checkpoint(paths['g']), codebook_params=SMALL,
        LQ_stage=False, use_semantic_loss=True)
    pd, spec = convert_discriminator_checkpoint(
        load_torch_checkpoint(paths['d']))
    lpips_p = convert_lpips_checkpoint(load_torch_checkpoint(paths['lpips'],
                                                             None))
    vgg_p = convert_vgg_checkpoint(load_torch_checkpoint(paths['vgg'],
                                                         None), 'vgg19')
    bf = jnp.bfloat16
    monkeypatch.setenv('FEMASR_UPCONV', 'plain')
    jnet = JFeMaSRNet(codebook_params=SMALL, LQ_stage=False,
                      use_semantic_loss=True, dtype=bf, vq_index_f32=True)
    jd = JUNetD(num_feat=16, dtype=bf)
    lpips_loss = jl.LPIPSLoss(1.0).bind_params(lpips_p)
    gan = jl.GANLoss('hinge', loss_weight=0.1)
    x = jnp.asarray(gt)
    vgg_feat = strict(lambda p, x: JVGG(['relu4_4'], 'vgg19', dtype=bf).apply(
        {'params': p}, x.astype(bf))['relu4_4'], vgg_p, x)

    def loss_fn(p):
        out, l_cb, l_sem, _ = jnet.apply({'params': p}, x.astype(bf),
                                         vgg_feat=vgg_feat, train=True)
        out32 = out.astype(jnp.float32)
        pred = jd.apply({'params': pd, 'spectral': spec}, out.astype(bf))
        return (l_cb + 0.1 * l_sem + jl.L1Loss()(out32, x)
                + lpips_loss(out32, x)[0] + gan(pred, True, is_disc=False),
                out32)

    own = []
    forced_search(monkeypatch, idx.numpy(), own)
    (loss_j, _), grads_j = strict(jax.value_and_grad(
        loss_fn, has_aux=True), params)
    jax.effects_barrier()
    z = tokens[0].float().permute(0, 2, 3, 1).reshape(-1, SMALL[0][2])
    agree, gap = near_tie_agreement(
        z, model.net_g.quantize_group[0].embedding.weight.detach(), idx,
        own[0])
    assert agree >= 0.9 and gap <= NEAR_TIE, (agree, gap)
    np.testing.assert_allclose(float(total), float(loss_j), rtol=LOSS_RTOL)
    want = from_flax(grads_j, SMALL, LQ_stage=False, use_semantic_loss=True)
    assert len(want) == len(list(model.net_g.parameters()))
    check_grads(model.net_g, want)

    # one discriminator step in bf16 on GT and the port's output: the real
    # side with a power iteration, then the fake side with another
    crit = jl.GANLoss('hinge')

    def d_fn(p, s, data, label):
        pred, mut = jd.apply({'params': p, 'spectral': s}, data.astype(bf),
                             update_stats=True, mutable=['spectral'])
        return crit(pred, label, is_disc=True), mut['spectral']

    fake = jnp.asarray(out.numpy().transpose(0, 2, 3, 1))
    (l_real, spec1), g_real = strict(jax.value_and_grad(
        lambda p, s, d: d_fn(p, s, d, True), has_aux=True), pd, spec, x)
    (l_fake, spec2), g_fake = strict(jax.value_and_grad(
        lambda p, s, d: d_fn(p, s, d, False), has_aux=True), pd, spec1,
        fake)
    model.net_d.zero_grad()
    lr, _ = model._d_phase(nchw(gt), True, 1)
    lf, _ = model._d_phase(out, False, 1)
    np.testing.assert_allclose(lr.item(), float(l_real), rtol=LOSS_RTOL)
    np.testing.assert_allclose(lf.item(), float(l_fake), rtol=LOSS_RTOL)
    want = discriminator_from_flax(
        jax.tree.map(lambda a, b: a + b, g_real, g_fake), spec2)
    assert len(list(model.net_d.parameters())) == 12
    check_grads(model.net_d, want, D_REL_L2, D_REL_L2)
    sd = model.net_d.state_dict()
    for i in range(1, 9):       # the power iteration stays f32
        assert sd[f'conv{i}.weight_u'].dtype == torch.float32
        np.testing.assert_allclose(sd[f'conv{i}.weight_u'].numpy(),
                                   want[f'conv{i}.weight_u'].numpy(),
                                   rtol=1e-5, atol=1e-6)
