"""LQ-stage generator gradients: the port's trainer against
jax.value_and_grad of the JAX FeMaSRNet, on the CPU.

The port's FeMaSRModel (device: cpu) builds the LQ net from a seeded HQ
prior checkpoint, takes the prior's GT code indices, and runs its
generator forward and backward in training mode (differentiable=True: the
conv3 tail and the attention take their plain versions). The JAX side runs
the same weights (the JAX package's converter of the port's state dict)
with the same GT indices. Loss: codebook (beta MSE + Gram against the GT
codes) + L1. Indices equal; loss to 1e-4 relative; every gradient tensor
to 5e-3 of its max, as tests/test_gradient_parity.py holds the JAX
package against the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from femasr_torch.models import FeMaSRNet, init_weights
from femasr_torch.models.convert import from_flax
from femasr_torch.train import FeMaSRModel
from femasr_tpu.losses import L1Loss
from femasr_tpu.models.convert import convert_femasr_checkpoint
from femasr_tpu.models.femasr_arch import FeMaSRNet as JFeMaSRNet
from torch_port_util import nchw

SMALL = [[32, 16, 32]]


def lq_options(tmp_path, hq_pth):
    return {
        'name': 'lq', 'model_type': 'FeMaSRModel', 'scale': 4,
        'manual_seed': 0, 'device': 'cpu', 'is_train': True,
        'network_g': {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                      'LQ_stage': True, 'scale_factor': 4},
        'network_d': {'type': 'UNetDiscriminatorSN', 'num_feat': 8},
        'path': {'pretrain_network_hq': hq_pth,
                 'models': str(tmp_path / 'models')},
        'train': {
            'optim_g': {'type': 'Adam', 'lr': 1e-4, 'betas': [0.9, 0.99]},
            'optim_d': {'type': 'Adam', 'lr': 4e-4, 'betas': [0.9, 0.99]},
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                        'loss_weight': 0.0},
            'codebook_opt': {'loss_weight': 1.0}}}


def test_lq_generator_gradients_match_jax(tmp_path):
    hq = FeMaSRNet(SMALL, LQ_stage=False)
    init_weights(hq, torch.Generator().manual_seed(1))
    hq_pth = str(tmp_path / 'hq.pth')
    torch.save({'params': hq.state_dict()}, hq_pth)
    model = FeMaSRModel(lq_options(tmp_path, hq_pth))
    rng = np.random.default_rng(0)
    lq = rng.random((1, 16, 16, 3), dtype=np.float32)
    gt = rng.random((1, 64, 64, 3), dtype=np.float32)
    model.opt_g.zero_grad()
    total, ld, _, idx, gt_idx = model.g_backward(nchw(lq), nchw(gt))
    assert set(ld) == {'l_codebook', 'l_pix'}

    sd = {k: v.detach().numpy() for k, v in model.net_g.state_dict().items()}
    params = convert_femasr_checkpoint(sd, codebook_params=SMALL,
                                       LQ_stage=True, scale_factor=4)
    jnet = JFeMaSRNet(codebook_params=SMALL, LQ_stage=True, scale_factor=4)
    gt_j = [jnp.asarray(gt_idx[0].numpy())]

    def loss_fn(p):
        out, l_cb, _, idx_j = jnet.apply({'params': p}, jnp.asarray(lq),
                                         gt_indices=gt_j, train=True)
        return l_cb + L1Loss()(out, jnp.asarray(gt)), idx_j[0]

    (loss_j, idx_j), grads_j = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(float(total), float(loss_j), rtol=1e-4)
    want = from_flax(grads_j, SMALL, LQ_stage=True, scale_factor=4)
    checked = 0
    for name, p in model.net_g.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        ref = want[name].numpy()
        assert np.abs(g.numpy() - ref).max() <= 5e-3 * np.abs(ref).max(), \
            name
        checked += 1
    assert checked == len(want) > 300
