"""The serving options of the JAX SRInferencer in the port: lq_stage (HQ
serving: the HQ model's reconstruction, scale 1), gt_resolution, norm_type
and act_type, through SRInferencer and load_inferencer (device='cpu'),
against the JAX SRInferencer on the same weights and image in f32 (rel
2e-3, as tests/test_torch_inference.py holds the LQ model). A gn + silu
model keeps the conv3 tail; another activation takes the plain layers
there. `in` and `bn` are not ported and raise."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch.models import FeMaSRNet, SRInferencer, init_weights
from femasr_torch.models.inference import load_inferencer
from femasr_tpu.models.convert import convert_femasr_checkpoint
from femasr_tpu.models.inference import SRInferencer as JSRInferencer
from torch_port_util import nchw, nhwc

SMALL = ((32, 16, 32),)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize('act_type', ['silu', 'gelu'])
def test_hq_serving_matches_jax(tmp_path, act_type):
    net = FeMaSRNet(SMALL, LQ_stage=False, act_type=act_type)
    init_weights(net, torch.Generator().manual_seed(0))
    assert net.decoder_group[-1].kernel == (act_type == 'silu')
    params = convert_femasr_checkpoint(
        {k: v.numpy() for k, v in net.state_dict().items()},
        codebook_params=SMALL, LQ_stage=False, act_type=act_type)
    jsr = JSRInferencer(params, codebook_params=SMALL, lq_stage=False,
                        act_type=act_type, init_merge=False)
    pth = os.path.join(tmp_path, 'hq.pth')
    torch.save({'params': net.state_dict()}, pth)
    sr = load_inferencer(pth, codebook_params=SMALL, device='cpu',
                         lq_stage=False, act_type=act_type, strict=True)
    assert sr.scale == jsr.scale == 1 and sr.wsz == jsr.wsz == 64
    img = np.random.default_rng(1).random((1, 30, 32, 3), dtype=np.float32)
    ref = np.asarray(jsr.run_padded(jnp.asarray(img)))
    out = nhwc(sr.run_padded(nchw(img)))
    assert out.shape == ref.shape == (1, 30, 32, 3)
    assert _rel(out, ref) < 2e-3


def test_serving_options_reach_the_model():
    sr = SRInferencer(codebook_params=((16, 16, 32),), gt_resolution=128,
                      norm_type='gn', act_type='leakyrelu', device='cpu')
    m = sr.model
    assert (m.gt_resolution, m.max_depth, m.scale_factor) == (128, 3, 4)
    assert not m.decoder_group[-1].kernel       # not gn + silu: no kernel
    assert m.decoder_group[0].block[2].conv[1].act_type == 'leakyrelu'


@pytest.mark.parametrize('norm_type', ['in', 'bn'])
def test_instance_and_batch_norm_are_refused(norm_type):
    with pytest.raises(NotImplementedError, match='A12'):
        SRInferencer(codebook_params=SMALL, norm_type=norm_type,
                     device='cpu')
