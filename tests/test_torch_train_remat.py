"""network_g.use_checkpoint (the JAX package's nn.remat of the Swin block)
on the CPU, port only: the LQ-stage generator gradients with and without
it are bit-equal in f32 and bf16; under it each Swin block's forward runs
twice per step (the recomputation in the backward), so the flag cannot be
silently ignored; serving never checkpoints."""

import numpy as np
import pytest
import torch

from femasr_torch.models import FeMaSRNet, init_weights
from femasr_torch.models.inference import SRInferencer
from femasr_torch.ops import swin
from femasr_torch.train import FeMaSRModel
from test_torch_train_grad_lq import lq_options
from torch_port_util import nchw

SMALL = [[32, 16, 32]]
BLOCKS = 24     # 4 RSTB x 6 Swin blocks


@pytest.fixture(scope='module')
def hq_pth(tmp_path_factory):
    hq = FeMaSRNet(SMALL, LQ_stage=False)
    init_weights(hq, torch.Generator().manual_seed(1))
    path = str(tmp_path_factory.mktemp('remat') / 'hq.pth')
    torch.save({'params': hq.state_dict()}, path)
    return path


def count_block_forwards(monkeypatch) -> list:
    """Every SwinTransformerBlock.forward call appends to the list (the
    recomputation in the backward too, which module hooks do not see)."""
    calls = []
    forward = swin.SwinTransformerBlock.forward

    def counted(self, *args, **kwargs):
        calls.append(1)
        return forward(self, *args, **kwargs)
    monkeypatch.setattr(swin.SwinTransformerBlock, 'forward', counted)
    return calls


def g_step(tmp_path, hq_pth, dtype, use_checkpoint, monkeypatch):
    opt = lq_options(tmp_path, hq_pth)
    opt['network_g'].update(dtype=dtype, use_checkpoint=use_checkpoint)
    if dtype == 'bfloat16':
        opt['network_g']['vq_index_f32'] = True
    model = FeMaSRModel(opt)
    rng = np.random.default_rng(0)
    lq = rng.random((2, 16, 16, 3), dtype=np.float32)
    gt = rng.random((2, 64, 64, 3), dtype=np.float32)
    calls = count_block_forwards(monkeypatch)
    model.opt_g.zero_grad()
    total, ld, out, _, _ = model.g_backward(nchw(lq), nchw(gt))
    monkeypatch.undo()
    grads = {n: p.grad for n, p in model.net_g.named_parameters()
             if p.grad is not None}
    return total, out, grads, len(calls)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_checkpointed_gradients_are_bit_equal(tmp_path, hq_pth, dtype,
                                              monkeypatch):
    total, out, grads, calls = g_step(tmp_path, hq_pth, dtype, False,
                                      monkeypatch)
    total_c, out_c, grads_c, calls_c = g_step(tmp_path, hq_pth, dtype, True,
                                              monkeypatch)
    assert calls == BLOCKS and calls_c == 2 * BLOCKS
    assert torch.equal(total, total_c) and torch.equal(out, out_c)
    assert grads.keys() == grads_c.keys() and len(grads) > 300
    swin_grads = [n for n in grads if 'residual_group' in n]
    assert swin_grads
    for n in grads:
        assert torch.equal(grads[n], grads_c[n]), n


def test_serving_never_checkpoints(monkeypatch):
    net = FeMaSRNet(SMALL, LQ_stage=True, use_checkpoint=True)
    init_weights(net, torch.Generator().manual_seed(2))
    used = []

    def no_checkpoint(*args, **kwargs):
        used.append(1)
        raise AssertionError('serving checkpointed a Swin block')
    monkeypatch.setattr(swin, 'checkpoint', no_checkpoint)
    calls = count_block_forwards(monkeypatch)
    x = torch.rand((1, 3, 16, 16), generator=torch.Generator().manual_seed(3))
    for dtype in (torch.float32, torch.bfloat16):
        SRInferencer(model=net, dtype=dtype).run_padded(x)
    with torch.no_grad():       # a differentiable forward without grad
        net(x, differentiable=True)
    assert not used and len(calls) == 3 * BLOCKS
