"""The port's CUDA kernels against their plain PyTorch versions on the card.

The kernels have no CPU mode, so these tests skip without a CUDA device.
This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from femasr_torch.kernels import conv3, vq_argmin, window_attention
from femasr_torch.ops.swin import shifted_window_mask

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernels have no CPU mode)')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_conv3_kernel_matches_plain(gen, dtype, tol):
    x = torch.randn(2, 64, 37, 70, generator=gen).cuda().to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    bias = torch.randn(64, generator=gen).cuda() * 0.04
    scale = torch.rand(2, 64, generator=gen).cuda() + 0.5
    shift = torch.randn(2, 64, generator=gen).cuda()
    for o in (64, 3):
        w = torch.randn(o, 64, 3, 3, generator=gen).cuda() * 0.04
        for kw in ({}, dict(scale=scale, shift=shift, pre_act='silu',
                            act='lrelu')):
            out = conv3.conv3(x, w, bias[:o], **kw)
            ref = conv3.conv3_plain(x, w, bias[:o], **kw)
            assert out.is_contiguous(memory_format=torch.channels_last)
            torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                       rtol=tol)


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_window_attention_kernel_matches_plain(gen, dtype, tol):
    qkv = torch.randn(8, 64, 768, generator=gen).cuda().to(dtype)
    q = qkv[..., :256] * 32 ** -0.5
    k, v = qkv[..., 256:512], qkv[..., 512:]
    bias = torch.randn(8, 64, 64, generator=gen).cuda() * 0.1
    mask = torch.from_numpy(shifted_window_mask(16, 16, 8, 4)).cuda()
    for m in (None, mask):
        out = window_attention.window_attention(q, k, v, bias, m, 8)
        ref = window_attention.window_attention_plain(q, k, v, bias, m, 8)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)


def test_vq_argmin_kernel_matches_plain(gen):
    for n, k, c in ((1000, 1024, 512), (77, 100, 36)):
        z = torch.randn(n, c, generator=gen).cuda()
        cb = torch.randn(k, c, generator=gen).cuda()
        out = vq_argmin.vq_argmin(z, cb)
        ref = vq_argmin.vq_argmin_plain(z, cb)
        assert (out == ref).float().mean().item() >= 0.999
    # duplicated codes: the first index wins
    cb = torch.eye(4).repeat(2, 1).cuda()
    out = vq_argmin.vq_argmin(torch.eye(4).cuda(), cb)
    assert out.tolist() == [0, 1, 2, 3]


def test_wrappers_count_launches(gen):
    before = conv3.launches
    x = torch.randn(1, 64, 8, 8, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    conv3.conv3(x, torch.zeros(3, 64, 3, 3, device='cuda'))
    assert conv3.launches == before + 1
