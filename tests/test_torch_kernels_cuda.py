"""The port's CUDA kernels against their plain PyTorch versions on the card.

The kernels have no CPU mode, so these tests skip without a CUDA device.
This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from femasr_torch.kernels import (conv3, conv3_w8a8, matmul_w8a8,
                                  matmul_w8a8_q, vq_argmin, window_attention)
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


def _w8a8_close(out, ref, dtype):
    """f32: 1e-6 relative (with act=None the kernel and the plain version
    run the same f32 operations on the same exact integer sums); bf16: one
    bf16 ulp (2^-7 relative at most)."""
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    else:
        torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('m,k,n', [(300, 256, 768), (77, 40, 3)])
def test_matmul_w8a8_kernel_matches_plain(gen, dtype, m, k, n):
    x = torch.randn(m, k, generator=gen).cuda().to(dtype)
    w = torch.randn(n, k, generator=gen).cuda()
    b = torch.randn(n, generator=gen).cuda()
    for bias in (None, b):
        out = matmul_w8a8.matmul_w8a8(x, w, bias)
        ref = matmul_w8a8.matmul_w8a8_plain(x, w, bias)
        assert out.dtype == dtype and out.shape == (m, n)
        _w8a8_close(out, ref, dtype)
    for act in ('gelu', 'silu', 'lrelu'):
        out = matmul_w8a8.matmul_w8a8(x, w, b, act=act)
        ref = matmul_w8a8.matmul_w8a8_plain(x, w, b, act=act)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-6 if
                                   dtype == torch.float32 else 2 ** -7,
                                   atol=1e-5)


@pytest.mark.parametrize('m,k,n', [(300, 256, 1024), (50, 1024, 256),
                                   (9, 36, 5)])
def test_matmul_w8a8_q_kernel_matches_plain(gen, m, k, n):
    from femasr_torch.ops.layers import quantize_rows
    x_q, s_x = quantize_rows(torch.randn(m, k, generator=gen).cuda())
    w = torch.randn(n, k, generator=gen).cuda()
    b = torch.randn(n, generator=gen).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        out = matmul_w8a8_q.matmul_w8a8_q(x_q, s_x, w, b, out_dtype=dtype)
        ref = matmul_w8a8_q.matmul_w8a8_q_plain(x_q, s_x, w, b,
                                                out_dtype=dtype)
        assert out.dtype == dtype
        _w8a8_close(out, ref, dtype)
    q, s = matmul_w8a8_q.matmul_w8a8_q(x_q, s_x, w, b, out_int8=True)
    q_r, s_r = matmul_w8a8_q.matmul_w8a8_q_plain(x_q, s_x, w, b,
                                                 out_int8=True)
    assert torch.equal(q, q_r)
    torch.testing.assert_close(s, s_r, rtol=1e-6, atol=0)
    # fused tanh GELU: codes equal except <= 0.1% that differ by one
    q, s = matmul_w8a8_q.matmul_w8a8_q(x_q, s_x, w, b, act='gelu',
                                       out_int8=True)
    q_r, s_r = matmul_w8a8_q.matmul_w8a8_q_plain(x_q, s_x, w, b, act='gelu',
                                                 out_int8=True)
    d = (q.int() - q_r.int()).abs()
    assert d.max().item() <= 1 and d.float().mean().item() <= 1e-3
    torch.testing.assert_close(s, s_r, rtol=1e-6, atol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,ci,o,h,w', [(2, 64, 64, 37, 70),
                                        (1, 128, 64, 20, 33),
                                        (1, 40, 3, 9, 13)])
def test_conv3_w8a8_kernel_matches_plain(gen, dtype, b, ci, o, h, w):
    x = torch.randn(b, ci, h, w, generator=gen).cuda().to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    wt = torch.randn(o, ci, 3, 3, generator=gen).cuda() * 0.05
    bias = torch.randn(o, generator=gen).cuda()
    out = conv3_w8a8.conv3_w8a8(x, wt, bias)
    ref = conv3_w8a8.conv3_w8a8_plain(x, wt, bias)
    assert out.is_contiguous(memory_format=torch.channels_last)
    _w8a8_close(out, ref, dtype)
    out = conv3_w8a8.conv3_w8a8(x, wt, None, act='silu')
    ref = conv3_w8a8.conv3_w8a8_plain(x, wt, None, act='silu')
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-6 if
                               dtype == torch.float32 else 2 ** -7, atol=1e-5)


def test_int8_wrappers_count_launches(gen):
    from femasr_torch.ops.layers import quantize_rows
    x = torch.randn(32, 64, generator=gen).cuda()
    w = torch.randn(16, 64, generator=gen).cuda()
    before = (matmul_w8a8.launches, matmul_w8a8_q.launches,
              conv3_w8a8.launches)
    matmul_w8a8.matmul_w8a8(x, w)
    matmul_w8a8_q.matmul_w8a8_q(*quantize_rows(x), w, out_int8=True)
    conv3_w8a8.conv3_w8a8(x.view(1, 64, 4, 8).contiguous(
        memory_format=torch.channels_last), torch.zeros(3, 64, 3, 3).cuda())
    # the plain versions (CPU tensors) launch nothing
    matmul_w8a8.matmul_w8a8(x.cpu(), w.cpu())
    assert (matmul_w8a8.launches, matmul_w8a8_q.launches,
            conv3_w8a8.launches) == tuple(b + 1 for b in before)
