"""The port's CUDA kernels against their plain PyTorch versions on the card.

The kernels have no CPU mode, so these tests skip without a CUDA device.
This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import pytest
import torch

from femasr_torch.kernels import (act_bf16, conv3, conv3_w8a8, matmul_w8a8,
                                  matmul_w8a8_q, vq_argmin, window_attention)
from femasr_torch.kernels.tolerance import assert_bf16_close
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
                                       (torch.bfloat16, None)])
@pytest.mark.parametrize('ci,outs', [(64, (64, 3)), (32, (32, 16))])
def test_conv3_kernel_matches_plain(gen, dtype, tol, ci, outs):
    # ragged H, W (not multiples of the 8x32 tile), B = 2; in bf16, Ci = 64
    # with O = 64 or 3 takes the tensor-core kernel, the rest the FFMA one
    x = torch.randn(2, ci, 37, 70, generator=gen).cuda().to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    bias = torch.randn(64, generator=gen).cuda() * 0.04
    scale = torch.rand(2, ci, generator=gen).cuda() + 0.5
    shift = torch.randn(2, ci, generator=gen).cuda()
    for o in outs:
        w = torch.randn(o, ci, 3, 3, generator=gen).cuda() * 0.04
        for kw in ({}, dict(scale=scale, shift=shift, pre_act='silu'),
                   dict(scale=scale, shift=shift, pre_act='silu',
                        act='lrelu')):
            out = conv3.conv3(x, w, bias[:o], **kw)
            ref = conv3.conv3_plain(x, w, bias[:o], **kw)
            assert out.is_contiguous(memory_format=torch.channels_last)
            assert out.dtype == dtype and out.shape == (2, o, 37, 70)
            if tol is not None:
                torch.testing.assert_close(out.float(), ref.float(),
                                           atol=tol, rtol=tol)
                continue
            xa = x.float()
            if kw:
                xa = torch.nn.functional.silu(
                    xa * scale[:, :, None, None] + shift[:, :, None, None])
            # one flipped input rounding: 2^-7 * max|x_act| * max|w|
            assert_bf16_close(out, ref, 2.0 ** -7 * xa.abs().max().item()
                              * w.abs().max().item())


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, None)])
@pytest.mark.parametrize('b_,nh,side', [(8, 8, 16), (100, 8, 40),
                                        (50, 2, 40)])
def test_window_attention_kernel_matches_plain(gen, dtype, tol, b_, nh,
                                               side):
    # side 40: nW = 25 windows, so windows straddle the blocks' item runs
    c = 32 * nh
    qkv = torch.randn(b_, 64, 3 * c, generator=gen).cuda().to(dtype)
    q = qkv[..., :c] * 32 ** -0.5
    k, v = qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.randn(nh, 64, 64, generator=gen).cuda() * 0.1
    mask = torch.from_numpy(shifted_window_mask(side, side, 8, 4)).cuda()
    for m in (None, mask):
        out = window_attention.window_attention(q, k, v, bias, m, nh)
        ref = window_attention.window_attention_plain(q, k, v, bias, m, nh)
        assert out.dtype == dtype and out.shape == (b_, 64, c)
        if tol is not None:
            torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                       rtol=tol)
        else:
            # one flipped p (< 1, ulp <= 2^-8): 2^-8 * max|v|
            assert_bf16_close(out, ref,
                              2.0 ** -8 * v.float().abs().max().item())


def test_vq_argmin_kernel_matches_plain(gen):
    # N and K not multiples of the 128-token and 128-code tiles; C not a
    # multiple of the 16-channel chunk (the wrapper zero-pads)
    for n, k, c in ((1000, 1024, 512), (77, 100, 36), (300, 1000, 64)):
        z = torch.randn(n, c, generator=gen).cuda()
        cb = torch.randn(k, c, generator=gen).cuda()
        ref = vq_argmin.vq_argmin_plain(z, cb)
        for splits in (None, 1, 2, 3, 8):
            out = vq_argmin.vq_argmin(z, cb, splits=splits)
            assert out.dtype == torch.int32 and out.shape == (n,)
            assert (out == ref).float().mean().item() >= 0.999
    # duplicated codes: the first index wins
    cb = torch.eye(4).repeat(2, 1).cuda()
    out = vq_argmin.vq_argmin(torch.eye(4).cuda(), cb)
    assert out.tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize('k', [1024, 1000])
def test_vq_argmin_kernel_first_index_wins_exact_ties(gen, k):
    # exact duplicates of a code placed in the same thread's column of a
    # later tile (+128), in another thread's column (+1 of 16), in another
    # range of codes (+512) and at the end; tokens near the first copy
    cb = torch.randn(k, 64, generator=gen) * 4
    firsts = torch.tensor([5, 17, 200, 300])
    copies = torch.tensor([133, 22, 712, k - 1])
    cb[copies] = cb[firsts]
    z = cb[firsts].repeat_interleave(50, 0)
    z = z + 0.01 * torch.randn(z.shape, generator=gen)
    z, cb = z.cuda(), cb.cuda()
    want = firsts.repeat_interleave(50).int().cuda()
    assert torch.equal(vq_argmin.vq_argmin_plain(z, cb), want)
    for splits in (None, 1, 2, 4, 8):
        assert torch.equal(vq_argmin.vq_argmin(z, cb, splits=splits), want)


def test_wrappers_count_launches(gen):
    before = conv3.launches, window_attention.launches
    x = torch.randn(1, 64, 8, 8, generator=gen).cuda().contiguous(
        memory_format=torch.channels_last)
    for dtype in (torch.float32, torch.bfloat16):
        conv3.conv3(x.to(dtype), torch.zeros(3, 64, 3, 3, device='cuda'))
        q = torch.randn(2, 64, 64, generator=gen).cuda().to(dtype)
        window_attention.window_attention(q, q, q, torch.zeros(
            2, 64, 64, device='cuda'), None, 2)
    # the plain versions (CPU tensors) launch nothing
    conv3.conv3(x.cpu(), torch.zeros(3, 64, 3, 3))
    assert (conv3.launches, window_attention.launches) == tuple(
        b + 2 for b in before)


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
@pytest.mark.parametrize('m,k,n', [(300, 256, 768), (77, 40, 3),
                                   (65, 256, 256), (130, 64, 320),
                                   (70, 1024, 64), (50, 100, 64)])
def test_matmul_w8a8_kernel_matches_plain(gen, dtype, m, k, n):
    """Both routes (tensor cores: K and N multiples of 64; qkv and proj
    shapes with M off the 64-row tile; N = 320 leaves three of the second
    N tile's four column warps past N; N = 64 one active warp column;
    K = 1024 sixteen K chunks per tile) and dp4a (K = 40, K = 100)."""
    x = torch.randn(m, k, generator=gen).cuda().to(dtype)
    w = torch.randn(n, k, generator=gen).cuda()
    b = torch.randn(n, generator=gen).cuda()
    tc = k % 64 == 0 and n % 64 == 0
    assert matmul_w8a8.route_of(k, n, x.data_ptr()) == (
        matmul_w8a8.TC if tc else matmul_w8a8.DP4A)
    for bias in (None, b):
        out = matmul_w8a8.matmul_w8a8(x, w, bias)
        ref = matmul_w8a8.matmul_w8a8_plain(x, w, bias)
        assert out.dtype == dtype and out.shape == (m, n)
        _w8a8_close(out, ref, dtype)
    if tc:   # the weight packed once, as LinearInt8 passes it
        out = matmul_w8a8.matmul_w8a8(x, w, b,
                                      packed=matmul_w8a8_q.weight_tc(w))
        _w8a8_close(out, matmul_w8a8.matmul_w8a8_plain(x, w, b), dtype)
    for act in ('gelu', 'silu', 'lrelu'):
        out = matmul_w8a8.matmul_w8a8(x, w, b, act=act)
        ref = matmul_w8a8.matmul_w8a8_plain(x, w, b, act=act)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-6 if
                                   dtype == torch.float32 else 2 ** -7,
                                   atol=1e-5)


@pytest.mark.parametrize('m,k,n', [(300, 256, 1024), (50, 1024, 256),
                                   (9, 36, 5), (50, 256, 1024),
                                   (300, 1024, 256), (128, 64, 320),
                                   (65, 128, 64), (70, 100, 64)])
def test_matmul_w8a8_q_kernel_matches_plain(gen, m, k, n):
    """Both routes (tensor cores: K and N multiples of 64; fc1 and fc2
    with M off the 64-row tile; N = 320 leaves three of the second block's
    four column warps past N, and its int8-out row max spans a cluster of
    two blocks; N = 64 one block of one active warp column)."""
    from femasr_torch.ops.layers import quantize_rows
    x_q, s_x = quantize_rows(torch.randn(m, k, generator=gen).cuda())
    w = torch.randn(n, k, generator=gen).cuda()
    b = torch.randn(n, generator=gen).cuda()
    assert matmul_w8a8_q.route_of(k, n, x_q.data_ptr()) == (
        matmul_w8a8_q.TC if k % 64 == 0 else matmul_w8a8_q.DP4A)
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
    # the other fused activations, model-dtype out (expf / tanhf may differ
    # from PyTorch's by an ulp)
    for act in ('gelu', 'silu', 'lrelu'):
        out = matmul_w8a8_q.matmul_w8a8_q(x_q, s_x, w, b, act=act,
                                          out_dtype=torch.float32)
        ref = matmul_w8a8_q.matmul_w8a8_q_plain(x_q, s_x, w, b, act=act,
                                                out_dtype=torch.float32)
        torch.testing.assert_close(out, ref, rtol=2e-6, atol=1e-5)
    # no bias; a zero row takes the 1e-12 scale floor
    x_q[m // 2] = 0
    q, s = matmul_w8a8_q.matmul_w8a8_q(x_q, s_x, w, None, out_int8=True)
    q_r, s_r = matmul_w8a8_q.matmul_w8a8_q_plain(x_q, s_x, w, None,
                                                 out_int8=True)
    assert torch.equal(q, q_r) and torch.equal(s, s_r)


def test_matmul_w8a8_q_tensor_cores_past_65535_row_tiles():
    """Row tiles run on grid.x: M = 65,535 x 64 + 65 rows, N = 320 (a
    cluster of two blocks along grid.y)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card (the kernels have no CPU mode)')
    g = torch.Generator(device='cuda').manual_seed(0)
    m, k, n = 65535 * 64 + 65, 64, 320
    x_q = torch.randint(-127, 128, (m, k), generator=g, device='cuda',
                        dtype=torch.int8)
    s_x = torch.rand((m, 1), generator=g, device='cuda') * 1e-2 + 1e-3
    w = torch.randn((n, k), generator=g, device='cuda')
    b = torch.randn((n,), generator=g, device='cuda')
    assert matmul_w8a8_q.route_of(k, n, x_q.data_ptr()) == matmul_w8a8_q.TC
    out = matmul_w8a8_q.matmul_w8a8_q(x_q, s_x, w, b,
                                      out_dtype=torch.bfloat16)
    _w8a8_close(out, matmul_w8a8_q.matmul_w8a8_q_plain(
        x_q, s_x, w, b, out_dtype=torch.bfloat16), torch.bfloat16)
    del out
    q, s = matmul_w8a8_q.matmul_w8a8_q(x_q, s_x, w, b, out_int8=True)
    q_r, s_r = matmul_w8a8_q.matmul_w8a8_q_plain(x_q, s_x, w, b,
                                                 out_int8=True)
    assert torch.equal(q, q_r)
    torch.testing.assert_close(s, s_r, rtol=1e-6, atol=0)


def test_linear_int8_chain_serves_weights_after_move_or_cast(gen):
    """LinearInt8 keeps its weight packed for B5's tensor-core route; after
    a forward, a move off the card and back, a cast, a reassigned .data
    and a load, each next forward serves the current weights."""
    from femasr_torch.ops.layers import LinearInt8, quantize_rows
    lin = LinearInt8(256, 1024).cuda()
    x = quantize_rows(torch.randn(100, 256, generator=gen).cuda())

    def check():
        for out_int8 in (False, True):
            out = lin(x, out_int8=out_int8)
            ref = matmul_w8a8_q.matmul_w8a8_q_plain(
                *x, lin.weight, lin.bias, out_int8=out_int8,
                out_dtype=torch.float32)
            if out_int8:
                assert torch.equal(out[0], ref[0])
                torch.testing.assert_close(out[1], ref[1], rtol=1e-6, atol=0)
            else:
                _w8a8_close(out, ref, torch.float32)

    check()
    for change in (lambda: lin.cpu().cuda(),
                   lambda: lin.to(torch.bfloat16),
                   lambda: setattr(lin.weight, 'data',
                                   torch.randn(1024, 256, device='cuda')),
                   lambda: lin.load_state_dict(dict(
                       weight=-lin.weight.detach(), bias=lin.bias.detach()))):
        change()
        check()


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('b,ci,o,h,w', [(2, 64, 64, 37, 70),
                                        (1, 64, 256, 9, 40),
                                        (1, 64, 3, 11, 40),
                                        (1, 128, 64, 20, 33),
                                        (1, 128, 256, 10, 35),
                                        (2, 128, 3, 9, 13),
                                        (2, 256, 256, 19, 45),
                                        (1, 256, 64, 17, 31),
                                        (1, 256, 3, 13, 21),
                                        (1, 40, 3, 9, 13),
                                        (2, 64, 40, 9, 35)])
def test_conv3_w8a8_kernel_matches_plain(gen, dtype, b, ci, o, h, w):
    # ragged H, W (not multiples of the 8x32 tile); B = 2 shares one s_x
    # (the second sample sets it); Ci % 64 == 0 with O % 64 == 0 or O <= 8
    # runs on the tensor cores, the rest on __dp4a
    x = torch.randn(b, ci, h, w, generator=gen).cuda().to(dtype)
    x[-1] *= 3.0
    x = x.contiguous(memory_format=torch.channels_last)
    wt = torch.randn(o, ci, 3, 3, generator=gen).cuda() * 0.05
    bias = torch.randn(o, generator=gen).cuda()
    want = (conv3_w8a8.TC if ci % 64 == 0 and (o % 64 == 0 or o <= 8)
            else conv3_w8a8.DP4A)
    assert conv3_w8a8.route_of(ci, o, x.data_ptr()) == want
    # the integer sums are exact, so with no act or lrelu the kernel runs
    # the plain version's f32 operations: equal bit for bit
    for bias_, act in ((bias, None), (None, None), (bias, 'lrelu')):
        out = conv3_w8a8.conv3_w8a8(x, wt, bias_, act=act)
        ref = conv3_w8a8.conv3_w8a8_plain(x, wt, bias_, act=act)
        assert out.is_contiguous(memory_format=torch.channels_last)
        assert out.dtype == dtype and out.shape == (b, o, h, w)
        assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()
    # expf / tanhf: the kernel's and PyTorch's may differ by an f32 ulp
    for act in ('silu', 'gelu'):
        out = conv3_w8a8.conv3_w8a8(x, wt, bias, act=act)
        ref = conv3_w8a8.conv3_w8a8_plain(x, wt, bias, act=act)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2e-6 if
                                   dtype == torch.float32 else 2 ** -7,
                                   atol=1e-5)


@pytest.mark.parametrize('act', ['silu', 'gelu'])
def test_act_bf16_kernel_matches_plain(gen, act):
    """The kernel against its twin (the JAX op sequence in bf16 as PyTorch
    ops): 16-byte aligned (eight values per load, a ragged tail), a view
    off the 16-byte grid (one value at a time), channels_last, and the
    edges (zeros, huge values, +-inf, NaN)."""
    x = torch.randn(70001, generator=gen).cuda() * 4
    x[:8] = torch.tensor([0.0, -0.0, 88.0, -88.0, 1e30, -1e30, float('inf'),
                          float('-inf')])
    x[8] = float('nan')
    x = x.bfloat16()
    cl = torch.randn(2, 64, 9, 13, generator=gen).cuda().bfloat16() \
        .contiguous(memory_format=torch.channels_last)
    for t in (x, x[1:], cl):
        before = act_bf16.launches
        out = act_bf16.act_bf16(t, act)
        assert act_bf16.launches == before + 1
        ref = act_bf16.act_bf16_plain(t, act)
        assert out.shape == t.shape and out.stride() == t.stride()
        fin = ref.isfinite()
        assert torch.equal(out.isnan(), ref.isnan())
        assert torch.equal(out[ref.isinf()], ref[ref.isinf()])
        assert_bf16_close(out[fin], ref[fin], 0.0)


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
