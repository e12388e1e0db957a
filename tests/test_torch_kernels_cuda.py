"""The port's CUDA kernels against their plain PyTorch versions on the card.

The kernels have no CPU mode, so these tests skip without a CUDA device.
This file imports neither jax nor the JAX package, so it also runs where
only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q
"""

import contextlib

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
    # FeMaSR's shape: the N = 64, head_dim 32 tensor-core kernel in bf16
    assert window_attention.route_of(q, k, v, nh) == (
        window_attention.F32 if dtype == torch.float32
        else window_attention.TC64)
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


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5),
                                       (torch.bfloat16, None)])
@pytest.mark.parametrize('b_,n,c,nh,offset', [
    (8, 64, 180, 6, 0),     # SwinIR-M: head_dim 30, 4-byte aligned slices
    (8, 64, 60, 6, 0),      # SwinIR-S: head_dim 10
    (8, 49, 180, 6, 0),     # SwinIR-M JPEG: N 49
    (4, 49, 42, 6, 0),      # head_dim 7: odd, element loads
    (4, 64, 96, 2, 0),      # head_dim 48: an odd count of k-steps
    (4, 36, 128, 2, 0),     # head_dim 64, N 36
    (4, 1, 16, 1, 0),       # one token a window
    (8, 64, 256, 8, 1)])    # FeMaSR's shape, misaligned: the padded route
def test_window_attention_any_shape_matches_plain(gen, dtype, tol, b_, n, c,
                                                  nh, offset):
    qkv = torch.randn(b_, n, 3 * c + offset, generator=gen).cuda().to(
        dtype)[..., offset:]
    q = qkv[..., :c] * (c // nh) ** -0.5
    k, v = qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.randn(nh, n, n, generator=gen).cuda() * 0.1
    side = {49: (14, 7), 64: (16, 8)}.get(n)
    masks = [None]
    if side is not None:
        masks.append(torch.from_numpy(shifted_window_mask(
            side[0], side[0], side[1], side[1] // 2)).cuda())
    else:   # a random 0 / -100 mask over 2 windows, the diagonal kept
        m = (torch.rand(2, n, n, generator=gen) < 0.3).float() * -100.0
        masks.append(m.masked_fill(torch.eye(n, dtype=torch.bool), 0.0)
                     .cuda())
    want = (window_attention.F32 if dtype == torch.float32 else
            window_attention.TC)
    assert window_attention.route_of(q, k, v, nh) == want
    for m in masks:
        out = window_attention.window_attention(q, k, v, bias, m, nh)
        ref = window_attention.window_attention_plain(q, k, v, bias, m, nh)
        assert out.dtype == dtype and out.shape == (b_, n, c)
        if tol is not None:
            torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                       rtol=tol)
        else:
            assert_bf16_close(out, ref,
                              2.0 ** -8 * v.float().abs().max().item())


def test_window_attention_refuses_beyond_its_limits(gen):
    for n, c, nh in ((81, 64, 2), (64, 130, 2)):
        q = torch.zeros(2, n, c, device='cuda')
        with pytest.raises(ValueError, match='N <= 64 tokens'):
            window_attention.window_attention(
                q, q, q, torch.zeros(nh, n, n, device='cuda'), None, nh)


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


@pytest.mark.parametrize('splits', [1, 3])
def test_vq_argmin_kernel_distance_is_the_compared_one(gen, splits):
    # with its distance: the same indices, and the distance within f32
    # rounding of the plain version's (one code range and three: the
    # merge writes it)
    z = torch.randn(2000, 512, generator=gen).cuda()
    cb = torch.randn(1000, 512, generator=gen).cuda()
    idx = vq_argmin.vq_argmin(z, cb, splits=splits)
    idx_d, dist = vq_argmin.vq_argmin(z, cb, splits=splits, with_dist=True)
    assert torch.equal(idx_d, idx) and dist.dtype == torch.float32
    ref_idx, ref = vq_argmin.vq_argmin_plain(z, cb, with_dist=True)
    assert (idx == ref_idx).float().mean().item() >= 0.999
    assert (dist - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_vq_argmin_split_search_equals_the_whole_search(gen):
    # the codebook in two and four shards, as tensor-parallel ranks hold
    # it: each shard's (distance, index) pairs reduced by the kernel's
    # rule give the whole search's indices bit for bit, exact ties across
    # the shards included (code j + 512 repeats code j)
    from femasr_torch.parallel.tensor_parallel import first_minimum
    cb = torch.randn(1024, 512, generator=gen)
    cb[512:520] = cb[:8]
    z = torch.cat([cb[:8].repeat_interleave(4, 0),
                   torch.randn(5000, 512, generator=gen)]).cuda()
    cb = cb.cuda()
    whole = vq_argmin.vq_argmin(z, cb)
    assert (whole[:32] < 8).all()
    for shards in (2, 4):
        n = 1024 // shards
        parts = [vq_argmin.vq_argmin(z, cb[s * n:(s + 1) * n],
                                     with_dist=True) for s in range(shards)]
        got = first_minimum([d for _, d in parts],
                            [i.long() + s * n for s, (i, _) in
                             enumerate(parts)])
        assert torch.equal(got.int(), whole), shards


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

    @torch.no_grad()      # the layer's parameters require grad
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


def test_validation_through_kernels_matches_plain(gen, tmp_path):
    """Validation of a SMALL-codebook LQ model on the card: per image B1 5,
    B2 24 and B3 1 launches, no other kernel; then the same validation
    with every wrapper on its plain version: >= 99.9% equal codebook
    indices and an output mean abs diff <= 1e-4 per image, PSNR within
    0.01 dB and SSIM within 1e-4."""
    import cv2
    import numpy as np

    from femasr_torch import kernels
    from femasr_torch.data import PairedImageDataset, build_eval_loader
    from femasr_torch.models import FeMaSRNet, init_weights
    from femasr_torch.models.inference import flip_pad
    from femasr_torch.train import FeMaSRModel

    rng = np.random.default_rng(0)
    for sub in ('gt', 'lq'):
        (tmp_path / sub).mkdir()
    for i, (h, w) in enumerate(((36, 52), (52, 40))):
        coarse = rng.random((h // 4, w // 4, 3)).astype(np.float32)
        gt = cv2.resize(coarse, (4 * w, 4 * h),
                        interpolation=cv2.INTER_LINEAR)
        gt = (np.clip(gt, 0, 1) * 255).round().astype(np.uint8)
        cv2.imwrite(str(tmp_path / 'gt' / f'{i}.png'), gt)
        cv2.imwrite(str(tmp_path / 'lq' / f'{i}.png'),
                    cv2.resize(gt, (w, h), interpolation=cv2.INTER_AREA))
    small = [[32, 16, 32]]
    net = FeMaSRNet(small, LQ_stage=True)
    init_weights(net, torch.Generator().manual_seed(3))
    torch.save({'params': net.state_dict()}, str(tmp_path / 'g.pth'))
    metric = {'crop_border': 4, 'test_y_channel': True}
    model = FeMaSRModel({
        'name': 'val_card', 'is_train': False, 'device': 'cuda',
        'manual_seed': 0, 'path': {'pretrain_network_g':
                                   str(tmp_path / 'g.pth')},
        'network_g': {'type': 'FeMaSRNet', 'codebook_params': small,
                      'LQ_stage': True, 'scale_factor': 4},
        'val': {'metrics': {'psnr': dict(type='psnr', **metric),
                            'ssim': dict(type='ssim', **metric)}}})
    loader = build_eval_loader(PairedImageDataset({
        'name': 'card', 'phase': 'val', 'dataroot_gt': str(tmp_path / 'gt'),
        'dataroot_lq': str(tmp_path / 'lq')}))
    kernels.reset_launches()
    model.validation(loader, 0, None)
    want = {'conv3': 10, 'window_attention': 48, 'vq_argmin': 2}
    assert kernels.launch_counts() == {k: want.get(k, 0)
                                       for k in kernels.MODULES}
    runs = []
    for ctx in (contextlib.nullcontext(), kernels.plain_versions()):
        with ctx:
            model.validation(loader, 0, None)
            outs = []
            for batch in loader:
                x = batch['lq'].cuda()
                h, w = x.shape[2:]
                xp = flip_pad(x, (h // 16 + 1) * 16 - h,
                              (w // 16 + 1) * 16 - w)
                with torch.no_grad():
                    out, _, _, idx = model.net_g(xp)
                outs.append((out.clamp(0, 1)[:, :, :4 * h, :4 * w], idx[0]))
        runs.append((dict(model.metric_results), outs))
    (mk, ok), (mp, op) = runs
    for (out_k, idx_k), (out_p, idx_p) in zip(ok, op):
        assert (idx_k == idx_p).float().mean().item() >= 0.999
        assert (out_k - out_p).abs().mean().item() <= 1e-4
    assert abs(mk['psnr'] - mp['psnr']) <= 0.01
    assert abs(mk['ssim'] - mp['ssim']) <= 1e-4


def test_bf16_g_step_kernels_match_plain(gen, tmp_path):
    """One bf16 LQ-stage generator step of a SMALL-codebook model on the
    card (network_g / network_d bfloat16): the frozen prior runs B1 on its
    bf16 tensor-core route (5 launches), act_bf16 and B3, the trainee's
    search B3 (2 B3 in all), the trainee's layers their plain versions.
    Then the same step with every wrapper on its plain version: the
    prior's indices >= 99.9% equal, the loss within 1e-3 relative, every
    gradient within 1e-2 of its max or within twice the spread of two
    steps through the kernels (the bf16 backward is not bit for bit on
    the card: chip_smoke.py measures 7.6e-3 of their max run to run at the
    release width)."""
    from femasr_torch import kernels
    from femasr_torch.models import FeMaSRNet, init_weights
    from femasr_torch.train import FeMaSRModel

    small = [[32, 16, 32]]
    hq = FeMaSRNet(small, LQ_stage=False)
    init_weights(hq, torch.Generator().manual_seed(1))
    torch.save({'params': hq.state_dict()}, str(tmp_path / 'hq.pth'))
    model = FeMaSRModel({
        'name': 'bf16_card', 'is_train': True, 'device': 'cuda',
        'manual_seed': 0, 'scale': 4,
        'network_g': {'type': 'FeMaSRNet', 'codebook_params': small,
                      'LQ_stage': True, 'scale_factor': 4,
                      'dtype': 'bfloat16', 'vq_index_f32': True},
        'network_d': {'type': 'UNetDiscriminatorSN', 'num_feat': 16,
                      'dtype': 'bfloat16'},
        'path': {'pretrain_network_hq': str(tmp_path / 'hq.pth')},
        'train': {
            'optim_g': {'type': 'Adam', 'lr': 1e-4},
            'optim_d': {'type': 'Adam', 'lr': 1e-4},
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                        'loss_weight': 0.1},
            'codebook_opt': {'loss_weight': 1.0}}})
    g = torch.Generator().manual_seed(5)
    lq = torch.rand((2, 3, 64, 64), generator=g).cuda()
    gt = torch.rand((2, 3, 256, 256), generator=g).cuda()
    runs = []
    for ctx in (contextlib.nullcontext(), contextlib.nullcontext(),
                kernels.plain_versions()):
        kernels.reset_launches()
        with ctx:
            model.opt_g.zero_grad(set_to_none=True)
            total, _, _, _, gt_idx = model.g_backward(lq, gt)
        runs.append((total.item(), gt_idx[0], kernels.launch_counts(), {
            n: p.grad.clone() for n, p in model.net_g.named_parameters()
            if p.grad is not None}))
    (lk, ik, ck, gk), (_, _, _, gk2), (lp, ip, cp, gp) = runs
    assert ck['conv3'] == 5 and ck['vq_argmin'] == 2 and ck['act_bf16'] > 0
    assert {k: v for k, v in ck.items()
            if k not in ('conv3', 'vq_argmin', 'act_bf16')} == {
        'window_attention': 0, 'matmul_w8a8': 0, 'matmul_w8a8_q': 0,
        'conv3_w8a8': 0}
    assert not any(cp.values())
    assert (ik == ip).float().mean().item() >= 0.999
    assert abs(lk - lp) <= 1e-3 * abs(lp)
    assert gk.keys() == gp.keys() and len(gk) > 300

    def of_max(a, b):
        return {n: ((a[n] - b[n]).abs().max()
                    / b[n].abs().max().clamp_min(1e-30)).item() for n in b}
    spread = max(of_max(gk2, gk).values())
    for n, err in of_max(gk, gp).items():
        assert err <= max(1e-2, 2 * spread), (n, err, spread)


def test_degradation_on_card_matches_cpu_without_sync(gen):
    """The on-device BSRGAN degradation of a batch of 8 smooth 256 px GT
    crops, stage by stage: a warm call runs under
    set_sync_debug_mode('error'); under the same draws (kernels and noise
    fields handed to both), each stage on the card against the same stage
    on the CPU fed the card's input: the blurs, resizes and noise within
    1e-4, each JPEG's differences confined to its 16x16 blocks, in at most
    1% of them (a near-tie of round(coeff / q) between two f32 summation
    orders moves a whole block)."""
    import torch.nn.functional as F

    from femasr_torch.ops import degradations as D
    coarse = torch.rand(8, 3, 32, 32, generator=gen)
    gt = F.interpolate(coarse, size=(256, 256), mode='bilinear',
                       align_corners=False).cuda()
    touched = blocks = 0
    for seed in range(8):
        draws = D.draw_degradation(
            torch.Generator('cuda').manual_seed(seed), gt.shape, 4)
        lq = D.apply_degradation(gt, draws, 4)
        torch.cuda.set_sync_debug_mode('error')
        try:        # warm: every matrix of these draws is on the card
            again = D.apply_degradation(gt, draws, 4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(lq, again) and lq.shape == (8, 3, 64, 64)
        x = gt
        for (name, card), (_, cpu) in zip(
                D.degradation_stages(draws, 256, 256, 4),
                D.degradation_stages(draws.to('cpu'), 256, 256, 4)):
            y = card(x)
            diff = (y.cpu() - cpu(x.cpu())).abs().amax(dim=1)
            if 'jpeg' not in name:
                assert float(diff.max()) <= 1e-4, (seed, name)
            else:
                b, h, w = diff.shape
                bad = (diff > 1e-4).reshape(b, h // 16, 16, w // 16, 16)
                touched += int(bad.any(dim=4).any(dim=2).sum())
                blocks += b * (h // 16) * (w // 16)
            x = y
        assert torch.equal(x, lq)
    assert touched <= 0.01 * blocks, (touched, blocks)


def test_ddp_world1_nccl_step_equals_the_bare_step(gen, tmp_path,
                                                   monkeypatch):
    """One f32 LQ-stage G step and D step of a SMALL-codebook model in a
    world-1 NCCL process group (init_dist('pytorch'): net_g and net_d in
    DistributedDataParallel) against the same step without one: the frozen
    prior and the trainee's search run B1 5 and B3 2 times through DDP as
    without; the losses and every gradient (all-reduced over the one rank)
    within 1e-6 of their max, or twice the spread of two bare models'
    steps."""
    import socket

    import torch.distributed as dist

    from femasr_torch import kernels
    from femasr_torch.models import FeMaSRNet, init_weights
    from femasr_torch.parallel import init_dist
    from femasr_torch.train import FeMaSRModel

    small = [[32, 16, 32]]
    hq = FeMaSRNet(small, LQ_stage=False)
    init_weights(hq, torch.Generator().manual_seed(1))
    torch.save({'params': hq.state_dict()}, str(tmp_path / 'hq.pth'))
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
                     MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)

    def model(dist_on):
        return FeMaSRModel({
            'name': 'ddp_card', 'is_train': True, 'device': 'cuda:0',
            'manual_seed': 0, 'scale': 4, 'dist': dist_on,
            'network_g': {'type': 'FeMaSRNet', 'codebook_params': small,
                          'LQ_stage': True, 'scale_factor': 4},
            'network_d': {'type': 'UNetDiscriminatorSN', 'num_feat': 16},
            'path': {'pretrain_network_hq': str(tmp_path / 'hq.pth')},
            'train': {
                'optim_g': {'type': 'Adam', 'lr': 1e-4},
                'optim_d': {'type': 'Adam', 'lr': 1e-4},
                'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
                'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                            'loss_weight': 0.1},
                'codebook_opt': {'loss_weight': 1.0}}})

    def step(m):
        kernels.reset_launches()
        m.opt_g.zero_grad(set_to_none=True)
        m.opt_d.zero_grad(set_to_none=True)
        total, _, out, _, _ = m.g_backward(lq, gt)
        l_real = m._d_phase(gt, True, 1, sync=False)[0]
        l_fake = m._d_phase(out, False, 1)[0]
        torch.cuda.synchronize()
        grads = {f'{net}.{n}': p.grad.clone()
                 for net, mod in (('g', m.net_g), ('d', m.net_d))
                 for n, p in mod.named_parameters() if p.grad is not None}
        losses = torch.stack([total, l_real, l_fake]).cpu()
        return losses, grads, kernels.launch_counts()

    g = torch.Generator().manual_seed(5)
    lq = torch.rand((2, 3, 64, 64), generator=g).cuda()
    gt = torch.rand((2, 3, 256, 256), generator=g).cuda()
    runs = [step(model(False)), step(model(False))]   # the spread
    init_dist('pytorch', device='cuda:0')
    try:
        assert dist.get_backend() == 'nccl'
        ddp = model(True)
        assert type(ddp.net_g_train).__name__ == 'DistributedDataParallel'
        runs.append(step(ddp))
    finally:
        dist.destroy_process_group()
    (l0, g0, c0), (l1, g1, _), (l2, g2, c2) = runs
    assert c0 == c2 and c2['conv3'] == 5 and c2['vq_argmin'] == 2

    def of_max(a, b):
        return max(((a[n] - b[n]).abs().max()
                    / b[n].abs().max().clamp_min(1e-30)).item() for n in b)
    spread = of_max(g1, g0)
    assert g2.keys() == g0.keys() and len(g0) > 300
    assert of_max(g2, g0) <= max(1e-6, 2 * spread), (of_max(g2, g0), spread)
    assert ((l2 - l0).abs() <= 1e-6 * l0.abs()).all()


def test_device_prefetcher_stages_on_its_own_stream(gen):
    """DevicePrefetcher: the staged tensors equal the loader's, they come
    from a copy on a stream other than the caller's (which waits for it),
    nothing synchronizes (set_sync_debug_mode('error')), and a batch that
    is not pinned is refused."""
    from femasr_torch.data.loader import DevicePrefetcher
    batches = [{'gt': torch.rand((2, 3, 64, 64), generator=gen).pin_memory(),
                'gt_path': [f'{i}a', f'{i}b']} for i in range(4)]
    prefetcher = DevicePrefetcher(batches, 'cuda')
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        got = [(b['gt'] * 2, b['gt_path']) for b in prefetcher]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    side = prefetcher.stream
    assert side is not None and side != torch.cuda.current_stream()
    assert [p for _, p in got] == [b['gt_path'] for b in batches]
    for (y, _), b in zip(got, batches):
        assert y.is_cuda and torch.equal(y.cpu(), b['gt'] * 2)
    with pytest.raises(ValueError, match='pinned'):
        next(iter(DevicePrefetcher([{'gt': torch.zeros(2)}], 'cuda')))


def test_shardstore_native_build_reads_on_the_card_machine(gen, tmp_path):
    """The shard store's C++ library builds with the machine's g++ and its
    reads and draws equal the numpy twin's."""
    import numpy as np

    from femasr_torch.data import shardstore
    rng = np.random.default_rng(0)
    path = str(tmp_path / 's.fmrs')
    with shardstore.ShardStoreWriter(path) as w:
        for i in range(3):
            w.add(f'k{i}', rng.integers(0, 256, (40 + i, 33, 3), np.uint8))
    native, plain = (shardstore.ShardStoreReader(path),
                     shardstore.PlainShardReader(path))
    assert native.keys() == plain.keys() == ['k0', 'k1', 'k2']
    assert all(np.array_equal(native.read(i), plain.read(i))
               for i in range(3))
    assert np.array_equal(native.sample_batch([2, 0, 1, 2], 32, seed=9),
                          plain.sample_batch([2, 0, 1, 2], 32, seed=9))
