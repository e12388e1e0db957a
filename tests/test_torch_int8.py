"""B4-B6, the int8 kernels: the port's plain versions (what the CUDA kernels
compute) against the JAX Pallas kernels in interpret mode, on the CPU, at
the shapes of tests/test_pallas_int8.py. Integer sums are exact on both
sides and the f32 epilogue runs the same operations, so the tolerances are
those of f32 rounding: 1e-6 for the matmuls, 1e-5 for the conv (the JAX
suite's own bound). The tanh GELU differs by at most one f32 ulp between
jax.nn.gelu and F.gelu; with int8 output that may move a code by one, on
at most 0.1% of the codes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch.kernels.conv3_w8a8 import conv3_w8a8
from femasr_torch.kernels.matmul_w8a8 import matmul_w8a8
from femasr_torch.kernels.matmul_w8a8_q import matmul_w8a8_q
from femasr_torch.ops.layers import quantize_rows
from femasr_tpu.ops.layers import quantize_rows as jquantize_rows
from femasr_tpu.ops.pallas import int8_dense as J
from torch_port_util import nchw, nhwc


def _t(a):
    return torch.from_numpy(np.array(a))


def _dense(seed, m, k, n, lead=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(lead or (m,)) + (k,)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize('m,k,n', [(64, 32, 48), (300, 256, 768),
                                   (128, 512, 128)])
def test_matmul_w8a8_plain_matches_pallas(m, k, n):
    x, w, b = _dense(0, m, k, n)
    ref = J.matmul_w8a8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        tm=128, tn=128, interpret=True)
    out = matmul_w8a8(_t(x), _t(w.T), _t(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_matmul_w8a8_plain_bf16_leading_dims():
    x, w, _ = _dense(1, None, 96, 64, lead=(2, 7))
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    ref = J.matmul_w8a8(xj, jnp.asarray(w), None, tm=128, tn=128,
                        interpret=True)
    xt = _t(xj.astype(jnp.float32)).bfloat16()
    out = matmul_w8a8(xt, _t(w.T))
    assert out.dtype == torch.bfloat16 and out.shape == (2, 7, 64)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('act', ['gelu', 'silu', 'lrelu'])
def test_matmul_w8a8_plain_fused_act(act):
    x, w, b = _dense(2, 64, 128, 64)
    ref = J.matmul_w8a8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                        act=act, tm=64, tn=64, interpret=True)
    out = matmul_w8a8(_t(x), _t(w.T), _t(b), act=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_quantize_rows_matches_jax():
    x = np.random.default_rng(3).normal(size=(5, 40, 96)).astype(np.float32)
    x[0, 0] = 0.0                       # an all-zero row: scale 1e-12
    q_j, s_j = jquantize_rows(jnp.asarray(x))
    q, s = quantize_rows(_t(x))
    assert q.dtype == torch.int8 and s.shape == (5, 40, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))


def _ptok(seed, m, k, n):
    x, w, b = _dense(seed, m, k, n)
    x_q, s_x = jquantize_rows(jnp.asarray(x))
    return (x_q, s_x, w, b), (_t(np.asarray(x_q)), _t(np.asarray(s_x)),
                              _t(w.T), _t(b))


@pytest.mark.parametrize('m,k,n', [(64, 96, 48), (300, 256, 1024)])
@pytest.mark.parametrize('out_int8', [False, True])
def test_matmul_w8a8_q_plain_matches_pallas(m, k, n, out_int8):
    (xj, sj, wj, bj), (x, s, w, b) = _ptok(11, m, k, n)
    ref = J.matmul_w8a8_q(xj, sj, jnp.asarray(wj), jnp.asarray(bj),
                          out_int8=out_int8, out_dtype=jnp.float32, tm=128,
                          interpret=True)
    out = matmul_w8a8_q(x, s, w, b, out_int8=out_int8,
                        out_dtype=torch.float32)
    if out_int8:
        np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
        np.testing.assert_allclose(out[1].numpy(), np.asarray(ref[1]),
                                   rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)


def _assert_codes_within_one(q, q_ref):
    d = np.abs(q.astype(np.int32) - q_ref.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert d.mean() <= 1e-3, d.mean()


@pytest.mark.parametrize('m,k,n', [(64, 96, 48), (300, 256, 1024)])
def test_matmul_w8a8_q_plain_gelu_int8_out(m, k, n):
    (xj, sj, wj, bj), (x, s, w, b) = _ptok(12, m, k, n)
    ref = J.matmul_w8a8_q(xj, sj, jnp.asarray(wj), jnp.asarray(bj),
                          act='gelu', out_int8=True, tm=128, interpret=True)
    q, s_y = matmul_w8a8_q(x, s, w, b, act='gelu', out_int8=True)
    _assert_codes_within_one(q.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(s_y.numpy(), np.asarray(ref[1]), rtol=1e-6,
                               atol=0)


def test_matmul_w8a8_q_plain_two_link_chain():
    rng = np.random.default_rng(13)
    x = rng.normal(size=(200, 64)).astype(np.float32)
    w1 = rng.normal(size=(64, 256)).astype(np.float32)
    b1 = rng.normal(size=(256,)).astype(np.float32)
    w2 = rng.normal(size=(256, 64)).astype(np.float32)
    b2 = rng.normal(size=(64,)).astype(np.float32)
    xq_j, sx_j = jquantize_rows(jnp.asarray(x))
    h_j = J.matmul_w8a8_q(xq_j, sx_j, jnp.asarray(w1), jnp.asarray(b1),
                          act='gelu', out_int8=True, tm=64, interpret=True)
    ref = J.matmul_w8a8_q(h_j[0], h_j[1], jnp.asarray(w2), jnp.asarray(b2),
                          out_dtype=jnp.float32, tm=64, interpret=True)
    h = matmul_w8a8_q(*quantize_rows(_t(x)), _t(w1.T), _t(b1), act='gelu',
                      out_int8=True)
    _assert_codes_within_one(h[0].numpy(), np.asarray(h_j[0]))
    np.testing.assert_allclose(h[1].numpy(), np.asarray(h_j[1]), rtol=1e-6,
                               atol=0)
    # the second link on the first link's JAX codes is exact up to f32
    out = matmul_w8a8_q(_t(np.asarray(h_j[0])), _t(np.asarray(h_j[1])),
                        _t(w2.T), _t(b2), out_dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def _conv(seed, b, h, w, ci, co):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, ci)).astype(np.float32)
    k = rng.normal(size=(3, 3, ci, co)).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    return x, k, bias


def _torch_conv_args(x, k):
    return (nchw(x).contiguous(memory_format=torch.channels_last),
            _t(k.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize('h,w,ci,co', [(8, 8, 16, 24), (13, 9, 8, 8),
                                       (10, 12, 64, 3)])
def test_conv3_w8a8_plain_matches_pallas(h, w, ci, co):
    x, k, bias = _conv(3, 1, h, w, ci, co)
    ref = J.conv3_w8a8(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias),
                       th=4, interpret=True)
    xt, kt = _torch_conv_args(x, k)
    out = conv3_w8a8(xt, kt, _t(bias))
    assert out.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_conv3_w8a8_plain_batch_shares_one_scale_and_fused_silu():
    x, k, _ = _conv(4, 2, 8, 8, 8, 8)
    x[1] *= 10.0     # the second sample sets the scale of both
    ref = J.conv3_w8a8(jnp.asarray(x), jnp.asarray(k), None, act='silu',
                       th=4, interpret=True)
    xt, kt = _torch_conv_args(x, k)
    out = conv3_w8a8(xt, kt, None, act='silu')
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    # per-sample scales would give the first sample finer codes
    alone = conv3_w8a8(xt[:1], kt, None, act='silu')
    assert not torch.allclose(alone, out[:1], rtol=1e-5, atol=1e-5)
