"""B1 conv3: the port's plain version (what the CUDA kernel computes) and
its ResBlock against the JAX ws2d Pallas kernel (interpret mode) and the
flax ResBlock, on the CPU. Tolerance 2e-5 for the f32 conv (the JAX
suite's kernel-vs-composite bound), 1e-5 for the module. In bf16 both
round the activated input and the weight to bf16 before the conv: one bf16
ulp, with at most 0.1% of outputs one flipped input rounding further."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch.kernels import conv3 as conv3_mod
from femasr_torch.kernels.tolerance import assert_bf16_close
from femasr_torch.models.convert import _resblock_entries
from femasr_torch.ops.layers import GroupNorm as TGroupNorm
from femasr_torch.ops.layers import ResBlock as TResBlock
from femasr_tpu.ops.layers import GroupNormWs2DAffine, ResBlock, from_ws2d, to_ws2d
from femasr_tpu.ops.pallas.ws2d_conv import conv3_ws2d
from torch_port_util import carry, nchw, nhwc, randomize


def _inputs(seed, h, w, ci, co):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, ci)).astype(np.float32)
    k = (rng.normal(size=(3, 3, ci, co)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(co,)) * 0.05).astype(np.float32)
    return x, k, b


def _torch_weight(k):
    return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _check(out, ref, x_act, k):
    """f32: 2e-5. bf16: see the module note; one flipped input rounding
    moves an output by at most 2^-7 * max|x_act| * max|w|."""
    ref = np.asarray(ref.astype(jnp.float32))
    if out.dtype == torch.float32:
        np.testing.assert_allclose(nhwc(out), ref, atol=2e-5, rtol=2e-5)
    else:
        assert_bf16_close(nhwc(out), ref,
                          2.0 ** -7 * np.abs(x_act).max() * np.abs(k).max())


F32 = (torch.float32, jnp.float32)
BF16 = (torch.bfloat16, jnp.bfloat16)


@pytest.mark.parametrize('prologue,dtype,jdtype', [
    pytest.param(False, *F32, id='False'),
    pytest.param(True, *F32, id='True'),
    pytest.param(False, *BF16, id='False-bf16'),
    pytest.param(True, *BF16, id='True-bf16')])
def test_conv3_plain_matches_ws2d_kernel(prologue, dtype, jdtype):
    x, k, b = _inputs(0, 8, 16, 64, 64)
    x = np.asarray(jnp.asarray(x).astype(jdtype).astype(jnp.float32))
    xj = to_ws2d(jnp.asarray(x))
    kw_j, kw_t = {}, {}
    if prologue:
        gn = GroupNormWs2DAffine(num_groups=32, eps=1e-6)
        params = randomize(jax.eval_shape(
            gn.init, jax.random.PRNGKey(0), xj)['params'], 1)
        a, bb = gn.apply({'params': params}, xj)          # (B, 2C) ws2d
        kw_j = dict(pre_scale=a, pre_bias=bb, pre_act='silu')
        c = x.shape[-1]
        kw_t = dict(scale=torch.from_numpy(np.array(a)[:, :c]),
                    shift=torch.from_numpy(np.array(bb)[:, :c]),
                    pre_act='silu')
    ref = from_ws2d(conv3_ws2d(xj.astype(jdtype), jnp.asarray(k),
                               jnp.asarray(b), interpret=True, **kw_j))
    xt = nchw(x).to(dtype).contiguous(memory_format=torch.channels_last)
    out = conv3_mod.conv3(xt, _torch_weight(k), torch.from_numpy(b), **kw_t)
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert out.dtype == dtype
    x_act = x
    if prologue:
        x_act = nhwc(torch.nn.functional.silu(
            nchw(x) * kw_t['scale'][:, :, None, None]
            + kw_t['shift'][:, :, None, None]))
    _check(out, ref, x_act, k)


def _out_conv_64_to_3(dtype, jdtype):
    x, k, b = _inputs(1, 8, 16, 64, 3)
    x = np.asarray(jnp.asarray(x).astype(jdtype).astype(jnp.float32))
    ref = from_ws2d(conv3_ws2d(to_ws2d(jnp.asarray(x)).astype(jdtype),
                               jnp.asarray(k), jnp.asarray(b),
                               interpret=True))
    out = conv3_mod.conv3(
        nchw(x).to(dtype).contiguous(memory_format=torch.channels_last),
        _torch_weight(k), torch.from_numpy(b))
    assert out.dtype == dtype
    _check(out, ref, x, k)


def test_conv3_plain_out_conv_64_to_3():
    _out_conv_64_to_3(*F32)


def test_conv3_plain_out_conv_64_to_3_bf16():
    _out_conv_64_to_3(*BF16)


def test_groupnorm_affine_matches_ws2d_affine():
    x, _, _ = _inputs(2, 8, 16, 64, 64)
    xj = to_ws2d(jnp.asarray(x))
    gn = GroupNormWs2DAffine(num_groups=32, eps=1e-6)
    params = randomize(jax.eval_shape(
        gn.init, jax.random.PRNGKey(0), xj)['params'], 3)
    a, bb = gn.apply({'params': params}, xj)
    tgn = TGroupNorm(32, 64)
    tgn.load_state_dict({'weight': torch.tensor(params['scale']),
                         'bias': torch.tensor(params['bias'])})
    with torch.no_grad():
        ta, tb = tgn.affine(nchw(x))
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(a)[:, :64],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb.detach().numpy(), np.asarray(bb)[:, :64],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('kernel', [False, True])
def test_resblock_matches_flax(kernel):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 12, 16, 64)).astype(np.float32)
    blk = ResBlock(64, 64, 'gn', 'silu')
    params = randomize(jax.eval_shape(
        blk.init, jax.random.PRNGKey(0), jnp.asarray(x))['params'], 5,
        std=0.05)
    ref = blk.apply({'params': params}, jnp.asarray(x))
    tblk = TResBlock(64, 64, 'gn', 'silu', kernel=kernel)
    tblk.load_state_dict(carry(params, _resblock_entries((), 'm', 'silu'),
                               'm'), strict=True)
    with torch.no_grad():
        out = tblk(nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
