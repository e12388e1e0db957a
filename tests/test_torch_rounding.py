"""The port's bf16 norms and activations round where the JAX package rounds.

The JAX layers run their normalize and activations in the model dtype, op
by op, and XLA rounds to bf16 after every op (also inside a fusion):
GroupNorm and LayerNormTPU apply (x - mean) * (inv * scale) + bias with
mean and inv * scale rounded to bf16; nn.silu is x * (1 / (1 + exp(-x)))
and nn.gelu(approximate=True) x * (0.5 * (1 + tanh(c2 * (x + c1 * x^3))))
with bf16 constants; flax's nn.Conv adds its bias to the rounded
convolution and rounds again. An f32 evaluation rounded once moves 5-7% of
the norms' and the conv's outputs, and ~40% of the activations', by more
than one bf16 ulp.

The activations must agree bit for bit. The norms sum their f32 moments in
another order than XLA, so a mean or a scale may round to the other bf16
neighbour: they are held to tolerance.py's bf16 rule (one ulp, at most
0.1% of outputs up to one such flip further).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch.kernels.tolerance import assert_bf16_close
from flax import linen as nn

from femasr_torch.ops.layers import ActLayer, Conv2d, GroupNorm
from femasr_torch.ops.swin import LayerNorm
from femasr_tpu.ops.layers import ActLayer as JActLayer
from femasr_tpu.ops.layers import GroupNorm as JGroupNorm
from femasr_tpu.ops.swin import LayerNormTPU
from torch_port_util import nchw


def _affine(rng, c):
    return ((1 + 0.1 * rng.normal(size=c)).astype(np.float32),
            (0.1 * rng.normal(size=c)).astype(np.float32))


def _flip_atol(x, mean, mul):
    """How far one flipped bf16 rounding of the mean or of inv * scale can
    move an output: ulp <= 2^-7 of the value, times the other factor."""
    return 2.0 ** -7 * float(np.abs(mul).max()) * (
        float(np.abs(mean).max()) + float(np.abs(x - mean).max()))


def test_groupnorm_bf16_rounds_as_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1, 16, 16, 64)) * 2 + 0.5).astype(np.float32)
    scale, bias = _affine(rng, 64)
    jgn = JGroupNorm(num_groups=32, eps=1e-6, dtype=jnp.bfloat16)
    params = {'params': {'scale': jnp.asarray(scale),
                         'bias': jnp.asarray(bias)}}
    ref = jax.jit(lambda v: jgn.apply(params, v))(jnp.asarray(x,
                                                              jnp.bfloat16))
    gn = GroupNorm(32, 64)
    gn.load_state_dict({'weight': torch.from_numpy(scale),
                        'bias': torch.from_numpy(bias)})
    with torch.no_grad():
        out = gn(nchw(x).bfloat16())
    assert out.dtype == torch.bfloat16
    xg = x.reshape(1, -1, 32, 2)
    mean = xg.mean(axis=(1, 3))
    inv = 1 / np.sqrt(xg.var(axis=(1, 3)) + 1e-6)
    atol = _flip_atol(x, mean.max(), inv.max() * scale)
    assert_bf16_close(out.permute(0, 2, 3, 1),
                      np.asarray(ref.astype(jnp.float32)), atol)


def test_layernorm_bf16_rounds_as_jax():
    rng = np.random.default_rng(1)
    x = (rng.normal(size=(256, 256)) * 1.5 + 0.3).astype(np.float32)
    scale, bias = _affine(rng, 256)
    jln = LayerNormTPU(dtype=jnp.bfloat16)
    params = {'params': {'scale': jnp.asarray(scale),
                         'bias': jnp.asarray(bias)}}
    ref = jax.jit(lambda v: jln.apply(params, v))(jnp.asarray(x,
                                                              jnp.bfloat16))
    ln = LayerNorm(256)
    ln.load_state_dict({'weight': torch.from_numpy(scale),
                        'bias': torch.from_numpy(bias)})
    with torch.no_grad():
        out = ln(torch.from_numpy(x).bfloat16())
    assert out.dtype == torch.bfloat16
    mean = x.mean(-1, keepdims=True)
    inv = 1 / np.sqrt(x.var(-1, keepdims=True) + 1e-5)
    atol = _flip_atol(x, mean, inv.max() * scale)
    assert_bf16_close(out, np.asarray(ref.astype(jnp.float32)), atol)


@pytest.mark.parametrize('act', ['silu', 'gelu'])
def test_activation_bf16_matches_jax_bit_for_bit(act):
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.normal(size=3064) * 3,
                        rng.uniform(-12, 12, size=1024),
                        [0.0, -0.0, 1e-30, -1e-30, 88.0, -88.0, 1e4, -1e4]])
    x = x.astype(np.float32).reshape(1, 8, 8, -1)
    jact = JActLayer(x.shape[-1], act, dtype=jnp.bfloat16)
    ref = np.asarray(jax.jit(lambda v: jact.apply({}, v))(
        jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    # XLA on the CPU (as the TPU) flushes subnormal values to zero, where
    # PyTorch and the act_bf16 kernel keep them: silu(-88) takes
    # 1 / (1 + e^88), a subnormal. The rounding sequence is compared under
    # XLA's flush; the one output that the flush moves is checked apart.
    port = ActLayer(x.shape[-1], act)
    kept = port(nchw(x).bfloat16())
    assert torch.set_flush_denormal(True)
    try:
        out = port(nchw(x).bfloat16())
    finally:
        torch.set_flush_denormal(False)
    assert out.dtype == torch.bfloat16
    out = out.float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(out, ref)
    moved = (kept.float().permute(0, 2, 3, 1).numpy() != out)
    assert moved.sum() == (act == 'silu')
    assert (x[moved] == -88.0).all()


def test_conv_bias_bf16_rounds_as_flax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 16, 16, 64)).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, 64, 32)) * 0.05).astype(np.float32)
    bias = (rng.normal(size=32) * 0.5).astype(np.float32)
    jconv = nn.Conv(32, (3, 3), padding=((1, 1), (1, 1)),
                    dtype=jnp.bfloat16, param_dtype=jnp.float32)
    params = {'params': {'kernel': jnp.asarray(kernel),
                         'bias': jnp.asarray(bias)}}
    ref = np.asarray(jax.jit(lambda v: jconv.apply(params, v))(
        jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    conv = Conv2d(64, 32, 3, 1, 1)
    conv.load_state_dict({
        'weight': torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()),
        'bias': torch.from_numpy(bias)})
    with torch.no_grad():
        out = conv(nchw(x).bfloat16())
    assert out.dtype == torch.bfloat16
    # the two sum the products in other orders: a flipped rounding of the
    # convolution moves an output by one ulp of the convolution's value
    atol = 2.0 ** -7 * float(np.abs(ref - bias).max())
    assert_bf16_close(out.permute(0, 2, 3, 1), ref, atol)
