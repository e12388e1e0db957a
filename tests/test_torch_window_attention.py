"""B2 window attention: the port's plain version (what the CUDA kernel
computes) against the JAX Pallas kernel (interpret mode), and the Swin
modules against their flax counterparts, on the CPU at tolerance 1e-5. In
bf16 both round p to bf16 before p @ v: one bf16 ulp, with at most 0.1% of
outputs one flipped probability rounding further."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch.kernels import window_attention as wa_mod
from femasr_torch.kernels.tolerance import assert_bf16_close
from femasr_torch.models.convert import _conv_entries, _swin_block_entries
from femasr_torch.ops import swin as tswin
from femasr_tpu.ops import swin as jswin
from femasr_tpu.ops.pallas.window_attention import window_attention_fused
from torch_port_util import carry, jit_quick, nchw, nhwc, randomize


def _qkv(seed, b_, n, c):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b_, n, c)).astype(np.float32) * 0.2
    k = rng.normal(size=(b_, n, c)).astype(np.float32)
    v = rng.normal(size=(b_, n, c)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize('with_mask,dtype,jdtype', [
    pytest.param(False, torch.float32, jnp.float32, id='False'),
    pytest.param(True, torch.float32, jnp.float32, id='True'),
    pytest.param(False, torch.bfloat16, jnp.bfloat16, id='False-bf16'),
    pytest.param(True, torch.bfloat16, jnp.bfloat16, id='True-bf16')])
def test_window_attention_plain_matches_pallas(with_mask, dtype, jdtype):
    nh, n = 8, 64
    mask = jswin.shifted_window_mask(16, 16, 8, 4)     # (nW=4, 64, 64)
    b_ = 2 * mask.shape[0]
    q, k, v = (np.array(jnp.asarray(t).astype(jdtype).astype(jnp.float32))
               for t in _qkv(0, b_, n, nh * 32))
    bias = (np.random.default_rng(1).normal(size=(nh, n, n)) * 0.1).astype(
        np.float32)
    # the JAX kernel takes the mask tiled to (B_, N, N) (swin.py:313-317);
    # the port takes (nW, N, N) and indexes it by window id mod nW
    mask_j = jnp.tile(jnp.asarray(mask), (b_ // mask.shape[0], 1, 1)) \
        if with_mask else None
    ref = window_attention_fused(
        *(jnp.asarray(t).astype(jdtype) for t in (q, k, v)),
        jnp.asarray(bias), mask_j, num_heads=nh, tw=8, interpret=True)
    out = wa_mod.window_attention(
        *(torch.from_numpy(t).to(dtype) for t in (q, k, v)),
        torch.from_numpy(bias),
        torch.from_numpy(mask) if with_mask else None, num_heads=nh)
    assert out.dtype == dtype
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == torch.float32:
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)
    else:
        # one flipped p (< 1, so its ulp is <= 2^-8) moves an output by at
        # most 2^-8 * max|v|
        assert_bf16_close(out.float().numpy(), ref,
                          2.0 ** -8 * np.abs(v).max())


def test_window_attention_scaled_q_matches_jax_bf16(monkeypatch):
    """bf16: the port scales q as JAX's `qkv[..., :c] * scale` does, the
    scale rounded to bf16 first (swin.py:309), bit for bit."""
    dim, nh = 64, 2
    x = np.random.default_rng(11).normal(size=(4, 64, dim)).astype(np.float32)
    tmod = tswin.WindowAttention(dim, (8, 8), nh)
    with torch.no_grad():
        tmod.qkv.weight.copy_(torch.from_numpy(
            np.random.default_rng(12).normal(size=(3 * dim, dim)).astype(
                np.float32)))
    seen = {}
    tmod.qkv.register_forward_hook(
        lambda mod, inp, out: seen.__setitem__('qkv', out))

    def capture(q, k, v, bias, mask, num_heads):
        seen['q'] = q
        return torch.zeros_like(q)

    monkeypatch.setattr(tswin, 'window_attention', capture)
    with torch.no_grad():
        tmod(torch.from_numpy(x).bfloat16())
    qkv = jnp.asarray(seen['qkv'].float().numpy()).astype(jnp.bfloat16)
    ref = qkv[..., :dim] * (dim // nh) ** -0.5
    assert seen['q'].dtype == torch.bfloat16 and ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(seen['q'].float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))


def test_window_attention_plain_on_packed_qkv_slices():
    nh, n, c = 2, 64, 64
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.normal(size=(4, n, 3 * c)).astype(np.float32))
    bias = torch.zeros(nh, n, n)
    q, k, v = qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    out = wa_mod.window_attention(q, k, v, bias, None, nh)
    ref = wa_mod.window_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), bias, None, nh)
    torch.testing.assert_close(out, ref)


@pytest.mark.parametrize('with_mask', [False, True])
def test_window_attention_module_matches_flax(with_mask):
    dim, nh = 64, 2
    mask = jswin.shifted_window_mask(16, 16, 8, 4) if with_mask else None
    x = np.random.default_rng(3).normal(size=(8, 64, dim)).astype(np.float32)
    mod = jswin.WindowAttention(dim=dim, window_size=(8, 8), num_heads=nh)
    params = randomize(jax.eval_shape(lambda: mod.init(
        jax.random.PRNGKey(0), jnp.asarray(x), mask=mask))['params'], 4)
    ref = jit_quick(lambda p, v: mod.apply(p, v, mask=mask),
                    {'params': params}, jnp.asarray(x))
    tmod = tswin.WindowAttention(dim, (8, 8), nh)
    entries = {p[1:]: v for p, v in _swin_block_entries((), 'b').items()
               if p[0] == 'attn'}
    tmod.load_state_dict(carry(params, entries, 'b.attn'), strict=True)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x),
                   torch.from_numpy(mask) if with_mask else None)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('shift', [0, 4])
def test_swin_block_matches_flax(shift):
    dim, nh = 64, 2
    x = np.random.default_rng(5).normal(size=(2, 16, 16, dim)).astype(
        np.float32)
    blk = jswin.SwinTransformerBlock(dim=dim, input_resolution=(32, 32),
                                     num_heads=nh, window_size=8,
                                     shift_size=shift)
    params = randomize(jax.eval_shape(lambda: blk.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))['params'], 6)
    ref = jit_quick(blk.apply, {'params': params}, jnp.asarray(x))
    tblk = tswin.SwinTransformerBlock(dim, (32, 32), nh, 8, shift)
    assert tblk.shift_size == shift
    tblk.load_state_dict(carry(params, _swin_block_entries((), 'b'), 'b'),
                         strict=True)
    with torch.no_grad():
        out = tblk(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_rstb_matches_flax():
    dim, nh, depth = 64, 2, 2
    x = np.random.default_rng(7).normal(size=(1, 16, 24, dim)).astype(
        np.float32)
    blk = jswin.RSTB(dim=dim, input_resolution=(32, 32), depth=depth,
                     num_heads=nh, window_size=8)
    params = randomize(jax.eval_shape(lambda: blk.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))['params'], 8, std=0.05)
    ref = jit_quick(blk.apply, {'params': params}, jnp.asarray(x))
    entries = _conv_entries(('conv',), 'r.conv')
    for i in range(depth):
        entries.update(_swin_block_entries(
            ('residual_group', f'blocks_{i}'), f'r.residual_group.blocks.{i}'))
    tblk = tswin.RSTB(dim, (32, 32), depth, nh, 8)
    tblk.load_state_dict(carry(params, entries, 'r'), strict=True)
    with torch.no_grad():
        out = tblk(nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)


def test_window_helpers_match_jax():
    np.testing.assert_array_equal(tswin.relative_position_index(8, 8),
                                  jswin.relative_position_index(8, 8))
    np.testing.assert_array_equal(tswin.shifted_window_mask(24, 16, 8, 4),
                                  jswin.shifted_window_mask(24, 16, 8, 4))
    x = np.random.default_rng(9).normal(size=(2, 16, 24, 3)).astype(
        np.float32)
    win = tswin.window_partition(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(
        win.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), 8)))
    np.testing.assert_array_equal(
        tswin.window_reverse(win, 8, 16, 24).numpy(), x)
