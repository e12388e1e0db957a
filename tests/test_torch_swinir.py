"""SwinIR in the port against the JAX package's SwinIR on the CPU, and the
pieces under it: B2's plain version (what the CUDA kernel computes)
against the Pallas kernel in interpret mode at SwinIR's window lengths and
head widths, the route B2 takes for each layout, a Swin block at SwinIR's
widths, pixel shuffle and the arch_util copies (flow_warp, resize_flow,
ResidualBlockNoBN, DropPath, trunc_normal_init); loading, build_network
and model_flops.

Weights are seeded numpy values carried across by `swinir_from_flax`; the
inputs are 14x18 images (padded to the window by reflection). One case per
upsampler, at small widths whose heads are 6-30 wide: pixelshuffle x4,
pixelshuffledirect x2 (window 8 clamped to the nominal resolution 4),
nearest+conv x4, and '' x1 (JPEG artifact removal: one channel, window 7,
so N = 49, img_range 255); in f32 also the absolute position embedding
without the patch norm (on an 8x8 image, its img_size). The JAX side runs
jitted (`jit_quick`) with its default XLA attention, and the '' case in
f32 also with its Pallas kernel (interpret mode; B2's bf16 rounding is
held to that kernel's on its own, below).

Tolerances: float32 1e-4 max abs (outputs are O(1); the two sum in other
orders: measured <= 2.1e-6). bfloat16: relative L2 2e-2 against JAX's
bf16 output (measured 0.01-0.6%: JAX's XLA attention stores its logits in
bf16 where B2 keeps them in f32, and bf16 products sum in other orders;
JAX's own bf16 output is 0.05-0.8% from its f32 one), and the port's bf16
output no further from JAX's f32 output than 1.25x JAX's own bf16 output
is (measured <= 1.01x). B2: float32 2e-5
(f32 sums in other orders), bfloat16 by kernels/tolerance.py (both round p
to bf16 before p @ v: one bf16 ulp, at most 0.1% of outputs one flipped
probability further). The rest 1e-5, or bit for bit where the arithmetic
is the same.
"""

import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch.kernels import window_attention as wa
from femasr_torch.kernels.tolerance import assert_bf16_close
from femasr_torch.models import (FeMaSRNet, SwinIR, UNetDiscriminatorSN,
                                 VGGFeatureExtractor, build_network,
                                 init_weights)
from femasr_torch.models.convert import (_swin_block_entries,
                                         load_torch_checkpoint,
                                         swinir_from_flax)
from femasr_torch.ops import arch_util as tarch
from femasr_torch.ops import swin as tswin
from femasr_torch.utils.flops import model_flops
from femasr_tpu.models.swinir_arch import SwinIR as JSwinIR
from femasr_tpu.ops import arch_util as jarch
from femasr_tpu.ops import layers as jlayers
from femasr_tpu.ops import swin as jswin
from femasr_tpu.ops.pallas import window_attention as jpallas
from torch_port_util import carry, jit_quick, nchw, nhwc, randomize

CONFIGS = {
    # head_dim 6 and 12
    'pixelshuffle': dict(upsampler='pixelshuffle', upscale=4, window_size=4,
                         embed_dim=24, num_heads=(4, 2)),
    # head_dim 10; window 8 clamped to the nominal resolution 4
    'pixelshuffledirect': dict(upsampler='pixelshuffledirect', upscale=2,
                               window_size=8, img_size=4, embed_dim=20,
                               num_heads=(2, 2)),
    # head_dim 6 and 30
    'nearest+conv': dict(upsampler='nearest+conv', upscale=4, window_size=4,
                         embed_dim=30, num_heads=(5, 1)),
    # N = 49, head_dim 12 and 6
    'car': dict(upsampler='', upscale=1, window_size=7, embed_dim=24,
                num_heads=(2, 4), in_chans=1, img_range=255.0),
    # the absolute position embedding (its input must be img_size square),
    # no patch norm
    'ape': dict(upsampler='pixelshuffledirect', upscale=2, window_size=4,
                img_size=8, embed_dim=12, num_heads=(2, 2), ape=True,
                patch_norm=False),
}
IMAGE_HW = {'ape': (8, 8)}
BF16_CASES = ('pixelshuffle', 'pixelshuffledirect', 'nearest+conv', 'car')
BF16_REL_L2 = 2e-2
BF16_VS_JAX_OWN = 1.25
# B2 cases: N -> (window, side of the masked image)
WINDOWS = {49: (7, 14), 64: (8, 16)}


def _kwargs(name):
    return dict(dict(depths=(2, 2), mlp_ratio=2.0, img_size=16),
                **CONFIGS[name])


def _image(name):
    return np.random.default_rng(0).uniform(size=(
        1, *IMAGE_HW.get(name, (14, 18)),
        CONFIGS[name].get('in_chans', 3))).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _params(name):
    kw = _kwargs(name)
    shapes = jax.eval_shape(lambda: JSwinIR(**kw).init(
        jax.random.PRNGKey(0), jnp.asarray(_image(name))))['params']
    return randomize(shapes, 1, std=0.05)


@functools.lru_cache(maxsize=None)
def _jax_outs(name, pallas=False):
    """JAX's SwinIR output in f32 and, for the bf16 cases, bf16, as
    float32 numpy arrays: {'float32': ..., 'bfloat16': ...}, one program."""
    dtypes = ((jnp.float32, jnp.bfloat16)
              if not pallas and name in BF16_CASES else (jnp.float32,))
    mods = [JSwinIR(**_kwargs(name), dtype=dt) for dt in dtypes]

    def fn(params, x):
        return [m.apply(params, x).astype(jnp.float32) for m in mods]

    mp = pytest.MonkeyPatch()
    if pallas:
        mp.setenv('FEMASR_ATTN', 'pallas')
        mp.setattr(jpallas, 'window_attention_fused', functools.partial(
            jpallas.window_attention_fused, interpret=True))
    try:
        outs = jit_quick(fn, {'params': _params(name)},
                         jnp.asarray(_image(name)))
    finally:
        mp.undo()
    return {str(dt.dtype): np.asarray(o) for dt, o in zip(dtypes, outs)}


def _jax_out(name, jdtype, pallas=False):
    return _jax_outs(name, pallas)[str(jdtype.dtype)]


def _port(name, dtype):
    kw = _kwargs(name)
    net = SwinIR(**kw, dtype=dtype)
    net.load_state_dict(swinir_from_flax(
        _params(name), depths=kw['depths'], upsampler=kw['upsampler'],
        upscale=kw['upscale'], patch_norm=kw.get('patch_norm', True),
        ape=kw.get('ape', False)), strict=True)
    with torch.no_grad():
        return nhwc(net(nchw(_image(name))))


def _rel(a, b, ref):
    return np.linalg.norm(a - b) / np.linalg.norm(ref)


@pytest.mark.parametrize('name,pallas', [
    ('pixelshuffle', False), ('pixelshuffledirect', False),
    ('nearest+conv', False), ('car', False), ('car', True),
    ('ape', False)])
def test_swinir_f32_matches_jax(name, pallas):
    ref = _jax_out(name, jnp.float32, pallas)
    out = _port(name, torch.float32)
    scale = _kwargs(name)['upscale']
    h, w = IMAGE_HW.get(name, (14, 18))
    assert out.shape == (1, h * scale, w * scale, ref.shape[-1])
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize('name', BF16_CASES)
def test_swinir_bf16_matches_jax(name):
    ref = _jax_out(name, jnp.bfloat16)
    ref32 = _jax_out(name, jnp.float32)
    out = _port(name, torch.bfloat16)
    assert np.isfinite(out).all()
    assert _rel(out, ref, ref32) <= BF16_REL_L2
    assert _rel(out, ref32, ref32) <= BF16_VS_JAX_OWN * _rel(ref, ref32,
                                                               ref32)


def test_released_state_dict_loads(tmp_path):
    """A reference-keyed .pth (derived buffers included, under params_ema
    and params) loads strictly once load_torch_checkpoint drops the
    buffers; x3 pixelshuffle (one conv + shuffle by 3)."""
    kw = dict(img_size=8, window_size=4, embed_dim=12, depths=(2,),
              num_heads=(2,), mlp_ratio=2.0, upscale=3,
              upsampler='pixelshuffle')
    src = init_weights(SwinIR(**kw), torch.Generator().manual_seed(3))
    sd = dict(src.state_dict())
    assert 'upsample.0.weight' in sd and 'upsample.2.weight' not in sd
    for k in range(2):
        key = f'layers.0.residual_group.blocks.{k}'
        sd[f'{key}.attn.relative_position_index'] = torch.from_numpy(
            tswin.relative_position_index(4, 4))
        if k % 2:
            sd[f'{key}.attn_mask'] = torch.from_numpy(
                tswin.shifted_window_mask(8, 8, 4, 2))
    torch.save({'params_ema': sd, 'params': sd}, tmp_path / 'swinir.pth')
    for key in ('params_ema', 'params'):
        net = SwinIR(**kw)
        net.load_state_dict(load_torch_checkpoint(
            str(tmp_path / 'swinir.pth'), key), strict=True)
        x = torch.rand(1, 3, 8, 8, generator=torch.Generator().manual_seed(4))
        with torch.no_grad():
            assert torch.equal(net(x), src(x))


def test_3conv_is_refused():
    with pytest.raises(NotImplementedError, match="only '1conv'"):
        SwinIR(resi_connection='3conv')


@pytest.mark.parametrize('opt,cls', [
    (dict(type='SwinIR', upscale=2, img_size=8, window_size=4, embed_dim=12,
          depths=[2], num_heads=[2], mlp_ratio=2, upsampler='pixelshuffle',
          dtype='bfloat16'), SwinIR),
    (dict(type='FeMaSRNet', codebook_params=[[32, 16, 32]], LQ_stage=True,
          scale_factor=4, dtype='bfloat16', vq_backend='pallas',
          frozen_module_keywords=['quantize']), FeMaSRNet),
    (dict(type='UNetDiscriminatorSN', num_in_ch=3, num_feat=16,
          dtype='bfloat16'), UNetDiscriminatorSN),
    (dict(type='VGGFeatureExtractor', layer_name_list=['relu1_1']),
     VGGFeatureExtractor)])
def test_build_network_builds_each_type(opt, cls):
    net = build_network(opt)
    assert type(net) is cls
    if cls is SwinIR:
        assert net.dtype == torch.bfloat16 and net.upscale == 2
        with torch.no_grad():
            out = net(torch.rand(1, 3, 6, 10))
        assert out.shape == (1, 3, 12, 20) and out.dtype == torch.float32
    with pytest.raises(KeyError, match='No object named'):
        build_network({'type': 'NoSuchNet'})


def test_model_flops_counts_convs_linears_attention():
    c, nh, ws, h, w, t = 8, 2, 4, 8, 12, 96
    net = SwinIR(img_size=16, in_chans=1, embed_dim=c, depths=(2,),
                 num_heads=(nh,), window_size=ws, mlp_ratio=2.0,
                 upscale=1, upsampler='')
    convs = 2 * 9 * h * w * (1 * c + c * c + c * c + c * 1)
    linears = 2 * t * (3 * c * c + c * c + 2 * c * c + 2 * c * c)
    windows, n, hd = t // (ws * ws), ws * ws, c // nh
    attention = 2 * (2 * n * n * hd) * nh * windows
    got = model_flops(net, torch.rand(1, 1, h, w))
    assert got == convs + 2 * (linears + attention)


ATTENTION_CASES = [(hd, n) for hd in (6, 10, 30) for n in (49, 64)]


@functools.lru_cache(maxsize=None)
def _attention_cases():
    """Per (head_dim, N): packed qkv (bf16 values: both dtypes' cases take
    the same inputs), bias, shift mask, and the Pallas kernel's outputs
    without and with the mask in f32 and bf16 (one program for all)."""
    nh = 2
    inputs = {}
    for hd, n in ATTENTION_CASES:
        c = nh * hd
        ws, side = WINDOWS[n]
        mask = jswin.shifted_window_mask(side, side, ws, ws // 2)   # nW = 4
        rng = np.random.default_rng(hd * 100 + n)
        qkv = rng.normal(size=(mask.shape[0], n, 3 * c)).astype(np.float32)
        qkv[..., :c] *= 0.3
        qkv = np.array(jnp.asarray(qkv).astype(jnp.bfloat16).astype(
            jnp.float32))
        bias = (rng.normal(size=(nh, n, n)) * 0.1).astype(np.float32)
        inputs[hd, n] = (qkv, bias, mask)

    def fused(inputs):
        refs = {}
        for (hd, n), (qkv, bias, m) in inputs.items():
            c = nh * hd
            refs[hd, n] = {str(jdt.dtype): [
                jpallas.window_attention_fused(
                    *(qkv[..., i * c:(i + 1) * c].astype(jdt)
                      for i in range(3)),
                    bias, mm, num_heads=nh, tw=m.shape[0], interpret=True)
                .astype(jnp.float32) for mm in (None, m)]
                for jdt in (jnp.float32, jnp.bfloat16)}
        return refs
    refs = jit_quick(fused, {k: tuple(map(jnp.asarray, v))
                             for k, v in inputs.items()})
    return {k: (nh, *inputs[k], refs[k]) for k in inputs}


@pytest.fixture(scope='module', autouse=True)
def _references():
    """Build the JAX references at once: XLA compiles in some threads while
    another traces (a few seconds of this file's time). The Pallas-backend
    model case patches modules while it traces, so it stays out."""
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(lambda f: f(), [_attention_cases] + [
            functools.partial(_jax_outs, name, False) for name in CONFIGS]))


@pytest.mark.parametrize('dtype', [
    pytest.param(torch.float32, id='f32'),
    pytest.param(torch.bfloat16, id='bf16')])
@pytest.mark.parametrize('n', [49, 64])
@pytest.mark.parametrize('hd', [6, 10, 30])
def test_window_attention_plain_matches_pallas(hd, n, dtype):
    """Both with and without the shift mask; q, k, v column slices of one
    packed qkv, as the models give them."""
    nh, qkv, bias, mask, refs = _attention_cases()[hd, n]
    c = nh * hd
    tq = torch.from_numpy(qkv).to(dtype)
    for m, ref in zip((None, mask), refs[str(dtype)[6:]]):
        out = wa.window_attention(
            tq[..., :c], tq[..., c:2 * c], tq[..., 2 * c:],
            torch.from_numpy(bias),
            None if m is None else torch.from_numpy(m), num_heads=nh)
        assert out.dtype == dtype and out.shape == (mask.shape[0], n, c)
        ref = np.asarray(ref)
        if dtype == torch.float32:
            np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)
        else:
            assert_bf16_close(out.float().numpy(), ref,
                              2.0 ** -8 * np.abs(qkv[..., 2 * c:]).max())


def test_window_attention_routes():
    """FeMaSR's packed bf16 qkv (N 64, head_dim 32, 16-byte rows) takes the
    N = 64 kernel; SwinIR-M's (C 180: 4-byte aligned head slices), SwinIR-S's
    and N = 49 take the padded one; float32 the FFMA one."""
    def slices(b_, n, c, dtype, offset=0):
        qkv = torch.zeros(b_, n, 3 * c + offset, dtype=dtype)[..., offset:]
        return qkv[..., :c], qkv[..., c:2 * c], qkv[..., 2 * c:]
    bf = torch.bfloat16
    assert wa.route_of(*slices(4, 64, 256, bf), 8) == wa.TC64
    assert wa.route_of(*slices(4, 64, 128, bf), 4) == wa.TC64
    assert wa.route_of(*slices(4, 64, 256, bf, offset=1), 8) == wa.TC
    assert wa.route_of(*slices(4, 64, 180, bf), 6) == wa.TC
    assert wa.route_of(*slices(4, 64, 60, bf), 6) == wa.TC
    assert wa.route_of(*slices(4, 49, 180, bf), 6) == wa.TC
    assert wa.route_of(*slices(4, 64, 256, torch.float32), 8) == wa.F32
    assert wa.N_MAX == 64 and wa.HEAD_DIM_MAX == 64


@pytest.mark.parametrize('shift,qkv_bias', [(0, True), (3, False)])
def test_swin_block_at_swinir_widths_matches_flax(shift, qkv_bias):
    """Window 7 (N 49), 3 heads of 10, MLP ratio 2, a qk scale, with and
    without the qkv bias, on a 14x14 map (nominal resolution 16: no
    clamp)."""
    dim, nh = 30, 3
    x = np.random.default_rng(5).normal(size=(1, 14, 14, dim)).astype(
        np.float32)
    kw = dict(mlp_ratio=2.0, qk_scale=0.25, qkv_bias=qkv_bias)
    blk = jswin.SwinTransformerBlock(dim=dim, input_resolution=(16, 16),
                                     num_heads=nh, window_size=7,
                                     shift_size=shift, **kw)
    params = randomize(jax.eval_shape(lambda: blk.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))['params'], 6)
    ref = jit_quick(blk.apply, {'params': params}, jnp.asarray(x))
    tblk = tswin.SwinTransformerBlock(dim, (16, 16), nh, 7, shift, **kw)
    entries = {path: v for path, v in _swin_block_entries((), 'b').items()
               if qkv_bias or path != ('attn', 'qkv', 'bias')}
    tblk.load_state_dict(carry(params, entries, 'b'), strict=True)
    with torch.no_grad():
        out = tblk(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_pixel_shuffle_matches_jax():
    x = np.random.default_rng(1).normal(size=(2, 6, 10, 12)).astype(
        np.float32)
    for r in (2, 3):
        if 12 % (r * r):
            continue
        np.testing.assert_array_equal(
            nhwc(torch.nn.functional.pixel_shuffle(nchw(x), r)),
            np.asarray(jlayers.pixel_shuffle(jnp.asarray(x), r)))
    np.testing.assert_array_equal(
        nhwc(torch.nn.functional.pixel_unshuffle(nchw(x), 2)),
        np.asarray(jlayers.pixel_unshuffle(jnp.asarray(x), 2)))


@pytest.mark.parametrize('interp_mode', ['bilinear', 'nearest'])
@pytest.mark.parametrize('padding_mode', ['zeros', 'border'])
def test_flow_warp_matches_jax(interp_mode, padding_mode):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 11, 3)).astype(np.float32)
    flow = (rng.normal(size=(2, 9, 11, 2)) * 3).astype(np.float32)
    ref = jit_quick(lambda x, f: jarch.flow_warp(x, f, interp_mode,
                                                 padding_mode),
                    jnp.asarray(x), jnp.asarray(flow))
    out = tarch.flow_warp(nchw(x), torch.from_numpy(flow), interp_mode,
                          padding_mode)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize('size_type,sizes', [('ratio', (2.0, 1.5)),
                                             ('shape', (5, 7))])
def test_resize_flow_matches_jax(size_type, sizes):
    flow = np.random.default_rng(3).normal(size=(2, 10, 14, 2)).astype(
        np.float32)
    ref = jarch.resize_flow(jnp.asarray(flow), size_type, sizes)
    out = tarch.resize_flow(torch.from_numpy(flow), size_type, sizes)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match='ratio or shape'):
        tarch.resize_flow(torch.from_numpy(flow), 'scale', sizes)


def test_residual_block_no_bn_matches_jax():
    x = np.random.default_rng(4).normal(size=(1, 8, 10, 16)).astype(
        np.float32)
    mod = jarch.ResidualBlockNoBN(num_feat=16, res_scale=0.5)
    params = randomize(jax.eval_shape(lambda: mod.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))['params'], 7)
    ref = jit_quick(mod.apply, {'params': params}, jnp.asarray(x))
    tmod = tarch.ResidualBlockNoBN(16, 0.5)
    sd = {}
    for name in ('conv1', 'conv2'):
        sd[f'{name}.weight'] = torch.from_numpy(np.ascontiguousarray(
            np.asarray(params[name]['kernel']).transpose(3, 2, 0, 1)))
        sd[f'{name}.bias'] = torch.from_numpy(np.asarray(
            params[name]['bias']))
    tmod.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = tmod(nchw(x))
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), atol=1e-5,
                               rtol=0)


def test_drop_path_and_trunc_normal():
    """DropPath: the identity in eval and at rate 0; in training each
    sample is zeroed or scaled by 1 / keep, as JAX's. trunc_normal_init:
    flax's truncated_normal (|v| <= 2 sigma, std = stddev)."""
    x = torch.ones(4000, 3)
    dp = tarch.DropPath(0.25)
    assert torch.equal(dp.eval()(x), x)
    assert torch.equal(tarch.DropPath(0.0).train()(x), x)
    y = dp.train()(x, generator=torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, (x[0, 0] / 0.75).item()}
    assert (y[:, 0] == y[:, 1]).all()
    assert abs((y[:, 0] == 0).float().mean().item() - 0.25) < 0.03
    t = tarch.trunc_normal_init(0.02)(
        torch.empty(100000), torch.Generator().manual_seed(1))
    assert t.abs().max().item() <= 2 * 0.02 / tarch._TRUNC_STD
    assert abs(t.std().item() - 0.02) < 4e-4
    assert tarch.to_2tuple(3) == (3, 3) and tarch.to_2tuple((1, 2)) == (1, 2)
