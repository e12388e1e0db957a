"""The int8 serving lane as a whole, on the CPU: the port's int8 layers,
FeMaSRNet with all five int8 flags and SRInferencer against the JAX
package (its XLA int8 path, which the JAX suite holds equal to its Pallas
kernels), the CLI flags, the state-dict keys, and the port's own int8
quality gate against its float model at the JAX suite's thresholds.

A w8a8 layer rounds its input, so float differences in the last bits
upstream of it (GroupNorm, LayerNorm, attention, all ~1e-6) move the few
activations that sit on a round-half boundary by one code, and that step
grows through every later layer. The comparisons therefore feed each int8
layer of the port the input its JAX counterpart saw
(femasr_torch.models.int8_forcing.force), check that the port's own input
was within MAX_STEPS quantization steps of it (so every code it would
have rounded differently is a round-half boundary case), and hold the
outputs to the float slice's bounds: 1e-5 for modules, rel 2e-3 with
identical codebook indices for the model. MAX_STEPS = 0.01 steps is about
8e-5 of a tensor's max |x|: the f32 drift of the (unforced) residual
stream over 24 Swin blocks, 25 times inside the float slice's rel 2e-3."""

import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as nn

from femasr_torch import inference_cli
from femasr_torch.models import FeMaSRNet, SRInferencer, init_weights
from femasr_torch.models.convert import (_resblock_entries,
                                         _swin_block_entries, from_flax,
                                         femasr_param_mapping)
from femasr_torch.models.int8_forcing import force, record
from femasr_torch.ops.layers import ResBlock
from femasr_torch.ops.swin import Mlp, WindowAttention
from femasr_tpu.models.convert import convert_femasr_checkpoint
from femasr_tpu.models.femasr_arch import FeMaSRNet as JFeMaSRNet
from femasr_tpu.models.femasr_arch import ResBlockInt8 as JResBlockInt8
from femasr_tpu.models.inference import SRInferencer as JSRInferencer
from femasr_tpu.ops.swin import Mlp as JMlp
from femasr_tpu.ops.swin import WindowAttention as JWindowAttention
from torch_port_util import carry, nchw, nhwc, randomize

SMALL = [[32, 16, 32]]
RELEASE = [[32, 1024, 512]]
INT8 = dict(int8_tail=True, int8_levels=3, int8_enc_up=True, int8_swin=True,
            int8_mlp=True)
MAX_STEPS = 1e-2   # own vs forced input, in quantization steps


def _is_int8_input(mod):
    name = type(mod).__name__
    if name in ('Conv3Int8', 'DenseInt8'):
        return True
    if name == 'UpConv3':
        return mod.int8
    return name == 'Mlp' and mod.chain


def jax_capture(fn, *args):
    """Run fn(*args) (jitted or not) and capture, by flax module path, the
    input of every int8 layer (float, or a chain link's (codes, scales)),
    plus FeMaSRNet's raw output and first-scale indices under 'out' and
    'indices'."""
    store = {}

    def put(key, kind):
        def cb(v):
            store[key] = (kind, jax.tree_util.tree_map(np.asarray, v))
        return cb

    def interceptor(next_fun, args, kwargs, ctx):
        mod = ctx.module
        if ctx.method_name == '__call__' and _is_int8_input(mod):
            jax.debug.callback(put(mod.scope.path, type(mod).__name__),
                               args[0])
        out = next_fun(*args, **kwargs)
        if ctx.method_name == 'encode_and_decode':
            jax.debug.callback(put('out', None), out[0])
            jax.debug.callback(put('indices', None), out[3][0])
        return out

    with nn.intercept_methods(interceptor):
        result = jax.block_until_ready(fn(*args))
    return result, store


def torch_inputs(store, names):
    """JAX captures -> {port module name: forced input in port layout}.
    `names` maps a flax module path to the port module name."""
    out = {}
    for path, (kind, v) in store.items():
        if not isinstance(path, tuple):
            continue
        if isinstance(v, tuple):
            out[names(path)] = tuple(torch.from_numpy(a.copy()) for a in v)
            continue
        if v.dtype == jnp.bfloat16:     # exact in f32; `force` casts back
            v = v.astype(np.float32)
        t = torch.from_numpy(v.copy())
        if kind in ('Conv3Int8', 'UpConv3'):
            t = nchw(v)
            if kind == 'UpConv3':        # the port's conv follows the x2
                t = F.interpolate(t, scale_factor=2, mode='nearest')
        out[names(path)] = t
    return out


def model_names(codebook, **kw):
    """flax module path -> port module name, from the parameter table."""
    table = {p: k for p, (k, _) in femasr_param_mapping(codebook, **kw)
             .items()}

    def name(path):
        if path + ('kernel',) in table:
            return table[path + ('kernel',)][:-len('.weight')]
        return table[path + ('fc1', 'kernel')][:-len('.fc1.weight')]
    return name


def assert_boundary_only(stats, n_expected):
    """Every int8 layer was forced; each float input was within MAX_STEPS
    quantization steps of the forced one; each chain link's codes were off
    by at most one on at most 0.1% of them (the one-ulp GELU of the link
    before), with the row scales equal to 1e-6."""
    assert len(stats) == n_expected, (len(stats), n_expected)
    bad = {k: v for k, v in stats.items() if not (
        v['max_steps'] <= MAX_STEPS if v['kind'] == 'float' else
        v['max_code_diff'] <= 1 and v['flips'] <= 1e-3 * v['numel']
        and v['scale_rel'] <= 1e-6)}
    assert not bad, bad


# -- modules ------------------------------------------------------------------

def _params(module, x, seed, std=0.05):
    """Seeded numpy parameters for a flax module (shapes from eval_shape,
    values as torch_port_util.randomize: norm scales around 1)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))['params']
    return randomize(shapes, seed, std=std)


def test_int8_resblock_matches_jax():
    x = np.random.default_rng(4).normal(size=(1, 12, 16, 64)).astype(
        np.float32)
    blk = JResBlockInt8(64, 'gn', 'silu')
    params = _params(blk, x, 5)
    ref, store = jax_capture(
        jax.jit(lambda x: blk.apply({'params': params}, x)), jnp.asarray(x))
    t = ResBlock(64, 64, 'gn', 'silu', int8=True)
    t.load_state_dict(carry(params, _resblock_entries((), 'm', 'silu'), 'm'),
                      strict=True)
    stats = {}
    inputs = torch_inputs(store, lambda p: {('conv1',): 'conv.2',
                                            ('conv2',): 'conv.5'}[p])
    with torch.no_grad(), force(t, inputs, stats):
        out = t(nchw(x))
    assert_boundary_only(stats, 2)
    np.testing.assert_allclose(nhwc(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('chain', [False, True])
def test_int8_mlp_matches_jax(chain):
    x = np.random.default_rng(5).normal(size=(1, 8, 8, 96)).astype(np.float32)
    jm = JMlp(hidden_features=384, out_features=96, int8=True, chain=chain)
    params = _params(jm, x, 6)
    ref, store = jax_capture(
        jax.jit(lambda x: jm.apply({'params': params}, x)), jnp.asarray(x))
    m = Mlp(96, 384, int8=True, chain=chain)
    m.load_state_dict({f'{fc}.{p}': torch.from_numpy(np.array(
        params[fc]['kernel'].T if p == 'weight' else params[fc]['bias']))
        for fc in ('fc1', 'fc2') for p in ('weight', 'bias')}, strict=True)
    stats = {}
    names = {(): '', ('fc1',): 'fc1', ('fc2',): 'fc2'}
    # the chained Mlp is forced as a whole (its input, before
    # quantize_rows), so it is driven from a wrapper
    wrapper = torch.nn.Sequential(m)
    inputs = {('0.' + names[p]).rstrip('.'): v for p, v in
              torch_inputs(store, lambda p: p).items()}
    with torch.no_grad(), force(wrapper, inputs, stats):
        out = wrapper(torch.from_numpy(x))
    assert_boundary_only(stats, 3 if chain else 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_int8_window_attention_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 64, 256)).astype(np.float32)
    jm = JWindowAttention(dim=256, window_size=(8, 8), num_heads=8,
                          int8_linears=True)
    params = _params(jm, x, 7)
    ref, store = jax_capture(
        jax.jit(lambda x: jm.apply({'params': params}, x)), jnp.asarray(x))
    m = WindowAttention(256, (8, 8), 8, int8_linears=True)
    ent = {k[1:]: v for k, v in _swin_block_entries((), 'm').items()
           if k[0] == 'attn'}
    m.load_state_dict(carry(params, ent, 'm.attn'), strict=True)
    stats = {}
    inputs = torch_inputs(store, lambda p: p[0])
    with torch.no_grad(), force(m, inputs, stats):
        out = m(torch.from_numpy(x))
    assert_boundary_only(stats, 2)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


# -- the model and serving ----------------------------------------------------

def _seeded_params(codebook, seed=0):
    net = FeMaSRNet(codebook, LQ_stage=True, scale_factor=4)
    init_weights(net, torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    return convert_femasr_checkpoint(sd, codebook_params=codebook,
                                     LQ_stage=True, scale_factor=4)


@pytest.fixture(scope='module')
def int8_pair():
    """One JAX SRInferencer run (the JAX FeMaSRNet with all five int8
    flags) and the port's SRInferencer run with every int8 layer forced."""
    params = _seeded_params(SMALL)
    jnet = JFeMaSRNet(codebook_params=SMALL, LQ_stage=True, scale_factor=4,
                      **INT8)
    jsr = JSRInferencer(params, codebook_params=SMALL, scale_factor=4,
                        model=jnet, init_merge=False)
    img = np.random.default_rng(0).random((1, 30, 31, 3), dtype=np.float32)
    ref, store = jax_capture(jsr.run_padded, jnp.asarray(img))

    sr = SRInferencer(from_flax(params, SMALL, LQ_stage=True, scale_factor=4),
                      codebook_params=SMALL, device='cpu', **INT8)
    got, stats = {}, {}
    sr.model.register_forward_hook(
        lambda m, a, o: got.update(out=o[0].clone(), indices=o[-1][0]))
    inputs = torch_inputs(store, model_names(SMALL, LQ_stage=True,
                                             scale_factor=4))
    with force(sr.model, inputs, stats):
        out = sr.run_padded(nchw(img))
    return dict(ref=np.asarray(ref), store=store, out=nhwc(out), got=got,
                stats=stats, params=params, jnet=jnet, sr=sr)


def test_int8_model_matches_jax(int8_pair):
    p = int8_pair
    # 10 convs in the encoder up blocks, 15 in the decoder, out_conv; per
    # Swin block qkv, proj, the chained MLP and its two links
    assert_boundary_only(p['stats'], 26 + 24 * 5)
    np.testing.assert_array_equal(p['got']['indices'].numpy(),
                                  p['store']['indices'][1])
    ref = p['store']['out'][1]
    out = nhwc(p['got']['out'])
    assert out.shape == ref.shape == (1, 128, 128, 3)
    rel = np.abs(out - ref).max() / np.abs(ref).max()
    assert rel < 2e-3, rel


def test_int8_run_padded_matches_jax(int8_pair):
    out, ref = int8_pair['out'], int8_pair['ref']
    assert out.shape == ref.shape == (1, 120, 124, 3)
    assert np.abs(out - ref).max() / np.abs(ref).max() < 2e-3


def _decode_forced(p, dtype, jdtype):
    """JAX's decode_indices of the int8 model in jdtype and the port's in
    dtype on the same codes, each port int8 layer forced from JAX's input:
    (port output, JAX output as f32, stats, the dtypes of the port's own
    float inputs of those layers)."""
    idx = np.random.default_rng(1).integers(0, 16, size=(1, 8, 8))
    jnet = p['jnet'].clone(dtype=jdtype)
    ref, store = jax_capture(jax.jit(lambda i: jnet.apply(
        {'params': p['params']}, i, method=JFeMaSRNet.decode_indices)),
        jnp.asarray(idx))
    assert ref.dtype == jdtype
    model, stats, own = p['sr'].model, {}, {}
    inputs = torch_inputs(store, model_names(SMALL, LQ_stage=True,
                                             scale_factor=4))
    with torch.no_grad(), record(model, own), force(model, inputs, stats):
        out = model.decode_indices(torch.from_numpy(idx), dtype=dtype)
    dtypes = {v.dtype for v in own.values() if not isinstance(v, tuple)}
    return out, np.asarray(ref, np.float32), stats, dtypes


def test_int8_decode_indices_matches_jax(int8_pair):
    out, ref, stats, dtypes = _decode_forced(int8_pair, torch.float32,
                                             jnp.float32)
    assert_boundary_only(stats, 16)
    assert out.dtype == torch.float32 and dtypes == {torch.float32}
    assert np.abs(nhwc(out) - ref).max() / np.abs(ref).max() < 2e-3


def test_int8_decode_indices_bf16_matches_jax(int8_pair):
    """The decode runs in bf16 from the gathered codes on, as JAX's
    get_codebook_entry casts them to the model dtype. The port's norms,
    activations and conv biases round where the JAX source rounds
    (tests/test_torch_rounding.py), but under jit XLA drops a bf16
    rounding whose result is cast back to f32 (its excess precision): a
    SiLU's last product reaches the next int8 quantize unrounded, so the
    JAX conv sees other codes than its captured (rounded) input gives.
    The int8 layers are all forced, and the output is held to the JAX
    package's own bound for that fusion-order rounding of the bf16 int8
    tail (max 2%, mean 0.4%, PARITY.md). Every int8 layer's own float
    input was bf16: the decode ran in bf16, not in f32 cast at the end."""
    out, ref, stats, dtypes = _decode_forced(int8_pair, torch.bfloat16,
                                             jnp.bfloat16)
    assert len(stats) == 16, len(stats)
    assert out.dtype == torch.bfloat16 and dtypes == {torch.bfloat16}
    d = np.abs(nhwc(out) - ref)
    rel, mean_rel = d.max() / np.abs(ref).max(), d.mean() / np.abs(ref).max()
    assert rel < 2e-2 and mean_rel < 4e-3, (rel, mean_rel)


def test_int8_state_dict_is_the_float_one():
    params = _seeded_params(SMALL, seed=1)
    sd = from_flax(params, SMALL, LQ_stage=True, scale_factor=4)
    f = FeMaSRNet(SMALL, LQ_stage=True, scale_factor=4)
    q = FeMaSRNet(SMALL, LQ_stage=True, scale_factor=4, **INT8)
    assert set(q.state_dict()) == set(f.state_dict()) == set(sd)
    for k, v in f.state_dict().items():
        assert q.state_dict()[k].shape == v.shape, k
    q.load_state_dict(sd, strict=True)


def test_int8_cli_on_cpu(tmp_path):
    net = FeMaSRNet(RELEASE, LQ_stage=True, scale_factor=4)
    init_weights(net, torch.Generator().manual_seed(0))
    pth = os.path.join(tmp_path, 'x4.pth')
    torch.save({'params': net.state_dict()}, pth)
    src = os.path.join(tmp_path, 'in')
    os.makedirs(src)
    rng = np.random.default_rng(4)
    cv2.imwrite(os.path.join(src, 'a.png'),
                (rng.random((20, 24, 3)) * 255).astype(np.uint8))
    outs = {}
    for lane, flags in (('f', []), ('q', [
            '--int8_tail', '--int8_levels', '3', '--int8_enc_up',
            '--int8_swin', '--int8_mlp'])):
        stats = inference_cli.main(['-i', src, '-w', pth, '-o',
                                    os.path.join(tmp_path, lane), '-s', '4',
                                    '--precision', 'f32', '--device', 'cpu',
                                    *flags])
        assert stats['images'] == 1
        outs[lane] = cv2.imread(os.path.join(tmp_path, lane, 'a.png'))
        assert outs[lane].shape == (80, 96, 3)
    # the flags reach the model: the int8 lane's image is another one
    assert not np.array_equal(outs['f'], outs['q'])


def _psnr(a, b):
    return 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def test_int8_quality_gate_release_arch():
    """The port's int8 lane against its own float model on the release
    architecture (seeded weights), at tests/test_inference.py's
    thresholds: int8 tail + encoder up blocks PSNR > 30 dB; everything
    int8 (Swin linears and MLP chain too, which feed the quantizer) index
    flips < 10% and PSNR > 29 dB."""
    net = FeMaSRNet(RELEASE, LQ_stage=True, scale_factor=4)
    init_weights(net, torch.Generator().manual_seed(0))
    img = torch.from_numpy(np.random.default_rng(3).random(
        (1, 3, 32, 32), dtype=np.float32))

    def run(**kw):
        m = FeMaSRNet(RELEASE, LQ_stage=True, scale_factor=4, **kw)
        m.load_state_dict(net.state_dict(), strict=True)
        with torch.no_grad():
            out, _, _, idx = m(img)
        return out.clamp(0, 1).numpy(), idx[0].numpy()

    ref, idx_ref = run()
    tail, _ = run(int8_tail=True, int8_levels=3, int8_enc_up=True)
    assert _psnr(tail, ref) > 30.0
    out, idx = run(**INT8)
    assert float((idx != idx_ref).mean()) < 0.10
    assert _psnr(out, ref) > 29.0
