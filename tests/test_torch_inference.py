"""Serving: the port's SRInferencer (device='cpu') against the JAX
SRInferencer on the same weights and images (whole-image, tiled,
bucketed), checkpoint loading and the CLI, on the CPU. Outputs agree to
rel 2e-3 as for the slice."""

import copy
import os
from concurrent.futures import ThreadPoolExecutor

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch import inference_cli
from femasr_torch.models import FeMaSRNet, SRInferencer, init_weights
from femasr_torch.models.convert import from_flax, merge_state_dict
from femasr_torch.models.inference import (flip_pad, load_inferencer,
                                           seeded_init)
from femasr_tpu.models.convert import convert_femasr_checkpoint
from femasr_tpu.models.inference import SRInferencer as JSRInferencer
from femasr_tpu.models.inference import flip_pad as jflip_pad
from torch_port_util import nchw, nhwc

SMALL = ((32, 16, 32),)


@pytest.fixture(scope='module')
def pair():
    net = FeMaSRNet(SMALL, LQ_stage=True, scale_factor=4)
    init_weights(net, torch.Generator().manual_seed(0))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    params = convert_femasr_checkpoint(sd, codebook_params=SMALL,
                                       LQ_stage=True, scale_factor=4)
    jsr = JSRInferencer(params, codebook_params=SMALL, scale_factor=4,
                        init_merge=False)
    sr = SRInferencer(from_flax(params, SMALL, LQ_stage=True,
                                scale_factor=4),
                      codebook_params=SMALL, device='cpu')
    return jsr, sr


# the inputs of the JAX comparisons (jax_refs)
PADDED = np.random.default_rng(0).random((1, 30, 31, 3), dtype=np.float32)
TILED = np.random.default_rng(1).random((1, 40, 44, 3), dtype=np.float32)
_rng = np.random.default_rng(2)
BUCKETED = [_rng.random((20, 22, 3), dtype=np.float32),
            _rng.random((18, 30, 3), dtype=np.float32)]


@pytest.fixture(scope='module')
def jax_refs(pair):
    """The JAX SRInferencer's whole-image, tiled and bucketed outputs,
    started together in threads: XLA compiles one program while another
    traces and the port's side of the tests runs."""
    jsr = pair[0]
    with ThreadPoolExecutor(3) as pool:
        yield {
            'padded': pool.submit(
                lambda: np.asarray(jsr.run_padded(jnp.asarray(PADDED)))),
            'tiled': pool.submit(lambda: np.asarray(jsr.run_tiled(
                jnp.asarray(TILED), tile_size=24, tile_pad=4))),
            'bucketed': pool.submit(jsr.run_bucketed, BUCKETED, bucket=32)}


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_flip_pad_matches_jax():
    x = np.arange(2 * 5 * 7 * 3, dtype=np.float32).reshape(2, 5, 7, 3)
    ref = np.asarray(jflip_pad(jnp.asarray(x), 3, 2))
    np.testing.assert_array_equal(nhwc(flip_pad(nchw(x), 3, 2)), ref)


def test_run_padded_matches_jax(pair, jax_refs):
    _, sr = pair
    out = nhwc(sr.run_padded(nchw(PADDED)))
    ref = jax_refs['padded'].result()
    assert out.shape == ref.shape == (1, 120, 124, 3)
    assert _rel(out, ref) < 2e-3


def test_run_tiled_matches_jax(pair, jax_refs):
    _, sr = pair
    out = nhwc(sr.run_tiled(nchw(TILED), tile_size=24, tile_pad=4))
    ref = jax_refs['tiled'].result()
    assert out.shape == ref.shape == (1, 160, 176, 3)
    assert _rel(out, ref) < 2e-3


def test_dispatcher_and_bucketed_match_jax(pair, jax_refs):
    _, sr = pair
    imgs = BUCKETED
    out = sr.run_bucketed(imgs, bucket=32)
    ref = jax_refs['bucketed'].result()
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        assert _rel(o, r) < 2e-3
    # whole-image below max_size**2 pixels, tiled above
    whole = sr(imgs[0], max_size=600)
    np.testing.assert_array_equal(whole, nhwc(sr.run_padded(
        nchw(imgs[0][None])))[0])
    tiled = sr(imgs[0], max_size=8, tile_size=16, tile_pad=4)
    np.testing.assert_array_equal(tiled, nhwc(sr.run_tiled(
        nchw(imgs[0][None]), tile_size=16, tile_pad=4))[0])


@pytest.mark.parametrize('key', ['params', 'params_ema'])
def test_load_inferencer_reads_reference_pth(tmp_path, pair, key):
    _, sr = pair
    sd = dict(sr.model.state_dict())
    # reference checkpoints also carry derived buffers; the loader drops them
    sd['multiscale_encoder.blocks.1.swin_blks.0.residual_group.blocks.0.'
       'attn.relative_position_index'] = torch.zeros(64, 64,
                                                     dtype=torch.long)
    path = os.path.join(tmp_path, 'w.pth')
    torch.save({key: sd}, path)
    loaded = load_inferencer(path, codebook_params=SMALL, device='cpu')
    img = nchw(np.random.default_rng(3).random((1, 16, 16, 3),
                                               dtype=np.float32))
    torch.testing.assert_close(loaded.run_padded(img), sr.run_padded(img),
                               rtol=0, atol=0)


def test_non_strict_load_overlays_a_seeded_init(pair, jax_refs, capsys):
    """A state dict with keys the model lacks (a use_semantic_loss
    checkpoint's conv_semantic.0.*), a missing key and a mis-shaped tensor
    loads as the JAX package's merge_params loads it: the extras are
    ignored, the other two keep the seed-0 init, the counts are printed.
    The weights are the seed-0 init plus seeded noise, so each check tells
    a loaded tensor from an initial one."""
    jsr, sr = pair
    init = sr.model.state_dict()      # from_flax of the seed-0 init: itself
    g = torch.Generator().manual_seed(7)
    sd = {k: v + 0.01 * torch.randn(v.shape, generator=g)
          for k, v in init.items()}
    jsr1 = copy.copy(jsr)        # JAX's jitted forward, other params
    jsr1.params = convert_femasr_checkpoint(
        {k: v.numpy() for k, v in sd.items()}, codebook_params=SMALL,
        LQ_stage=True, scale_factor=4)
    extra = dict(sd, **{'conv_semantic.0.weight': torch.ones(8, 4, 1, 1),
                        'conv_semantic.0.bias': torch.ones(8)})

    # the same input shape as test_run_padded_matches_jax: no new compile
    jax_refs['padded'].result()
    img = PADDED
    ref = np.asarray(jsr1.run_padded(jnp.asarray(img)))
    sr1 = SRInferencer(extra, codebook_params=SMALL, device='cpu')
    out = nhwc(sr1.run_padded(nchw(img)))
    assert _rel(out, ref) < 2e-3
    assert '2 unused, 0 missing (init kept), 0 skipped' in \
        capsys.readouterr().out

    # SRInferencer's overlay, on the model it built
    gone, bent = 'out_conv.bias', 'decoder_group.0.block.1.weight'
    bad = dict(extra)
    del bad[gone]
    bad[bent] = bad[bent][:, :-1]
    assert merge_state_dict(sr1.model, bad, seeded_init) == dict(
        unused=2, missing=1, skipped=1)
    assert '2 unused, 1 missing (init kept), 1 skipped' in \
        capsys.readouterr().out
    got = sr1.model.state_dict()
    assert set(got) == set(sd)
    for k, v in got.items():
        assert torch.equal(v, init[k] if k in (gone, bent) else sd[k]), k


def test_strict_load_refuses_a_checkpoint_off_the_model(pair, tmp_path):
    """strict=True (the CLI's --strict_load) loads a state dict that
    matches the model key for key, and refuses one with keys the model
    lacks before anything is served."""
    _, sr = pair
    sd = sr.model.state_dict()
    got = SRInferencer(sd, codebook_params=SMALL, device='cpu',
                       strict=True).model.state_dict()
    assert set(got) == set(sd)
    for k, v in got.items():
        assert torch.equal(v, sd[k]), k
    semantic = {'conv_semantic.0.weight': torch.ones(8, 4, 1, 1)}
    with pytest.raises(RuntimeError, match='conv_semantic.0.weight'):
        SRInferencer(dict(sd, **semantic), codebook_params=SMALL,
                     device='cpu', strict=True)
    pth = os.path.join(tmp_path, 'x4.pth')
    torch.save({'params': semantic}, pth)
    with pytest.raises(RuntimeError, match='conv_semantic.0.weight'):
        inference_cli.main(['-i', str(tmp_path), '-w', pth, '-o',
                            os.path.join(tmp_path, 'out'), '--device', 'cpu',
                            '--strict_load'])
    assert not os.path.exists(os.path.join(tmp_path, 'out'))


def test_cli_serves_a_folder_on_cpu(tmp_path):
    net = FeMaSRNet([[32, 1024, 512]], LQ_stage=True, scale_factor=4)
    init_weights(net, torch.Generator().manual_seed(0))
    pth = os.path.join(tmp_path, 'x4.pth')
    torch.save({'params': net.state_dict()}, pth)
    src = os.path.join(tmp_path, 'in', 'sub')
    os.makedirs(src)
    rng = np.random.default_rng(4)
    cv2.imwrite(os.path.join(src, 'a.png'),
                (rng.random((20, 24, 3)) * 255).astype(np.uint8))
    out_dir = os.path.join(tmp_path, 'out')
    stats = inference_cli.main(['-i', os.path.join(tmp_path, 'in'), '-w',
                                pth, '-o', out_dir, '-s', '4', '--precision',
                                'f32', '--device', 'cpu', '--suffix', 'sr'])
    assert stats['images'] == 1
    out = cv2.imread(os.path.join(out_dir, 'sub', 'a_sr.png'))
    assert out.shape == (80, 96, 3)
