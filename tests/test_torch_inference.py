"""Serving: the port's SRInferencer (device='cpu') against the JAX
SRInferencer on the same weights and images (whole-image, tiled,
bucketed), checkpoint loading and the CLI, on the CPU. Outputs agree to
rel 2e-3 as for the slice."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch import inference_cli
from femasr_torch.models import FeMaSRNet, SRInferencer, init_weights
from femasr_torch.models.convert import from_flax
from femasr_torch.models.inference import flip_pad, load_inferencer
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


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_flip_pad_matches_jax():
    x = np.arange(2 * 5 * 7 * 3, dtype=np.float32).reshape(2, 5, 7, 3)
    ref = np.asarray(jflip_pad(jnp.asarray(x), 3, 2))
    np.testing.assert_array_equal(nhwc(flip_pad(nchw(x), 3, 2)), ref)


def test_run_padded_matches_jax(pair):
    jsr, sr = pair
    img = np.random.default_rng(0).random((1, 30, 31, 3), dtype=np.float32)
    ref = np.asarray(jsr.run_padded(jnp.asarray(img)))
    out = nhwc(sr.run_padded(nchw(img)))
    assert out.shape == ref.shape == (1, 120, 124, 3)
    assert _rel(out, ref) < 2e-3


def test_run_tiled_matches_jax(pair):
    jsr, sr = pair
    img = np.random.default_rng(1).random((1, 40, 44, 3), dtype=np.float32)
    ref = np.asarray(jsr.run_tiled(jnp.asarray(img), tile_size=24,
                                   tile_pad=4))
    out = nhwc(sr.run_tiled(nchw(img), tile_size=24, tile_pad=4))
    assert out.shape == ref.shape == (1, 160, 176, 3)
    assert _rel(out, ref) < 2e-3


def test_dispatcher_and_bucketed_match_jax(pair):
    jsr, sr = pair
    rng = np.random.default_rng(2)
    imgs = [rng.random((20, 22, 3), dtype=np.float32),
            rng.random((18, 30, 3), dtype=np.float32)]
    ref = jsr.run_bucketed(imgs, bucket=32)
    out = sr.run_bucketed(imgs, bucket=32)
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
