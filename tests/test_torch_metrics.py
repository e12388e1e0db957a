"""The port's metrics against the JAX package's on the same seeded numpy
inputs, on the CPU: the MATLAB color conversions, PSNR and SSIM (with and
without border crop and Y channel), NIQE with pristine parameters fitted by
the JAX package, the LPIPS metric on seeded weights, InceptionV3-FID's
pool3 features and input resize, the Frechet distance, tensor2img, and
what create_metric refuses."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch.losses import LPIPS, lpips_package_state
from femasr_torch.metrics import calculate_psnr, calculate_ssim, create_metric
from femasr_torch.metrics.fid import frechet_distance
from femasr_torch.metrics.inception import (InceptionV3FID,
                                            convert_inception_checkpoint,
                                            resize_299)
from femasr_torch.metrics.niqe import calculate_niqe
from femasr_torch.models.convert import inception_from_flax, lpips_from_flax
from femasr_torch.utils import matlab_functions as mf
from femasr_torch.utils.img_util import tensor2img
from femasr_tpu.losses.lpips import convert_lpips_checkpoint
from femasr_tpu.metrics import calculate_psnr as jpsnr
from femasr_tpu.metrics import calculate_ssim as jssim
from femasr_tpu.metrics import create_metric as jcreate_metric
from femasr_tpu.metrics.fid import frechet_distance as jfrechet
from femasr_tpu.metrics.inception import InceptionV3FID as JInception
from femasr_tpu.metrics.inception import \
    convert_inception_checkpoint as jconvert_inception
from femasr_tpu.metrics.niqe import calculate_niqe as jniqe
from femasr_tpu.metrics.niqe import fit_niqe_params
from femasr_tpu.utils import matlab_functions as jmf
from femasr_tpu.utils.img_util import array2img
from torch_port_util import nchw


def _u8(seed, h=40, w=52):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                dtype=np.uint8)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_color_conversions_match_jax():
    u8 = _u8(0)
    f32 = u8.astype(np.float32) / 255.0
    for img in (u8, f32):
        for name in ('rgb2ycbcr', 'bgr2ycbcr'):
            for y_only in (True, False):
                out = getattr(mf, name)(img, y_only=y_only)
                ref = getattr(jmf, name)(img, y_only=y_only)
                assert out.dtype == ref.dtype and out.shape == ref.shape
                assert np.abs(out.astype(np.float64)
                              - ref.astype(np.float64)).max() <= (
                    1 if img.dtype == np.uint8 else 1e-6)
        ycc = jmf.rgb2ycbcr(img)
        for name in ('ycbcr2rgb', 'ycbcr2bgr'):
            out, ref = getattr(mf, name)(ycc), getattr(jmf, name)(ycc)
            assert np.abs(out.astype(np.float64)
                          - ref.astype(np.float64)).max() <= (
                1 if img.dtype == np.uint8 else 1e-6)
    # tensors stay tensors
    t = mf.rgb2ycbcr(torch.from_numpy(f32), y_only=True)
    assert isinstance(t, torch.Tensor)
    np.testing.assert_allclose(t.numpy(), jmf.rgb2ycbcr(f32, y_only=True),
                               atol=1e-6)


@pytest.mark.parametrize('crop_border', [0, 4])
@pytest.mark.parametrize('test_y_channel', [False, True])
def test_psnr_ssim_match_jax(crop_border, test_y_channel):
    """8-bit images: PSNR within 1e-6 dB, SSIM within 1e-7; tensors and
    numpy arrays give the same numbers."""
    gt = _u8(1).astype(np.float32) / 255.0
    noise = np.random.default_rng(2).integers(-12, 13, gt.shape)
    sr = np.clip(np.round(gt * 255) + noise, 0, 255).astype(np.float32) / 255
    kw = dict(crop_border=crop_border, test_y_channel=test_y_channel)
    ref_p, ref_s = jpsnr(sr, gt, **kw), jssim(sr, gt, **kw)
    for a, b in ((sr, gt), (torch.from_numpy(sr), torch.from_numpy(gt))):
        assert abs(calculate_psnr(a, b, **kw) - ref_p) <= 1e-6
        assert abs(calculate_ssim(a, b, **kw) - ref_s) <= 1e-7
    assert calculate_psnr(gt, gt) == float('inf')


def test_niqe_matches_jax(tmp_path):
    """NIQE with pristine parameters fitted by the JAX package on seeded
    smooth images: 1e-4 relative, through create_metric too."""
    rng = np.random.default_rng(3)

    def smooth(h, w):
        coarse = rng.random((h // 12, w // 12, 3)).astype(np.float32)
        img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
        img = img + rng.normal(0, 0.03, img.shape).astype(np.float32)
        return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f'{i}.png'), smooth(192, 288))
    mu, cov = fit_niqe_params(str(tmp_path))
    params = str(tmp_path / 'pris.npz')
    np.savez(params, mu=mu, cov=cov)
    img = smooth(200, 296).astype(np.float32) / 255.0
    ref = jniqe(img, mu, cov, crop_border=2)
    assert np.isfinite(ref)
    assert _rel(calculate_niqe(img, mu, cov, crop_border=2), ref) <= 1e-4
    fn = create_metric('niqe', pristine_params=params, crop_border=2)
    assert _rel(fn(torch.from_numpy(img), None), ref) <= 1e-4


def test_lpips_metric_matches_jax():
    src = LPIPS()
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for i in range(5):       # learned, non-negative channel weights
            w = getattr(src, f'lin{i}')
            w.copy_(torch.from_numpy(rng.random(w.shape, np.float32)) / 64)
    params = convert_lpips_checkpoint(
        {k: v.numpy() for k, v in lpips_package_state(src).items()})
    x = rng.random((32, 36, 3), dtype=np.float32)
    y = np.clip(x + rng.normal(0, 0.1, x.shape), 0, 1).astype(np.float32)
    ref = jcreate_metric('lpips', lpips_params=params)(x, y)
    fn = create_metric('lpips', lpips_params=lpips_from_flax(params))
    assert _rel(fn(torch.from_numpy(x), torch.from_numpy(y)), ref) <= 1e-5
    assert create_metric('lpips') is None      # no weights: skipped


def test_inception_pool3_and_resize_match_jax():
    """Seeded weights in the pt_inception keys, carried to the JAX tree by
    the JAX package's converter and back by inception_from_flax; one 75x75
    image without resize: the pool3 features within 1e-4 of max |ref|. The
    resize to 299 alone (up and down) within 1e-6 of
    jax.image.resize(bilinear, antialias=False)."""
    x = np.random.default_rng(5).random((1, 75, 75, 3), dtype=np.float32)
    src = InceptionV3FID()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, t in src.state_dict().items():
            if name.endswith('conv.weight'):
                t.copy_(torch.randn(t.shape, generator=gen)
                        * t[0].numel() ** -0.5)
            elif name.endswith(('bn.weight', 'running_var')):
                t.copy_(torch.rand(t.shape, generator=gen) + 0.5)
            else:
                t.copy_(torch.randn(t.shape, generator=gen) * 0.1)
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    params = jconvert_inception(dict(sd, **{'fc.weight': np.zeros(1)}))
    jnet = JInception(resize_input=False)
    ref = np.asarray(jax.jit(jnet.apply)({'params': params},
                                         jnp.asarray(x)))
    net = src              # the same module, the weights carried back
    net.resize_input = False
    net.load_state_dict(inception_from_flax(params))
    # the pt_inception loader: prefix and BatchNorm counters dropped
    pt = {'inception.' + k: v for k, v in src.state_dict().items()}
    pt['Conv2d_1a_3x3.bn.num_batches_tracked'] = torch.tensor(0)
    assert all(torch.equal(a, net.state_dict()[k]) for k, a in
               convert_inception_checkpoint(pt).items())
    with torch.no_grad():
        out = net(nchw(x)).numpy()
    assert out.shape == ref.shape == (1, 2048)
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
    for h, w in ((75, 75), (320, 410)):
        img = np.random.default_rng(h).random((1, h, w, 3), dtype=np.float32)
        want = jax.image.resize(jnp.asarray(img), (1, 299, 299, 3),
                                method='bilinear', antialias=False)
        got = resize_299(nchw(img)).permute(0, 2, 3, 1).numpy()
        assert np.abs(got - np.asarray(want)).max() <= 1e-6


def test_frechet_distance_matches_jax():
    rng = np.random.default_rng(6)
    a, b = rng.normal(size=(64, 16)), rng.normal(0.3, 1.2, size=(64, 16))
    stats = [(f.mean(0), np.cov(f, rowvar=False)) for f in (a, b)]
    ref = jfrechet(*stats[0], *stats[1])
    assert _rel(frechet_distance(*stats[0], *stats[1]), ref) <= 1e-6


def test_tensor2img_matches_array2img():
    """8-bit BGR (the levels validation measures): NCHW batches of one and
    two (a grid), CHW and HW tensors against the JAX package's array2img
    of HWC / NHWC arrays."""
    x = np.random.default_rng(7).random((9, 11, 3), dtype=np.float32)
    x = x * 1.2 - 0.1                   # values outside [0, 1] clip
    t = torch.from_numpy(x).permute(2, 0, 1)
    np.testing.assert_array_equal(tensor2img(t[None]), array2img(x))
    np.testing.assert_array_equal(tensor2img(t), array2img(x))
    np.testing.assert_array_equal(tensor2img(t[0]), array2img(x[..., 0]))
    # a batch of two tiles into a grid, as the JAX package's NHWC path
    batch = np.stack([x, 1 - x])
    np.testing.assert_array_equal(
        tensor2img(torch.from_numpy(batch).permute(0, 3, 1, 2)),
        array2img(batch))


def test_create_metric_refuses_unknown_types_and_niqe_without_params():
    with pytest.raises(KeyError, match='fid'):
        create_metric('fid')
    with pytest.raises(ValueError, match='pristine_params'):
        create_metric('niqe')
    assert create_metric('psnr', crop_border=4)(
        np.zeros((9, 9, 3)), np.ones((9, 9, 3))) == 0.0
