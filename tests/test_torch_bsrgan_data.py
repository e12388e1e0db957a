"""The port's host BSRGAN degradations (femasr_torch/data/degradations.py)
against the JAX package's numpy copy (femasr_tpu/data/degradations.py),
and BSRGANTrainDataset: its items with the LQ synthesized in the worker
and with on-device degradation (GT only), and the same batch for 0 and 2
loader workers."""

import cv2
import numpy as np
import pytest
import torch

from femasr_torch.data import BSRGANTrainDataset, build_train_loader
from femasr_torch.data import degradations as P
from femasr_torch.ops.resize import imresize_np
from femasr_tpu.data import degradations as J
from femasr_tpu.ops.resize import imresize_np as imresize_np_jax
import torch_port_util  # noqa: F401  (caps torch at 2 threads)


def _img(seed, h=48, w=40):
    base = np.random.default_rng(seed).random((h // 4, w // 4, 3),
                                              dtype=np.float32)
    return cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC).clip(0, 1)


@pytest.mark.parametrize('ksize,theta,l1,l2', [(15, np.pi, 6, 6),
                                               (21, 0.7, 1.5, 9.0),
                                               (7, 2.9, 0.3, 4.0)])
def test_kernels_equal_jax(ksize, theta, l1, l2):
    np.testing.assert_array_equal(
        P.anisotropic_gaussian_kernel(ksize, theta, l1, l2),
        J.anisotropic_gaussian_kernel(ksize, theta, l1, l2))
    np.testing.assert_array_equal(P.fspecial('gaussian', ksize, l1),
                                  J.fspecial('gaussian', ksize, l1))
    np.testing.assert_array_equal(P.fspecial('laplacian', theta / 4),
                                  J.fspecial('laplacian', theta / 4))
    k = P.gen_kernel(np.random.default_rng(ksize), k_size=(ksize, ksize),
                     noise_level=0.1)
    np.testing.assert_array_equal(k, J.gen_kernel(
        (ksize, ksize), noise_level=0.1, rng=np.random.default_rng(ksize)))


def test_host_ops_equal_jax():
    img = _img(0)
    k = P.fspecial('gaussian', 25, 1.7)
    for sf in (2, 3, 4):
        np.testing.assert_array_equal(P.shift_pixel(k, sf),
                                      J.shift_pixel(k, sf))
        np.testing.assert_array_equal(P.shift_pixel(img, sf, False),
                                      J.shift_pixel(img, sf, False))
    aniso = P.anisotropic_gaussian_kernel(11, 0.4, 2.0, 5.0)
    np.testing.assert_array_equal(P.filter2d_mirror(img, aniso),
                                  J.filter2d_mirror(img, aniso))
    np.testing.assert_array_equal(P.add_sharpening(img),
                                  J.add_sharpening(img))
    for q in (30, 60, 95):
        np.testing.assert_array_equal(P.add_jpeg_noise(img, quality=q),
                                      J.add_jpeg_noise(img, quality=q))
    for scale in (0.5, 0.25, 2.0):
        np.testing.assert_array_equal(imresize_np(img, scale),
                                      imresize_np_jax(img, scale))


@pytest.mark.parametrize('pipeline', ['bsrgan', 'bsrgan_plus'])
def test_host_pipelines_shapes_and_determinism(pipeline):
    fn = getattr(P, f'degradation_{pipeline}')
    img = _img(1, 64, 64)
    for seed in range(3):
        lq, hq = fn(img, np.random.default_rng(seed), sf=4, lq_patchsize=16,
                    use_crop=False)
        assert lq.shape == (16, 16, 3) and lq.dtype == np.float32
        assert hq.shape == (64, 64, 3)
        assert 0 <= lq.min() and lq.max() <= 1
        lq2, _ = fn(img, np.random.default_rng(seed), sf=4, lq_patchsize=16,
                    use_crop=False)
        np.testing.assert_array_equal(lq, lq2)
    lq, hq = fn(img, np.random.default_rng(0), sf=4, lq_patchsize=8)
    assert lq.shape == (8, 8, 3) and hq.shape == (32, 32, 3)


def test_host_pipeline_statistics_match_jax():
    """Mean error against a clean MATLAB-bicubic downsample within 0.5-2x
    of the JAX package's host pipeline (global random state) over 12
    seeds."""
    import random
    img = _img(2, 64, 64)
    clean = imresize_np(img, 0.25)
    port, ref = [], []
    for seed in range(12):
        lq, _ = P.degradation_bsrgan(img, np.random.default_rng(seed), sf=4,
                                     lq_patchsize=16, use_crop=False)
        port.append(np.abs(lq - clean).mean())
        random.seed(seed)
        np.random.seed(seed)
        lq, _ = J.degradation_bsrgan(img, sf=4, lq_patchsize=16,
                                     use_crop=False)
        ref.append(np.abs(lq - clean).mean())
    assert 0.5 < np.mean(port) / np.mean(ref) < 2.0, (np.mean(port),
                                                      np.mean(ref))


@pytest.fixture(scope='module')
def gt_folder(tmp_path_factory):
    root = tmp_path_factory.mktemp('bsrgan_gt')
    for i in range(4):
        cv2.imwrite(str(root / f'{i}.png'),
                    (_img(10 + i, 80, 80) * 255).round().astype(np.uint8))
    return root


def _opt(root, **kw):
    return dict({'name': 'gt', 'type': 'BSRGANTrainDataset', 'phase': 'train',
                 'scale': 4, 'dataroot_gt': str(root), 'gt_size': 64,
                 'use_resize_crop': True, 'use_flip': True, 'use_rot': True,
                 'batch_size_per_gpu': 2}, **kw)


@pytest.mark.parametrize('on_device', [False, True])
def test_bsrgan_dataset_items(gt_folder, on_device):
    data = BSRGANTrainDataset(_opt(gt_folder,
                                   on_device_degradation=on_device))
    assert len(data) == 4
    item = data[(2, (0, 0, 5))]
    assert item['gt'].shape == (3, 64, 64) and item['gt'].dtype == torch.float32
    assert item['gt_path'].endswith('2.png')
    if on_device:
        assert 'lq' not in item
    else:
        assert item['lq'].shape == (3, 16, 16)
        assert 0 <= float(item['lq'].min()) and float(item['lq'].max()) <= 1
    # the item is a function of (index, seed)
    again = data[(2, (0, 0, 5))]
    assert all(torch.equal(item[k], again[k]) for k in ('lq', 'gt')
               if k in item)
    other = data[(2, (0, 0, 6))]
    assert not torch.equal(item['gt'], other['gt'])


def test_bsrgan_batches_do_not_depend_on_workers(gt_folder):
    batches = []
    for workers in (0, 2):
        loader, sampler = build_train_loader(
            BSRGANTrainDataset(_opt(gt_folder)),
            _opt(gt_folder, num_worker_per_gpu=workers), seed=3)
        sampler.start(1)
        batches.append(next(iter(loader)))
    for key in ('lq', 'gt'):
        assert torch.equal(batches[0][key], batches[1][key]), key
    assert batches[0]['gt_path'] == batches[1]['gt_path']
