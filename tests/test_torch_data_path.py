"""The port's data path beyond the BSRGAN data, on the CPU: the rest of
`data_util` against the JAX package's (paths exactly, frames exactly,
`duf_downsample` within 1e-6); dataset items from `.fmrs` roots against
the folder's items and the JAX package's `ImageSource.get`, bit for bit;
the train loader with persistent workers (batches of epochs 0 and 1 and
after a resume inside epoch 1 equal those of a loader without workers,
also after a break mid-epoch); `DevicePrefetcher` on the CPU (the
loader's batches as they are); and two training iterations of a SMALL
HQ-stage trainer from GT and LQ shards, through the train loader and the
model's prefetcher, against the same iterations from the folders (torch
against torch, bit for bit)."""

import copy
import os
import pickle

import cv2
import numpy as np
import pytest
import torch

from femasr_torch.data import (BSRGANTrainDataset, DevicePrefetcher,
                               ImageSource, PairedImageDataset, build_dataset,
                               build_train_loader, make_shard_from_folder)
from femasr_torch.data import data_util as P
from femasr_torch.train import FeMaSRModel
from femasr_torch.utils.options import parse_options
from femasr_tpu.data import data_util as J
from femasr_tpu.data.datasets import ImageSource as JImageSource
import torch_port_util  # noqa: F401  (caps torch at 2 threads)

SMALL = [[32, 16, 32]]
N = 6


@pytest.fixture(scope='module', autouse=True)
def jax_native_cache(tmp_path_factory):
    """The JAX package's reader: g++ writes its library straight to its
    cache path, so a cache of this module's own keeps two test processes
    from writing one library at the same time."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('FEMASR_NATIVE_CACHE',
                  str(tmp_path_factory.mktemp('jax_native')))
        yield


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """N seeded 64px GT images, their x4 LQ, both as folders and shards;
    a meta-info file."""
    root = tmp_path_factory.mktemp('data_path')
    rng = np.random.default_rng(0)
    for sub in ('gt', 'lq'):
        os.makedirs(root / sub)
    for i in range(N):
        base = rng.random((16, 16, 3), dtype=np.float32)
        gt = (cv2.resize(base, (64, 64), interpolation=cv2.INTER_CUBIC)
              .clip(0, 1) * 255).round().astype(np.uint8)
        cv2.imwrite(str(root / 'gt' / f'{i:02d}.png'), gt)
        cv2.imwrite(str(root / 'lq' / f'{i:02d}.png'),
                    cv2.resize(gt, (16, 16), interpolation=cv2.INTER_AREA))
    for sub in ('gt', 'lq'):
        make_shard_from_folder(str(root / sub), str(root / f'{sub}.fmrs'))
    with open(root / 'meta.txt', 'w') as f:
        f.writelines(f'{i:02d}.png (64,64,3)\n' for i in range(N))
    return root


def test_paired_paths_equal_jax(data):
    folders, keys = [str(data / 'lq'), str(data / 'gt')], ['lq', 'gt']
    assert P.paired_paths_from_folders(folders, keys) == \
        J.paired_paths_from_folders(folders, keys)
    meta = str(data / 'meta.txt')
    for tmpl in ('{}', '{}x4'):
        assert P.paired_paths_from_meta_info_file(folders, keys, meta, tmpl) \
            == J.paired_paths_from_meta_info_file(folders, keys, meta, tmpl)
    with pytest.raises(AssertionError, match='is not in lq_paths'):
        P.paired_paths_from_folders(folders, keys, '{}x4')


@pytest.mark.parametrize('padding', ['replicate', 'reflection',
                                     'reflection_circle', 'circle'])
def test_frame_indices_equal_jax(padding):
    for total in (7, 12):
        for n in (1, 3, 5, 7):
            for crt in range(total):
                assert P.generate_frame_indices(crt, total, n, padding) == \
                    J.generate_frame_indices(crt, total, n, padding)


def test_read_img_seq_and_duf_downsample_equal_jax(data):
    folder = str(data / 'gt')
    for mod, scale in ((False, 1), (True, 3)):
        a = P.read_img_seq(folder, mod, scale)
        b = J.read_img_seq(folder, mod, scale)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    paths = [os.path.join(folder, f'{i:02d}.png') for i in (3, 1)]
    assert np.array_equal(P.read_img_seq(paths), J.read_img_seq(paths))
    frames = P.read_img_seq(folder)[:2]
    for scale in (2, 3, 4):
        for x in (frames, frames[0]):
            a = P.duf_downsample(x, 13, scale)
            b = J.duf_downsample(x, 13, scale)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1e-6


def test_image_source_shard_equals_folder_and_jax(data):
    shard, folder = ImageSource(str(data / 'gt.fmrs')), ImageSource(
        str(data / 'gt'))
    ref = JImageSource(str(data / 'gt.fmrs'))
    assert len(shard) == len(folder) == N
    assert shard.paths == [f'{data}/gt.fmrs:{i:02d}' for i in range(N)] == [
        ref.path(i) for i in range(N)]
    for i in range(N):
        a = shard.get(i)
        assert a.dtype == np.float32 and a.shape == (64, 64, 3)
        assert np.array_equal(a, folder.get(i))
        assert np.array_equal(a, ref.get(i))
    # a pickled copy (a spawned worker) maps the shard itself
    copy = pickle.loads(pickle.dumps(shard))
    assert copy._reader is None and np.array_equal(copy.get(2),
                                                   shard.get(2))


def _paired(root, gt, lq, **kw):
    return dict({'name': 'p', 'type': 'PairedImageDataset', 'phase': 'train',
                 'dataroot_gt': str(root / gt), 'dataroot_lq': str(root / lq),
                 'gt_size': 24, 'use_resize_crop': True, 'use_flip': True,
                 'use_rot': True, 'scale': 4}, **kw)


def _bsrgan(root, gt, on_device, **kw):
    return dict({'name': 'b', 'type': 'BSRGANTrainDataset', 'phase': 'train',
                 'dataroot_gt': str(root / gt), 'gt_size': 32,
                 'use_resize_crop': True, 'use_flip': True, 'use_rot': True,
                 'scale': 4, 'on_device_degradation': on_device}, **kw)


def _same_item(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize('make', [
    lambda r, s: PairedImageDataset(_paired(r, 'gt' + s, 'lq' + s)),
    lambda r, s: PairedImageDataset(_paired(r, 'gt' + s, 'lq' + s,
                                            phase='val')),
    lambda r, s: BSRGANTrainDataset(_bsrgan(r, 'gt' + s, True)),
    lambda r, s: BSRGANTrainDataset(_bsrgan(r, 'gt' + s, False))],
    ids=['paired', 'paired_val', 'bsrgan_on_device', 'bsrgan_host'])
def test_dataset_items_from_a_shard_equal_the_folder(data, make):
    shard, folder = make(data, '.fmrs'), make(data, '')
    assert len(shard) == len(folder) == N
    for pos, i in enumerate((0, 4, 5)):
        item = shard[(i, (7, 1, pos))]
        _same_item(item, folder[(i, (7, 1, pos))])
        assert item['gt_path'] == f'{data}/gt.fmrs:{i:02d}'


def _batches(loader, sampler, epoch, skip=0, stop=None):
    sampler.start(epoch, skip)
    out = []
    for b in loader:
        out.append(b)
        if stop is not None and len(out) == stop:
            break
    return out


def _same_batches(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a['gt_path'] == b['gt_path']
        assert torch.equal(a['gt'], b['gt'])


def test_persistent_workers_yield_the_batches_of_no_workers(data):
    opt = _bsrgan(data, 'gt.fmrs', True, batch_size_per_gpu=2,
                  dataset_enlarge_ratio=2, num_prefetch_queue=3)
    ref, ref_s = build_train_loader(BSRGANTrainDataset(opt), dict(
        opt, num_worker_per_gpu=0), seed=4)
    loader, sampler = build_train_loader(BSRGANTrainDataset(opt), dict(
        opt, num_worker_per_gpu=2), seed=4)
    assert loader.persistent_workers and loader.prefetch_factor == 2
    assert not ref.persistent_workers and not loader.pin_memory
    want = [_batches(ref, ref_s, e) for e in (0, 1)]
    assert len(want[0]) == N * 2 // 2
    for e in (0, 1):
        _same_batches(_batches(loader, sampler, e), want[e])
        if e == 0:      # the worker processes of epoch 0
            pids = [w.pid for w in loader._iterator._workers]
    # a break mid-epoch (the loop's end at total_iter), then a resume
    # inside epoch 1 at iteration 2 of it, on the same workers
    _same_batches(_batches(loader, sampler, 0, stop=2), want[0][:2])
    _same_batches(_batches(loader, sampler, 1, skip=2 * 2), want[1][2:])
    _same_batches(_batches(loader, sampler, 1), want[1])
    assert [w.pid for w in loader._iterator._workers] == pids
    # a new loader resumed there (a new process's run)
    fresh, fresh_s = build_train_loader(BSRGANTrainDataset(opt), dict(
        opt, num_worker_per_gpu=2), seed=4)
    _same_batches(_batches(fresh, fresh_s, 1, skip=2 * 2), want[1][2:])


def test_device_prefetcher_passes_cpu_batches_through(data):
    opt = _paired(data, 'gt.fmrs', 'lq.fmrs', batch_size_per_gpu=2,
                  num_worker_per_gpu=0)
    loader, sampler = build_train_loader(PairedImageDataset(opt), opt, 1,
                                         device=torch.device('cpu'))
    prefetcher = DevicePrefetcher(loader, 'cpu')
    assert len(prefetcher) == len(loader) == N // 2
    sampler.start(0)
    want = list(loader)
    sampler.start(0)
    got = list(prefetcher)
    _same_batches(got, want)
    assert all(torch.equal(a['lq'], b['lq']) for a, b in zip(got, want))


def _train_options(root):
    """A SMALL HQ-stage run on the paired set (the cheapest trainer)."""
    return {
        'name': 'from_shard', 'model_type': 'FeMaSRModel', 'scale': 4,
        'manual_seed': 5, 'device': 'cpu',
        'datasets': {'train': _paired(root, 'gt', 'lq', gt_size=64,
                                      batch_size_per_gpu=1,
                                      num_worker_per_gpu=0)},
        'network_g': {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                      'LQ_stage': False, 'scale_factor': 4},
        'network_d': {'type': 'UNetDiscriminatorSN', 'num_feat': 8},
        'path': {},
        'train': {
            'optim_g': {'type': 'Adam', 'lr': 1e-3, 'betas': [0.9, 0.99]},
            'optim_d': {'type': 'Adam', 'lr': 4e-4, 'betas': [0.9, 0.99]},
            'total_iter': 2, 'warmup_iter': -1,
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                        'loss_weight': 0.1},
            'codebook_opt': {'loss_weight': 1.0}},
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 1e9,
                   'save_latest_freq': 1e9, 'use_tb_logger': False}}


def test_training_from_a_shard_equals_training_from_the_folder(data):
    opt, _ = parse_options('.', opt=_train_options(data), argv=[])
    built = FeMaSRModel(opt)
    runs = []
    for ext in ('', '.fmrs'):
        model = copy.deepcopy(built)
        dopt = dict(opt['datasets']['train'],
                    dataroot_gt=str(data / f'gt{ext}'),
                    dataroot_lq=str(data / f'lq{ext}'))
        loader, sampler = build_train_loader(
            build_dataset(dopt), dopt, opt['manual_seed'], device=model.device)
        sampler.start(0)
        logs = []
        for step, batch in zip((1, 2), model.wrap_loader(loader)):
            model.feed_data(batch)
            model.optimize_parameters(step)
            logs.append(model.get_current_log())
        runs.append((model, logs))
    (a, log_a), (b, log_b) = runs
    assert len(log_a) == 2 and log_a == log_b
    for k in ('l_codebook', 'l_pix', 'l_g_gan', 'l_d_real', 'l_d_fake'):
        assert np.isfinite([r[k] for r in log_a]).all(), k
    assert torch.equal(a.gt, b.gt) and torch.equal(a.lq, b.lq)
    for (name, p), q in zip(a.net_g.named_parameters(),
                            b.net_g.parameters()):
        assert torch.equal(p, q), name
