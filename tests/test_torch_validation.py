"""Validation and offline evaluation in the port, on the CPU (device: cpu).

A SMALL-codebook LQ run of the port's training loop with validation: when
it runs, the best records and checkpoints, the LPIPS fallback, and that it
leaves the next training iteration bit for bit as it was. Then
`python -m femasr_torch.test_cli` on the run's best checkpoint: the
validation's metrics exactly, two test images against the same weights
through the JAX pieces that the JAX trainer's validation composes
(SRInferencer.run_padded, array2img, the JAX PSNR / SSIM), and an LQ-only
folder. The release option files pass with their val blocks."""

import copy
import json
import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from torch.utils.data import default_collate

from femasr_torch import test_cli, train_cli
from femasr_torch.data import (EpochSampler, PairedImageDataset,
                               SingleImageDataset, build_dataset)
from femasr_torch.models import FeMaSRNet, init_weights
from femasr_torch.ops import swin
from femasr_torch.train import FeMaSRModel
from femasr_torch.utils.options import check_port_options
from femasr_tpu.metrics import calculate_psnr as jpsnr
from femasr_tpu.metrics import calculate_ssim as jssim
from femasr_tpu.models.convert import convert_femasr_checkpoint
from femasr_tpu.models.inference import SRInferencer as JSRInferencer
from femasr_tpu.utils.img_util import array2img
import torch_port_util  # noqa: F401  (caps torch at 2 threads)

SMALL = [[32, 16, 32]]
FROZEN = ['quantize', 'decoder', 'after_quant_group', 'out_conv']
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRICS = {'psnr': {'type': 'psnr', 'crop_border': 4,
                    'test_y_channel': True},
           'ssim': {'type': 'ssim', 'crop_border': 4,
                    'test_y_channel': True},
           'lpips': {'type': 'lpips', 'better': 'lower'}}


def _smooth(rng, h, w):
    """A seeded smooth uint8 BGR image (bilinear-upsampled coarse noise)."""
    coarse = (rng.random((h // 8 + 2, w // 8 + 2, 3)) * 255).astype(
        np.float32)
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_LINEAR)
    return np.clip(img + rng.normal(0, 6, img.shape), 0, 255).round() \
        .astype(np.uint8)


def _pairs(root, sizes, rng):
    for sub in ('gt', 'lq'):
        os.makedirs(root / sub)
    for i, (h, w) in enumerate(sizes):
        gt = _smooth(rng, 4 * h, 4 * w)
        cv2.imwrite(str(root / 'gt' / f'{i}.png'), gt)
        cv2.imwrite(str(root / 'lq' / f'{i}.png'),
                    cv2.resize(gt, (w, h), interpolation=cv2.INTER_AREA))


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    """Two 128px GT training images (x4 LQ at 32px: the Swin shapes of a
    24px validation image, flip-padded to 32); a val set of one 24x24 LR
    image; a test set of a 32x44 and a 40x36 LR image; a seeded HQ
    prior."""
    root = tmp_path_factory.mktemp('val_data')
    rng = np.random.default_rng(0)
    for name, sizes in (('train', [(32, 32), (32, 32)]),
                        ('val', [(24, 24)]),
                        ('test', [(32, 44), (40, 36)])):
        os.makedirs(root / name)
        _pairs(root / name, sizes, rng)
    hq = FeMaSRNet(SMALL, LQ_stage=False)
    init_weights(hq, torch.Generator().manual_seed(1))
    torch.save({'params': hq.state_dict()}, str(root / 'hq.pth'))
    return root


def _dataset(root, name, kind='PairedImageDataset'):
    d = {'name': name, 'type': kind, 'dataroot_lq': str(root / 'lq')}
    if kind == 'PairedImageDataset':
        d['dataroot_gt'] = str(root / 'gt')
    return d


def train_options(data):
    train_set = dict(_dataset(data / 'train', 'seeded'), gt_size=128,
                     use_flip=True, batch_size_per_gpu=1,
                     num_worker_per_gpu=0)
    opt = {
        'name': 'val_cpu',
        'model_type': 'FeMaSRModel', 'scale': 4, 'manual_seed': 0,
        'device': 'cpu', 'datasets': {'train': train_set},
        'network_g': {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                      'LQ_stage': True, 'scale_factor': 4,
                      'frozen_module_keywords': FROZEN},
        'network_d': {'type': 'UNetDiscriminatorSN', 'num_feat': 8},
        'path': {'pretrain_network_hq': str(data / 'hq.pth')},
        'train': {
            'optim_g': {'type': 'Adam', 'lr': 1e-3, 'betas': [0.9, 0.99]},
            'optim_d': {'type': 'Adam', 'lr': 4e-4, 'betas': [0.9, 0.99]},
            'scheduler': {'type': 'MultiStepLR', 'milestones': [9],
                          'gamma': 1},
            'total_iter': 2, 'warmup_iter': -1,
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                        'loss_weight': 0.1},
            'codebook_opt': {'loss_weight': 1.0}},
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 1e9,
                   'save_latest_freq': 1e9, 'use_tb_logger': False},
        'val': {'val_freq': 1, 'save_img': True, 'key_metric': 'lpips',
                'metrics': METRICS}}
    opt['datasets']['val'] = _dataset(data / 'val', 'seeded_val')
    return opt


def eval_options(datasets, weights, name='best'):
    return {'name': name, 'model_type': 'FeMaSRModel', 'scale': 4,
            'manual_seed': 0, 'device': 'cpu', 'datasets': datasets,
            'network_g': {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                          'LQ_stage': True, 'scale_factor': 4},
            'path': {'pretrain_network_g': weights},
            'val': {'save_img': True, 'key_metric': 'lpips',
                    'metrics': {k: v for k, v in METRICS.items()
                                if k != 'lpips'}}}


def _records(monkeypatch):
    """Each validation's (iteration, metrics, best records), recorded
    around FeMaSRModel.validation, and the trainer's state before the first
    one. The Swin shift-mask cache is emptied first, so that validation,
    not the training step before it, fills the entry of the training shape
    that the next training step reads."""
    calls, snaps = [], []
    orig = FeMaSRModel.validation

    def validation(self, loader, current_iter, tb_logger, save_img=False):
        swin._device_mask.cache_clear()
        if self.is_train and not snaps:
            snaps.append(copy.deepcopy(dict(
                g=self.net_g.state_dict(), d=self.net_d.state_dict(),
                opt_g=self.opt_g.state_dict(), opt_d=self.opt_d.state_dict(),
                step=self.step)))
        rng = torch.get_rng_state()
        orig(self, loader, current_iter, tb_logger, save_img)
        assert torch.equal(rng, torch.get_rng_state())
        best = self.best_metric_results.get(loader.dataset.opt['name'], {})
        calls.append((current_iter, dict(self.metric_results),
                      {m: dict(r) for m, r in best.items()}))
    monkeypatch.setattr(FeMaSRModel, 'validation', validation)
    return calls, snaps


def _iteration_again(model, snap, opt, position):
    """Restore the trainer to `snap` and run the iteration at `position` of
    epoch 0 again, on the batch the loader gave it; returns its log."""
    model.net_g.load_state_dict(snap['g'])
    model.net_d.load_state_dict(snap['d'])
    model.opt_g.load_state_dict(snap['opt_g'])
    model.opt_d.load_state_dict(snap['opt_d'])
    model.step = snap['step']
    dopt = opt['datasets']['train']
    data = build_dataset(dict(dopt, phase='train'))
    sampler = EpochSampler(len(data), opt['manual_seed'])
    sampler.start(0, position)
    model.feed_data(default_collate([data[next(iter(sampler))]]))
    model.optimize_parameters(position + 1)
    return model.get_current_log()


def _jax_validation(weights, folder):
    """The JAX trainer's validation pieces on the port's checkpoint: per
    image the 8-bit output (BGR) and the PSNR / SSIM of its RGB levels."""
    sd = {k: v.numpy() for k, v in torch.load(weights)['params'].items()}
    jsr = JSRInferencer(convert_femasr_checkpoint(
        sd, codebook_params=SMALL, LQ_stage=True, scale_factor=4),
        codebook_params=SMALL, scale_factor=4, init_merge=False)
    out = []
    for name in sorted(os.listdir(folder / 'lq')):
        lq, gt = (cv2.cvtColor(cv2.imread(str(folder / d / name)),
                               cv2.COLOR_BGR2RGB).astype(np.float32) / 255.
                  for d in ('lq', 'gt'))
        img = array2img(np.asarray(jsr.run_padded(jnp.asarray(lq)[None])[0]))
        sr01 = img[..., ::-1].astype(np.float32) / 255.0
        out.append((img, jpsnr(sr01, gt, crop_border=4, test_y_channel=True),
                    jssim(sr01, gt, crop_border=4, test_y_channel=True)))
    return out


def test_training_validates_and_evaluation_reproduces_it(data, tmp_path,
                                                         monkeypatch):
    monkeypatch.chdir(tmp_path)
    calls, snaps = _records(monkeypatch)
    opt = train_options(data)
    model = train_cli.main([], opt=opt)
    # at iterations 1 and 2, and once more after the loop; the global RNG
    # did not move (checked around each call)
    assert [c[0] for c in calls] == [1, 2, 2]
    assert model.net_g.training
    # validation at the training Swin shapes changed nothing in training:
    # iteration 2 run again from the state before the validation at 1,
    # without it, gives the logged losses and the weights bit for bit
    exp = tmp_path / 'experiments' / 'val_cpu'
    with open(exp / 'train_log.jsonl') as f:
        logged = [json.loads(line) for line in f][1]
    weights = {n: p.detach().clone() for n, p in
               model.net_g.named_parameters()}
    again = _iteration_again(model, snaps[0], opt, 1)
    assert again and all(again[k] == logged[k] for k in again)
    for n, p in model.net_g.named_parameters():
        assert torch.equal(p, weights[n]), n
    # no LPIPS weights: lpips skipped, the best records kept per metric
    for it, res, best in calls:
        assert sorted(res) == ['psnr', 'ssim'] and np.isfinite(
            list(res.values())).all()
        assert best['lpips']['iter'] == -1
    for m in ('psnr', 'ssim'):
        vals = [c[1][m] for c in calls]
        assert calls[-1][2][m]['val'] == max(vals)
    models = exp / 'models'
    for name in ('net_g_best.pth', 'net_d_best.pth'):
        assert (models / name).exists(), name
    for it in (1, 2):
        assert (exp / 'visualization' / 'image_results' / str(it)
                / '0.png').exists()
    # net_g_best holds the weights of the last validation that improved a
    # record
    last = max(k for k, (it, _, best) in enumerate(calls)
               if any(r['iter'] == it for r in best.values()))

    # test_cli on net_g_best, one run over three datasets: the val set
    # (that validation's metrics exactly), two 32-48 px test images and an
    # LQ-only folder (images, no metrics)
    best = models / 'net_g_best.pth'
    test_cli.main([], opt=eval_options(
        {'test_1': _dataset(data / 'val', 'seeded_val'),
         'test_2': _dataset(data / 'test', 'seeded_test'),
         'test_3': _dataset(data / 'val', 'lq_only', 'SingleImageDataset')},
        str(best)))
    (_, val_res, _), (_, test_res, _), (_, lq_res, _) = calls[-3:]
    assert val_res == calls[last][1]
    assert lq_res == {}
    vis = tmp_path / 'results' / 'best' / 'visualization'
    assert os.listdir(vis / 'lq_only') == ['0_best.png']

    # against the JAX pieces on the same weights and images: <= 0.1% of
    # the pixels one level apart, PSNR within 0.01 dB, SSIM within 1e-4
    ref = _jax_validation(str(best), data / 'test')
    for i, (img, _, _) in enumerate(ref):
        out = cv2.imread(str(vis / 'seeded_test' / f'{i}_best.png'))
        assert out.shape == img.shape
        diff = np.abs(out.astype(int) - img.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert sorted(test_res) == ['psnr', 'ssim']
    assert abs(test_res['psnr'] - np.mean([r[1] for r in ref])) <= 0.01
    assert abs(test_res['ssim'] - np.mean([r[2] for r in ref])) <= 1e-4


@pytest.mark.parametrize('yml', ['train_FeMaSR_LQ_stage.yml',
                                 'test_FeMaSR.yml'])
def test_release_options_with_val_blocks_pass(yml):
    with open(os.path.join(ROOT, 'options', yml)) as f:
        opt = yaml.safe_load(f)
    assert opt['val']['metrics']
    check_port_options(opt)


def test_eval_datasets(data):
    """val / test items: whole pairs, a crop_eval_size crop drawn from the
    item's index (the same twice), and LQ-only items (color y, mean/std)."""
    opt = dict(_dataset(data / 'test', 'pairs'), phase='val')
    item = PairedImageDataset(opt)[1]
    assert item['lq'].shape == (3, 40, 36) and item['gt'].shape == (
        3, 160, 144)
    crop = PairedImageDataset(dict(opt, crop_eval_size=64))
    a, b = crop[1], crop[1]
    assert a['gt'].shape == (3, 64, 64) and a['lq'].shape == (3, 16, 16)
    assert torch.equal(a['gt'], b['gt'])
    lq_opt = _dataset(data / 'test', 'lq', 'SingleImageDataset')
    y = SingleImageDataset(dict(lq_opt, color='y', mean=0.5, std=0.25))[0]
    assert set(y) == {'lq', 'lq_path'} and y['lq'].shape == (1, 32, 44)
    assert y['lq'].min() < 0 < y['lq'].max()
