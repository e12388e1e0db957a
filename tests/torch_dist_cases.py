"""Training cases shared by the data-parallel CPU tests
(tests/test_torch_dist_train*.py, test_torch_dist_resume.py): a seeded
folder, the LQ- and HQ-stage options at a small size, and the comparisons.

The parameter checks train with SGD: Adam's first update lr * g / (|g| +
eps) turns the rounding noise of a gradient whose true value is zero (the
attention's key bias: softmax ignores a constant added to every key) into
a step of full size, in one process as much as across two; SGD keeps the
parameters within the gradients' rounding. A resume, which replays the
same arithmetic, trains with Adam.
"""

import copy
import json
import os
import shutil

import cv2
import numpy as np
import torch

from femasr_torch.models import FeMaSRNet, init_weights

SMALL = [[32, 16, 32]]
FROZEN = ['quantize', 'decoder', 'after_quant_group', 'out_conv']
LOSSES = ('l_codebook', 'l_pix', 'l_g_gan', 'l_g_total', 'l_d_real',
          'l_d_fake', 'out_d_real', 'out_d_fake', 'codebook_perplexity')
RTOL = 1e-5        # world 2 against world 1, of each tensor's largest value


def make_folder(root):
    """8 seeded smooth 64px GT images (the degradation's JPEG sees
    photo-like blocks), their x4 area-downsampled LQ, and a seeded HQ
    prior at root/hq.pth."""
    rng = np.random.default_rng(0)
    for sub in ('gt', 'lq'):
        os.makedirs(root / sub)
    for i in range(8):
        base = rng.random((9, 9, 3), dtype=np.float32)
        gt = (cv2.resize(base, (64, 64), interpolation=cv2.INTER_CUBIC)
              .clip(0, 1) * 255).round().astype(np.uint8)
        cv2.imwrite(str(root / 'gt' / f'{i}.png'), gt)
        cv2.imwrite(str(root / 'lq' / f'{i}.png'),
                    cv2.resize(gt, (16, 16), interpolation=cv2.INTER_AREA))
    hq = FeMaSRNet(SMALL, LQ_stage=False)
    init_weights(hq, torch.Generator().manual_seed(1))
    torch.save({'params': hq.state_dict()}, str(root / 'hq.pth'))
    return root


def options(root, name, batch, iters=2, lq_stage=True, optim='SGD',
            save_every=1e9, **train):
    """Training options on the folder: the LQ stage (frozen prior
    modules) or the HQ stage from the prior, L1 + codebook + hinge GAN
    losses with the discriminator step from iteration 1; a checkpoint and
    training state every `save_every` iterations."""
    optim = ({'type': 'SGD', 'lr': 1e-2} if optim == 'SGD' else
             {'type': 'Adam', 'lr': 1e-3, 'betas': [0.9, 0.99]})
    net_g = {'type': 'FeMaSRNet', 'codebook_params': SMALL,
             'LQ_stage': lq_stage, 'scale_factor': 4}
    if lq_stage:
        net_g['frozen_module_keywords'] = FROZEN
    return {
        'name': name, 'model_type': 'FeMaSRModel', 'scale': 4,
        'manual_seed': 3, 'device': 'cpu',
        'datasets': {'train': {
            'name': 'seeded', 'type': 'PairedImageDataset',
            'dataroot_gt': str(root / 'gt'), 'dataroot_lq': str(root / 'lq'),
            'gt_size': 64, 'use_flip': True, 'use_rot': True,
            'batch_size_per_gpu': batch, 'num_worker_per_gpu': 0}},
        'network_g': net_g,
        'network_d': {'type': 'UNetDiscriminatorSN', 'num_feat': 8},
        'path': ({'pretrain_network_hq': str(root / 'hq.pth')} if lq_stage
                 else {'pretrain_network_g': str(root / 'hq.pth')}),
        'train': dict({
            'optim_g': dict(optim), 'optim_d': dict(optim),
            'total_iter': iters, 'warmup_iter': -1,
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                        'loss_weight': 0.1},
            'codebook_opt': {'loss_weight': 1.0}}, **train),
        'logger': {'print_freq': 1, 'save_checkpoint_freq': save_every,
                   'save_latest_freq': 1e9, 'use_tb_logger': False}}


def degrading(opt):
    """The options with the train set's LQ synthesized on the device."""
    opt = copy.deepcopy(opt)
    opt['datasets']['train'].update(type='BSRGANTrainDataset',
                                    on_device_degradation=True)
    del opt['datasets']['train']['dataroot_lq']
    return opt


CASES = {
    'lq': lambda root, b: options(root, 'lq', b),
    'lq_chunks': lambda root, b: options(root, 'lq_chunks', b,
                                         grad_accum_chunks=2),
    'lq_degrade': lambda root, b: degrading(options(root, 'lq_degrade', b)),
    'hq': lambda root, b: options(root, 'hq', b, iters=1, lq_stage=False),
}


def job(work, name, opt, *argv):
    """A worker's train_cli job in `work`."""
    return {'kind': 'train', 'name': name, 'cwd': str(work), 'opt': opt,
            'argv': list(argv)}


def read_runs(work):
    """experiment name -> (its logged iterations, its networks as saved at
    the end: models/net_g_latest.pth and net_d_latest.pth); then the
    experiments are removed (each LQ network is ~130 MB)."""
    out = {}
    for name in os.listdir(work / 'experiments'):
        root = work / 'experiments' / name
        with open(root / 'train_log.jsonl') as f:
            records = [json.loads(line) for line in f]
        nets = {net: torch.load(str(root / 'models' / f'{net}_latest.pth'),
                                weights_only=True)['params']
                for net in ('net_g', 'net_d')}
        out[name] = (records, nets)
    shutil.rmtree(work / 'experiments')
    return out


def assert_states_close(a, b, rtol):
    """Every tensor of b within rtol of a's largest value."""
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k].double(), b[k].double()
        assert (x - y).abs().max() <= rtol * x.abs().max(), k


def assert_world2_equals_world1(one, two, ranks):
    """World 2's ranks hold the same networks (fingerprints), within RTOL
    of world 1's, and log world 1's losses within RTOL. one, two: a run's
    (records, networks); ranks: world 2's worker results."""
    (log1, nets1), (log2, nets2) = one, two
    assert ranks[0]['ddp'] == 'DistributedDataParallel'
    for net in ('net_g', 'net_d'):
        assert ranks[0][net] == ranks[1][net]    # the ranks agree exactly
        assert_states_close(nets1[net], nets2[net], RTOL)
    assert [r['iter'] for r in log1] == [r['iter'] for r in log2]
    for a, b in zip(log1, log2):
        for k in LOSSES:
            if k in a:
                assert abs(a[k] - b[k]) <= RTOL * max(abs(a[k]), 1e-3), (
                    a['iter'], k, a[k], b[k])
