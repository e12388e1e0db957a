"""On-device degradation in the port's trainer (datasets.train.
on_device_degradation, LQ stage) on the CPU: a step equals the plain step
fed the LQ that degradation_bsrgan gives for that step's generator, bit
for bit; the LQ does not depend on grad_accum_chunks; a run resumed at
iteration 2 replays the uninterrupted run; and the shipped configurations
that need the BSRGAN data pass the port's option check."""

import copy
import json
import os

import cv2
import numpy as np
import pytest
import torch

from femasr_torch import train_cli
from femasr_torch.data import build_dataset
from femasr_torch.models import FeMaSRNet, init_weights
from femasr_torch.ops.degradations import degradation_bsrgan
from femasr_torch.train import FeMaSRModel
from femasr_torch.utils.options import (check_port_options, load_options,
                                        parse_options)
import torch_port_util  # noqa: F401  (caps torch at 2 threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = [[32, 16, 32]]
FROZEN = ['quantize', 'decoder', 'after_quant_group', 'out_conv']
LOSSES = ('l_codebook', 'l_pix', 'l_g_gan', 'l_d_real', 'l_d_fake')


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    """4 seeded 72px GT images and a seeded HQ prior checkpoint."""
    root = tmp_path_factory.mktemp('degrade_data')
    rng = np.random.default_rng(0)
    os.makedirs(root / 'gt')
    for i in range(4):
        base = rng.random((9, 9, 3), dtype=np.float32)
        img = cv2.resize(base, (72, 72), interpolation=cv2.INTER_CUBIC)
        cv2.imwrite(str(root / 'gt' / f'{i}.png'),
                    (img.clip(0, 1) * 255).round().astype(np.uint8))
    hq = FeMaSRNet(SMALL, LQ_stage=False)
    init_weights(hq, torch.Generator().manual_seed(1))
    torch.save({'params': hq.state_dict()}, str(root / 'hq.pth'))
    return root


def options(root, batch=2):
    return {
        'name': 'lq_degrade', 'model_type': 'FeMaSRModel', 'scale': 4,
        'manual_seed': 5, 'device': 'cpu',
        'datasets': {'train': {
            'name': 'seeded', 'type': 'BSRGANTrainDataset',
            'dataroot_gt': str(root / 'gt'), 'on_device_degradation': True,
            'gt_size': 64, 'use_resize_crop': True,
            'use_flip': True, 'use_rot': True, 'batch_size_per_gpu': batch,
            'num_worker_per_gpu': 0}},
        'network_g': {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                      'LQ_stage': True, 'scale_factor': 4,
                      'frozen_module_keywords': FROZEN},
        'network_d': {'type': 'UNetDiscriminatorSN', 'num_feat': 8},
        'path': {'pretrain_network_hq': str(root / 'hq.pth')},
        'train': {
            'optim_g': {'type': 'Adam', 'lr': 1e-3, 'betas': [0.9, 0.99]},
            'optim_d': {'type': 'Adam', 'lr': 4e-4, 'betas': [0.9, 0.99]},
            'total_iter': 4, 'warmup_iter': -1,
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                        'loss_weight': 0.1},
            'codebook_opt': {'loss_weight': 1.0}},
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 2,
                   'save_latest_freq': 1e9, 'use_tb_logger': False}}


@pytest.fixture(scope='module')
def built(folder):
    """An on-device LQ-stage trainer before its first step, and a GT batch
    of its train set; the tests step deep copies of it."""
    opt, _ = parse_options('.', opt=options(folder), argv=[])
    data = build_dataset(opt['datasets']['train'])
    batch = torch.utils.data.default_collate([data[(i, (5, 0, i))]
                                              for i in (0, 3)])
    return FeMaSRModel(opt), batch


def test_on_device_step_equals_the_plain_step_fed_its_lq(built):
    model, batch = built
    on, plain = copy.deepcopy(model), copy.deepcopy(model)
    plain.degrade_on_device = False     # datasets.train without the flag
    assert on.degrade_on_device and 'lq' not in batch
    lq = degradation_bsrgan(batch['gt'], on.degradation_generator(), 4)
    on.feed_data(batch)
    on.optimize_parameters()
    assert torch.equal(on.lq, lq)
    plain.feed_data(dict(batch, lq=lq))
    plain.optimize_parameters()
    assert on.get_current_log() == plain.get_current_log()
    for (name, p), q in zip(on.net_g.named_parameters(),
                            plain.net_g.parameters()):
        assert torch.equal(p, q), name
    for (name, p), q in zip(on.net_d.named_parameters(),
                            plain.net_d.parameters()):
        assert torch.equal(p, q), name


def test_degraded_lq_does_not_depend_on_grad_accum_chunks(built):
    # the whole batch is degraded before it is cut into chunks: the LQ of
    # a 2-chunk step is the one degradation_bsrgan gives the whole batch
    # (which the 1-chunk step above takes)
    model, batch = built
    model = copy.deepcopy(model)
    model.grad_accum_chunks = 2         # train.grad_accum_chunks: 2
    assert model.chunks(2) == 2
    lq = degradation_bsrgan(batch['gt'], model.degradation_generator(), 4)
    model.feed_data(batch)
    model.optimize_parameters()
    assert lq.shape == (2, 3, 16, 16)
    assert torch.equal(model.lq, lq)


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_resumed_on_device_run_replays_the_uninterrupted_run(
        folder, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    opt_path = str(tmp_path / 'degrade.json')
    with open(opt_path, 'w') as f:
        json.dump(options(folder, batch=1), f)
    model = train_cli.main(['-opt', opt_path])
    exp = tmp_path / 'experiments' / 'lq_degrade'
    full = _log(exp / 'train_log.jsonl')
    assert [r['iter'] for r in full] == [1, 2, 3, 4]
    for key in LOSSES:
        assert np.isfinite([r[key] for r in full]).all(), key

    resumed = train_cli.main(['-opt', opt_path, '--force_yml',
                              'path:resume_state=' + str(
                                  exp / 'training_states' / '2.state')])
    again = _log(exp / 'train_log.jsonl')[4:]
    assert [r['iter'] for r in again] == [3, 4]
    for a, b in zip(full[2:], again):
        for key in LOSSES:
            assert abs(a[key] - b[key]) <= 1e-6 * max(abs(a[key]), 1e-12), (
                key, a[key], b[key])
    for (name, p), q in zip(model.net_g.named_parameters(),
                            resumed.net_g.parameters()):
        torch.testing.assert_close(p, q, rtol=1e-6, atol=1e-6, msg=name)


@pytest.mark.parametrize('yml', ['train_FeMaSR_LQ_stage_ondevice.yml',
                                 'train_FeMaSR_HQ_pretrain_stage.yml'])
def test_shipped_bsrgan_configs_pass_the_port_check(yml):
    opt = load_options(os.path.join(ROOT, 'options', yml))
    assert opt['datasets']['train']['type'] == 'BSRGANTrainDataset'
    check_port_options(opt)
