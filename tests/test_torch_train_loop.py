"""The port's training loop on the CPU (device: cpu), port only: an LQ-stage
run through `python -m femasr_torch.train_cli` on a seeded folder (finite
losses that move, frozen modules untouched, checkpoints written), resumed
from its saved state bit for bit; grad_accum_chunks=2 against the whole
batch; the generator EMA; and the options the port refuses, each with its
reason (a bfloat16 codebook search, a dtype other than float32 and
bfloat16 among them)."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from femasr_torch import train_cli
from femasr_torch.data import build_dataset
from femasr_torch.models import FeMaSRNet, init_weights
from femasr_torch.train import FeMaSRModel
from femasr_torch.utils.options import OptionError, parse_options
import torch_port_util  # noqa: F401  (caps torch at 2 threads)

SMALL = [[32, 16, 32]]
FROZEN = ['quantize', 'decoder', 'after_quant_group', 'out_conv']


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    """4 seeded 64px GT images, their x4 area-downsampled LQ, and a seeded
    HQ prior checkpoint."""
    root = tmp_path_factory.mktemp('train_data')
    rng = np.random.default_rng(0)
    for sub in ('gt', 'lq'):
        os.makedirs(root / sub)
    for i in range(4):
        gt = (rng.random((64, 64, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / 'gt' / f'{i}.png'), gt)
        cv2.imwrite(str(root / 'lq' / f'{i}.png'),
                    cv2.resize(gt, (16, 16), interpolation=cv2.INTER_AREA))
    hq = FeMaSRNet(SMALL, LQ_stage=False)
    init_weights(hq, torch.Generator().manual_seed(1))
    torch.save({'params': hq.state_dict()}, str(root / 'hq.pth'))
    return root


def options(root, **train):
    return {
        'name': 'lq_cpu', 'model_type': 'FeMaSRModel', 'scale': 4,
        'manual_seed': 0, 'device': 'cpu',
        'datasets': {'train': {
            'name': 'seeded', 'type': 'PairedImageDataset',
            'dataroot_gt': str(root / 'gt'), 'dataroot_lq': str(root / 'lq'),
            'gt_size': 64, 'use_resize_crop': True, 'use_flip': True,
            'use_rot': True, 'batch_size_per_gpu': 2,
            'num_worker_per_gpu': 0}},
        'network_g': {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                      'LQ_stage': True, 'scale_factor': 4,
                      'frozen_module_keywords': FROZEN},
        'network_d': {'type': 'UNetDiscriminatorSN', 'num_feat': 8},
        'path': {'pretrain_network_hq': str(root / 'hq.pth')},
        'train': dict({
            'optim_g': {'type': 'Adam', 'lr': 1e-3, 'betas': [0.9, 0.99]},
            'optim_d': {'type': 'Adam', 'lr': 4e-4, 'betas': [0.9, 0.99]},
            'scheduler': {'type': 'MultiStepLR', 'milestones': [2],
                          'gamma': 0.5},
            'total_iter': 3, 'warmup_iter': -1,
            'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0},
            'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                        'loss_weight': 0.1},
            'codebook_opt': {'loss_weight': 1.0}}, **train),
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 2,
                   'save_latest_freq': 1e9, 'use_tb_logger': False}}


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_cli_runs_and_resumes_bit_for_bit(folder, tmp_path,
                                                monkeypatch):
    monkeypatch.chdir(tmp_path)
    opt_path = str(tmp_path / 'lq.json')
    with open(opt_path, 'w') as f:
        json.dump(options(folder), f)
    model = train_cli.main(['-opt', opt_path])
    exp = tmp_path / 'experiments' / 'lq_cpu'
    full = _log(exp / 'train_log.jsonl')
    assert [r['iter'] for r in full] == [1, 2, 3]
    losses = ('l_codebook', 'l_pix', 'l_g_gan', 'l_d_real', 'l_d_fake')
    for key in losses:
        vals = [r[key] for r in full]
        assert np.isfinite(vals).all() and len(set(vals)) > 1, key
    assert full[2]['lrs'] == [5e-4, 2e-4]     # update 2: the milestone
    for name in ('net_g_2.pth', 'net_d_2.pth', 'net_g_latest.pth',
                 'net_d_latest.pth'):
        assert (exp / 'models' / name).exists(), name
    # the frozen modules still hold the HQ prior's weights
    prior = torch.load(str(folder / 'hq.pth'))['params']
    for name, p in model.net_g.named_parameters():
        if any(kw in name for kw in FROZEN):
            assert torch.equal(p, prior[name]), name

    resumed = train_cli.main(['-opt', opt_path, '--force_yml',
                              'path:resume_state=' + str(
                                  exp / 'training_states' / '2.state')])
    again = _log(exp / 'train_log.jsonl')[3:]
    assert [r['iter'] for r in again] == [3]
    for a, b in zip(full[2:], again):
        assert {k: a[k] for k in losses} == {k: b[k] for k in losses}
    for (name, p), q in zip(model.net_g.named_parameters(),
                            resumed.net_g.parameters()):
        assert torch.equal(p, q), name


def _model(root, **train):
    opt, _ = parse_options('.', opt=options(root, **train), argv=[])
    return FeMaSRModel(opt), build_dataset(opt['datasets']['train'])


def _grads(module):
    return {n: p.grad.clone() for n, p in module.named_parameters()
            if p.grad is not None}


def test_grad_accum_chunks_equal_the_whole_batch(folder):
    models = {}
    for chunks in (1, 2):
        model, data = _model(folder, grad_accum_chunks=chunks)
        batch = torch.utils.data.default_collate([data[i] for i in (0, 3)])
        model.feed_data(batch)
        total, ld, out, _, _ = model.g_backward(model.lq, model.gt)
        model.net_d.zero_grad()
        l_real = model._d_phase(model.gt, True, chunks)[0]
        l_fake = model._d_phase(out, False, chunks)[0]
        models[chunks] = (total, ld, l_real, l_fake, _grads(model.net_g),
                          _grads(model.net_d))
    one, two = models[1], models[2]
    for a, b in zip(one[:4], two[:4]):
        for x, y in (zip(a.values(), b.values()) if isinstance(a, dict)
                     else [(a, b)]):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-7)
    for ga, gb in ((one[4], two[4]), (one[5], two[5])):
        assert ga.keys() == gb.keys() and ga
        for n in ga:
            assert (ga[n] - gb[n]).abs().max() <= \
                1e-5 * ga[n].abs().max(), n


def test_generator_ema_tracks_the_weights(folder):
    model, data = _model(folder, ema_decay=0.9)
    ema = {n: p.detach().clone() for n, p in model.net_g.named_parameters()}
    model.feed_data(torch.utils.data.default_collate([data[0], data[2]]))
    model.optimize_parameters(1)
    for n, p in model.net_g.named_parameters():
        ema[n] = ema[n] * 0.9 + p.detach() * (1 - 0.9)
    moved = 0
    for n, p in model.net_g.named_parameters():
        torch.testing.assert_close(model.ema[n], ema[n], rtol=1e-6,
                                   atol=1e-7)
        moved += not torch.equal(model.ema[n], p)
    assert moved > 100     # the trained tensors lag behind the weights


@pytest.mark.parametrize('edit,match', [
    (lambda o: o['train'].update(chain_steps=8), 'chain_steps'),
    (lambda o: o['train'].update(flat_optimizer=True), 'flat_optimizer'),
    (lambda o: o['network_g'].update(attn_pack=2), 'attn_pack'),
    (lambda o: o.update(model_parallel=2), 'torchrun --nproc_per_node 2'),
    (lambda o: o['network_g'].update(dtype='bfloat16', vq_index_f32=False),
     'vq_index_f32'),
    (lambda o: o['network_d'].update(dtype='float16'), 'not ported'),
    (lambda o: o['network_g'].update(ws2d_tail=True), 'ws2d_tail'),
    (lambda o: o.update(dist=True, val={'val_freq': 2}), 'launcher'),
], ids=['chain_steps', 'flat_optimizer', 'attn_pack', 'model_parallel',
        'bf16', 'float16', 'serving_knob', 'val'])
def test_options_the_port_does_not_carry_are_refused(folder, edit, match):
    opt = options(folder)
    edit(opt)
    with pytest.raises(OptionError, match=match):
        parse_options('.', opt=opt, argv=[])


def test_bsrgan_dataset_needs_the_degradations(folder):
    # the degradations are ported: the dataset synthesizes the x4 LQ
    opt = options(folder)['datasets']['train']
    opt.update(type='BSRGANTrainDataset', phase='train', scale=4)
    item = build_dataset(opt)[(1, (0, 0, 1))]
    assert item['gt'].shape == (3, 64, 64)
    assert item['lq'].shape == (3, 16, 16)
    assert 0 <= float(item['lq'].min()) and float(item['lq'].max()) <= 1
