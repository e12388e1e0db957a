"""TF32 in the port's CLIs, on the CPU: after the setup of train_cli,
test_cli and inference_cli both of torch's TF32 flags (cuBLAS matmuls and
cuDNN convolutions) are False, whatever they were before: float32 is the
parity lane, true float32 on the card as in the gates."""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from femasr_torch import inference_cli, test_cli, train_cli
from femasr_torch.models import FeMaSRNet, init_weights
from test_torch_train_loop import SMALL, folder, options  # noqa: F401


def flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def run_train(root, tmp_path):
    path = str(tmp_path / 'lq.json')
    with open(path, 'w') as f:
        json.dump(options(root, total_iter=1), f)
    train_cli.main(['-opt', path])


def run_test(root, tmp_path):
    pth = str(tmp_path / 'g.pth')
    net = FeMaSRNet(SMALL, LQ_stage=True, scale_factor=4)
    init_weights(net, torch.Generator().manual_seed(0))
    torch.save({'params': net.state_dict()}, pth)
    opt = {'name': 'eval', 'model_type': 'FeMaSRModel', 'scale': 4,
           'device': 'cpu', 'manual_seed': 0,
           'datasets': {'test_1': {
               'name': 'seeded', 'type': 'PairedImageDataset',
               'dataroot_gt': str(root / 'gt'),
               'dataroot_lq': str(root / 'lq')}},
           'network_g': {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                         'LQ_stage': True, 'scale_factor': 4},
           'path': {'pretrain_network_g': pth},
           'val': {'save_img': False, 'metrics': {
               'psnr': {'type': 'psnr', 'crop_border': 4}}}}
    path = str(tmp_path / 'eval.json')
    with open(path, 'w') as f:
        json.dump(opt, f)
    test_cli.main(['-opt', path])


def run_inference(root, tmp_path):
    pth = str(tmp_path / 'x4.pth')
    net = FeMaSRNet(SMALL, LQ_stage=True, scale_factor=4)
    torch.save({'params': net.state_dict()}, pth)
    src = str(tmp_path / 'in')
    os.makedirs(src)
    img = (np.random.default_rng(0).random((16, 16, 3)) * 255)
    cv2.imwrite(os.path.join(src, 'a.png'), img.astype(np.uint8))
    inference_cli.main(['-i', src, '-w', pth, '-o', str(tmp_path / 'out'),
                        '--precision', 'f32', '--device', 'cpu'])


@pytest.mark.parametrize('cli', [run_train, run_test, run_inference],
                         ids=['train_cli', 'test_cli', 'inference_cli'])
def test_cli_setup_turns_tf32_off(folder, tmp_path,  # noqa: F811
                                  monkeypatch, cli):
    monkeypatch.chdir(tmp_path)
    saved = flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        cli(folder, tmp_path)
        assert flags() == (False, False)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = saved
