"""Data-parallel evaluation of the port on the CPU: `test_cli --launcher
pytorch` at world 2 (gloo ranks: `FeMaSRModel.dist_validation`, rank r
takes the images whose index is r modulo 2) against test_cli in one
process (`nondist_validation`), on three seeded image pairs (an odd count:
the ranks take two and one) with PSNR, SSIM and a seeded LPIPS.

Held: the metrics equal bit for bit (every image's metrics are all-reduced
and averaged in image order), and the ranks together write the images one
process writes, with the same pixels (each rank writes its own). Each rank
runs in a subprocess on one thread (tests/torch_dist_worker.py).
"""

import os

import cv2
import numpy as np
import torch

from femasr_torch.losses import LPIPS, lpips_package_state
from femasr_torch.models import FeMaSRNet, init_weights
from torch_port_util import start_ranks, wait_ranks

SMALL = [[32, 16, 32]]


def _folder(root):
    rng = np.random.default_rng(4)
    for sub in ('gt', 'lq'):
        os.makedirs(root / sub)
    for i, (h, w) in enumerate(((20, 24), (24, 20), (17, 22))):
        coarse = rng.random((4, 4, 3), dtype=np.float32)
        gt = (cv2.resize(coarse, (4 * w, 4 * h),
                         interpolation=cv2.INTER_CUBIC).clip(0, 1) * 255
              ).round().astype(np.uint8)
        cv2.imwrite(str(root / 'gt' / f'{i}.png'), gt)
        cv2.imwrite(str(root / 'lq' / f'{i}.png'),
                    cv2.resize(gt, (w, h), interpolation=cv2.INTER_AREA))
    net = FeMaSRNet(SMALL, LQ_stage=True, scale_factor=4)
    init_weights(net, torch.Generator().manual_seed(2))
    torch.save({'params': net.state_dict()}, str(root / 'net_g.pth'))
    lp = LPIPS()
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for p in lp.parameters():
            p.copy_(torch.rand(p.shape, generator=gen) * 0.02)
    torch.save(lpips_package_state(lp), str(root / 'lpips.pth'))


def _options(root):
    return {
        'name': 'eval', 'model_type': 'FeMaSRModel', 'scale': 4,
        'manual_seed': 0, 'device': 'cpu', 'num_gpu': 'auto',
        'datasets': {'test_1': {
            'name': 'seeded', 'type': 'PairedImageDataset',
            'dataroot_gt': str(root / 'gt'),
            'dataroot_lq': str(root / 'lq')}},
        'network_g': {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                      'LQ_stage': True, 'scale_factor': 4},
        'path': {'pretrain_network_g': str(root / 'net_g.pth'),
                 'pretrain_lpips': str(root / 'lpips.pth')},
        'val': {'save_img': True, 'key_metric': 'lpips', 'metrics': {
            'psnr': {'type': 'psnr', 'crop_border': 4,
                     'test_y_channel': True},
            'ssim': {'type': 'ssim', 'crop_border': 4,
                     'test_y_channel': True},
            'lpips': {'type': 'lpips', 'better': 'lower'}}}}


def test_dist_validation_equals_nondist_validation(tmp_path):
    root = tmp_path / 'data'
    _folder(root)

    def job(work, *argv):
        return [{'kind': 'test', 'name': 'eval', 'cwd': str(work),
                 'opt': _options(root), 'argv': list(argv)}]

    two, one = wait_ranks(
        start_ranks(job(tmp_path / 'w2', '--launcher', 'pytorch'),
                    str(tmp_path / 'out_w2'), 2),
        start_ranks(job(tmp_path / 'w1'), str(tmp_path / 'out_w1'), 0),
        timeout=120)
    want = one['eval'][0]['metrics']
    assert sorted(want) == ['lpips', 'psnr', 'ssim']
    for rank in (0, 1):
        assert two['eval'][rank]['metrics'] == want
    vis = [w / 'results' / 'eval' / 'visualization' / 'seeded'
           for w in (tmp_path / 'w1', tmp_path / 'w2')]
    names = sorted(os.listdir(vis[0]))
    assert names == ['0_eval.png', '1_eval.png', '2_eval.png']
    assert sorted(os.listdir(vis[1])) == names
    for name in names:
        a, b = (cv2.imread(str(v / name)) for v in vis)
        assert np.array_equal(a, b), name
