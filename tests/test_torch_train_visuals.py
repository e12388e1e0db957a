"""logger.show_tf_imgs_freq in the port's training loop, on the CPU: with
TensorBoard on, every crossing of the frequency writes the trainer's
current visuals as `samples/<name>` (the JAX loop's images): lq, result,
gt_rec and gt in the LQ stage, lq, result, the codebook grid and gt in the
HQ stage; and the codebook grid (`vis_single_code`: every code decoded)
equals the JAX trainer's, in f32."""

import json

import numpy as np
import pytest
import torch

from femasr_torch import train_cli
from femasr_torch.train import pipeline
from femasr_tpu.train.femasr_model import FeMaSRModel as JFeMaSRModel
from test_torch_train_loop import SMALL, folder, options  # noqa: F401

LQ_KEYS = {'lq', 'result', 'gt_rec', 'gt'}
HQ_KEYS = {'lq', 'result', 'codebook', 'gt'}


class Recorder:
    """A TensorBoard SummaryWriter stand-in that keeps the images."""

    def __init__(self):
        self.images = []

    def add_images(self, tag, imgs, step, dataformats='NCHW'):
        self.images.append((tag, step, dataformats, imgs.clone()))

    def add_scalar(self, *args, **kwargs):
        pass

    def close(self):
        pass


def run(root, tmp_path, monkeypatch, stage):
    opt = options(root, total_iter=4)
    opt['logger'].update(use_tb_logger=True, show_tf_imgs_freq=2,
                         save_checkpoint_freq=1e9)
    opt['name'] = f'{stage}_visuals'
    if stage == 'hq':
        opt['network_g'] = {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                            'LQ_stage': False}
        opt['path'] = {}
    rec = Recorder()
    monkeypatch.setattr(pipeline, 'init_tb', lambda opt, logger: rec)
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / f'{stage}.json')
    with open(path, 'w') as f:
        json.dump(opt, f)
    return train_cli.main(['-opt', path]), rec


@pytest.mark.parametrize('stage', ['lq', 'hq'])
def test_visuals_are_written_at_each_crossing(folder, tmp_path,  # noqa: F811
                                              monkeypatch, stage):
    model, rec = run(folder, tmp_path, monkeypatch, stage)
    keys = LQ_KEYS if stage == 'lq' else HQ_KEYS
    assert sorted({step for _, step, _, _ in rec.images}) == [2, 4]
    for step in (2, 4):
        got = {tag for tag, s, _, _ in rec.images if s == step}
        assert got == {f'samples/{k}' for k in keys}, step
    n_e = SMALL[0][1]
    shapes = {'lq': (2, 3, 16, 16), 'result': (2, 3, 64, 64),
              'gt_rec': (2, 3, 64, 64), 'gt': (2, 3, 64, 64),
              'codebook': (n_e, 3, 16, 16)}
    for tag, _, fmt, imgs in rec.images:
        assert fmt == 'NCHW' and imgs.dtype == torch.float32
        assert tuple(imgs.shape) == shapes[tag.split('/')[1]], tag
        assert 0 <= imgs.min() and imgs.max() <= 1, tag
    last = {tag: imgs for tag, s, _, imgs in rec.images if s == 4}
    torch.testing.assert_close(last['samples/gt'], model.gt.clamp(0, 1))
    torch.testing.assert_close(last['samples/result'],
                               model.output.clamp(0, 1))


def test_codebook_grid_matches_jax(folder, tmp_path,  # noqa: F811
                                   monkeypatch):
    model, _ = run(folder, tmp_path, monkeypatch, 'hq')
    grid = model.vis_single_code()
    pth = str(tmp_path / 'hq_g.pth')
    torch.save({'params': model.net_g.state_dict()}, pth)
    jmodel = JFeMaSRModel({
        'is_train': False, 'num_gpu': 1, 'manual_seed': 0,
        'network_g': {'type': 'FeMaSRNet', 'codebook_params': SMALL,
                      'LQ_stage': False},
        'datasets': {'train': {'gt_size': 64}},
        'path': {'pretrain_network_g': pth}})
    ref = jmodel.vis_single_code()                  # (n_e, h, w, 3)
    got = grid.numpy().transpose(0, 2, 3, 1)
    assert got.shape == ref.shape == (SMALL[0][1], 16, 16, 3)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()
