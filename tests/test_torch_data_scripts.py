"""The port's data-preparation scripts (`python -m
femasr_torch.scripts.<name>`) against the JAX package's scripts in
scripts/data_preparation/, on one
tiny seeded folder with the same arguments: the same files byte for byte
(tiles, LR images, shards, meta-info text); `back_projection` within 1e-9
of the JAX functions in float64 and its written images within one 8-bit
level. And `python -m femasr_torch.generate_dataset`: `--device cpu`
repeats under one seed and moves with it, `--device cuda` (the default)
raises without a card, and the card path refuses HQ images of mixed
sizes."""

import filecmp
import importlib.util
import os
import sys

import cv2
import numpy as np
import pytest
import torch

from femasr_torch import generate_dataset as gen
from femasr_torch.scripts import (back_projection, create_shard,
                                  extract_subimages, generate_bicubic_lr,
                                  generate_meta_info)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_script(name):
    """The JAX package's script as a module (registered, so its pool's
    workers can be pickled)."""
    if f'jax_{name}' not in sys.modules:
        path = os.path.join(ROOT, 'scripts', 'data_preparation',
                            f'{name}.py')
        spec = importlib.util.spec_from_file_location(f'jax_{name}', path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[f'jax_{name}'] = mod
        spec.loader.exec_module(mod)
    return sys.modules[f'jax_{name}']


def _run_jax(name, argv, monkeypatch):
    monkeypatch.setattr(sys, 'argv', [name] + argv)
    _jax_script(name).main()


@pytest.fixture(scope='module')
def folder(tmp_path_factory):
    """Five seeded images of odd sizes (one in a subfolder, one gray)."""
    root = tmp_path_factory.mktemp('prep')
    rng = np.random.default_rng(3)
    os.makedirs(root / 'hr' / 'sub')
    for i, (h, w) in enumerate([(52, 61), (48, 48), (70, 45), (33, 40),
                                (44, 58)]):
        base = rng.random((h // 4 + 1, w // 4 + 1, 3), dtype=np.float32)
        img = (cv2.resize(base, (w, h), interpolation=cv2.INTER_CUBIC)
               .clip(0, 1) * 255).round().astype(np.uint8)
        if i == 3:
            img = img[..., 0]
        name = f'sub/img{i}.png' if i == 2 else f'img{i}.png'
        cv2.imwrite(str(root / 'hr' / name), img)
    return root


def _same_tree(a, b):
    names_a = sorted(os.path.relpath(os.path.join(d, f), a)
                     for d, _, fs in os.walk(a) for f in fs)
    names_b = sorted(os.path.relpath(os.path.join(d, f), b)
                     for d, _, fs in os.walk(b) for f in fs)
    assert names_a == names_b and names_a
    for n in names_a:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


def test_create_shard_matches_jax(folder, tmp_path, monkeypatch, capsys):
    hr = str(folder / 'hr')
    create_shard.main(['--input', hr, '--output', str(tmp_path / 'a.fmrs')])
    _run_jax('create_shard', ['--input', hr, '--output',
                              str(tmp_path / 'b.fmrs')], monkeypatch)
    assert filecmp.cmp(tmp_path / 'a.fmrs', tmp_path / 'b.fmrs',
                       shallow=False)
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace('a.fmrs', 'b.fmrs') == out[1]


def test_extract_subimages_matches_jax(folder, tmp_path, monkeypatch):
    args = ['--input', str(folder / 'hr'), '--crop_size', '24', '--step',
            '16', '--thresh_size', '4', '--n_thread', '1']
    extract_subimages.main(args + ['--output', str(tmp_path / 'a')])
    _run_jax('extract_subimages', args + ['--output', str(tmp_path / 'b')],
             monkeypatch)
    _same_tree(tmp_path / 'a', tmp_path / 'b')
    assert len(os.listdir(tmp_path / 'a')) > 5 * 4


def test_generate_meta_info_matches_jax(folder, tmp_path, monkeypatch):
    hr = str(folder / 'hr')
    generate_meta_info.main(['--input', hr, '--meta_info',
                             str(tmp_path / 'a.txt')])
    _run_jax('generate_meta_info', ['--input', hr, '--meta_info',
                                    str(tmp_path / 'b.txt')], monkeypatch)
    a = (tmp_path / 'a.txt').read_text()
    assert a == (tmp_path / 'b.txt').read_text()
    assert 'img3.png (33,40,1)' in a and 'sub/img2.png (70,45,3)' in a


@pytest.mark.parametrize('scale', [2, 4])
def test_generate_bicubic_lr_matches_jax(folder, tmp_path, monkeypatch,
                                         scale):
    args = ['--input', str(folder / 'hr'), '--scale', str(scale), '--mod']
    generate_bicubic_lr.main(args + ['--output', str(tmp_path / 'a' / 'lr')])
    _run_jax('generate_bicubic_lr', args + ['--output',
                                            str(tmp_path / 'b' / 'lr')],
             monkeypatch)
    _same_tree(tmp_path / 'a', tmp_path / 'b')
    lr = cv2.imread(str(tmp_path / 'a' / 'lr' / 'img0.png'))
    assert lr.shape == (52 // scale, 60 // scale, 3)
    # its back-projection helper
    jax_mod = _jax_script('generate_bicubic_lr')
    rng = np.random.default_rng(scale)
    small = rng.random((6, 5, 3)).astype(np.float32)
    big = rng.random((6 * scale, 5 * scale, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        generate_bicubic_lr.back_projection(small, big, scale, 3),
        jax_mod.back_projection(small, big, scale, 3))


@pytest.mark.parametrize('mode', ['bp', 'filter'])
def test_back_projection_matches_jax(folder, tmp_path, monkeypatch, mode):
    # SR: the x2 bicubic upscale of each LR, so the pair matches at scale 2
    lr_dir, sr_dir = tmp_path / 'lr', tmp_path / 'sr'
    os.makedirs(lr_dir)
    os.makedirs(sr_dir)
    for i in (0, 1):
        img = cv2.imread(str(folder / 'hr' / f'img{i}.png'))
        cv2.imwrite(str(lr_dir / f'img{i}.png'), img)
        cv2.imwrite(str(sr_dir / f'img{i}.png'), cv2.resize(
            img, (img.shape[1] * 2, img.shape[0] * 2),
            interpolation=cv2.INTER_CUBIC))
    args = ['--lr', str(lr_dir), '--sr', str(sr_dir), '--mode', mode,
            '--iters', '3', '--scale', '2']
    back_projection.main(args + ['--out', str(tmp_path / 'a')])
    _run_jax('back_projection', args + ['--out', str(tmp_path / 'b')],
             monkeypatch)
    for i in (0, 1):
        a = cv2.imread(str(tmp_path / 'a' / f'img{i}.png')).astype(int)
        b = cv2.imread(str(tmp_path / 'b' / f'img{i}.png')).astype(int)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
    jax_mod = _jax_script('back_projection')
    im_l = cv2.imread(str(lr_dir / 'img0.png')).astype(np.float64) / 255
    im_h = cv2.imread(str(sr_dir / 'img0.png')).astype(np.float64) / 255
    if mode == 'bp':
        a = back_projection.backprojection(im_h, im_l, 3)
        b = jax_mod.backprojection(im_h, im_l, 3)
    else:
        a = back_projection.reverse_filter(im_h, im_l, 2, 3)
        b = jax_mod.reverse_filter(im_h, im_l, 2, 3)
        with pytest.raises(ValueError, match='is not 4x'):
            back_projection.reverse_filter(im_h, im_l, 4, 1)
    assert np.abs(a - b).max() <= 1e-9


@pytest.fixture(scope='module')
def crops(tmp_path_factory):
    """Two seeded 32px HQ crops."""
    root = tmp_path_factory.mktemp('hq')
    rng = np.random.default_rng(9)
    for i in range(2):
        base = rng.random((8, 8, 3), dtype=np.float32)
        cv2.imwrite(str(root / f'{i}.png'), (cv2.resize(
            base, (32, 32), interpolation=cv2.INTER_CUBIC).clip(0, 1)
            * 255).round().astype(np.uint8))
    return root


def _lq(out):
    d = os.path.join(out, 'LQ_sub_X4')
    return {n: cv2.imread(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def test_generate_dataset_cpu_repeats_under_one_seed(crops, tmp_path):
    runs = []
    for run, seed in enumerate((1, 1, 2)):
        out = str(tmp_path / f'run{run}')
        assert gen.main(['-i', str(crops), '-o', out, '-s', '4', '--device',
                         'cpu', '--nproc', '2', '--seed', str(seed)]) == 2
        runs.append(_lq(out))
    assert list(runs[0]) == ['0.png', '1.png']
    assert all(v.shape == (8, 8, 3) for v in runs[0].values())
    assert all(np.array_equal(runs[0][k], runs[1][k]) for k in runs[0])
    assert any(not np.array_equal(runs[0][k], runs[2][k]) for k in runs[0])


def test_generate_dataset_cuda_raises_without_a_card(crops, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a card is present: the card path runs')
    for device in (['--device', 'cuda'], []):      # the card by default
        with pytest.raises(RuntimeError, match='no CUDA device'):
            gen.main(['-i', str(crops), '-o', str(tmp_path), *device])
    assert not os.path.exists(tmp_path / 'LQ_sub_X4')
    # the card path's batches: one size, or refused
    imgs = [np.zeros((32, 32, 3), np.float32), np.ones((32, 32, 3),
                                                       np.float32)]
    assert gen.one_size_batch(imgs).shape == (2, 3, 32, 32)
    with pytest.raises(ValueError, match='one size'):
        gen.one_size_batch(imgs + [np.zeros((24, 32, 3), np.float32)])
