"""Experiment directories, file scanning and the float32 precision setting
(counterpart of femasr_tpu/utils/misc.py). Randomness uses explicit
generators, so there is no global seeding helper."""

from __future__ import annotations

import os
import time
from os import path as osp
from typing import Iterator, Optional, Tuple, Union

import torch

from ..parallel.dist_util import barrier, get_dist_info

IMG_EXTENSIONS = ('.jpg', '.JPG', '.jpeg', '.JPEG', '.png', '.PNG', '.ppm',
                  '.PPM', '.bmp', '.BMP', '.tif', '.TIF', '.tiff', '.TIFF',
                  '.webp', '.WEBP')


def get_time_str() -> str:
    return time.strftime('%Y%m%d_%H%M%S', time.localtime())


def mkdir_and_rename(path: str) -> None:
    """mkdir; an existing directory is first renamed with a time suffix."""
    if osp.exists(path):
        new_name = path + '_archived_' + get_time_str()
        print(f'Path already exists. Rename it to {new_name}', flush=True)
        os.rename(path, new_name)
    os.makedirs(path, exist_ok=True)


def make_exp_dirs(opt: dict) -> None:
    """experiments/<name>/{models, training_states, visualization} for
    training, results/<name>/visualization for evaluation: made by rank 0,
    which the other ranks then wait for."""
    if get_dist_info()[0] == 0:
        _make_exp_dirs(opt)
    barrier()


def _make_exp_dirs(opt: dict) -> None:
    path_opt = dict(opt['path'])
    mkdir_and_rename(path_opt.pop('experiments_root' if opt['is_train']
                                  else 'results_root'))
    for key, p in path_opt.items():
        if ('strict_load' in key or 'pretrain' in key or 'resume' in key
                or 'param_key' in key or p is None):
            continue
        os.makedirs(p, exist_ok=True)


def scandir(dir_path: str, suffix: Optional[Union[str, Tuple[str, ...]]]
            = None, recursive: bool = False) -> Iterator[str]:
    """Paths relative to dir_path of the files under it, skipping hidden
    entries, optionally filtered by suffix."""

    def _scan(path):
        for entry in os.scandir(path):
            if not entry.name.startswith('.') and entry.is_file():
                rel = osp.relpath(entry.path, dir_path)
                if suffix is None or rel.endswith(suffix):
                    yield rel
            elif recursive and entry.is_dir():
                yield from _scan(entry.path)

    return _scan(dir_path)


def is_image_file(filename: str) -> bool:
    return filename.endswith(IMG_EXTENSIONS)



def disable_tf32(logger=None) -> None:
    """Run float32 matmuls and cuDNN convolutions in true float32, not
    TF32 (torch's default for cuDNN): float32 is the port's parity lane,
    held to the JAX package and to the kernels, which sum in true float32.
    Logs the setting."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    msg = ('TF32 off: float32 matmuls and cuDNN convolutions run in true '
           'float32 (torch.backends.cuda.matmul.allow_tf32 = '
           'torch.backends.cudnn.allow_tf32 = False)')
    if logger is None:
        print(msg, flush=True)
    else:
        logger.info(msg)
