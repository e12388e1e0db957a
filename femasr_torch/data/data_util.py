"""Dataset paths (counterpart of femasr_tpu/data/data_util.py)."""

from __future__ import annotations

import os
from os import path as osp
from typing import List

from ..utils.misc import is_image_file, scandir


def make_dataset(dir_path: str) -> List[str]:
    """Sorted image paths under dir_path, recursively."""
    if not osp.isdir(dir_path):
        raise FileNotFoundError(f'{dir_path} is not a valid directory')
    images = []
    for root, _, fnames in sorted(os.walk(dir_path, followlinks=True)):
        images += [osp.join(root, f) for f in sorted(fnames)
                   if is_image_file(f)]
    return images


def paths_from_folder(folder: str) -> List[str]:
    """Sorted paths of the files directly in `folder`."""
    return [osp.join(folder, p) for p in sorted(scandir(folder))]
