"""Dataset paths and frame helpers (counterpart of
femasr_tpu/data/data_util.py): image trees, paired paths from two folders
or a meta-info file, frame sequences and their temporal neighbours, and
DUF's Gaussian downsampling."""

from __future__ import annotations

import os
from os import path as osp
from typing import Dict, List

import numpy as np

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


def paired_paths_from_folders(folders, keys, filename_tmpl: str = '{}'
                              ) -> List[Dict[str, str]]:
    """Pair (input, GT) paths of two folders: each GT file `name.ext` with
    the input file `filename_tmpl.format(name).ext`, in sorted GT order.
    Returns dicts {f'{input_key}_path', f'{gt_key}_path'}."""
    assert len(folders) == 2 and len(keys) == 2
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    input_paths = list(scandir(input_folder))
    gt_paths = list(scandir(gt_folder))
    assert len(input_paths) == len(gt_paths), (
        f'{input_key} and {gt_key} datasets have different number of images: '
        f'{len(input_paths)}, {len(gt_paths)}.')
    paths = []
    for gt_path in sorted(gt_paths):
        basename, ext = osp.splitext(osp.basename(gt_path))
        input_name = f'{filename_tmpl.format(basename)}{ext}'
        assert input_name in input_paths, (
            f'{input_name} is not in {input_key}_paths.')
        paths.append({f'{input_key}_path': osp.join(input_folder, input_name),
                      f'{gt_key}_path': osp.join(gt_folder, gt_path)})
    return paths


def paired_paths_from_meta_info_file(folders, keys, meta_info_file: str,
                                     filename_tmpl: str = '{}'
                                     ) -> List[Dict[str, str]]:
    """Pair (input, GT) paths from the GT names that open each line of
    `meta_info_file`, as `paired_paths_from_folders` names them."""
    assert len(folders) == 2 and len(keys) == 2
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    with open(meta_info_file, 'r') as f:
        gt_names = [line.strip().split(' ')[0] for line in f]
    paths = []
    for gt_name in gt_names:
        basename, ext = osp.splitext(osp.basename(gt_name))
        input_name = f'{filename_tmpl.format(basename)}{ext}'
        paths.append({f'{input_key}_path': osp.join(input_folder, input_name),
                      f'{gt_key}_path': osp.join(gt_folder, gt_name)})
    return paths


def read_img_seq(path, require_mod_crop: bool = False,
                 scale: int = 1) -> np.ndarray:
    """The frames of a folder (sorted) or of a list of paths as one
    (T, H, W, 3) float32 RGB array in [0, 1]; `require_mod_crop` cuts H
    and W to multiples of `scale`."""
    import cv2

    from .transforms import mod_crop
    img_paths = path if isinstance(path, list) else sorted(
        paths_from_folder(path))
    imgs = []
    for p in img_paths:
        img = cv2.imread(p).astype('float32') / 255.
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
        imgs.append(mod_crop(img, scale) if require_mod_crop else img)
    return np.stack(imgs, axis=0)


def generate_frame_indices(crt_idx: int, max_frame_num: int, num_frames: int,
                           padding: str = 'reflection') -> List[int]:
    """The `num_frames` frame indices centred on `crt_idx` in a clip of
    `max_frame_num` frames, those past either end padded by `padding`:
    replicate, reflection, reflection_circle or circle."""
    assert num_frames % 2 == 1, 'num_frames should be an odd number.'
    assert padding in ('replicate', 'reflection', 'reflection_circle',
                       'circle'), f'Wrong padding mode: {padding}.'
    last = max_frame_num - 1
    num_pad = num_frames // 2
    indices = []
    for i in range(crt_idx - num_pad, crt_idx + num_pad + 1):
        if i < 0:
            pad_idx = {'replicate': 0, 'reflection': -i,
                       'reflection_circle': crt_idx + num_pad - i,
                       'circle': num_frames + i}[padding]
        elif i > last:
            pad_idx = {'replicate': last, 'reflection': last * 2 - i,
                       'reflection_circle': (crt_idx - num_pad) - (i - last),
                       'circle': i - num_frames}[padding]
        else:
            pad_idx = i
        indices.append(pad_idx)
    return indices


def duf_downsample(x: np.ndarray, kernel_size: int = 13,
                   scale: int = 4) -> np.ndarray:
    """DUF's downsampling of (T, H, W, C) or (H, W, C) frames in [0, 1]: a
    Gaussian blur (sigma 0.4 x scale, mirror borders), then every
    `scale`-th pixel from the kernel's centre phase."""
    from .degradations import filter2d_mirror, fspecial_gaussian
    assert scale in (2, 3, 4), \
        f'Only support scale (2, 3, 4), but got {scale}.'
    frames = x[None] if x.ndim == 3 else x
    kernel = fspecial_gaussian(kernel_size, 0.4 * scale)
    phase = (kernel_size // 2) % scale
    out = np.stack([filter2d_mirror(np.asarray(f, np.float32), kernel)
                    [phase::scale, phase::scale] for f in frames], axis=0)
    return out[0] if x.ndim == 3 else out
