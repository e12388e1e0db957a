"""Training image transforms (counterpart of femasr_tpu/data/transforms.py):
random crops of one image or of matching GT/LQ pairs and random flips /
rotations, on HWC numpy images, each drawing from an explicit
numpy.random.Generator."""

from __future__ import annotations

from typing import List, Sequence, Union

import numpy as np

Images = Union[np.ndarray, List[np.ndarray]]


def random_crop(img: np.ndarray, out_size: int,
                rng: np.random.Generator) -> np.ndarray:
    """An out_size x out_size crop at a random place."""
    h, w = img.shape[:2]
    top = int(rng.integers(0, h - out_size + 1))
    left = int(rng.integers(0, w - out_size + 1))
    return img[top:top + out_size, left:left + out_size, ...]


def paired_random_crop(img_gts: Images, img_lqs: Images, gt_patch_size: int,
                       scale: int, rng: np.random.Generator,
                       gt_path: str = None):
    """Crop a gt_patch_size GT patch and the matching LQ patch (its size
    over `scale`, at the same place)."""
    gts = img_gts if isinstance(img_gts, list) else [img_gts]
    lqs = img_lqs if isinstance(img_lqs, list) else [img_lqs]
    h_lq, w_lq = lqs[0].shape[:2]
    h_gt, w_gt = gts[0].shape[:2]
    lq_patch = gt_patch_size // scale
    if h_gt != h_lq * scale or w_gt != w_lq * scale:
        raise ValueError(f'Scale mismatches. GT ({h_gt}, {w_gt}) is not '
                         f'{scale}x multiplication of LQ ({h_lq}, {w_lq}). '
                         f'{gt_path}')
    if h_lq < lq_patch or w_lq < lq_patch:
        raise ValueError(f'LQ ({h_lq}, {w_lq}) is smaller than patch size '
                         f'({lq_patch}, {lq_patch}). {gt_path}')
    top = int(rng.integers(0, h_lq - lq_patch + 1))
    left = int(rng.integers(0, w_lq - lq_patch + 1))
    lqs = [v[top:top + lq_patch, left:left + lq_patch] for v in lqs]
    top, left = top * scale, left * scale
    gts = [v[top:top + gt_patch_size, left:left + gt_patch_size]
           for v in gts]
    return (gts if len(gts) > 1 else gts[0],
            lqs if len(lqs) > 1 else lqs[0])


def augment(imgs: Images, hflip: bool, rotation: bool,
            rng: np.random.Generator) -> Images:
    """The same random horizontal flip, vertical flip and transpose (a 90
    degree rotation with the flips) for every image in `imgs`."""
    hflip = hflip and rng.random() < 0.5
    vflip = rotation and rng.random() < 0.5
    rot90 = rotation and rng.random() < 0.5

    def _augment(img):
        if hflip:
            img = img[:, ::-1]
        if vflip:
            img = img[::-1]
        if rot90:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    if isinstance(imgs, Sequence) and not isinstance(imgs, np.ndarray):
        out = [_augment(img) for img in imgs]
        return out if len(out) > 1 else out[0]
    return _augment(imgs)
