"""MATLAB-exact bicubic LR images of a folder (counterpart of
scripts/data_preparation/generate_bicubic_lr.py): each image mod-cropped
to the scale, then `imresize(img, 1/scale, 'bicubic')` (`ops/resize.py`),
written under the same name; `--mod` also writes the mod-cropped GT to
`gt_mod{scale}` beside the output folder.

    python -m femasr_torch.scripts.generate_bicubic_lr \
        --input ../datasets/DIV2K_valid_HR --output ../datasets/lrx4 --scale 4
"""

import argparse
import os
from os import path as osp

import cv2
import numpy as np

from ..data.data_util import make_dataset
from ..data.transforms import mod_crop
from ..ops.resize import imresize_np
from ..utils.img_util import imwrite, rgb_to_bgr_uint8


def back_projection(lr: np.ndarray, sr: np.ndarray, scale: int,
                    iters: int = 10) -> np.ndarray:
    """Iterative back-projection: sr += up(lr - down(sr)), `iters` times,
    then clipped to [0, 1]."""
    out = sr.copy()
    for _ in range(iters):
        out = out + imresize_np(lr - imresize_np(out, 1.0 / scale), scale)
    return np.clip(out, 0, 1)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--input', type=str, required=True)
    parser.add_argument('--output', type=str, required=True)
    parser.add_argument('--scale', type=int, default=4)
    parser.add_argument('--mod', action='store_true',
                        help='also write a gt_mod{scale} folder of '
                             'mod-cropped GT')
    args = parser.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    mod_dir = None
    if args.mod:
        mod_dir = osp.join(osp.dirname(args.output.rstrip('/')),
                           f'gt_mod{args.scale}')
        os.makedirs(mod_dir, exist_ok=True)
    for i, p in enumerate(make_dataset(args.input)):
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            continue
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.
        rgb = mod_crop(rgb, args.scale)
        name = osp.basename(p)
        imwrite(rgb_to_bgr_uint8(imresize_np(rgb, 1.0 / args.scale)),
                osp.join(args.output, name))
        if mod_dir:
            imwrite(rgb_to_bgr_uint8(rgb), osp.join(mod_dir, name))
        print(f'{i + 1}: {name}', flush=True)


if __name__ == '__main__':
    main()
