"""Cut large images into overlapping sub-images for training (counterpart
of scripts/data_preparation/extract_subimages.py; DIV2K's tiling by
default: crop 480, step 240, thresh 0). A tile `name_sNNN.ext` per crop,
written with the input's extension.

    python -m femasr_torch.scripts.extract_subimages \
        --input ../datasets/DIV2K_train_HR --output ../datasets/HQ_sub
"""

import argparse
import os
from multiprocessing import Pool
from os import path as osp

import cv2
import numpy as np

from ..data.data_util import make_dataset


def crop_starts(size: int, crop_size: int, step: int,
                thresh_size: int) -> np.ndarray:
    """Tile origins along one side: every `step`, plus a last tile flush
    with the border when more than `thresh_size` pixels would be left."""
    starts = np.arange(0, size - crop_size + 1, step)
    if size - (starts[-1] + crop_size) > thresh_size:
        starts = np.append(starts, size - crop_size)
    return starts


def worker(args_tuple) -> str:
    path, opt = args_tuple
    crop_size = opt['crop_size']
    img_name, extension = osp.splitext(osp.basename(path))
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        return f'{img_name}: unreadable'
    h, w = img.shape[0:2]
    if h < crop_size or w < crop_size:
        return f'{img_name}: skipped ({h}x{w} < crop_size {crop_size})'
    index = 0
    for x in crop_starts(h, crop_size, opt['step'], opt['thresh_size']):
        for y in crop_starts(w, crop_size, opt['step'], opt['thresh_size']):
            index += 1
            cv2.imwrite(
                osp.join(opt['save_folder'],
                         f'{img_name}_s{index:03d}{extension}'),
                np.ascontiguousarray(img[x:x + crop_size, y:y + crop_size]),
                [cv2.IMWRITE_PNG_COMPRESSION, opt['compression_level']])
    return f'{img_name}: {index} tiles'


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--input', type=str, required=True)
    parser.add_argument('--output', type=str, required=True)
    parser.add_argument('--crop_size', type=int, default=480)
    parser.add_argument('--step', type=int, default=240)
    parser.add_argument('--thresh_size', type=int, default=0)
    parser.add_argument('--compression_level', type=int, default=3)
    parser.add_argument('--n_thread', type=int, default=os.cpu_count())
    args = parser.parse_args(argv)

    os.makedirs(args.output, exist_ok=True)
    opt = {'crop_size': args.crop_size, 'step': args.step,
           'thresh_size': args.thresh_size, 'save_folder': args.output,
           'compression_level': args.compression_level}
    paths = make_dataset(args.input)
    with Pool(max(args.n_thread, 1)) as pool:
        for msg in pool.imap_unordered(worker, [(p, opt) for p in paths]):
            print(msg, flush=True)
    print('All processes done.')


if __name__ == '__main__':
    main()
