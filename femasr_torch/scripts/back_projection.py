"""Iterative back-projection of SR results onto their LR inputs
(counterpart of scripts/data_preparation/back_projection.py, after the
reference's MATLAB scripts backprojection.m and main_reverse_filter.m),
with MATLAB-exact bicubic resizes (`ops/resize.py`):

  bp      im_h += conv2(up(im_l - down(im_h)), g), g the 5x5 Gaussian
          (sigma 1) squared and renormalized
  filter  im_h += up(im_l) - up(down(im_h))

    python -m femasr_torch.scripts.back_projection \
        --lr ./LR --sr ./results --out ./results_20bp --mode bp --iters 20
"""

import argparse
import os
from os import path as osp

import cv2
import numpy as np

from ..ops.resize import matlab_resize_matrix


def resize_to(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """MATLAB imresize(img, [out_h out_w], 'bicubic') of an HWC float64
    image."""
    h, w, _ = img.shape
    rh = matlab_resize_matrix(h, out_h, out_h / h, antialias=out_h < h)
    rw = matlab_resize_matrix(w, out_w, out_w / w, antialias=out_w < w)
    out = np.einsum('oh,hwc->owc', rh.astype(np.float64), img)
    return np.einsum('pw,owc->opc', rw.astype(np.float64), out)


def gauss_kernel() -> np.ndarray:
    """fspecial('gaussian', 5, 1), squared and renormalized."""
    ax = np.arange(-2, 3, dtype=np.float64)
    g = np.exp(-(ax[:, None] ** 2 + ax[None, :] ** 2) / 2.0)
    g = (g / g.sum()) ** 2
    return g / g.sum()


def conv2_same(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """MATLAB conv2(img, k, 'same'): a true convolution, zero borders."""
    kf = k[::-1, ::-1]
    pad = k.shape[0] // 2
    p = np.pad(img, ((pad, pad), (pad, pad)), mode='constant')
    out = np.zeros_like(img)
    for dy in range(k.shape[0]):
        for dx in range(k.shape[1]):
            out += kf[dy, dx] * p[dy:dy + img.shape[0], dx:dx + img.shape[1]]
    return out


def backprojection(im_h: np.ndarray, im_l: np.ndarray,
                   max_iter: int = 20) -> np.ndarray:
    """Gaussian-kernel iterative back-projection (backprojection.m)."""
    row_l, col_l, _ = im_l.shape
    row_h, col_h, _ = im_h.shape
    g = gauss_kernel()
    im_h = im_h.astype(np.float64).copy()
    im_l = im_l.astype(np.float64)
    for _ in range(max_iter):
        diff = resize_to(im_l - resize_to(im_h, row_l, col_l), row_h, col_h)
        for ch in range(im_h.shape[2]):
            im_h[:, :, ch] += conv2_same(diff[:, :, ch], g)
    return im_h


def reverse_filter(im_h: np.ndarray, im_l: np.ndarray, scale: int = 4,
                   max_iter: int = 20) -> np.ndarray:
    """Iterative reverse filtering (main_reverse_filter.m); the SR must be
    `scale` times the LR."""
    row_h, col_h, _ = im_h.shape
    if (row_h, col_h) != (im_l.shape[0] * scale, im_l.shape[1] * scale):
        raise ValueError(
            f'SR {im_h.shape[:2]} is not {scale}x the LR {im_l.shape[:2]}; '
            'pass the matching --scale or fix the input pairing')
    im_h = im_h.astype(np.float64).copy()
    j = resize_to(im_l.astype(np.float64), row_h, col_h)
    for _ in range(max_iter):
        down = resize_to(im_h, im_l.shape[0], im_l.shape[1])
        im_h += j - resize_to(down, row_h, col_h)
    return im_h


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--lr', required=True, help='LR input folder')
    ap.add_argument('--sr', required=True, help='SR results folder')
    ap.add_argument('--out', required=True)
    ap.add_argument('--mode', choices=['bp', 'filter'], default='bp')
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--scale', type=int, default=4,
                    help='SR scale (filter mode)')
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    names = sorted(n for n in os.listdir(args.sr)
                   if n.lower().endswith(('.png', '.jpg', '.jpeg', '.bmp')))
    for i, name in enumerate(names):
        lr_path = osp.join(args.lr, name)
        if not osp.exists(lr_path):
            print(f'! no LR match for {name}, skipping')
            continue
        im_l = cv2.imread(lr_path).astype(np.float64) / 255.0
        im_h = cv2.imread(osp.join(args.sr, name)).astype(np.float64) / 255.0
        if args.mode == 'bp':
            out = backprojection(im_h, im_l, args.iters)
        else:
            out = reverse_filter(im_h, im_l, args.scale, args.iters)
        cv2.imwrite(osp.join(args.out, name),
                    (np.clip(out, 0, 1) * 255).round().astype(np.uint8))
        print(f'[{i + 1}/{len(names)}] {name}')


if __name__ == '__main__':
    main()
