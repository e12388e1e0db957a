"""Image helpers: cv2 file I/O (BGR uint8 on disk) and model outputs to
images (counterpart of femasr_tpu/utils/img_util.py tensor2img /
array2img)."""

from __future__ import annotations

import math
import os
from typing import Iterator, Optional, Sequence

import numpy as np
import torch


def imread_rgb(path: str) -> Optional[np.ndarray]:
    """HWC float32 RGB in [0, 1], or None if the file cannot be read."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        return None
    if img.ndim == 2:
        img = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
    if img.shape[2] == 4:
        img = img[:, :, :3]
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def imwrite(img: np.ndarray, file_path: str) -> None:
    """Write an HWC BGR image with cv2 (making its folder); raise on failure."""
    import cv2
    os.makedirs(os.path.abspath(os.path.dirname(file_path)), exist_ok=True)
    if not cv2.imwrite(file_path, img):
        raise IOError(f'Failed in writing {file_path}.')


def rgb_to_bgr_uint8(img: np.ndarray) -> np.ndarray:
    """HWC RGB float in [0, 1] -> HWC BGR uint8."""
    out = (np.clip(img, 0, 1) * 255.0).round().astype(np.uint8)
    return np.ascontiguousarray(out[:, :, ::-1])


def scandir(dir_path: str, recursive: bool = False) -> Iterator[str]:
    """Paths relative to dir_path of the files under it, skipping hidden
    entries."""

    def _scan(path):
        for entry in os.scandir(path):
            if not entry.name.startswith('.') and entry.is_file():
                yield os.path.relpath(entry.path, dir_path)
            elif recursive and entry.is_dir():
                yield from _scan(entry.path)

    return _scan(dir_path)


def round_8bit(x: torch.Tensor, min_max: Sequence[float] = (0, 1)
               ) -> torch.Tensor:
    """The 8-bit levels of an image as float32 on its device: x clipped to
    min_max, mapped to [0, 1], times 255, rounded half to even. These are
    the values tensor2img writes, and the ones the validation metrics
    see."""
    x = x.detach().float().clamp(min_max[0], min_max[1])
    x = (x - min_max[0]) / (min_max[1] - min_max[0])
    return (x * 255.0).round()


def make_grid(imgs: torch.Tensor, nrow: int = 8, padding: int = 2,
              pad_value: float = 0.0) -> torch.Tensor:
    """Tile a batch (N, H, W, C) into one (H', W', C) grid image."""
    n, h, w, c = imgs.shape
    ncol = min(nrow, n)
    nrow_ = int(math.ceil(n / ncol))
    grid = imgs.new_full((nrow_ * (h + padding) + padding,
                          ncol * (w + padding) + padding, c), pad_value)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y, x = r * (h + padding) + padding, col * (w + padding) + padding
        grid[y:y + h, x:x + w] = imgs[idx]
    return grid


def array2img(arrays, rgb2bgr: bool = True, out_type=np.uint8,
              min_max: Sequence[float] = (0, 1)):
    """HWC (or NHWC, tiled into a grid; or HW) image array(s) or tensor(s)
    -> cv2 image(s): values clipped to min_max and mapped to [0, 1], RGB to
    BGR, then for uint8 times 255 and rounded. A list gives a list."""
    single = not isinstance(arrays, (list, tuple))
    out = []
    for arr in ([arrays] if single else arrays):
        x = torch.as_tensor(arr).detach().float()
        if x.ndim == 4:
            lo, hi = min_max
            x = make_grid((x.clamp(lo, hi) - lo) / (hi - lo),
                          nrow=int(math.sqrt(x.shape[0])))
            lim = (0, 1)
        elif x.ndim in (2, 3):
            lim = min_max
        else:
            raise TypeError(f'Only support 4D, 3D or 2D array. Got '
                            f'{x.ndim}D.')
        if x.ndim == 3 and x.shape[2] == 3 and rgb2bgr:
            x = x.flip(-1)
        elif x.ndim == 3 and x.shape[2] == 1:
            x = x[..., 0]
        if out_type == np.uint8:
            x = round_8bit(x, lim)
        else:
            x = (x.clamp(lim[0], lim[1]) - lim[0]) / (lim[1] - lim[0])
        out.append(x.cpu().numpy().astype(out_type))
    return out[0] if single else out


def tensor2img(tensor, rgb2bgr: bool = True, out_type=np.uint8,
               min_max: Sequence[float] = (0, 1)):
    """Model output(s) in the port's layout, (N, C, H, W) (tiled into a grid
    when N > 1), (C, H, W) or (H, W), -> HWC cv2 image(s), as array2img."""
    def hwc(t):
        t = t.detach()
        if t.ndim == 4 and t.shape[0] == 1:
            t = t[0]
        if t.ndim == 4:
            return t.permute(0, 2, 3, 1)
        return t.permute(1, 2, 0) if t.ndim == 3 else t
    if isinstance(tensor, (list, tuple)):
        return array2img([hwc(t) for t in tensor], rgb2bgr, out_type,
                         min_max)
    return array2img(hwc(tensor), rgb2bgr, out_type, min_max)
