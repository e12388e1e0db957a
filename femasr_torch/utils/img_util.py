"""Image file helpers for the CLI (cv2 I/O, BGR uint8 on disk)."""

from __future__ import annotations

import os
from typing import Iterator, Optional

import numpy as np


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
