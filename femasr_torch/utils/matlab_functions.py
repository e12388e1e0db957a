"""MATLAB-compatible color conversions (counterpart of
femasr_tpu/utils/matlab_functions.py), on torch tensors.

Images are HWC (or NHWC) RGB / BGR, float in [0, 1] or uint8. A numpy
array in gives a numpy array out; a tensor stays on its device. The
arithmetic is float32, as the JAX copy's.
"""

from __future__ import annotations

import numpy as np
import torch

_Y_RGB = (65.481, 128.553, 24.966)
_YCBCR_RGB = ((65.481, -37.797, 112.0),
              (128.553, -74.203, -93.786),
              (24.966, 112.0, -18.214))
_YCBCR_BGR = ((24.966, 112.0, -18.214),
              (128.553, -74.203, -93.786),
              (65.481, -37.797, 112.0))
_RGB_YCBCR = ((0.00456621, 0.00456621, 0.00456621),
              (0, -0.00153632, 0.00791071),
              (0.00625893, -0.00318811, 0))


def _convert_input_type_range(img):
    """(float32 tensor in [0, 1], whether the input was uint8, whether it
    was numpy)."""
    is_np = isinstance(img, np.ndarray)
    t = torch.from_numpy(np.ascontiguousarray(img)) if is_np else img
    is_u8 = t.dtype == torch.uint8
    t = t.float() / 255.0 if is_u8 else t.float()
    return t, is_u8, is_np


def _convert_output_type_range(t: torch.Tensor, is_u8: bool, is_np: bool):
    t = t.round().to(torch.uint8) if is_u8 else t / 255.0
    return t.numpy() if is_np else t


def _mat(rows, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.float32, device=like.device)


def rgb2ycbcr(img, y_only: bool = False):
    """RGB -> YCbCr (ITU-R BT.601, offsets 16/128, as MATLAB's rgb2ycbcr).
    The output keeps the input's convention: float stays in [0, 1], uint8
    in [0, 255]."""
    t, is_u8, is_np = _convert_input_type_range(img)
    if y_only:
        out = t @ _mat(_Y_RGB, t) + 16.0
    else:
        out = t @ _mat(_YCBCR_RGB, t) + _mat((16, 128, 128), t)
    return _convert_output_type_range(out, is_u8, is_np)


def bgr2ycbcr(img, y_only: bool = False):
    """bgr2ycbcr: rgb2ycbcr of a BGR image."""
    t, is_u8, is_np = _convert_input_type_range(img)
    if y_only:
        out = t @ _mat(_Y_RGB[::-1], t) + 16.0
    else:
        out = t @ _mat(_YCBCR_BGR, t) + _mat((16, 128, 128), t)
    return _convert_output_type_range(out, is_u8, is_np)


def ycbcr2rgb(img):
    """YCbCr -> RGB (the inverse of rgb2ycbcr)."""
    t, is_u8, is_np = _convert_input_type_range(img)
    mat = _mat(_RGB_YCBCR, t) * 255.0
    out = (t * 255.0) @ mat + _mat((-222.921, 135.576, -276.836), t)
    return _convert_output_type_range(out, is_u8, is_np)


def ycbcr2bgr(img):
    rgb = ycbcr2rgb(img)
    return rgb[..., ::-1] if isinstance(rgb, np.ndarray) else rgb.flip(-1)
