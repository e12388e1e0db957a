"""MATLAB-compatible bicubic resize (counterpart of femasr_tpu/ops/resize.py).

Antialiased cubic kernel (a = -0.5), symmetric boundary handling, per-row
weight normalization and zero-column trimming, as MATLAB's `imresize`. The
resize is two dense products, `out = R_h @ img @ R_w^T`, against
(out_len, in_len) matrices built once in numpy with the symmetric padding
folded into in-range columns. `imresize` keeps the matrices on the tensor's
device, one copy per (lengths, scale, device), so a warm call moves nothing
from the host.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def cubic(x: np.ndarray) -> np.ndarray:
    """MATLAB cubic interpolation kernel (a = -0.5)."""
    absx = np.abs(x)
    absx2 = absx ** 2
    absx3 = absx ** 3
    return ((1.5 * absx3 - 2.5 * absx2 + 1) * (absx <= 1)
            + (-0.5 * absx3 + 2.5 * absx2 - 4 * absx + 2)
            * ((absx > 1) & (absx <= 2)))


@functools.lru_cache(maxsize=None)
def matlab_resize_matrix(in_len: int, out_len: int, scale: float,
                         antialias: bool = True) -> np.ndarray:
    """Dense (out_len, in_len) MATLAB-bicubic resize matrix (float64 ->
    float32). Multiplying by it is MATLAB's pad-then-filter."""
    kernel_width = 4.0
    if scale < 1 and antialias:
        kernel_width = 4.0 / scale

    x = np.arange(1, out_len + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    p = int(math.ceil(kernel_width)) + 2

    indices = left[:, None] + np.arange(p)[None, :]  # 1-based source index
    dist = u[:, None] - indices
    if scale < 1 and antialias:
        weights = scale * cubic(dist * scale)
    else:
        weights = cubic(dist)
    weights = weights / weights.sum(axis=1, keepdims=True)

    # trim an all-zero first / last column
    zero_cols = (weights == 0).sum(axis=0)
    lo, hi = 0, p
    if not math.isclose(zero_cols[0], 0, rel_tol=1e-6):
        lo += 1
    if not math.isclose(zero_cols[-1], 0, rel_tol=1e-6):
        hi -= 1
    indices = indices[:, lo:hi]
    weights = weights[:, lo:hi]

    # fold the symmetric extension into in-range 0-based indices
    mat = np.zeros((out_len, in_len), np.float64)
    for r in range(out_len):
        for c in range(indices.shape[1]):
            j = int(indices[r, c]) - 1
            if j < 0:
                j = -j - 1
            elif j >= in_len:
                j = 2 * in_len - 1 - j
            mat[r, j] += weights[r, c]
    return mat.astype(np.float32)


def _out_len(in_len: int, scale: float) -> int:
    return int(math.ceil(in_len * scale))


def imresize_np(img: np.ndarray, scale: float,
                antialiasing: bool = True) -> np.ndarray:
    """MATLAB bicubic resize of an HWC or HW float image in numpy."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    h, w, _ = img.shape
    rh = matlab_resize_matrix(h, _out_len(h, scale), scale, antialiasing)
    rw = matlab_resize_matrix(w, _out_len(w, scale), scale, antialiasing)
    out = np.einsum('oh,hwc->owc', rh, img.astype(np.float32))
    out = np.einsum('pw,owc->opc', rw, out)
    return out[:, :, 0] if squeeze else out


@functools.lru_cache(maxsize=None)
def on_device(builder, args: tuple, device: torch.device) -> torch.Tensor:
    """`builder(*args)`, a numpy constant, as a tensor kept on `device`
    (one copy per builder, arguments and device)."""
    return torch.from_numpy(np.ascontiguousarray(builder(*args))).to(device)


def resize_with(mat_h: torch.Tensor, mat_w: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., OH, OW): mat_h @ x @ mat_w^T."""
    return torch.matmul(torch.matmul(mat_h, x), mat_w.t())


def imresize(x: torch.Tensor, scale: float,
             antialiasing: bool = True) -> torch.Tensor:
    """MATLAB bicubic resize of an NCHW (or CHW) float tensor, in float32
    on its device."""
    h, w = x.shape[-2:]
    rh = on_device(matlab_resize_matrix,
                   (h, _out_len(h, scale), scale, antialiasing), x.device)
    rw = on_device(matlab_resize_matrix,
                   (w, _out_len(w, scale), scale, antialiasing), x.device)
    return resize_with(rh, rw, x.float())
