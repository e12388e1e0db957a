"""JPEG compression on the device (counterpart of femasr_tpu/ops/diffjpeg.py).

The DCT-quantization JPEG of the on-device BSRGAN degradation: JFIF
RGB -> YCbCr, 2x2 chroma mean-pooling, the 8x8 block DCT as one product
against a (64, 64) basis, quantization tables scaled by a quality per
sample, rounding (or its differentiable form), the inverse path, and the
chroma planes upsampled bilinearly ("fancy upsampling"). The bases and
tables live on the device, one copy per device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ITU-T T.81 Annex K quantization tables
Y_TABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)

C_TABLE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.float32)

# JFIF colour conversion on [0, 255] values: ycc = RGB2YCC @ rgb + shift
RGB2YCC = np.array([[0.299, 0.587, 0.114],
                    [-0.168736, -0.331264, 0.5],
                    [0.5, -0.418688, -0.081312]], np.float32)
YCC2RGB = np.array([[1.0, 0.0, 1.402],
                    [1.0, -0.344136, -0.714136],
                    [1.0, 1.772, 0.0]], np.float32)
YCC_SHIFT = np.array([0.0, 128.0, 128.0], np.float32)


@functools.lru_cache(maxsize=None)
def _dct_basis() -> Tuple[np.ndarray, np.ndarray]:
    """(8,8,8,8) forward (x,y,u,v) and inverse (u,v,x,y) DCT-II bases with
    JPEG normalization."""
    x = np.arange(8)
    u = np.arange(8)
    cos = np.cos((2 * x[:, None] + 1) * u[None, :] * np.pi / 16)  # (x, u)
    alpha = np.where(u == 0, 1.0 / np.sqrt(2.0), 1.0)
    fwd = 0.25 * np.einsum('u,v,xu,yv->xyuv', alpha, alpha, cos, cos)
    inv = 0.25 * np.einsum('u,v,xu,yv->uvxy', alpha, alpha, cos, cos)
    return fwd.astype(np.float32), inv.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _device_constants(device: torch.device) -> dict:
    """The bases (as (64, 64) matrices), tables and colour matrices as
    tensors on `device`, one copy per device."""
    fwd, inv = _dct_basis()
    consts = dict(fwd=fwd.reshape(64, 64), inv=inv.reshape(64, 64),
                  y_table=Y_TABLE, c_table=C_TABLE, rgb2ycc=RGB2YCC,
                  ycc2rgb=YCC2RGB, shift=YCC_SHIFT[:, None, None])
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in consts.items()}


def quality_to_factor(quality) -> torch.Tensor:
    """JPEG quality (1..100) -> quantization scale factor, float32.

    As the JAX package computes it under jit: XLA turns a division by a
    constant into a product with its reciprocal, and round(table * factor)
    sees the difference. Here a constant divisor is always written as that
    product, and 5000 / quality as a division of two tensors, so the
    arithmetic is the same on the CPU and on the card (whose division by a
    Python number is also a product with the reciprocal)."""
    quality = torch.as_tensor(quality, dtype=torch.float32)
    factor = torch.where(quality < 50,
                         torch.full_like(quality, 5000.0) / quality,
                         200.0 - quality * 2.0)
    return factor * 0.01


def diff_round(x: torch.Tensor) -> torch.Tensor:
    """Differentiable rounding: round(x) + (x - round(x))^3."""
    return torch.round(x) + torch.pow(x - torch.round(x), 3)


def rgb_to_ycbcr_jpeg(x: torch.Tensor) -> torch.Tensor:
    """JFIF RGB -> YCbCr of (B, 3, H, W) values in [0, 255]."""
    c = _device_constants(x.device)
    return torch.einsum('dc,bchw->bdhw', c['rgb2ycc'], x) + c['shift']


def ycbcr_to_rgb_jpeg(x: torch.Tensor) -> torch.Tensor:
    c = _device_constants(x.device)
    return torch.einsum('dc,bchw->bdhw', c['ycc2rgb'], x - c['shift'])


def _compress_plane(plane: torch.Tensor, table: torch.Tensor,
                    factor: torch.Tensor, rounding) -> torch.Tensor:
    """DCT -> quantize -> round -> dequantize -> iDCT of one (B, H, W)
    plane (H, W multiples of 8)."""
    c = _device_constants(plane.device)
    b, h, w = plane.shape
    # (B, H/8, W/8, 64): each 8x8 block flattened row-major (x, y)
    blocks = (plane - 128.0).reshape(b, h // 8, 8, w // 8, 8).permute(
        0, 1, 3, 2, 4).reshape(b, h // 8, w // 8, 64)
    coeffs = torch.matmul(blocks, c['fwd']).reshape(b, h // 8, w // 8, 8, 8)
    # libjpeg's integer tables: round(table * factor) clamped to [1, 255]
    q = torch.clamp(torch.round(table * factor), 1.0, 255.0)
    dequant = (rounding(coeffs / q) * q).reshape(b, h // 8, w // 8, 64)
    rec = torch.matmul(dequant, c['inv']).reshape(b, h // 8, w // 8, 8, 8)
    return rec.permute(0, 1, 3, 2, 4).reshape(b, h, w) + 128.0


def _down2(p: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling of a (B, H, W) plane."""
    b, h, w = p.shape
    return p.reshape(b, h // 2, 2, w // 2, 2).sum(dim=(2, 4)) * 0.25


def _up2(p: torch.Tensor) -> torch.Tensor:
    """Bilinear (triangle-filter) 2x upsampling of a (B, H, W) plane."""
    return F.interpolate(p[:, None], scale_factor=2, mode='bilinear',
                         align_corners=False)[:, 0]


def jpeg_compress(x: torch.Tensor, quality,
                  differentiable: bool = True) -> torch.Tensor:
    """JPEG round trip of (B, 3, H, W) RGB images in [0, 1].

    quality: a number, or one per sample ((B,) or any shape with B
    elements), on x's device. H and W are padded with edge values to
    multiples of 16 and cropped back after.
    """
    b, ch, h, w = x.shape
    if ch != 3:
        raise ValueError(f'jpeg_compress takes RGB images, got {ch} channels')
    rounding = diff_round if differentiable else torch.round
    factor = quality_to_factor(quality)
    if factor.ndim > 0:
        factor = factor.reshape(factor.shape[0], 1, 1, 1, 1)
    ph, pw = (-h) % 16, (-w) % 16
    if ph or pw:
        x = F.pad(x, (0, pw, 0, ph), mode='replicate')
    c = _device_constants(x.device)

    ycc = rgb_to_ycbcr_jpeg(x.float() * 255.0)
    y_r = _compress_plane(ycc[:, 0], c['y_table'], factor, rounding)
    cb_r = _up2(_compress_plane(_down2(ycc[:, 1]), c['c_table'], factor,
                                rounding))
    cr_r = _up2(_compress_plane(_down2(ycc[:, 2]), c['c_table'], factor,
                                rounding))
    rgb = ycbcr_to_rgb_jpeg(torch.stack([y_r, cb_r, cr_r], dim=1))
    out = torch.clamp(rgb * (1 / 255.0), 0.0, 1.0).to(x.dtype)
    return out[:, :, :h, :w]
