"""PSNR and SSIM (counterpart of femasr_tpu/metrics/psnr_ssim.py), in
float64 on the images' device.

Images are HWC RGB (or HW) in [0, 1], as tensors (on any device) or numpy
arrays. As in BasicSR and pyiqa: an optional MATLAB Y channel (computed in
float32, as the JAX copy does), `crop_border` pixels cut from each side,
values scaled to [0, 255]; SSIM with an 11x11 Gaussian window (sigma 1.5)
per channel, averaged over the channels.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.matlab_functions import rgb2ycbcr


def _tensor(img) -> torch.Tensor:
    if isinstance(img, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(img))
    return img


def _prepare(img, crop_border: int, test_y_channel: bool) -> torch.Tensor:
    img = _tensor(img)
    if img.ndim == 3 and img.shape[2] == 3 and test_y_channel:
        img = rgb2ycbcr(img.float(), y_only=True)
    img = img.double()
    if crop_border != 0:
        img = img[crop_border:-crop_border, crop_border:-crop_border, ...]
    return img * 255.0


def _check_shapes(img, img2) -> None:
    if tuple(img.shape) != tuple(img2.shape):
        raise ValueError(f'shapes differ: {tuple(img.shape)} vs '
                         f'{tuple(img2.shape)}')


def calculate_psnr(img, img2, crop_border: int = 0,
                   test_y_channel: bool = False, **kwargs) -> float:
    """PSNR in dB between two [0, 1] HWC RGB (or HW) images."""
    _check_shapes(img, img2)
    a = _prepare(img, crop_border, test_y_channel)
    b = _prepare(img2, crop_border, test_y_channel).to(a.device)
    mse = (a - b).square().mean().item()
    if mse == 0:
        return float('inf')
    return 10.0 * math.log10(255.0 * 255.0 / mse)


def _gaussian_window(device) -> torch.Tensor:
    """The 11x11 sigma-1.5 window of cv2.getGaussianKernel, float64."""
    import cv2
    k = cv2.getGaussianKernel(11, 1.5)
    return torch.from_numpy(np.outer(k, k.transpose())).to(device)


def _ssim_channels(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-channel SSIM of (C, H, W) float64 images in [0, 255].

    cv2.filter2D followed by the [5:-5, 5:-5] crop keeps only the outputs
    whose 11x11 window lies inside the image: exactly a valid conv2d."""
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    ch = a.shape[0]
    win = _gaussian_window(a.device).expand(ch, 1, 11, 11)

    def filt(x):
        return F.conv2d(x[None], win, groups=ch)[0]

    mu1, mu2 = filt(a), filt(b)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 ** 2, mu2 ** 2, mu1 * mu2
    sigma1_sq = filt(a * a) - mu1_sq
    sigma2_sq = filt(b * b) - mu2_sq
    sigma12 = filt(a * b) - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))
    return ssim_map.mean(dim=(1, 2))


def calculate_ssim(img, img2, crop_border: int = 0,
                   test_y_channel: bool = False, **kwargs) -> float:
    """SSIM between two [0, 1] HWC RGB (or HW) images."""
    _check_shapes(img, img2)
    a = _prepare(img, crop_border, test_y_channel)
    b = _prepare(img2, crop_border, test_y_channel).to(a.device)
    if a.ndim == 2:
        a, b = a[None], b[None]
    else:
        a, b = a.permute(2, 0, 1), b.permute(2, 0, 1)
    return float(_ssim_channels(a, b).cpu().numpy().mean())
