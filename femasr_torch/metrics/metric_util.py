"""The metric factory (counterpart of femasr_tpu/metrics/metric_util.py).

`create_metric(name, ...)` returns `metric(sr_img, gt_img) -> float` over
[0, 1] HWC RGB images (tensors on any device, or numpy arrays): psnr,
ssim, lpips (the port's LPIPS-VGG; None when no weights are given, and the
caller skips it) and niqe (no-reference; needs `pristine_params`).
"""

from __future__ import annotations

import functools
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from .psnr_ssim import calculate_psnr, calculate_ssim


class LPIPSMetric:
    """LPIPS(sr, gt) of two HWC RGB images in [0, 1], with the given LPIPS
    weights (the port's keys, `losses.lpips.convert_lpips_checkpoint`)."""

    def __init__(self, state_dict: Mapping[str, torch.Tensor],
                 device='cpu'):
        from ..losses.lpips import LPIPS
        self.device = torch.device(device)
        self.net = LPIPS()
        self.net.load_state_dict(state_dict)
        self.net.requires_grad_(False).eval().to(self.device)

    def _nchw(self, img) -> torch.Tensor:
        if isinstance(img, np.ndarray):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return img.to(self.device, torch.float32).permute(2, 0, 1)[None]

    def __call__(self, img, img2, **kwargs) -> float:
        with torch.no_grad():
            return float(self.net(self._nchw(img), self._nchw(img2))[0])


def _niqe_metric(img, img2=None, pristine_params: str = '',
                 **kwargs) -> float:
    """No-reference NIQE of `img`; img2 is unused (the (sr, gt) call
    signature). pristine_params: basicsr's niqe_pris_params.npz, MATLAB's
    modelparameters.mat, or a fitted mu/cov .npz (niqe.fit_niqe_params)."""
    from .niqe import calculate_niqe, load_niqe_pris_params
    mu, cov, window = load_niqe_pris_params(pristine_params)
    if isinstance(img, torch.Tensor):
        img = img.detach().cpu().numpy()
    return calculate_niqe(img, mu, cov, gaussian_window=window, **kwargs)


METRICS = {'psnr': calculate_psnr, 'ssim': calculate_ssim,
           'niqe': _niqe_metric}


def create_metric(name: str, lpips_params: Optional[Mapping] = None,
                  device='cpu', **mopt) -> Optional[Callable]:
    """The metric function `name` ('psnr' | 'ssim' | 'lpips' | 'niqe') with
    its options bound. lpips_params: LPIPS weights (port keys); lpips runs
    on `device`. Raises KeyError on an unknown name."""
    if name == 'lpips':
        if lpips_params is None:
            return None
        return LPIPSMetric(lpips_params, device)
    if name not in METRICS:
        raise KeyError(f'No object named {name!r} found in metric registry '
                       f'(have {sorted(METRICS) + ["lpips"]})')
    if name == 'niqe' and not mopt.get('pristine_params'):
        raise ValueError(
            'niqe metric needs pristine_params: <path to '
            'niqe_pris_params.npz / modelparameters.mat / fitted mu-cov '
            '.npz> (fit with femasr_torch.metrics.niqe.fit_niqe_params)')
    return functools.partial(METRICS[name], **mopt)
