"""Image quality metrics (counterpart of femasr_tpu/metrics): PSNR, SSIM,
LPIPS and NIQE through `create_metric`; FID with its InceptionV3."""

from .metric_util import create_metric
from .psnr_ssim import calculate_psnr, calculate_ssim

__all__ = ['calculate_psnr', 'calculate_ssim', 'create_metric']
