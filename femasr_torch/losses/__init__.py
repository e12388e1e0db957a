"""Training losses (counterpart of femasr_tpu/losses)."""

from .losses import (CharbonnierLoss, GANLoss, L1Loss, LPIPSLoss, MSELoss,
                     MultiScaleGANLoss, PerceptualLoss, build_loss,
                     charbonnier_loss, l1_loss, mse_loss)
from .lpips import LPIPS, convert_lpips_checkpoint, lpips_package_state

__all__ = ['build_loss', 'L1Loss', 'MSELoss', 'CharbonnierLoss',
           'LPIPSLoss', 'PerceptualLoss', 'GANLoss', 'MultiScaleGANLoss',
           'l1_loss', 'mse_loss', 'charbonnier_loss', 'LPIPS',
           'convert_lpips_checkpoint', 'lpips_package_state']
