"""Generic architecture blocks (the BasicSR arch_util surface).

The port's copy of femasr_tpu/ops/arch_util.py: to_2tuple,
trunc_normal_init, ResidualBlockNoBN, Upsample (the conv + pixel-shuffle
upsampler, models.swinir_arch.UpsampleShuffle), flow_warp, resize_flow
and DropPath; JAX's pixel_shuffle / pixel_unshuffle are F.pixel_shuffle /
F.pixel_unshuffle. Images are NCHW; flows are (B, H, W, 2) in (dx, dy)
pixel offsets, as there.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.swinir_arch import UpsampleShuffle
from .layers import Conv2d

Upsample = UpsampleShuffle  # conv + pixel-shuffle upsampler (arch_util.py:94)

# std of a unit normal truncated to [-2, 2]: flax's truncated_normal draws
# there and scales by stddev / this, so the result has std `stddev`
_TRUNC_STD = 0.87962566103423978


def to_2tuple(x):
    return x if isinstance(x, tuple) else (x, x)


def trunc_normal_init(stddev: float = 0.02
                      ) -> Callable[..., torch.Tensor]:
    """An initializer that fills a tensor in place as flax's
    truncated_normal(stddev) draws: a normal truncated at 2 sigma, with
    standard deviation `stddev`."""
    @torch.no_grad()
    def init(t: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return t.mul_(stddev / _TRUNC_STD)
    return init


class ResidualBlockNoBN(nn.Module):
    """Conv-ReLU-Conv residual block without BN (arch_util.py:63-91)."""

    def __init__(self, num_feat: int = 64, res_scale: float = 1.0):
        super().__init__()
        self.res_scale = res_scale
        self.conv1 = Conv2d(num_feat, num_feat, 3, 1, 1)
        self.conv2 = Conv2d(num_feat, num_feat, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.conv2(F.relu(self.conv1(x))) * self.res_scale


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              interp_mode: str = 'bilinear',
              padding_mode: str = 'zeros') -> torch.Tensor:
    """Warp an NCHW image by optical flow (arch_util.py:116-153).

    flow: (B, H, W, 2) in (dx, dy) pixel offsets. Bilinear (or nearest)
    sampling with zero or border padding, on the align_corners=True grid,
    in the JAX copy's arithmetic order.
    """
    b, _, h, w = x.shape
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=x.device),
        torch.arange(w, dtype=torch.float32, device=x.device),
        indexing='ij')
    sx = xx[None] + flow[..., 0]
    sy = yy[None] + flow[..., 1]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    fx, fy = sx - x0, sy - y0
    xl = x.permute(0, 2, 3, 1)
    batch = torch.arange(b, device=x.device)[:, None, None]

    def gather(yi, xi):
        if padding_mode == 'border':
            valid = torch.ones_like(yi)
        else:  # zeros
            valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)).float()
        yi = yi.clamp(0, h - 1).long()
        xi = xi.clamp(0, w - 1).long()
        return xl[batch, yi, xi] * valid[..., None]

    if interp_mode == 'nearest':
        out = gather(torch.round(sy), torch.round(sx))
    else:
        fx, fy = fx[..., None], fy[..., None]
        out = (gather(y0, x0) * (1 - fx) * (1 - fy)
               + gather(y0, x0 + 1) * fx * (1 - fy)
               + gather(y0 + 1, x0) * (1 - fx) * fy
               + gather(y0 + 1, x0 + 1) * fx * fy)
    return out.permute(0, 3, 1, 2)


def resize_flow(flow: torch.Tensor, size_type: str, sizes: Tuple[int, int],
                interp_mode: str = 'bilinear') -> torch.Tensor:
    """Resize a (B, H, W, 2) flow field, rescaling its values
    (arch_util.py:156-186): half-pixel bilinear, antialiased when it
    shrinks, as jax.image.resize."""
    _, h, w, _ = flow.shape
    if size_type == 'ratio':
        out_h, out_w = int(h * sizes[0]), int(w * sizes[1])
    elif size_type == 'shape':
        out_h, out_w = sizes
    else:
        raise ValueError(f'Size type should be ratio or shape, but got '
                         f'{size_type}.')
    scaled = flow * torch.tensor([out_w / w, out_h / h], dtype=flow.dtype,
                                 device=flow.device)
    out = F.interpolate(scaled.permute(0, 3, 1, 2), size=(out_h, out_w),
                        mode=interp_mode, align_corners=False,
                        antialias=out_h < h or out_w < w)
    return out.permute(0, 2, 3, 1)


class DropPath(nn.Module):
    """Stochastic depth per sample (arch_util.py:291-313): in training,
    each sample is kept with probability 1 - drop_prob and scaled by its
    inverse; in eval the identity."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        if not self.training or self.drop_prob == 0.0:
            return x
        keep = 1.0 - self.drop_prob
        mask = torch.rand((x.shape[0],) + (1,) * (x.ndim - 1),
                          generator=generator, device=x.device) < keep
        return x / keep * mask
