"""U-Net discriminator with spectral normalization (counterpart of
femasr_tpu/models/discriminator_arch.py, the Real-ESRGAN design).

`SpectralConv2d` is this package's own spectral norm, not
torch.nn.utils.spectral_norm: that one runs a power iteration on every
training-mode forward, the generator step's too, where the JAX package
iterates only when the caller asks (`update_stats`). Here the power
iteration runs only under `update=True`; `u` and `v` are buffers
(`weight_u`, `weight_v`, beside `weight_orig`: the reference's
state-dict keys), warm-started at construction by `init_power_iters`
iterations from a seeded random u, as the JAX init does.

In bfloat16 (`dtype`, the JAX module's), as the JAX discriminator rounds:
the input is cast to bf16; the power iteration and sigma stay f32 and
weight / sigma is rounded to bf16; every conv runs in bf16 with its bias
added after it in bf16; the leaky ReLUs, skip adds and bilinear upsamples
run in bf16. Parameters stay f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import Conv2d, leaky_relu


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x) + eps)


class SpectralConv2d(nn.Module):
    """Conv2d (no bias) whose weight is divided by its largest singular
    value sigma = u . (W v), W the (O, I*kh*kw) view of the weight."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int,
                 stride: int = 1, padding: int = 1, eps: float = 1e-12):
        super().__init__()
        self.stride, self.padding, self.eps = stride, padding, eps
        self.weight_orig = nn.Parameter(torch.empty(
            out_ch, in_ch, kernel_size, kernel_size))
        self.register_buffer('weight_u', torch.zeros(out_ch))
        self.register_buffer('weight_v', torch.zeros(
            in_ch * kernel_size * kernel_size))

    def _w_mat(self) -> torch.Tensor:
        return self.weight_orig.reshape(self.weight_orig.shape[0], -1)

    @torch.no_grad()
    def warm_start(self, generator: torch.Generator,
                   iters: int = 15) -> None:
        """u, v after `iters` power iterations from a random normal u."""
        w = self._w_mat()
        u = _l2_normalize(torch.randn(w.shape[0], generator=generator)
                          .to(w.device), self.eps)
        v = _l2_normalize(w.t() @ u, self.eps)
        for _ in range(max(iters - 1, 0)):
            u = _l2_normalize(w @ v, self.eps)
            v = _l2_normalize(w.t() @ u, self.eps)
        u = _l2_normalize(w @ v, self.eps)
        self.weight_u.copy_(u)
        self.weight_v.copy_(_l2_normalize(w.t() @ u, self.eps))

    @torch.no_grad()
    def power_iteration(self) -> None:
        w = self._w_mat()
        v = _l2_normalize(w.t() @ self.weight_u, self.eps)
        self.weight_u.copy_(_l2_normalize(w @ v, self.eps))
        self.weight_v.copy_(v)

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        if update:
            self.power_iteration()
        # copies: a later update must not change what backward reads
        u, v = self.weight_u.clone(), self.weight_v.clone()
        sigma = torch.dot(u, self._w_mat() @ v)
        return F.conv2d(x, (self.weight_orig / sigma).to(x.dtype), None,
                        self.stride, self.padding)


def upsample_bilinear(y: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsample, half-pixel centers (align_corners=False), as
    jax.image.resize contracts it: along W, then along H, each rounded to
    y's dtype (a 2-D F.interpolate rounds once; in bf16 26% of its
    outputs differ from JAX's)."""
    y = F.interpolate(y, scale_factor=(1, 2), mode='bilinear',
                      align_corners=False)
    return F.interpolate(y, scale_factor=(2, 1), mode='bilinear',
                         align_corners=False)


class UNetDiscriminatorSN(nn.Module):
    """3 SN-conv downs, 3 bilinear-up SN convs with skips, 2 more SN convs,
    a 1-channel output map. forward(x, update): update=True runs one power
    iteration in every SN conv first (the discriminator step). The input
    is cast to `dtype` (float32 or bfloat16), the compute dtype."""

    def __init__(self, num_in_ch: int = 3, num_feat: int = 64,
                 skip_connection: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        nf = num_feat
        self.skip_connection = skip_connection
        self.dtype = dtype
        self.conv0 = Conv2d(num_in_ch, nf, 3, 1, 1)
        self.conv1 = SpectralConv2d(nf, nf * 2, 4, 2, 1)
        self.conv2 = SpectralConv2d(nf * 2, nf * 4, 4, 2, 1)
        self.conv3 = SpectralConv2d(nf * 4, nf * 8, 4, 2, 1)
        self.conv4 = SpectralConv2d(nf * 8, nf * 4, 3, 1, 1)
        self.conv5 = SpectralConv2d(nf * 4, nf * 2, 3, 1, 1)
        self.conv6 = SpectralConv2d(nf * 2, nf, 3, 1, 1)
        self.conv7 = SpectralConv2d(nf, nf, 3, 1, 1)
        self.conv8 = SpectralConv2d(nf, nf, 3, 1, 1)
        self.conv9 = Conv2d(nf, 1, 3, 1, 1)

    def spectral_convs(self):
        return [getattr(self, f'conv{i}') for i in range(1, 9)]

    def forward(self, x: torch.Tensor, update: bool = False) -> torch.Tensor:
        lrelu, up = leaky_relu, upsample_bilinear
        x = x.to(self.dtype)
        x0 = lrelu(self.conv0(x))
        x1 = lrelu(self.conv1(x0, update))
        x2 = lrelu(self.conv2(x1, update))
        x3 = lrelu(self.conv3(x2, update))
        x4 = lrelu(self.conv4(up(x3), update))
        if self.skip_connection:
            x4 = x4 + x2
        x5 = lrelu(self.conv5(up(x4), update))
        if self.skip_connection:
            x5 = x5 + x1
        x6 = lrelu(self.conv6(up(x5), update))
        if self.skip_connection:
            x6 = x6 + x0
        out = lrelu(self.conv7(x6, update))
        out = lrelu(self.conv8(out, update))
        return self.conv9(out)


@torch.no_grad()
def init_discriminator(net: UNetDiscriminatorSN,
                       generator: Optional[torch.Generator] = None,
                       init_power_iters: int = 15) -> UNetDiscriminatorSN:
    """Seeded init: weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (the JAX
    SN convs' variance_scaling(1/3, fan_in, uniform)), biases zero, then the
    spectral vectors warm-started."""
    if generator is None:
        generator = torch.Generator().manual_seed(1)
    for p in net.parameters():
        if p.dim() == 1:
            p.zero_()
        else:
            bound = 1.0 / math.sqrt(p[0].numel())
            p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1)
                    * bound)
    for m in net.spectral_convs():
        m.warm_start(generator, init_power_iters)
    return net
