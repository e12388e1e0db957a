"""SwinIR, the second model family (femasr_tpu/models/swinir_arch.py).

shallow conv -> RSTB stack (patch norm, optional absolute position
embedding, final LayerNorm) -> residual conv -> reconstruction head
('pixelshuffle' | 'pixelshuffledirect' | 'nearest+conv' | '' for
denoising and JPEG artifact removal), with the RGB-mean shift, img_range
scaling, reflect padding to a window multiple and the crop back. Images
are NCHW. The attention core of every Swin block is the window-attention
kernel (B2): one launch a block, 36 a forward for SwinIR-M, 24 for
SwinIR-S; the convs and linears are PyTorch's (the JAX module leaves them
to XLA).

Parameters are float32 under the reference's torch keys (network_swinir.py:
`conv_first`, `patch_embed.norm`, `layers.{i}.residual_group.blocks.{k}`,
`layers.{i}.conv`, `norm`, `conv_after_body`, the head's), so a released
state dict loads with `load_state_dict` once
`models.convert.load_torch_checkpoint` has dropped its derived buffers
(`relative_position_index`, `attn_mask`). `dtype` is the compute dtype, as
the JAX module's: the image is padded, shifted and scaled in its own dtype,
cast to `dtype` at the first conv, and the output takes the dtype JAX's
promotions give it (float32 for a float32 image).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.layers import Conv2d, leaky_relu
from ..ops.swin import RSTB, LayerNorm
from ..utils.registry import ARCH_REGISTRY

RGB_MEAN = (0.4488, 0.4371, 0.4040)
DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


class UpsampleShuffle(nn.Sequential):
    """conv -> pixel shuffle, repeated for 2^n (or once for x3)
    (network_swinir.py:572-591); keys `{2i}.weight`, `{2i}.bias`."""

    def __init__(self, scale: int, num_feat: int):
        if scale & (scale - 1) == 0:
            steps = [(4, 2)] * int(math.log2(scale))
        elif scale == 3:
            steps = [(9, 3)]
        else:
            raise ValueError(f'scale {scale} is not supported. Supported '
                             'scales: 2^n and 3.')
        layers = []
        for mult, r in steps:
            layers += [Conv2d(num_feat, mult * num_feat, 3, 1, 1),
                       nn.PixelShuffle(r)]
        super().__init__(*layers)


class _PatchEmbed(nn.Module):
    """The reference's PatchEmbed at patch size 1: its optional norm."""

    def __init__(self, embed_dim: int, patch_norm: bool):
        super().__init__()
        self.norm = LayerNorm(embed_dim) if patch_norm else None


@ARCH_REGISTRY.register()
class SwinIR(nn.Module):
    """SwinIR with the JAX module's arguments. resi_connection '1conv'
    only: the JAX package has no '3conv' (its RSTB holds one conv, and
    convert_swinir_checkpoint maps no `cab_*` conv), so a SwinIR-L would
    load partly from init without an error there. The JAX module's
    patch_size (unused there too), use_checkpoint (SwinIR has no
    differentiable forward in the port) and attn_layout (a TPU layout) are
    not taken."""

    def __init__(self, img_size: int = 64, in_chans: int = 3, embed_dim: int = 96,
                 depths: Sequence[int] = (6, 6, 6, 6),
                 num_heads: Sequence[int] = (6, 6, 6, 6),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 ape: bool = False, patch_norm: bool = True,
                 upscale: int = 2, img_range: float = 1.0,
                 upsampler: str = '', resi_connection: str = '1conv',
                 dtype: Union[str, torch.dtype] = torch.float32):
        super().__init__()
        if resi_connection != '1conv':
            raise NotImplementedError(
                f"resi_connection {resi_connection!r}: only '1conv' is "
                "ported. The JAX package's RSTB has only the 1conv conv "
                "(femasr_tpu/ops/swin.py RSTB) and convert_swinir_checkpoint "
                "maps no 3conv weights, so it has no SwinIR-L to port")
        self.dtype = DTYPES[dtype] if isinstance(dtype, str) else dtype
        self.img_size = img_size
        self.in_chans = in_chans
        self.window_size = window_size
        self.upscale = upscale
        self.img_range = img_range
        self.upsampler = upsampler
        num_feat = 64

        self.conv_first = Conv2d(in_chans, embed_dim, 3, 1, 1)
        self.patch_embed = _PatchEmbed(embed_dim, patch_norm)
        self.absolute_pos_embed = (nn.Parameter(torch.zeros(
            1, img_size * img_size, embed_dim)) if ape else None)
        self.layers = nn.ModuleList([
            RSTB(embed_dim, (img_size, img_size), depth, num_heads[i],
                 window_size, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale)
            for i, depth in enumerate(depths)])
        self.norm = LayerNorm(embed_dim)
        self.conv_after_body = Conv2d(embed_dim, embed_dim, 3, 1, 1)

        if upsampler == 'pixelshuffle':
            self.conv_before_upsample = nn.Sequential(
                Conv2d(embed_dim, num_feat, 3, 1, 1))
            self.upsample = UpsampleShuffle(upscale, num_feat)
            self.conv_last = Conv2d(num_feat, in_chans, 3, 1, 1)
        elif upsampler == 'pixelshuffledirect':
            self.upsample = nn.Sequential(
                Conv2d(embed_dim, upscale ** 2 * in_chans, 3, 1, 1))
        elif upsampler == 'nearest+conv':
            if upscale != 4:
                raise ValueError('nearest+conv: only support x4 now.')
            self.conv_before_upsample = nn.Sequential(
                Conv2d(embed_dim, num_feat, 3, 1, 1))
            for name in ('conv_up1', 'conv_up2', 'conv_hr'):
                setattr(self, name, Conv2d(num_feat, num_feat, 3, 1, 1))
            self.conv_last = Conv2d(num_feat, in_chans, 3, 1, 1)
        else:   # denoising / JPEG artifact removal
            self.conv_last = Conv2d(embed_dim, in_chans, 3, 1, 1)

    def _norm(self, norm: LayerNorm, x: torch.Tensor) -> torch.Tensor:
        return norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2).contiguous()

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """patch_embed(+norm) -> RSTBs -> norm (network_swinir.py:791-803)."""
        if self.patch_embed.norm is not None:
            x = self._norm(self.patch_embed.norm, x)
        if self.absolute_pos_embed is not None:
            if tuple(x.shape[2:]) != (self.img_size, self.img_size):
                raise ValueError(f'ape: the padded input {tuple(x.shape[2:])}'
                                 f' must be img_size {self.img_size} square')
            x = x + self.absolute_pos_embed.view(
                1, self.img_size, self.img_size, -1).permute(
                    0, 3, 1, 2).to(x.dtype)
        for layer in self.layers:
            x = layer(x)
        return self._norm(self.norm, x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, in_chans, H, W) in [0, 1]; serving only (under no_grad:
        the attention kernel has no backward)."""
        h_in, w_in = x.shape[2:]
        ws = self.window_size
        pad_h, pad_w = (ws - h_in % ws) % ws, (ws - w_in % ws) % ws
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h), mode='reflect')
        mean = (torch.tensor(RGB_MEAN, dtype=x.dtype, device=x.device)
                if self.in_chans == 3 else
                torch.zeros(1, dtype=x.dtype, device=x.device))
        mean = mean.view(1, -1, 1, 1)
        x = (x - mean) * self.img_range

        def body(feat):
            return self.conv_after_body(self._features(feat)) + feat

        feat = self.conv_first(x.to(self.dtype))
        if self.upsampler == 'pixelshuffle':
            feat = leaky_relu(self.conv_before_upsample(body(feat)), 0.01)
            out = self.conv_last(self.upsample(feat))
        elif self.upsampler == 'pixelshuffledirect':
            out = F.pixel_shuffle(self.upsample(body(feat)), self.upscale)
        elif self.upsampler == 'nearest+conv':
            feat = leaky_relu(self.conv_before_upsample(body(feat)), 0.01)
            for conv in (self.conv_up1, self.conv_up2):
                feat = leaky_relu(conv(F.interpolate(
                    feat, scale_factor=2, mode='nearest')), 0.2)
            out = self.conv_last(leaky_relu(self.conv_hr(feat), 0.2))
        else:
            out = x + self.conv_last(body(feat))
        out = out / self.img_range + mean
        return out[:, :, :h_in * self.upscale, :w_in * self.upscale]
