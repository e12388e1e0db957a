"""LPIPS with the VGG16 backbone (counterpart of femasr_tpu/losses/lpips.py).

Zhang et al., CVPR'18: VGG16 taps at relu{1_2,2_2,3_3,4_3,5_3} of the
scaled input, channel-unit-normalized feature differences, learned
non-negative per-channel weights, spatial mean, summed over the layers.
Checkpoints of the `lpips` package (`lin{i}.model.1.weight` and the
backbone as `net.slice{k}.{features index}.*`) load through
`convert_lpips_checkpoint`; `lpips_package_state` writes that format.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
from torch import nn

from ..models.vgg_arch import (VGGFeatureExtractor, convert_vgg_checkpoint,
                               vgg_layer_names)

LPIPS_VGG_LAYERS = ('relu1_2', 'relu2_2', 'relu3_3', 'relu4_3', 'relu5_3')
LPIPS_VGG_CHANNELS = (64, 128, 256, 512, 512)
LPIPS_SHIFT = (-.030, -.088, -.188)
LPIPS_SCALE = (.458, .448, .450)
# torchvision vgg16 `features` index ranges of the lpips package's slices
LPIPS_SLICES = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (x.square().sum(1, keepdim=True).sqrt() + eps)


class LPIPS(nn.Module):
    """LPIPS(x, y) per sample, for (B, 3, H, W) RGB images in [0, 1]."""

    def __init__(self):
        super().__init__()
        self.net = VGGFeatureExtractor(LPIPS_VGG_LAYERS, 'vgg16',
                                       use_input_norm=False)
        for i, c in enumerate(LPIPS_VGG_CHANNELS):
            setattr(self, f'lin{i}', nn.Parameter(torch.full((c,), 1.0 / c)))
        self.register_buffer('shift', torch.tensor(LPIPS_SHIFT).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer('scale', torch.tensor(LPIPS_SCALE).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        fx = self.net((x * 2.0 - 1.0 - self.shift) / self.scale)
        fy = self.net((y * 2.0 - 1.0 - self.shift) / self.scale)
        total = torch.zeros(x.shape[0], device=x.device)
        for i, layer in enumerate(LPIPS_VGG_LAYERS):
            diff2 = (_unit_normalize(fx[layer].float())
                     - _unit_normalize(fy[layer].float())).square()
            val = torch.einsum('bchw,c->bhw', diff2, getattr(self, f'lin{i}'))
            total = total + val.mean(dim=(1, 2))
        return total


def convert_lpips_checkpoint(lpips_sd: Mapping[str, torch.Tensor],
                             vgg16_sd: Optional[Mapping[str, torch.Tensor]]
                             = None) -> Dict[str, torch.Tensor]:
    """lpips-package state dict (optionally with a separate torchvision
    vgg16 one for the backbone) -> LPIPS keys."""
    out = {}
    for i in range(len(LPIPS_VGG_LAYERS)):
        for key in (f'lin{i}.model.1.weight', f'lins.{i}.model.1.weight'):
            if key in lpips_sd:
                out[f'lin{i}'] = torch.as_tensor(lpips_sd[key]).float() \
                    .reshape(-1)
                break
        else:
            raise KeyError(f'lin{i} weight not found in LPIPS checkpoint')
    if vgg16_sd is None:
        vgg16_sd = {f'features.{k.split(".")[2]}.{k.rsplit(".", 1)[1]}': v
                    for k, v in lpips_sd.items() if k.startswith('net.slice')}
    out.update(convert_vgg_checkpoint(vgg16_sd, 'vgg16',
                                      prefix='net.vgg_net.'))
    return out


def lpips_package_state(model: LPIPS) -> Dict[str, torch.Tensor]:
    """An LPIPS module's weights in the lpips package's keys."""
    names = vgg_layer_names('vgg16')
    layers = dict(model.net.vgg_net.named_children())
    out = {}
    for k, (lo, hi) in enumerate(LPIPS_SLICES, start=1):
        for idx in range(lo, hi):
            if names[idx].startswith('conv'):
                conv = layers[names[idx]]
                out[f'net.slice{k}.{idx}.weight'] = conv.weight.detach()
                out[f'net.slice{k}.{idx}.bias'] = conv.bias.detach()
    for i in range(len(LPIPS_VGG_LAYERS)):
        out[f'lin{i}.model.1.weight'] = getattr(model, f'lin{i}').detach() \
            .reshape(1, -1, 1, 1)
    return out
