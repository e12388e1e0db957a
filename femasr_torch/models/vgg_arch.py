"""Frozen VGG feature extractor for the perceptual and semantic losses
(counterpart of femasr_tpu/models/vgg_arch.py).

Named-layer taps on VGG11/13/16/19, optional ImageNet input
normalization, truncated at the deepest requested layer. Weights load from
torchvision state dicts (`features.N.*`) with `convert_vgg_checkpoint`; no
torchvision needed. The compute dtype is the input's (the semantic loss
runs it in the generator's dtype, as the JAX trainer does): in bfloat16
the normalization constants, the conv weights and the biases are rounded
to bf16 and each op rounds, as flax's bf16 convs do. The _bn variants are
not ported (no configuration uses them).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Mapping, Sequence

import torch
from torch import nn

from ..ops.layers import Conv2d

VGG_CFGS = {
    'vgg11': [64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'],
    'vgg13': [64, 64, 'M', 128, 128, 'M', 256, 256, 'M', 512, 512, 'M', 512,
              512, 'M'],
    'vgg16': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M', 512, 512, 512,
              'M', 512, 512, 512, 'M'],
    'vgg19': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M', 512, 512,
              512, 512, 'M', 512, 512, 512, 512, 'M'],
}
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_layer_names(vgg_type: str) -> List[str]:
    """Ordered layer names ('conv1_1', 'relu1_1', ..., 'pool5'): the
    order of torchvision's `features`, one index per name."""
    if vgg_type not in VGG_CFGS:
        raise NotImplementedError(f'VGG type {vgg_type!r} is not ported')
    names = []
    block, conv_idx = 1, 0
    for v in VGG_CFGS[vgg_type]:
        if v == 'M':
            names.append(f'pool{block}')
            block += 1
            conv_idx = 0
        else:
            conv_idx += 1
            names.append(f'conv{block}_{conv_idx}')
            names.append(f'relu{block}_{conv_idx}')
    return names


class VGGFeatureExtractor(nn.Module):
    """VGG taps by layer name on (B, 3, H, W) RGB in [0, 1] (or [-1, 1]
    with range_norm). Layers live in `vgg_net` under their names."""

    def __init__(self, layer_name_list: Sequence[str],
                 vgg_type: str = 'vgg19', use_input_norm: bool = True,
                 range_norm: bool = False):
        super().__init__()
        self.layer_name_list = list(layer_name_list)
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        self.vgg_type = vgg_type
        names = vgg_layer_names(vgg_type)
        last = max(names.index(n) for n in self.layer_name_list)
        layers = OrderedDict()
        ch, widths = 3, iter(v for v in VGG_CFGS[vgg_type] if v != 'M')
        for name in names[:last + 1]:
            if name.startswith('conv'):
                out = next(widths)
                layers[name] = Conv2d(ch, out, 3, 1, 1)
                ch = out
            elif name.startswith('relu'):
                layers[name] = nn.ReLU()
            else:
                layers[name] = nn.MaxPool2d(2, 2)
        self.vgg_net = nn.Sequential(layers)
        self.register_buffer('mean', torch.tensor(IMAGENET_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer('std', torch.tensor(IMAGENET_STD).view(
            1, 3, 1, 1), persistent=False)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = (x - self.mean.to(x.dtype)) / self.std.to(x.dtype)
        out = {}
        wanted = set(self.layer_name_list)
        for name, layer in self.vgg_net.named_children():
            x = layer(x)
            if name in wanted:
                out[name] = x
        return out


def convert_vgg_checkpoint(torch_sd: Mapping[str, torch.Tensor],
                           vgg_type: str = 'vgg19',
                           prefix: str = 'vgg_net.'
                           ) -> Dict[str, torch.Tensor]:
    """torchvision VGG state dict (`features.N.*`) -> VGGFeatureExtractor
    keys (`vgg_net.<layer>.*`). Layers the checkpoint lacks are left out
    (truncation)."""
    out = {}
    for idx, name in enumerate(vgg_layer_names(vgg_type)):
        for leaf in ('weight', 'bias'):
            src = f'features.{idx}.{leaf}'
            if name.startswith('conv') and src in torch_sd:
                out[f'{prefix}{name}.{leaf}'] = torch.as_tensor(
                    torch_sd[src]).float()
    return out


def vgg_truncated_state(state_dict: Mapping[str, torch.Tensor],
                        model: VGGFeatureExtractor
                        ) -> Dict[str, torch.Tensor]:
    """The entries of a full-network state dict that a truncated extractor
    holds."""
    own = model.state_dict()
    return {k: v for k, v in state_dict.items() if k in own}


def torchvision_state(model: VGGFeatureExtractor
                      ) -> Dict[str, torch.Tensor]:
    """An extractor's weights in torchvision's `features.N.*` keys (the
    inverse of convert_vgg_checkpoint)."""
    index = {name: i for i, name in enumerate(vgg_layer_names(
        model.vgg_type))}
    return {f'features.{index[name]}.{leaf}': t.detach()
            for key, t in model.vgg_net.state_dict().items()
            for name, leaf in [key.split('.', 1)]}

