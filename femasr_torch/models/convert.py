"""Parameter conversion: JAX (flax) params -> torch state dicts, and
reference-format checkpoint loading (strict, or overlaid onto a seeded
init as the JAX package's merge_params does).

`femasr_param_mapping` is this package's copy of the flax-path -> torch-key
table of femasr_tpu/models/convert.py (`swinir_param_mapping` SwinIR's);
`from_flax` (`swinir_from_flax`) applies it backwards:
conv kernels (kh, kw, I, O) -> (O, I, kh, kw), dense kernels (I, O) ->
(O, I), norm scale -> weight. `discriminator_from_flax`, `vgg_from_flax`,
`lpips_from_flax` and `inception_from_flax` carry the training and metric
networks' trees the same way.
Checkpoints: the generator and the discriminator are saved and loaded in
the reference's torch keys ({'params': ..., 'params_ema': ...} .pth files;
the discriminator's spectral u / v as `conv{i}.weight_u` / `weight_v`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..parallel.mesh import local_state

# derived buffers that reference checkpoints carry beside the parameters
_BUFFER_SUFFIXES = ('relative_position_index', 'attn_mask')


def _conv_w(x: np.ndarray) -> np.ndarray:      # (kh, kw, I, O) -> (O, I, kh, kw)
    return np.ascontiguousarray(x.transpose(3, 2, 0, 1))


def _lin_w(x: np.ndarray) -> np.ndarray:       # (I, O) -> (O, I)
    return np.ascontiguousarray(x.T)


def _ident(x: np.ndarray) -> np.ndarray:
    return np.asarray(x)


Mapping_ = Dict[Tuple[str, ...], Tuple[str, Any]]


def _resblock_entries(fp: Tuple[str, ...], tp: str, act_type: str) -> Mapping_:
    m = {
        fp + ('norm1', 'norm', 'scale'): (f'{tp}.conv.0.norm.weight', _ident),
        fp + ('norm1', 'norm', 'bias'): (f'{tp}.conv.0.norm.bias', _ident),
        fp + ('conv1', 'kernel'): (f'{tp}.conv.2.weight', _conv_w),
        fp + ('conv1', 'bias'): (f'{tp}.conv.2.bias', _ident),
        fp + ('norm2', 'norm', 'scale'): (f'{tp}.conv.3.norm.weight', _ident),
        fp + ('norm2', 'norm', 'bias'): (f'{tp}.conv.3.norm.bias', _ident),
        fp + ('conv2', 'kernel'): (f'{tp}.conv.5.weight', _conv_w),
        fp + ('conv2', 'bias'): (f'{tp}.conv.5.bias', _ident),
    }
    if act_type == 'prelu':
        m[fp + ('act1', 'alpha')] = (f'{tp}.conv.1.func.weight', _ident)
        m[fp + ('act2', 'alpha')] = (f'{tp}.conv.4.func.weight', _ident)
    return m


def _conv_entries(fp: Tuple[str, ...], tp: str) -> Mapping_:
    return {fp + ('kernel',): (f'{tp}.weight', _conv_w),
            fp + ('bias',): (f'{tp}.bias', _ident)}


def _swin_block_entries(fp: Tuple[str, ...], tp: str) -> Mapping_:
    m: Mapping_ = {}
    for n in ('norm1', 'norm2'):
        m[fp + (n, 'scale')] = (f'{tp}.{n}.weight', _ident)
        m[fp + (n, 'bias')] = (f'{tp}.{n}.bias', _ident)
    m[fp + ('attn', 'relative_position_bias_table')] = (
        f'{tp}.attn.relative_position_bias_table', _ident)
    for sub, key in (('attn', 'qkv'), ('attn', 'proj'), ('mlp', 'fc1'),
                     ('mlp', 'fc2')):
        m[fp + (sub, key, 'kernel')] = (f'{tp}.{sub}.{key}.weight', _lin_w)
        m[fp + (sub, key, 'bias')] = (f'{tp}.{sub}.{key}.bias', _ident)
    return m


def femasr_param_mapping(codebook_params, gt_resolution: int = 256,
                         LQ_stage: bool = False, scale_factor: int = 4,
                         act_type: str = 'silu',
                         use_semantic_loss: bool = False, swin_depth: int = 6
                         ) -> Mapping_:
    """Flax path -> (torch key, flax-to-torch transform) for FeMaSRNet."""
    eff_scale = scale_factor if LQ_stage else 1
    scales = [int(p[0]) for p in codebook_params]
    max_depth = int(math.log2(gt_resolution // scales[0]))
    encode_depth = int(math.log2(gt_resolution // eff_scale // scales[0]))

    m: Mapping_ = {}
    enc = ('multiscale_encoder',)
    m.update(_conv_entries(enc + ('in_conv',), 'multiscale_encoder.in_conv'))
    idx = 0
    for _ in range(encode_depth):
        fb, tb = enc + (f'blocks_{idx}',), f'multiscale_encoder.blocks.{idx}'
        m.update(_conv_entries(fb + ('conv',), f'{tb}.0'))
        m.update(_resblock_entries(fb + ('res1',), f'{tb}.1', act_type))
        m.update(_resblock_entries(fb + ('res2',), f'{tb}.2', act_type))
        idx += 1
    if LQ_stage:
        fb, tb = enc + (f'blocks_{idx}',), f'multiscale_encoder.blocks.{idx}'
        for j in range(4):
            for k in range(swin_depth):
                m.update(_swin_block_entries(
                    fb + (f'swin_blks_{j}', 'residual_group', f'blocks_{k}'),
                    f'{tb}.swin_blks.{j}.residual_group.blocks.{k}'))
            m.update(_conv_entries(fb + (f'swin_blks_{j}', 'conv'),
                                   f'{tb}.swin_blks.{j}.conv'))
        idx += 1
        for _ in range(2):
            fb = enc + (f'blocks_{idx}',)
            tb = f'multiscale_encoder.blocks.{idx}'
            m.update(_conv_entries(fb + ('conv',), f'{tb}.1'))
            m.update(_resblock_entries(fb + ('res1',), f'{tb}.2', act_type))
            m.update(_resblock_entries(fb + ('res2',), f'{tb}.3', act_type))
            idx += 1
    for i in range(max_depth):
        fb, tb = (f'decoder_group_{i}',), f'decoder_group.{i}.block'
        m.update(_conv_entries(fb + ('conv',), f'{tb}.1'))
        m.update(_resblock_entries(fb + ('res1',), f'{tb}.2', act_type))
        m.update(_resblock_entries(fb + ('res2',), f'{tb}.3', act_type))
    m.update(_conv_entries(('out_conv',), 'out_conv'))
    for s in range(len(codebook_params)):
        m[(f'quantize_group_{s}', 'embedding')] = (
            f'quantize_group.{s}.embedding.weight', _ident)
        m.update(_conv_entries((f'before_quant_group_{s}',),
                               f'before_quant_group.{s}'))
        m.update(_conv_entries((f'after_quant_group_{s}', 'conv'),
                               f'after_quant_group.{s}.conv'))
    if use_semantic_loss:
        m.update(_conv_entries(('conv_semantic',), 'conv_semantic.0'))
    return m


def from_flax(params: Mapping[str, Any], codebook_params,
              **arch_kwargs) -> Dict[str, torch.Tensor]:
    """JAX params (nested dict of arrays) -> torch FeMaSRNet state dict.

    arch_kwargs: gt_resolution, LQ_stage, scale_factor, act_type,
    use_semantic_loss as for femasr_param_mapping. Raises KeyError on a
    missing flax path.
    """
    return _apply(params, femasr_param_mapping(codebook_params,
                                               **arch_kwargs))


def swinir_param_mapping(depths=(6, 6, 6, 6), upsampler: str = '',
                         upscale: int = 2, patch_norm: bool = True,
                         ape: bool = False) -> Mapping_:
    """Flax path -> (torch key, flax-to-torch transform) for SwinIR: the
    inverse of femasr_tpu/models/swinir_arch.py convert_swinir_checkpoint,
    with every upsampler's keys (resi_connection '1conv')."""
    m: Mapping_ = {}
    m.update(_conv_entries(('conv_first',), 'conv_first'))
    if patch_norm:
        m[('patch_embed_norm', 'scale')] = ('patch_embed.norm.weight', _ident)
        m[('patch_embed_norm', 'bias')] = ('patch_embed.norm.bias', _ident)
    if ape:
        m[('absolute_pos_embed',)] = ('absolute_pos_embed', _ident)
    for i, depth in enumerate(depths):
        for k in range(depth):
            m.update(_swin_block_entries(
                (f'layers_{i}', 'residual_group', f'blocks_{k}'),
                f'layers.{i}.residual_group.blocks.{k}'))
        m.update(_conv_entries((f'layers_{i}', 'conv'), f'layers.{i}.conv'))
    m[('norm', 'scale')] = ('norm.weight', _ident)
    m[('norm', 'bias')] = ('norm.bias', _ident)
    m.update(_conv_entries(('conv_after_body',), 'conv_after_body'))
    if upsampler in ('pixelshuffle', 'nearest+conv'):
        m.update(_conv_entries(('conv_before_upsample',),
                               'conv_before_upsample.0'))
    if upsampler == 'pixelshuffle':
        steps = (1 if upscale == 3 else int(math.log2(upscale)))
        for i in range(steps):
            m.update(_conv_entries(('upsample', f'conv_{i}'),
                                   f'upsample.{2 * i}'))
    elif upsampler == 'pixelshuffledirect':
        m.update(_conv_entries(('upsample_conv',), 'upsample.0'))
    elif upsampler == 'nearest+conv':
        for name in ('conv_up1', 'conv_up2', 'conv_hr'):
            m.update(_conv_entries((name,), name))
    if upsampler != 'pixelshuffledirect':
        m.update(_conv_entries(('conv_last',), 'conv_last'))
    return m


def swinir_from_flax(params: Mapping[str, Any],
                     **arch_kwargs) -> Dict[str, torch.Tensor]:
    """JAX SwinIR params (nested dict of arrays) -> the port's SwinIR state
    dict; arch_kwargs as for swinir_param_mapping."""
    return _apply(params, swinir_param_mapping(**arch_kwargs))


def _apply(tree: Mapping[str, Any], mapping: Mapping_
           ) -> Dict[str, torch.Tensor]:
    sd = {}
    for path, (key, to_torch) in mapping.items():
        node = tree
        for p in path:
            node = node[p]
        sd[key] = torch.from_numpy(
            to_torch(np.asarray(node, dtype=np.float32)).copy())
    return sd


def discriminator_from_flax(params: Mapping[str, Any],
                            spectral: Mapping[str, Any]
                            ) -> Dict[str, torch.Tensor]:
    """JAX UNetDiscriminatorSN params + its 'spectral' collection -> the
    port's (and the reference's) state dict."""
    m: Mapping_ = {}
    for i in (0, 9):
        m.update(_conv_entries((f'conv{i}',), f'conv{i}'))
    for i in range(1, 9):
        m[(f'conv{i}', 'kernel')] = (f'conv{i}.weight_orig', _conv_w)
    sd = _apply(params, m)
    for i in range(1, 9):
        for leaf in ('u', 'v'):
            sd[f'conv{i}.weight_{leaf}'] = torch.from_numpy(np.array(
                spectral[f'conv{i}'][leaf], dtype=np.float32))
    return sd


def vgg_from_flax(params: Mapping[str, Any], prefix: str = 'vgg_net.'
                  ) -> Dict[str, torch.Tensor]:
    """JAX VGGFeatureExtractor params -> VGGFeatureExtractor keys."""
    m: Mapping_ = {}
    for name in params:
        m.update(_conv_entries((name,), prefix + name))
    return _apply(params, m)


def lpips_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX LPIPS params -> the port's LPIPS keys."""
    sd = vgg_from_flax(params['net'], prefix='net.vgg_net.')
    for i in range(5):
        sd[f'lin{i}'] = torch.from_numpy(np.array(params[f'lin{i}'],
                                                  dtype=np.float32))
    return sd


def load_torch_checkpoint(path: str, param_key: Optional[str] = 'params'
                          ) -> Dict[str, torch.Tensor]:
    """Load a reference-format .pth ({'params': sd} or {'params_ema': sd}).

    Derived buffers (relative_position_index, attn_mask) are dropped: the
    port recomputes them.
    """
    ckpt = torch.load(path, map_location='cpu', weights_only=True)
    if param_key is not None and param_key in ckpt:
        ckpt = ckpt[param_key]
    elif 'params_ema' in ckpt:
        ckpt = ckpt['params_ema']
    return {k: v for k, v in ckpt.items()
            if not k.endswith(_BUFFER_SUFFIXES)}


def merge_state_dict(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                     init: Callable[[nn.Module], Any]) -> Dict[str, int]:
    """Overlay a state dict onto `model` as femasr_tpu's merge_params
    overlays loaded params onto a fresh init (non-strict load parity with
    the reference's base_model.py): a key the model lacks is ignored, a
    tensor of another shape is skipped, and a parameter that is missing or
    skipped keeps the value `init(model)` gives it. Returns the counts of
    unused, missing and skipped keys, and prints them in one line when any
    is nonzero. A tensor-parallel model takes its part of each split
    parameter (`parallel.mesh.local_state`)."""
    state_dict = local_state(model, state_dict)
    own = model.state_dict()
    unused = [k for k in state_dict if k not in own]
    skipped = [k for k in state_dict if k in own
               and tuple(state_dict[k].shape) != tuple(own[k].shape)]
    missing = [k for k in own if k not in state_dict]
    if missing or skipped:
        init(model)
    model.load_state_dict({k: v for k, v in state_dict.items()
                           if k in own and k not in skipped}, strict=False)
    counts = dict(unused=len(unused), missing=len(missing),
                  skipped=len(skipped))
    if unused or missing or skipped:
        print(f'[convert] non-strict load: {len(unused)} unused, '
              f'{len(missing)} missing (init kept), {len(skipped)} skipped '
              f'(shape mismatch); e.g. {(unused + missing + skipped)[:3]}')
    return counts


def inception_from_flax(params: Mapping[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """JAX InceptionV3FID params -> the port's InceptionV3FID state dict
    (pt_inception keys)."""
    flat: Dict[str, np.ndarray] = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, Mapping):
                walk(v, path + (k,))
            else:
                flat['/'.join(path + (k,))] = np.asarray(v, np.float32)
    walk(params, ())
    leaf = {'conv/kernel': ('conv.weight', _conv_w),
            'bn_scale': ('bn.weight', _ident),
            'bn_bias': ('bn.bias', _ident),
            'bn_mean': ('bn.running_mean', _ident),
            'bn_var': ('bn.running_var', _ident)}
    sd = {}
    for path, val in flat.items():
        for suffix, (key, to_torch) in leaf.items():
            if path.endswith('/' + suffix):
                prefix = path[:-len(suffix) - 1].replace('/', '.')
                sd[f'{prefix}.{key}'] = torch.from_numpy(
                    to_torch(val).copy())
                break
        else:
            raise KeyError(f'unexpected inception param {path}')
    return sd
