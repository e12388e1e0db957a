"""B1: 3x3 SAME conv with a GroupNorm-affine + activation prologue.

Kernel: csrc/conv3.cu (replaces femasr_tpu/ops/pallas/ws2d_conv.py
conv3_ws2d). `conv3` launches it for CUDA tensors and runs `conv3_plain`,
the same function in plain PyTorch, for CPU tensors.

Rounding points, as the JAX kernel's (ws2d_conv.py:156,235): the activated
input pre_act(x * scale + shift) and the weight are rounded to x.dtype
before the conv; the sums, the bias and the activation are f32, and the
output is rounded to x.dtype. In f32 the roundings are no-ops.

Routes on the card: bfloat16 at Ci = 64 with O = 64 or O <= 8 (the last
decoder level and out_conv of the release model) runs the tensor-core
kernel; float32, and bfloat16 at any other Ci and O, run the FFMA kernel,
with the same rounding points in bf16. The f32 sums are true f32 (TF32
would miss the f32 gates).

Tensors are NCHW in shape and channels_last in memory (the kernel reads
and writes NHWC in place).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build

_ACTS = {None: 0, 'silu': 1, 'lrelu': 2}
_DTYPES = (torch.float32, torch.bfloat16)
# csrc/conv3.cu routes
_FFMA_F32, _TC_BF16, _FFMA_BF16 = 0, 1, 2

launches = 0


def _act(y: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == 'silu':
        return F.silu(y)
    if act == 'lrelu':
        return F.leaky_relu(y, 0.2)
    return y


def conv3_plain(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                scale: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None,
                pre_act: Optional[str] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, arithmetic in f32.

    y = act(conv3x3_SAME(round(pre_act(x * scale + shift)), round(weight))
    + bias), round() to x.dtype; the zero padding applies after the
    prologue.
    """
    xf = x.float()
    if scale is not None:
        xf = xf * scale[:, :, None, None] + shift[:, :, None, None]
        xf = _act(xf, pre_act).to(x.dtype).float()
    y = F.conv2d(xf, weight.to(x.dtype).float(),
                 None if bias is None else bias.float(), padding=1)
    y = _act(y, act)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def _fn():
    lib = _build.load('conv3')
    fn = lib.femasr_conv3
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv3(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          scale: Optional[torch.Tensor] = None,
          shift: Optional[torch.Tensor] = None,
          pre_act: Optional[str] = None,
          act: Optional[str] = None) -> torch.Tensor:
    """act(conv3x3(pre_act(x * scale + shift), weight) + bias).

    x: (B, Ci, H, W) float32 or bfloat16, channels_last memory.
    weight: (O, Ci, 3, 3) float; bias: (O,) float or None.
    scale/shift: (B, Ci) float32 per-(sample, channel) affine or None.
    pre_act: None or 'silu' (applied after the affine); act: None, 'silu'
    or 'lrelu'. Returns (B, O, H, W) in x.dtype, channels_last memory.
    """
    if pre_act not in (None, 'silu') or act not in _ACTS:
        raise ValueError(f'unsupported pre_act={pre_act!r} act={act!r}')
    if (scale is None) != (shift is None):
        raise ValueError('scale and shift go together')
    _build.refuse_grad('conv3', x, weight, bias, scale, shift)
    if x.device.type == 'cpu':
        return conv3_plain(x, weight, bias, scale, shift, pre_act, act)
    if x.device.type != 'cuda':
        raise ValueError(f'conv3: unsupported device {x.device}')
    b, ci, h, w = x.shape
    o = weight.shape[0]
    if x.dtype not in _DTYPES:
        raise TypeError(f'conv3: unsupported dtype {x.dtype}')
    if tuple(weight.shape) != (o, ci, 3, 3):
        raise ValueError(f'conv3: weight {tuple(weight.shape)} for Ci={ci}')
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError('conv3: x must be channels_last contiguous')
    if x.dtype == torch.float32:
        route = _FFMA_F32
    elif ci == 64 and (o == 64 or o <= 8) and x.data_ptr() % 16 == 0:
        route = _TC_BF16
    else:
        route = _FFMA_BF16
    if route == _TC_BF16:
        # (9, OP, Ci) bf16, OP = 64 or 8 with zero rows past O
        wk = weight.detach().to(x.dtype).permute(2, 3, 0, 1).reshape(9, o, ci)
        wk = F.pad(wk, (0, 0, 0, (64 if o == 64 else 8) - o)).contiguous()
    else:
        # (Ci, 9, O) f32, rounded to x.dtype first
        wk = weight.detach().to(x.dtype).float().permute(1, 2, 3, 0)
        wk = wk.contiguous()
    bk = None if bias is None else bias.detach().float().contiguous()
    if scale is not None:
        scale = scale.float().contiguous()
        shift = shift.float().contiguous()
        if tuple(scale.shape) != (b, ci) or tuple(shift.shape) != (b, ci):
            raise ValueError('conv3: scale/shift must be (B, Ci)')
    for t in (wk, bk, scale, shift):
        if t is not None and t.device != x.device:
            raise ValueError('conv3: all tensors must be on one device')
    y = torch.empty((b, o, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)

    def p(t):
        return None if t is None else _build.ptr(t)

    err = _fn()(_build.ptr(x), _build.ptr(wk), p(bk), p(scale), p(shift),
                _build.ptr(y), b, h, w, ci, o,
                1 if pre_act == 'silu' else 0, _ACTS[act], route,
                _build.stream())
    _build.check(err, 'conv3 launch')
    global launches
    launches += 1
    return y
