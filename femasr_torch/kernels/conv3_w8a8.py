"""B6: w8a8 3x3 SAME conv with one per-tensor activation scale.

Kernel: csrc/conv3_w8a8.cu (replaces femasr_tpu/ops/pallas/int8_dense.py
conv3_w8a8). `conv3_w8a8` launches it for CUDA tensors and runs
`conv3_w8a8_plain`, the same function in plain PyTorch, for CPU tensors.

Tensors are NCHW in shape and channels_last in memory (the kernel reads and
writes NHWC in place), as for B1. The activation scale max|x| / 127 is
taken over the whole batch, as in the JAX kernel: a tiled chunk's tiles
share one scale. Weights (O, Ci, 3, 3) get per-O scales.

Routes on the card (`route_of`): Ci a multiple of 64 with O a multiple of
64 or O <= 8 (every conv of the int8 lane) runs on the int8 tensor cores,
with the weights packed by `pack_weight_tc`; any other shape runs the
`__dp4a` kernel. Both compute the same exact integer sums and epilogue.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from ._w8a8 import (ACTS, DTYPES, check_act, epilogue, quantize,
                    quantize_weight, tensor_scale)

launches = 0
# csrc/conv3_w8a8.cu routes
DP4A, TC = 0, 1
TC_CHUNK = 64   # input channels per chunk of the tensor-core route


def conv3_w8a8_plain(x: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None,
                     act: Optional[str] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch.

    The integer sums come from a float64 conv of the int8 codes (exact
    below 2^53), rounded to the nearest integer so that no conv algorithm's
    rounding can reach the f32 epilogue.
    """
    check_act(act, 'conv3_w8a8')
    w_q, s_w = quantize_weight(weight, (1, 2, 3))
    s_x = tensor_scale(x)
    acc = torch.round(F.conv2d(quantize(x, s_x).double(), w_q.double(),
                               padding=1))
    y = epilogue(acc, (s_x * s_w)[:, None, None],
                 None if bias is None else bias[:, None, None], act)
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


def route_of(ci: int, o: int, x_ptr: int) -> int:
    """The kernel a (Ci -> O) conv of x at address x_ptr runs on."""
    if ci % TC_CHUNK == 0 and (o % 64 == 0 or o <= 8) and x_ptr % 16 == 0:
        return TC
    return DP4A


def pack_weight_tc(w_q: torch.Tensor) -> torch.Tensor:
    """(O, Ci, 3, 3) int8 codes -> the tensor-core route's layout
    (O tiles, Ci / 64, 9, OT, 64): OT = 64 output channels per tile, or one
    tile of 8 with zero rows past O when O <= 8; tap = 3 * ky + kx. Each
    (O tile, Ci chunk) is one contiguous slab of 9 * OT * 64 bytes."""
    o, ci = w_q.shape[:2]
    ot = 8 if o <= 8 else 64
    n_ot = -(-o // ot)
    wk = w_q.permute(2, 3, 0, 1).reshape(9, o, ci)
    wk = F.pad(wk, (0, 0, 0, n_ot * ot - o))
    wk = wk.reshape(9, n_ot, ot, ci // TC_CHUNK, TC_CHUNK)
    return wk.permute(1, 3, 0, 2, 4).contiguous()


def _fn():
    lib = _build.load('conv3_w8a8')
    fn = lib.femasr_conv3_w8a8
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def conv3_w8a8(x: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor] = None,
               act: Optional[str] = None) -> torch.Tensor:
    """act(dequant(conv3x3(round(x / s_x), w_q)) + bias), int32 sums.

    x: (B, Ci, H, W) float32 or bfloat16, channels_last memory.
    weight: (O, Ci, 3, 3) float; bias: (O,) float or None. act: None,
    'gelu' (tanh form), 'silu' or 'lrelu'. Returns (B, O, H, W) in x.dtype,
    channels_last memory.
    """
    check_act(act, 'conv3_w8a8')
    if x.device.type == 'cpu':
        return conv3_w8a8_plain(x, weight, bias, act)
    if x.device.type != 'cuda':
        raise ValueError(f'conv3_w8a8: unsupported device {x.device}')
    if x.dtype not in DTYPES:
        raise TypeError(f'conv3_w8a8: unsupported dtype {x.dtype}')
    b, ci, h, w = x.shape
    o = weight.shape[0]
    if tuple(weight.shape) != (o, ci, 3, 3):
        raise ValueError(f'conv3_w8a8: weight {tuple(weight.shape)} for '
                         f'Ci={ci}')
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError('conv3_w8a8: x must be channels_last contiguous')
    w_q, s_w = quantize_weight(weight, (1, 2, 3))
    route = route_of(ci, o, x.data_ptr())
    if route == TC:
        wk = pack_weight_tc(w_q)
    else:
        wk = w_q.permute(2, 3, 0, 1).reshape(9, o, ci).contiguous()
    s_x = tensor_scale(x)
    bk = None if bias is None else bias.detach().float().contiguous()
    for t in (wk, bk):
        if t is not None and t.device != x.device:
            raise ValueError('conv3_w8a8: all tensors must be on one device')
    y = torch.empty((b, o, h, w), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    err = _fn()(_build.ptr(x), _build.ptr(wk), _build.ptr(s_x),
                _build.ptr(s_w), None if bk is None else _build.ptr(bk),
                _build.ptr(y), b, h, w, ci, o, ACTS[act], DTYPES[x.dtype],
                route, _build.stream())
    _build.check(err, 'conv3_w8a8 launch')
    global launches
    launches += 1
    return y
