"""B4: w8a8 dense with a per-tensor activation scale.

Kernel: csrc/matmul_w8a8.cu (replaces femasr_tpu/ops/pallas/int8_dense.py
matmul_w8a8). `matmul_w8a8` launches it for CUDA tensors and runs
`matmul_w8a8_plain`, the same function in plain PyTorch, for CPU tensors.

The weight is in torch nn.Linear layout (N, K), so its per-column scales
(the JAX kernel's (K, N) columns) reduce over dim 1. Weight quantization
and the activation scale max|x| / 127 are computed outside the kernel, in
plain PyTorch, as the JAX package leaves them to XLA; the kernel quantizes
x while it stages it.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from ._w8a8 import (ACTS, DTYPES, check_act, epilogue, int_matmul, quantize,
                    quantize_weight, tensor_scale)

launches = 0


def matmul_w8a8_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None,
                      act: Optional[str] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch (exact integer sums)."""
    check_act(act, 'matmul_w8a8')
    x2 = x.reshape(-1, x.shape[-1])
    w_q, s_w = quantize_weight(weight, 1)
    s_x = tensor_scale(x2)
    y = epilogue(int_matmul(quantize(x2, s_x), w_q), s_x * s_w, bias, act)
    return y.to(x.dtype).reshape(*x.shape[:-1], weight.shape[0])


def _fn():
    lib = _build.load('matmul_w8a8')
    fn = lib.femasr_matmul_w8a8
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def matmul_w8a8(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None) -> torch.Tensor:
    """act(dequant(round(x / s_x) @ w_q^T) + bias), w8a8 with int32 sums.

    x: (..., K) float32 or bfloat16. weight: (N, K) float; bias: (N,) float
    or None. act: None, 'gelu' (tanh form), 'silu' or 'lrelu'. Returns
    (..., N) in x.dtype.
    """
    check_act(act, 'matmul_w8a8')
    if x.device.type == 'cpu':
        return matmul_w8a8_plain(x, weight, bias, act)
    if x.device.type != 'cuda':
        raise ValueError(f'matmul_w8a8: unsupported device {x.device}')
    if x.dtype not in DTYPES:
        raise TypeError(f'matmul_w8a8: unsupported dtype {x.dtype}')
    k = x.shape[-1]
    n = weight.shape[0]
    if weight.dim() != 2 or weight.shape[1] != k:
        raise ValueError(f'matmul_w8a8: weight {tuple(weight.shape)} for '
                         f'K={k}')
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    w_q, s_w = quantize_weight(weight, 1)
    s_x = tensor_scale(x2)
    bk = None if bias is None else bias.detach().float().contiguous()
    for t in (w_q, bk):
        if t is not None and t.device != x.device:
            raise ValueError('matmul_w8a8: all tensors must be on one device')
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y.reshape(*x.shape[:-1], n)
    err = _fn()(_build.ptr(x2), _build.ptr(w_q), _build.ptr(s_x),
                _build.ptr(s_w), None if bk is None else _build.ptr(bk),
                _build.ptr(y), m, n, k, ACTS[act], DTYPES[x.dtype],
                _build.stream())
    _build.check(err, 'matmul_w8a8 launch')
    global launches
    launches += 1
    return y.reshape(*x.shape[:-1], n)
