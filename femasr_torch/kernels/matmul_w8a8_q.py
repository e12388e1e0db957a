"""B5: per-token w8a8 dense, one link of the int8 chain.

Kernel: csrc/matmul_w8a8_q.cu (replaces femasr_tpu/ops/pallas/int8_dense.py
matmul_w8a8_q). `matmul_w8a8_q` launches it for CUDA tensors and runs
`matmul_w8a8_q_plain`, the same function in plain PyTorch, for CPU
tensors.

The input is int8 with per-row f32 scales (…, 1) (from `quantize_rows` or
the previous link); the weight is in nn.Linear layout (N, K). With
out_int8 the output is re-quantized per row from the epilogue (the row max
runs over all N columns), so the chain moves int8 between links.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from . import _build
from ._w8a8 import (ACTS, DTYPES, check_act, epilogue, int_matmul, quantize,
                    quantize_weight, scale_of)

launches = 0

MAX_N_INT8 = 1024  # out_int8: a block keeps its rows' N results on chip


def matmul_w8a8_q_plain(x_q: torch.Tensor, s_x: torch.Tensor,
                        weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        act: Optional[str] = None, out_int8: bool = False,
                        out_dtype: torch.dtype = torch.bfloat16
                        ) -> Union[torch.Tensor,
                                   Tuple[torch.Tensor, torch.Tensor]]:
    """The kernel's function in plain PyTorch (exact integer sums)."""
    check_act(act, 'matmul_w8a8_q')
    lead = x_q.shape[:-1]
    n = weight.shape[0]
    x2 = x_q.reshape(-1, x_q.shape[-1])
    w_q, s_w = quantize_weight(weight, 1)
    scale = s_x.reshape(-1, 1).float() * s_w
    y = epilogue(int_matmul(x2, w_q), scale, bias, act)
    if out_int8:
        s_y = scale_of(y.abs().amax(dim=-1, keepdim=True))
        return quantize(y, s_y).reshape(*lead, n), s_y.reshape(*lead, 1)
    return y.to(out_dtype).reshape(*lead, n)


def _fn():
    lib = _build.load('matmul_w8a8_q')
    fn = lib.femasr_matmul_w8a8_q
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def matmul_w8a8_q(x_q: torch.Tensor, s_x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  act: Optional[str] = None, out_int8: bool = False,
                  out_dtype: torch.dtype = torch.bfloat16
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """act(acc * (s_x[row] * s_w[col]) + bias) on int8 input.

    x_q: (..., K) int8; s_x: (..., 1) float32 row scales. weight: (N, K)
    float; bias: (N,) float or None. act: None, 'gelu' (tanh form), 'silu'
    or 'lrelu'. Returns (..., N) in out_dtype (float32 or bfloat16), or
    with out_int8 the pair (y_q (..., N) int8, s_y (..., 1) float32),
    N <= 1024.
    """
    check_act(act, 'matmul_w8a8_q')
    if x_q.device.type == 'cpu':
        return matmul_w8a8_q_plain(x_q, s_x, weight, bias, act, out_int8,
                                   out_dtype)
    if x_q.device.type != 'cuda':
        raise ValueError(f'matmul_w8a8_q: unsupported device {x_q.device}')
    if x_q.dtype != torch.int8:
        raise TypeError(f'matmul_w8a8_q: x_q must be int8, got {x_q.dtype}')
    if not out_int8 and out_dtype not in DTYPES:
        raise TypeError(f'matmul_w8a8_q: unsupported out_dtype {out_dtype}')
    lead = x_q.shape[:-1]
    k = x_q.shape[-1]
    n = weight.shape[0]
    if weight.dim() != 2 or weight.shape[1] != k:
        raise ValueError(f'matmul_w8a8_q: weight {tuple(weight.shape)} for '
                         f'K={k}')
    if tuple(s_x.shape) != tuple(lead) + (1,):
        raise ValueError(f'matmul_w8a8_q: s_x {tuple(s_x.shape)} for x_q '
                         f'{tuple(x_q.shape)}')
    if out_int8 and n > MAX_N_INT8:
        raise ValueError(f'matmul_w8a8_q: out_int8 takes N <= {MAX_N_INT8}')
    x2 = x_q.reshape(-1, k).contiguous()
    sx = s_x.reshape(-1).float().contiguous()
    m = x2.shape[0]
    w_q, s_w = quantize_weight(weight, 1)
    bk = None if bias is None else bias.detach().float().contiguous()
    for t in (sx, w_q, bk):
        if t is not None and t.device != x_q.device:
            raise ValueError('matmul_w8a8_q: all tensors must be on one '
                             'device')
    dev = x_q.device
    if out_int8:
        y_q = torch.empty((m, n), dtype=torch.int8, device=dev)
        s_y = torch.empty((m,), dtype=torch.float32, device=dev)
        y, dtype_code = None, 0
        outs = (None, _build.ptr(y_q), _build.ptr(s_y))
    else:
        y = torch.empty((m, n), dtype=out_dtype, device=dev)
        dtype_code = DTYPES[out_dtype]
        outs = (_build.ptr(y), None, None)
    if m:
        err = _fn()(_build.ptr(x2), _build.ptr(sx), _build.ptr(w_q),
                    _build.ptr(s_w), None if bk is None else _build.ptr(bk),
                    *outs, m, n, k, ACTS[act], int(out_int8), dtype_code,
                    _build.stream())
        _build.check(err, 'matmul_w8a8_q launch')
        global launches
        launches += 1
    if out_int8:
        return y_q.reshape(*lead, n), s_y.reshape(*lead, 1)
    return y.reshape(*lead, n)
