"""B4: w8a8 dense with a per-tensor activation scale.

Kernel: csrc/matmul_w8a8.cu (replaces femasr_tpu/ops/pallas/int8_dense.py
matmul_w8a8). `matmul_w8a8` launches it for CUDA tensors and runs
`matmul_w8a8_plain`, the same function in plain PyTorch, for CPU tensors.

The weight is in torch nn.Linear layout (N, K), so its per-column scales
(the JAX kernel's (K, N) columns) reduce over dim 1. Weight quantization
and max|x| (one inf-norm pass) are computed outside the kernel, in plain
PyTorch, as the JAX package leaves them to XLA; the kernel takes s_x =
max(max|x| / 127, 1e-12) from that maximum and quantizes x while it
stages it.

Routes on the card (`route_of`): K and N multiples of 64, K <= 2048, with
a 16-byte aligned x (the Swin qkv and proj of the int8 lane) run on the
int8 tensor cores, with the weights quantized and packed by B5's
`weight_tc` (the same layout); any other shape runs the `__dp4a` kernel.
Both compute the same exact integer sums and epilogue. A caller that holds
frozen weights (`ops.layers.LinearInt8`) passes its packed copy as
`packed`; without one the wrapper packs the weight on every call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from ._w8a8 import (ACTS, DTYPES, check_act, epilogue, int_matmul, quantize,
                    quantize_weight, tensor_scale)
from .matmul_w8a8_q import TC_CHUNK, TC_WARP_COLS, tc_operands

launches = 0
# csrc/matmul_w8a8.cu routes
DP4A, TC = 0, 1
# the tensor-core route keeps a block's 64 rows of x, all of K, in shared
# memory beside the weight ring and the f32 output staging (227 KB)
MAX_K_TC = 2048


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


def route_of(k: int, n: int, x_ptr: int) -> int:
    """The kernel a (K -> N) product of x at address x_ptr runs on."""
    if (k % TC_CHUNK == 0 and n % TC_WARP_COLS == 0 and 0 < k <= MAX_K_TC
            and x_ptr % 16 == 0):
        return TC
    return DP4A


@functools.lru_cache(maxsize=None)
def _fn():
    lib = _build.load('matmul_w8a8')
    fn = lib.femasr_matmul_w8a8
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def matmul_w8a8(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                act: Optional[str] = None,
                packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """act(dequant(round(x / s_x) @ w_q^T) + bias), w8a8 with int32 sums.

    x: (..., K) float32 or bfloat16. weight: (N, K) float; bias: (N,) float
    or None. act: None, 'gelu' (tanh form), 'silu' or 'lrelu'. packed:
    `matmul_w8a8_q.weight_tc(weight)`, used on the tensor-core route (None:
    computed here). Returns (..., N) in x.dtype.
    """
    check_act(act, 'matmul_w8a8')
    _build.refuse_grad('matmul_w8a8', x, weight, bias)
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
    route = route_of(k, n, x2.data_ptr())
    if route == DP4A:
        w_q, s_w = quantize_weight(weight, 1)
    else:
        w_q, s_w = tc_operands(weight, packed, 'matmul_w8a8')
    # max|x| in x's dtype (exact): the kernel divides it by 127
    amax = torch.linalg.vector_norm(x2.detach(), float('inf'))
    bk = None if bias is None else bias.detach().float().contiguous()
    for t in (w_q, s_w, bk):
        if t is not None and t.device != x.device:
            raise ValueError('matmul_w8a8: all tensors must be on one device')
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y.reshape(*x.shape[:-1], n)
    err = _fn()(_build.ptr(x2), _build.ptr(w_q), _build.ptr(amax),
                _build.ptr(s_w), None if bk is None else _build.ptr(bk),
                _build.ptr(y), m, n, k, ACTS[act], DTYPES[x.dtype], route,
                _build.stream())
    _build.check(err, 'matmul_w8a8 launch')
    global launches
    launches += 1
    return y.reshape(*x.shape[:-1], n)
