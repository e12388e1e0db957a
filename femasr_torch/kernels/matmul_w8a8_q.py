"""B5: per-token w8a8 dense, one link of the int8 chain.

Kernel: csrc/matmul_w8a8_q.cu (replaces femasr_tpu/ops/pallas/int8_dense.py
matmul_w8a8_q). `matmul_w8a8_q` launches it for CUDA tensors and runs
`matmul_w8a8_q_plain`, the same function in plain PyTorch, for CPU
tensors.

The input is int8 with per-row f32 scales (…, 1) (from `quantize_rows` or
the previous link); the weight is in nn.Linear layout (N, K). With
out_int8 the output is re-quantized per row from the epilogue (the row max
runs over all N columns), so the chain moves int8 between links.

Routes on the card (`route_of`): K and N multiples of 64 with 16-byte
aligned x_q (fc1 and fc2 of the int8 lane) run on the int8 tensor cores,
with the weights packed by `pack_weight_tc`; any other shape runs the
`__dp4a` kernel. Both compute the same exact integer sums and epilogue.
The tensor-core route takes the weight quantized and packed by `weight_tc`:
a caller that holds frozen weights (`ops.layers.LinearInt8`) passes its
copy as `packed`; without one the wrapper packs the weight on every call.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from . import _build
from ._w8a8 import (ACTS, DTYPES, check_act, epilogue, int_matmul, quantize,
                    quantize_weight, scale_of)

launches = 0
# csrc/matmul_w8a8_q.cu routes
DP4A, TC = 0, 1
TC_CHUNK = 64   # K bytes per chunk of the tensor-core route
TC_WARP_COLS = 64   # output columns of one warp
TC_COLS = 256   # output columns of one block (a cluster spans a row's N)
# out_int8: a row's N results stay on chip (the dp4a kernel's shared
# memory; on the tensor cores, a cluster of at most 4 blocks)
MAX_N_INT8 = 1024


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


def route_of(k: int, n: int, x_ptr: int) -> int:
    """The kernel a (K -> N) product of x_q at address x_ptr runs on."""
    if k % TC_CHUNK == 0 and n % TC_WARP_COLS == 0 and x_ptr % 16 == 0:
        return TC
    return DP4A


def pack_weight_tc(w_q: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 codes -> the tensor-core route's layout (N tiles, K / 64,
    256, 64), zero rows past N: each (N tile, K chunk) is one contiguous
    slab of 256 x 64 bytes."""
    n, k = w_q.shape
    n_t = -(-n // TC_COLS)
    wk = F.pad(w_q, (0, 0, 0, n_t * TC_COLS - n))
    wk = wk.reshape(n_t, TC_COLS, k // TC_CHUNK, TC_CHUNK)
    return wk.permute(0, 2, 1, 3).contiguous()


def weight_tc(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core route's weight operands of an (N, K) float weight:
    `pack_weight_tc` of its int8 codes, and its f32 scales s_w (N,)."""
    w_q, s_w = quantize_weight(weight, 1)
    return pack_weight_tc(w_q), s_w


def tc_operands(weight: torch.Tensor,
                packed: Optional[Tuple[torch.Tensor, torch.Tensor]],
                what: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core route's (packed codes, s_w) of an (N, K) weight:
    `packed` after a check of its layout, or `weight_tc(weight)`."""
    n, k = weight.shape
    w_q, s_w = weight_tc(weight) if packed is None else packed
    want = (-(-n // TC_COLS), k // TC_CHUNK, TC_COLS, TC_CHUNK)
    if (tuple(w_q.shape) != want or w_q.dtype != torch.int8
            or tuple(s_w.shape) != (n,) or s_w.dtype != torch.float32
            or not w_q.is_contiguous()):
        raise ValueError(f'{what}: packed weight {w_q.dtype} '
                         f'{tuple(w_q.shape)}, {s_w.dtype} '
                         f'{tuple(s_w.shape)} for ({n}, {k})')
    return w_q, s_w


def _fn():
    lib = _build.load('matmul_w8a8_q')
    fn = lib.femasr_matmul_w8a8_q
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def matmul_w8a8_q(x_q: torch.Tensor, s_x: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  act: Optional[str] = None, out_int8: bool = False,
                  out_dtype: torch.dtype = torch.bfloat16,
                  packed: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                  ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """act(acc * (s_x[row] * s_w[col]) + bias) on int8 input.

    x_q: (..., K) int8; s_x: (..., 1) float32 row scales. weight: (N, K)
    float; bias: (N,) float or None. act: None, 'gelu' (tanh form), 'silu'
    or 'lrelu'. packed: `weight_tc(weight)`, used on the tensor-core route
    (None: computed here). Returns (..., N) in out_dtype (float32 or
    bfloat16), or with out_int8 the pair (y_q (..., N) int8, s_y (..., 1)
    float32), N <= 1024.
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
    route = route_of(k, n, x2.data_ptr())
    if route == DP4A:
        w_q, s_w = quantize_weight(weight, 1)
    else:
        w_q, s_w = tc_operands(weight, packed, 'matmul_w8a8_q')
    bk = None if bias is None else bias.detach().float().contiguous()
    for t in (sx, w_q, s_w, bk):
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
                    route, _build.stream())
        _build.check(err, 'matmul_w8a8_q launch')
        global launches
        launches += 1
    if out_int8:
        return y_q.reshape(*lead, n), s_y.reshape(*lead, 1)
    return y.reshape(*lead, n)
