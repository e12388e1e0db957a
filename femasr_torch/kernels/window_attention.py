"""B2: windowed multi-head attention with relative-position bias and mask.

Kernel: csrc/window_attention.cu (replaces
femasr_tpu/ops/pallas/window_attention.py window_attention_fused).
`window_attention` launches it for CUDA tensors and runs
`window_attention_plain`, the same function in plain PyTorch, for CPU
tensors.

Rounding points, as the JAX kernel's (window_attention.py:50): logits,
bias and mask adds and the softmax are f32; p is normalised in f32 and
rounded to q.dtype before p @ v; p @ v sums in f32 and the output is
rounded to q.dtype. In f32 the roundings are no-ops.

Routes on the card: bfloat16 runs the tensor-core kernel, float32 the FFMA
kernel, whose sums are true f32 (TF32 would miss the f32 gate).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           num_heads: int = 8) -> torch.Tensor:
    """softmax(q k^T + bias [+ mask[b % nW]]) v per window and head; f32
    arithmetic with p rounded to q.dtype before p @ v."""
    b_, n, c = q.shape
    hd = c // num_heads

    def heads(t):
        return t.float().reshape(b_, n, num_heads, hd).transpose(1, 2)

    logits = heads(q) @ heads(k).transpose(-1, -2) + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.view(b_ // nw, nw, num_heads, n, n)
                  + mask.float()[None, :, None]).view(b_, num_heads, n, n)
    p = torch.softmax(logits, dim=-1).to(q.dtype).float()
    out = (p @ heads(v)).transpose(1, 2).reshape(b_, n, c)
    return out.to(q.dtype)


def _fn():
    lib = _build.load('window_attention')
    fn = lib.femasr_window_attention
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_long] * 4 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _token_stride(t: torch.Tensor, name: str) -> int:
    b_, n, _ = t.shape
    if t.stride(2) != 1 or t.stride(0) != n * t.stride(1):
        raise ValueError(f'window_attention: {name} needs unit feature '
                         'stride and evenly strided tokens')
    return t.stride(1)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     num_heads: int = 8) -> torch.Tensor:
    """softmax(q k^T + bias [+ mask]) v over windows.

    q, k, v: (B_, N, C) per-window tokens, q pre-scaled by head_dim**-0.5;
    they may be column slices of one packed (B_, N, 3C) tensor (in bf16
    with rows 16-byte aligned).
    bias: (nh, N, N) float32. mask: (nW, N, N) float32 or None; window b
    uses mask[b % nW]. Returns a new contiguous (B_, N, C) in q.dtype.
    """
    if q.device.type == 'cpu':
        return window_attention_plain(q, k, v, bias, mask, num_heads)
    if q.device.type != 'cuda':
        raise ValueError(f'window_attention: unsupported device {q.device}')
    b_, n, c = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f'window_attention: dtypes {q.dtype} {k.dtype} '
                        f'{v.dtype}')
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError('window_attention: q, k, v shapes differ')
    if c % num_heads or n != 64 or c // num_heads != 32:
        raise ValueError(f'window_attention: kernel takes N=64, head_dim 32 '
                         f'(got N={n}, C={c}, heads={num_heads})')
    if tuple(bias.shape) != (num_heads, n, n) or bias.dtype != torch.float32 \
            or not bias.is_contiguous():
        raise ValueError('window_attention: bias must be (nh, N, N) f32')
    nw = 1
    if mask is not None:
        nw = mask.shape[0]
        if tuple(mask.shape) != (nw, n, n) or mask.dtype != torch.float32 \
                or not mask.is_contiguous() or b_ % nw:
            raise ValueError('window_attention: mask must be (nW, N, N) f32 '
                             'with nW dividing B_')
    for t in (k, v, bias, mask):
        if t is not None and t.device != q.device:
            raise ValueError('window_attention: all tensors on one device')
    ldq, ldk, ldv = (_token_stride(q, 'q'), _token_stride(k, 'k'),
                     _token_stride(v, 'v'))
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or ld % 8
            for t, ld in ((q, ldq), (k, ldk), (v, ldv))):
        raise ValueError('window_attention: the bf16 kernel copies 16-byte '
                         'chunks: q, k, v need 16-byte aligned rows')
    out = torch.empty((b_, n, c), dtype=q.dtype, device=q.device)
    err = _fn()(_build.ptr(q), _build.ptr(k), _build.ptr(v),
                _build.ptr(bias),
                None if mask is None else _build.ptr(mask),
                _build.ptr(out), b_, n, num_heads, c // num_heads, nw,
                ldq, ldk, ldv, c, _DTYPES[q.dtype], _build.stream())
    _build.check(err, 'window_attention launch')
    global launches
    launches += 1
    return out
