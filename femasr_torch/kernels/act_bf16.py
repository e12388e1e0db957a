"""SiLU and tanh-GELU in bfloat16, rounded where the JAX package rounds.

Kernel: csrc/act_bf16.cu. Not the port of a TPU kernel: the JAX package
leaves `nn.silu` and `nn.gelu(approximate=True)` (femasr_tpu/ops/layers.py
ActLayer, femasr_tpu/ops/swin.py Mlp) to XLA, which evaluates them in bf16
op by op and rounds to bf16 after every op:

    silu(x) = x * (1 / (1 + exp(-x)))
    gelu(x) = x * (0.5 * (1 + tanh(c2 * (x + c1 * ((x * x) * x)))))

with c1 and c2 the bf16 roundings of 0.044715 and sqrt(2 / pi).
`act_bf16_plain` writes those sequences as eager PyTorch ops (one pass
over the tensor per op); the kernel runs each sequence in one pass, in f32
registers, with a rounding to bf16 after every step (1 / d as the
correctly rounded reciprocal, which is what PyTorch's `1 / t` computes).
`act_bf16` launches it for CUDA tensors and runs the plain version for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
ACTS = {'silu': 0, 'gelu': 1}
GELU_C1 = 0.044677734375   # bf16(0.044715), exact in f32
GELU_C2 = 0.796875         # bf16(sqrt(2 / pi)), exact in f32


def act_bf16_plain(x: torch.Tensor, act: str) -> torch.Tensor:
    """The JAX op sequence in x.dtype, one rounding per op.

    The constants are exact bf16 values: PyTorch multiplies a bf16 tensor
    by a Python float in f32, so 0.044715 itself would round differently
    from JAX's bf16 constant."""
    if act == 'silu':
        return x * (1 / (1 + torch.exp(-x)))
    if act == 'gelu':
        return x * (0.5 * (1 + torch.tanh(
            GELU_C2 * (x + GELU_C1 * ((x * x) * x)))))
    raise ValueError(f'act_bf16: unsupported act={act!r}')


def _fn():
    lib = _build.load('act_bf16')
    fn = lib.femasr_act_bf16
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def act_bf16(x: torch.Tensor, act: str) -> torch.Tensor:
    """silu or tanh-gelu of a bfloat16 tensor, rounded as the JAX package
    rounds; returns a new tensor of x's shape (and memory format)."""
    if act not in ACTS:
        raise ValueError(f'act_bf16: unsupported act={act!r}')
    if x.dtype != torch.bfloat16:
        raise TypeError(f'act_bf16: needs bfloat16, got {x.dtype}')
    if x.device.type == 'cpu':
        return act_bf16_plain(x, act)
    if x.device.type != 'cuda':
        raise ValueError(f'act_bf16: unsupported device {x.device}')
    if not (x.is_contiguous()
            or x.is_contiguous(memory_format=torch.channels_last)):
        x = x.contiguous()
    y = torch.empty_like(x)   # keeps x's dense strides
    if x.numel():
        err = _fn()(_build.ptr(x), _build.ptr(y), x.numel(), ACTS[act],
                    _build.stream())
        _build.check(err, 'act_bf16 launch')
        global launches
        launches += 1
    return y
