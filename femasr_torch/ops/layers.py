"""Conv-stack building blocks: norm / act / resblock / resize / combine.

Counterpart of femasr_tpu/ops/layers.py (GroupNorm, NormLayer, ActLayer,
ResBlock, upsample_nearest as Upsample, resize_nearest, CombineQuantBlock,
and UpConv3 as the Upsample + Conv2d pair of the Sequentials; leaky_relu
with JAX's slope rounding; JAX's pixel_shuffle / pixel_unshuffle are
F.pixel_shuffle / F.pixel_unshuffle, whose channel order c*r^2 + dy*r + dx
is the same), plus the int8 serving layers (quantize_rows, Conv3Int8 as
Conv2dInt8, DenseInt8 as LinearInt8, ResBlockInt8 as ResBlock(int8=True)). Tensors are NCHW;
parameters stay float32 and are cast to the activation dtype at use, so
one model serves in float32 or bfloat16. Submodule names follow the
reference torch state-dict keys (`conv.0.norm`, `conv.2`, ...); the int8
layers hold the same parameters as the float ones (checkpoint-free).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import matmul_w8a8 as mm
from ..kernels import matmul_w8a8_q as mmq
from ..kernels._w8a8 import quantize, scale_of
from ..kernels.act_bf16 import act_bf16, act_bf16_plain
from ..kernels.conv3 import conv3, conv3_plain
from ..kernels.conv3_w8a8 import conv3_w8a8
from ..kernels.matmul_w8a8 import matmul_w8a8
from ..kernels.matmul_w8a8_q import matmul_w8a8_q, weight_tc
from ..parallel.tensor_parallel import (ColumnParallelLinear, ModelAxis,
                                        RowParallelLinear, dense)


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose float32 parameters are cast to the input dtype.

    The bias is added after the convolution, in x.dtype, as flax's nn.Conv
    adds it: outside float32 the two round apart (one rounding of the
    fused conv + bias moves ~5% of bf16 outputs by more than an ulp)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        if self.bias is None or x.dtype == torch.float32:
            return F.conv2d(x, w, self.bias, self.stride, self.padding)
        return (F.conv2d(x, w, None, self.stride, self.padding)
                + self.bias.to(x.dtype)[:, None, None])


class Linear(nn.Linear):
    """nn.Linear whose float32 parameters are cast to the input dtype.

    The bias is added after the product, in x.dtype, as flax's nn.Dense
    adds it (`tensor_parallel.dense`). `Linear.split` builds the layer's
    form on a tensor-parallel axis, which keeps these rounding points."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight.to(x.dtype), self.bias)

    @staticmethod
    def split(in_features: int, out_features: int,
              axis: Optional[ModelAxis], kind: str, unit: int,
              blocks: int = 1) -> nn.Linear:
        """The linear on a tensor-parallel axis: kind 'column' splits its
        output features (in `blocks` blocks), 'row' its input features.
        `unit` (heads, hidden width) is what must divide the axis; without
        an axis, or when it does not divide, the plain Linear."""
        if axis is None or not axis.splits(unit):
            return Linear(in_features, out_features)
        if kind == 'column':
            return ColumnParallelLinear(in_features, out_features, axis,
                                        blocks)
        return RowParallelLinear(in_features, out_features, axis)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8: (..., K) -> int8 codes + (..., 1) f32
    scales max(max_k |x| / 127, 1e-12), round-half-even."""
    s = scale_of(x.detach().abs().amax(dim=-1, keepdim=True))
    return quantize(x, s), s


class Conv2dInt8(nn.Conv2d):
    """3x3 SAME conv in w8a8 int8 (the conv3_w8a8 kernel); same parameters
    as Conv2d(in, out, 3, 1, 1). Serving only."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3_w8a8(x.contiguous(memory_format=torch.channels_last),
                          self.weight, self.bias)


class LinearInt8(nn.Linear):
    """nn.Linear in w8a8 int8; same parameters as Linear. Serving only.

    Two input forms, as DenseInt8:
      - a float tensor: per-tensor activation scale (matmul_w8a8), output
        in the input dtype;
      - an (x_q int8, s_x f32 (..., 1)) pair: one link of the per-token
        chain (matmul_w8a8_q), with an optional fused `act` and, with
        out_int8, a re-quantized (y_q, s_y) output; otherwise out_dtype.

    On the card the tensor-core routes of both forms take the weight
    quantized and packed (`weight_tc`) once per weight storage, device,
    dtype and version: the weights are frozen, and a move, a cast, a load
    or an in-place change of the parameter renews the copy. (An in-place
    edit through `weight.data` bumps no version and is not seen.)
    """

    _tc = None   # (key, packed codes, s_w) of the tensor-core route

    def _tc_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        w = self.weight
        if w.is_inference():     # no version counter: not kept
            return weight_tc(w)
        key = (w.device, w.dtype, w.data_ptr(), w._version)
        if self._tc is None or self._tc[0] != key:
            self._tc = (key, *weight_tc(w))
        return self._tc[1:]

    def forward(self, x, act: Optional[str] = None, out_int8: bool = False,
                out_dtype: torch.dtype = torch.float32):
        k, n = self.in_features, self.out_features
        if isinstance(x, tuple):
            x_q, s_x = x
            packed = (self._tc_weight() if x_q.is_cuda
                      and mmq.route_of(k, n, 0) == mmq.TC else None)
            return matmul_w8a8_q(x_q, s_x, self.weight, self.bias, act=act,
                                 out_int8=out_int8, out_dtype=out_dtype,
                                 packed=packed)
        if act is not None or out_int8:
            raise ValueError('fused act / int8 output are chain-mode features')
        packed = (self._tc_weight() if x.is_cuda
                  and mm.route_of(k, n, 0) == mm.TC else None)
        return matmul_w8a8(x, self.weight, self.bias, packed=packed)


class GroupNorm(nn.Module):
    """GroupNorm with float32 statistics in the E[x^2] - E[x]^2 form.

    Matches femasr_tpu GroupNorm ('chanraw'): per-channel raw moments,
    folded into groups, variance clamped at 0; then, as there, the
    normalize runs in x.dtype as (x - mean) * (inv * weight) + bias, with
    mean, inv * weight and bias rounded to x.dtype and each op rounding.
    """

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__()
        assert num_channels % num_groups == 0, (num_channels, num_groups)
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def _moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-(sample, channel) float32 group mean and 1 / sqrt(var + eps)."""
        b, c = x.shape[:2]
        g = self.num_groups
        xf = x.float()
        m1 = xf.mean(dim=(2, 3))
        m2 = xf.square().mean(dim=(2, 3))
        mean = m1.view(b, g, c // g).mean(-1)
        mean2 = m2.view(b, g, c // g).mean(-1)
        var = (mean2 - mean.square()).clamp_min(0.0)
        inv = torch.rsqrt(var + self.eps)
        return (mean.repeat_interleave(c // g, 1),
                inv.repeat_interleave(c // g, 1))

    def affine(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-(sample, channel) float32 (a, b) with norm(x) = x * a + b
        (the conv3 kernel's prologue, in f32)."""
        mean, inv = self._moments(x)
        a = inv * self.weight
        return a, self.bias - mean * a

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, inv = self._moments(x)
        dt = x.dtype
        sub = mean.to(dt)[:, :, None, None]
        mul = (inv * self.weight).to(dt)[:, :, None, None]
        return (x - sub) * mul + self.bias.to(dt)[:, None, None]


class NormLayer(nn.Module):
    """Norm switch: gn (32 groups, eps 1e-6) / none."""

    def __init__(self, channels: int, norm_type: str = 'gn'):
        super().__init__()
        nt = norm_type.lower()
        if nt in ('in', 'bn'):
            raise NotImplementedError(
                f'norm_type {norm_type!r} is not ported yet (ROADMAP A12)')
        if nt == 'gn':
            self.norm = GroupNorm(32, channels, eps=1e-6)
        elif nt == 'none':
            self.norm = nn.Identity()
        else:
            raise ValueError(f'Norm type {norm_type} not supported.')

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(x)


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """jax.nn.leaky_relu(x, slope), whose weakly typed slope takes x's
    dtype: F.leaky_relu with the slope rounded to that dtype (given 0.2
    itself it would multiply a bf16 tensor by the f32 0.2)."""
    return F.leaky_relu(x, float(torch.tensor(slope, dtype=x.dtype)))


def silu_gelu(x: torch.Tensor, act: str,
              differentiable: bool = False) -> torch.Tensor:
    """SiLU or GELU as the JAX package computes them: in bfloat16, its op
    sequences rounded after every op (the act_bf16 kernel on the card, or
    with differentiable=True its op-by-op twin under autograd: the kernel
    has no backward); otherwise F.silu, and GELU exact (erf) in float32,
    tanh elsewhere."""
    if x.dtype == torch.bfloat16:
        return (act_bf16_plain if differentiable else act_bf16)(x, act)
    if act == 'silu':
        return F.silu(x)
    return F.gelu(x, approximate='none' if x.dtype == torch.float32
                  else 'tanh')


class ActLayer(nn.Module):
    """Activation switch: relu / leakyrelu(0.2) / prelu / silu / gelu / none."""

    def __init__(self, channels: int, act_type: str = 'leakyrelu'):
        super().__init__()
        at = act_type.lower()
        if at not in ('relu', 'leakyrelu', 'prelu', 'silu', 'gelu', 'none'):
            raise ValueError(f'activation type {act_type} not supported.')
        self.act_type = at
        if at == 'prelu':
            self.func = nn.PReLU(channels)

    def forward(self, x: torch.Tensor,
                differentiable: bool = False) -> torch.Tensor:
        at = self.act_type
        if at == 'relu':
            return F.relu(x)
        if at == 'leakyrelu':
            return F.leaky_relu(x, 0.2)
        if at == 'prelu':
            return F.prelu(x, self.func.weight.to(x.dtype))
        if at in ('silu', 'gelu'):
            return silu_gelu(x, at, differentiable)
        return x


class ResBlock(nn.Module):
    """[Norm, Act, Conv3, Norm, Act, Conv3] + skip (fema_utils.py:65-84).

    kernel=True runs both convs through the conv3 kernel with the
    GroupNorm normalize and SiLU folded into its prologue (the release
    config, gn + silu); only the statistics are computed here. The input
    is kept in channels_last memory so the kernel reads NHWC in place.

    int8=True (ResBlockInt8) runs both convs through the conv3_w8a8 kernel;
    the norms and activations stay float and are materialized.
    """

    def __init__(self, in_channel: int, out_channel: int,
                 norm_type: str = 'gn', act_type: str = 'leakyrelu',
                 kernel: bool = False, int8: bool = False):
        super().__init__()
        assert not (kernel and int8), 'kernel and int8 are exclusive'
        self.kernel = kernel
        if kernel:
            assert (norm_type.lower(), act_type.lower()) == ('gn', 'silu'), (
                'the conv3-kernel ResBlock needs norm_type=gn, act_type=silu')
            assert in_channel == out_channel

        def conv(i, o):
            return Conv2dInt8(i, o) if int8 else Conv2d(i, o, 3, 1, 1)

        self.conv = nn.Sequential(
            NormLayer(in_channel, norm_type),
            ActLayer(in_channel, act_type),
            conv(in_channel, out_channel),
            NormLayer(out_channel, norm_type),
            ActLayer(out_channel, act_type),
            conv(out_channel, out_channel))

    def forward(self, x: torch.Tensor,
                differentiable: bool = False) -> torch.Tensor:
        """differentiable: under autograd (the conv3 and act_bf16 kernels
        have no backward). A kernel=True block takes the conv3 kernel's
        plain version in float32, where it is the layers' function in fewer
        passes, and the plain layers in bfloat16, which round where the
        JAX trainer's layers round (the plain version rounds where the
        kernel does); bf16 activations take act_bf16's op-by-op twin."""
        if not self.kernel or (differentiable
                               and x.dtype != torch.float32):
            res = x
            for m in self.conv:
                res = (m(res, differentiable) if isinstance(m, ActLayer)
                       else m(res))
            return res + x
        conv = conv3_plain if differentiable else conv3
        x = x.contiguous(memory_format=torch.channels_last)
        norm1, conv1 = self.conv[0].norm, self.conv[2]
        norm2, conv2 = self.conv[3].norm, self.conv[5]
        a, b = norm1.affine(x)
        res = conv(x, conv1.weight, conv1.bias, scale=a, shift=b,
                   pre_act='silu')
        a, b = norm2.affine(res)
        res = conv(res, conv2.weight, conv2.bias, scale=a, shift=b,
                   pre_act='silu')
        return res + x


def sequential(modules: nn.Module, x: torch.Tensor,
               differentiable: bool = False) -> torch.Tensor:
    """Run the modules of an nn.Sequential in order, handing
    `differentiable` to its ResBlocks."""
    for m in modules:
        x = m(x, differentiable) if isinstance(m, ResBlock) else m(x)
    return x


class Upsample(nn.Module):
    """Nearest x2 upsample (the reference's nn.Upsample slot in Sequentials)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.interpolate(x, scale_factor=2, mode='nearest')


def resize_nearest(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Nearest resize with floor(out_idx * in / out) source indexing."""
    h, w = x.shape[2:]
    oh, ow = size
    if (oh, ow) == (h, w):
        return x
    rows = torch.arange(oh, device=x.device) * h // oh
    cols = torch.arange(ow, device=x.device) * w // ow
    return x.index_select(2, rows).index_select(3, cols)


class CombineQuantBlock(nn.Module):
    """Concat (after nearest-resizing input2) then conv3 (fema_utils.py:87-99)."""

    def __init__(self, in_ch1: int, in_ch2: int, out_channel: int):
        super().__init__()
        self.conv = Conv2d(in_ch1 + in_ch2, out_channel, 3, 1, 1)

    def forward(self, input1: torch.Tensor,
                input2: Optional[torch.Tensor] = None) -> torch.Tensor:
        if input2 is not None:
            input2 = resize_nearest(input2, tuple(input1.shape[2:]))
            input1 = torch.cat([input1, input2], dim=1)
        return self.conv(input1)
