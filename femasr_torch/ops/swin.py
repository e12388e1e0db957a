"""Swin-transformer ops: window helpers, (S)W-MSA blocks, RSTB, SwinLayers.

Counterpart of femasr_tpu/ops/swin.py (spatial layout only). Parameter
names follow the reference torch keys (`swin_blks.{j}.residual_group.
blocks.{k}.attn.qkv.weight`, ...). The attention core runs through the
window-attention kernel; the qkv / proj / MLP linears are nn.Linear, or
in the int8 serving lane LinearInt8: per-tensor w8a8 (int8_linears: qkv,
proj and the MLP) and the per-token int8 chain for the MLP (int8_mlp,
which wins over int8_linears for the MLP).
The relative-position index and the shift mask are derived, not learned:
they are non-persistent buffers, so the state dict holds parameters only.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..kernels.window_attention import window_attention
from .layers import Conv2d, Linear, LinearInt8, quantize_rows, silu_gelu


@functools.lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """(wh*ww, wh*ww) int64 pairwise relative-position index in a window."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww),
                                  indexing='ij')).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).copy()
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1).astype(np.int64)


@functools.lru_cache(maxsize=None)
def shifted_window_mask(h: int, w: int, window_size: int,
                        shift_size: int) -> np.ndarray:
    """(nW, N, N) float32 0/-100 additive mask for SW-MSA."""
    img_mask = np.zeros((h, w), dtype=np.int32)
    slices = (slice(0, -window_size), slice(-window_size, -shift_size),
              slice(-shift_size, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[hs, ws] = cnt
            cnt += 1
    mask = img_mask.reshape(h // window_size, window_size,
                            w // window_size, window_size)
    mask = mask.transpose(0, 2, 1, 3).reshape(-1, window_size * window_size)
    attn_mask = mask[:, None, :] - mask[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _device_mask(h: int, w: int, window_size: int, shift_size: int,
                 device: torch.device) -> torch.Tensor:
    return torch.from_numpy(shifted_window_mask(
        h, w, window_size, shift_size)).to(device)


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window_size, window_size, w // window_size,
                  window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size * window_size,
                                               c)


def window_reverse(windows: torch.Tensor, window_size: int, h: int,
                   w: int) -> torch.Tensor:
    """(B*nW, ws*ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // window_size // window_size)
    x = windows.reshape(b, h // window_size, w // window_size, window_size,
                        window_size, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, f32 statistics in the E[x^2] form;
    the normalize in x.dtype, rounding where femasr_tpu's LayerNormTPU
    rounds: (x - mean) * (inv * weight) + bias, each op in x.dtype."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        m1 = xf.mean(-1, keepdim=True)
        m2 = xf.square().mean(-1, keepdim=True)
        inv = torch.rsqrt((m2 - m1.square()).clamp_min(0.0) + self.eps)
        dt = x.dtype
        return ((x - m1.to(dt)) * (inv * self.weight).to(dt)
                + self.bias.to(dt))


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2; GELU is exact (erf) in f32, the tanh form
    rounded as the JAX package rounds in bf16 (`layers.silu_gelu`).

    int8: both linears per-tensor w8a8. chain: the per-token int8 chain,
    quantize_rows -> fc1 with a fused tanh GELU and int8 output -> fc2 to
    the input dtype (femasr_tpu/ops/swin.py Mlp, chain branch).
    """

    def __init__(self, in_features: int, hidden_features: int,
                 int8: bool = False, chain: bool = False):
        super().__init__()
        lin = LinearInt8 if (int8 or chain) else Linear
        self.chain = chain
        self.fc1 = lin(in_features, hidden_features)
        self.fc2 = lin(hidden_features, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.chain:
            h = self.fc1(quantize_rows(x), act='gelu', out_int8=True)
            return self.fc2(h, out_dtype=x.dtype)
        return self.fc2(silu_gelu(self.fc1(x), 'gelu'))


class WindowAttention(nn.Module):
    """W-MSA with learned relative position bias (network_swinir.py:65-145)."""

    def __init__(self, dim: int, window_size: Tuple[int, int],
                 num_heads: int, int8_linears: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.scale = (dim // num_heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(torch.zeros(
            (2 * window_size[0] - 1) * (2 * window_size[1] - 1), num_heads))
        self.register_buffer(
            'relative_position_index',
            torch.from_numpy(relative_position_index(*window_size)),
            persistent=False)
        lin = LinearInt8 if int8_linears else Linear
        self.qkv = lin(dim, dim * 3)
        self.proj = lin(dim, dim)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B_, N, C) windows; mask: (nW, N, N) float32 or None."""
        b_, n, c = x.shape
        nh = self.num_heads
        qkv = self.qkv(x)
        # the scale rounded to the dtype first, as JAX's weakly typed scalar
        q = qkv[..., :c] * torch.tensor(self.scale, dtype=qkv.dtype)
        k = qkv[..., c:2 * c]
        v = qkv[..., 2 * c:]
        bias = (self.relative_position_bias_table[
            self.relative_position_index.view(-1)]
            .view(n, n, nh).permute(2, 0, 1).float().contiguous())
        out = window_attention(q, k, v, bias, mask, num_heads=nh)
        return self.proj(out)


class SwinTransformerBlock(nn.Module):
    """LN -> (S)W-MSA -> residual -> LN -> MLP -> residual (spatial layout).

    `input_resolution` is nominal: it only drives the window clamp.
    """

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 7, shift_size: int = 0,
                 int8_linears: bool = False, int8_mlp: bool = False):
        super().__init__()
        if min(input_resolution) <= window_size:
            shift_size = 0
            window_size = min(input_resolution)
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, (window_size, window_size),
                                    num_heads, int8_linears)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim, int8=int8_linears, chain=int8_mlp)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C)."""
        _, h, w, _ = x.shape
        ws, ss = self.window_size, self.shift_size
        y = self.norm1(x)
        if ss > 0:
            y = torch.roll(y, (-ss, -ss), dims=(1, 2))
        mask = _device_mask(h, w, ws, ss, x.device) if ss > 0 else None
        y = self.attn(window_partition(y, ws), mask=mask)
        y = window_reverse(y, ws, h, w)
        if ss > 0:
            y = torch.roll(y, (ss, ss), dims=(1, 2))
        x = x + y
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    """depth x SwinTransformerBlock with alternating shift 0 / ws // 2."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 int8_linears: bool = False, int8_mlp: bool = False):
        super().__init__()
        self.blocks = nn.ModuleList([
            SwinTransformerBlock(dim, input_resolution, num_heads,
                                 window_size,
                                 0 if i % 2 == 0 else window_size // 2,
                                 int8_linears, int8_mlp)
            for i in range(depth)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x


class RSTB(nn.Module):
    """BasicLayer -> conv3x3 -> + residual, on NCHW maps
    (network_swinir.py:419-482, resi_connection='1conv')."""

    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 depth: int, num_heads: int, window_size: int,
                 int8_linears: bool = False, int8_mlp: bool = False):
        super().__init__()
        self.residual_group = BasicLayer(dim, input_resolution, depth,
                                         num_heads, window_size,
                                         int8_linears, int8_mlp)
        self.conv = Conv2d(dim, dim, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.residual_group(x.permute(0, 2, 3, 1).contiguous())
        return self.conv(y.permute(0, 3, 1, 2).contiguous()) + x


class SwinLayers(nn.Module):
    """4 x RSTB at the deepest LQ-encoder resolution (femasr_arch.py:114-132)."""

    def __init__(self, input_resolution: Tuple[int, int] = (32, 32),
                 embed_dim: int = 256, blk_depth: int = 6, num_heads: int = 8,
                 window_size: int = 8, int8_linears: bool = False,
                 int8_mlp: bool = False):
        super().__init__()
        self.swin_blks = nn.ModuleList([
            RSTB(embed_dim, input_resolution, blk_depth, num_heads,
                 window_size, int8_linears, int8_mlp)
            for _ in range(4)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self.swin_blks:
            x = m(x)
        return x
