"""Plain-PyTorch w8a8 arithmetic shared by B4-B6 and the int8 layers.

The numerics are those of femasr_tpu/ops/layers.py (dense_w8a8,
dense_w8a8_ptok, conv3_w8a8, quantize_rows): symmetric per-output-channel
weight scales, symmetric dynamic activation scales, round-half-even,
exact integer sums, then `acc * (s_x * s_w)`, `+ bias`, activation, in f32.

Every division is a true division by a tensor on the operand's device:
PyTorch's CUDA `tensor / python_float` multiplies by the reciprocal, which
rounds differently from the JAX reference and from the kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

ACTS = {None: 0, 'gelu': 1, 'silu': 2, 'lrelu': 3}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def true_div(a: torch.Tensor, b: Union[torch.Tensor, float]) -> torch.Tensor:
    if not torch.is_tensor(b):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


def scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax / 127, 1e-12) in f32."""
    return true_div(amax.float(), 127.0).clamp_min(1e-12)


def quantize(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """round(x / s) to int8, half to even (s broadcasts against x)."""
    return torch.round(torch.div(x.float(), s)).to(torch.int8)


def quantize_weight(weight: torch.Tensor, dims: Union[int, Sequence[int]]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 codes and f32 scales of a torch-layout weight
    (output channels first), reducing |w| over `dims`."""
    wf = weight.detach().float()
    s = scale_of(wf.abs().amax(dim=dims))
    return quantize(wf, s.view((-1,) + (1,) * (wf.dim() - 1))), s


def tensor_scale(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor activation scale, a 0-dim f32 tensor on x's device."""
    return scale_of(x.detach().abs().amax())


def int_matmul(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact int8 (M, K) x int8 (N, K)^T sums, as integer-valued float64.

    float64 holds every such sum exactly (|acc| <= 127^2 * K << 2^53); f32
    would not, and int32 matmul does not run on CUDA."""
    return F.linear(a_q.double(), w_q.double())


def epilogue(acc: torch.Tensor, scale: torch.Tensor,
             bias: Optional[torch.Tensor], act: Optional[str]) -> torch.Tensor:
    """act(acc * scale + bias) in f32; acc holds exact integer sums."""
    y = acc.float() * scale
    if bias is not None:
        y = y + bias.detach().float()
    if act == 'gelu':
        return F.gelu(y, approximate='tanh')
    if act == 'silu':
        return F.silu(y)
    if act == 'lrelu':
        return F.leaky_relu(y, 0.2)
    if act is not None:
        raise ValueError(f'unknown fused activation {act!r}')
    return y


def check_act(act: Optional[str], what: str) -> None:
    if act not in ACTS:
        raise ValueError(f'{what}: unsupported act={act!r}')
