"""Operation counts of a forward (femasr_tpu/utils/flops.py).

The JAX package reads XLA's cost analysis of the compiled program; the
port counts the matrix products and convolutions that PyTorch dispatches
(`torch.utils.flop_counter.FlopCounterMode`: 2 per multiply-add), which
for SwinIR are its convs, linears and attention products (the attention
core's plain version, on CPU tensors).
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode


def model_flops(module: torch.nn.Module, *args, **kwargs) -> float:
    """Total FLOPs of one `module(*args, **kwargs)` forward, without
    gradients."""
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        module(*args, **kwargs)
    return float(counter.get_total_flops())
