"""Compare two runs of the int8 serving lane layer by layer.

Every w8a8 layer rounds its input to int8 codes. Two implementations whose
float inputs differ only in the last bits (another summation order, a
one-ulp GELU) put the few activations that sit on a round-half boundary on
either side of it, and one code step then moves every later layer: the
difference grows with depth however exact each layer is. So a comparison
of two runs (the kernels against their plain versions on the card, or the
port against the JAX package) gives each int8 layer of the second run the
input that layer saw in the first run (`force`), and records how far the
second run's own input was from it.

The int8 layers are Conv2dInt8, LinearInt8 and the chained Mlp (forced at
its float input, before quantize_rows). A float input is measured in
quantization steps of its own scale: a small distance says that every
code it would have rounded differently is a round-half boundary case. A
chain link's input is already codes (x_q, s_x): it is measured by how
many codes differ, by how much, and how far the row scales moved.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch
from torch import nn

from ..kernels._w8a8 import scale_of, tensor_scale
from ..ops.layers import Conv2dInt8, LinearInt8
from ..ops.swin import Mlp


def int8_layers(model: nn.Module) -> Dict[str, nn.Module]:
    """name -> module of every layer that quantizes its input or takes
    int8 codes."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, (Conv2dInt8, LinearInt8))
            or (isinstance(m, Mlp) and m.chain)}


def steps(x: torch.Tensor, per_row: bool) -> torch.Tensor:
    """x in quantization steps of its own scale (per row or per tensor)."""
    xf = x.float()
    s = (scale_of(xf.abs().amax(dim=-1, keepdim=True)) if per_row
         else tensor_scale(xf))
    return torch.div(xf, s)


def compare(own, forced, per_row: bool) -> dict:
    """How far a layer's own input is from the forced one."""
    if isinstance(own, tuple):
        d = (own[0].int() - forced[0].int()).abs()
        return dict(kind='codes', flips=int((d > 0).sum().item()),
                    max_code_diff=int(d.max().item()) if d.numel() else 0,
                    scale_rel=(torch.div(own[1], forced[1]) - 1).abs()
                    .max().item(), numel=d.numel())
    a, b = steps(own, per_row), steps(forced, per_row)
    return dict(kind='float', max_steps=(a - b).abs().max().item(),
                flips=int((a.round() != b.round()).sum().item()),
                numel=a.numel())


def _detach(x):
    if isinstance(x, tuple):
        return tuple(t.detach().clone() for t in x)
    return x.detach().clone()


@contextlib.contextmanager
def record(model: nn.Module, store: Dict[str, object]) -> Iterator:
    """Store each int8 layer's input (detached) under its module name."""
    def hook(name):
        def pre(_, args):
            store[name] = _detach(args[0])
        return pre
    handles = [m.register_forward_pre_hook(hook(n))
               for n, m in int8_layers(model).items()]
    try:
        yield store
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def force(model: nn.Module, inputs: Dict[str, object],
          stats: Dict[str, dict]) -> Iterator:
    """Feed each int8 layer named in `inputs` that input instead of its own;
    stats[name] gets `compare(own, forced)`."""
    def hook(name, per_row):
        def pre(_, args):
            own = args[0]
            forced = inputs[name]
            if isinstance(own, tuple):
                forced = tuple(f.to(o.device, o.dtype)
                               for f, o in zip(forced, own))
                shapes = [(f.shape, o.shape) for f, o in zip(forced, own)]
            else:
                forced = forced.to(own.device, own.dtype)
                if forced.dim() == 4:
                    forced = forced.contiguous(
                        memory_format=torch.channels_last)
                shapes = [(forced.shape, own.shape)]
            if any(f != o for f, o in shapes):
                raise ValueError(f'{name}: forced input shapes {shapes}')
            stats[name] = compare(own, forced, per_row)
            return (forced,) + tuple(args[1:])
        return pre
    handles = [m.register_forward_pre_hook(hook(n, isinstance(m, Mlp)))
               for n, m in int8_layers(model).items() if n in inputs]
    try:
        yield stats
    finally:
        for h in handles:
            h.remove()
