"""The bf16 agreement rule of a kernel and its plain version (or the JAX
kernel) when both round to bf16 at the same points.

Every output lies within one bf16 ulp of the reference (the ulp of the
reference value's binade: bf16 keeps 8 significant bits), except a share of
at most `share` (0.1%), which may lie `atol` further: the two sum in f32 in
different orders, so now and then an upstream rounding to bf16 (a prologue
value, a probability) falls the other way, and `atol` is what one such flip
can move an output. A missing or extra rounding point moves 11-18% of the
outputs beyond one ulp (tests/test_torch_conv3.py and
tests/test_torch_window_attention.py, against the JAX kernels); a flat
tolerance such as 2e-2 cannot see that.
"""

from __future__ import annotations

import torch


def _f32(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.float()
    return torch.tensor(t, dtype=torch.float32)


def bf16_agreement(out, ref, atol: float, share: float = 1e-3) -> tuple:
    """(ok, max abs err, share of outputs beyond one bf16 ulp); out and
    ref are tensors or arrays."""
    out, ref = _f32(out), _f32(ref)
    _, e = torch.frexp(ref)
    # a zero has no binade: its ulp is bf16's least subnormal
    ulp = torch.where(ref == 0, 2.0 ** -133,
                      torch.ldexp(torch.ones_like(ref), e - 8))
    err = (out - ref).abs()
    beyond = (err > ulp).float().mean().item()
    worst = (err - ulp).max().item()
    return beyond <= share and worst <= atol, err.max().item(), beyond


def assert_bf16_close(out, ref, atol: float, share: float = 1e-3) -> None:
    ok, err, beyond = bf16_agreement(out, ref, atol, share)
    assert ok, (f'{beyond:.3%} of outputs beyond one bf16 ulp (<= {share:.1%}'
                f' allowed), max abs err {err:.3e} (one ulp + {atol:.3e})')
