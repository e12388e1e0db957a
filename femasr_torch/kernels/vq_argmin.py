"""B3: codebook nearest-neighbour search (VQ argmin) in f32.

Kernel: csrc/vq_argmin.cu (replaces femasr_tpu/ops/pallas/vq.py
vq_argmin). `vq_argmin` launches it for CUDA tensors and runs
`vq_argmin_plain`, the same function in plain PyTorch, for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0


def vq_argmin_plain(z_flat: torch.Tensor, codebook: torch.Tensor
                    ) -> torch.Tensor:
    """argmin_j ||c_j||^2 - 2 z.c_j in f32, first minimum on ties."""
    z = z_flat.float()
    cb = codebook.float()
    d = cb.square().sum(1)[None, :] - 2.0 * (z @ cb.t())
    return d.argmin(dim=1).to(torch.int32)


def _fn():
    lib = _build.load('vq_argmin')
    fn = lib.femasr_vq_argmin
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def vq_argmin(z_flat: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N,) int32 index of the nearest code for each of the (N, C) tokens.

    Tokens and codebook are cast to float32 first, so a bfloat16 model
    searches in f32. The (N, K) distance matrix is never materialized.
    """
    if z_flat.device.type == 'cpu':
        return vq_argmin_plain(z_flat, codebook)
    if z_flat.device.type != 'cuda' or codebook.device != z_flat.device:
        raise ValueError(f'vq_argmin: unsupported devices {z_flat.device}, '
                         f'{codebook.device}')
    if z_flat.dim() != 2 or codebook.dim() != 2 \
            or z_flat.shape[1] != codebook.shape[1]:
        raise ValueError(f'vq_argmin: shapes {tuple(z_flat.shape)} and '
                         f'{tuple(codebook.shape)}')
    if not (z_flat.is_floating_point() and codebook.is_floating_point()):
        raise TypeError('vq_argmin: float inputs only')
    z = z_flat.float().contiguous()
    cb = codebook.detach().float().contiguous()
    n, c = z.shape
    k = cb.shape[0]
    c2 = torch.empty(k, dtype=torch.float32, device=z.device)
    idx = torch.empty(n, dtype=torch.int32, device=z.device)
    if n == 0:
        return idx
    err = _fn()(_build.ptr(z), _build.ptr(cb), _build.ptr(c2),
                _build.ptr(idx), n, k, c, _build.stream())
    _build.check(err, 'vq_argmin launch')
    global launches
    launches += 1
    return idx
