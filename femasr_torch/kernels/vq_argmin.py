"""B3: codebook nearest-neighbour search (VQ argmin) in f32.

Kernel: csrc/vq_argmin.cu (replaces femasr_tpu/ops/pallas/vq.py
vq_argmin). `vq_argmin` launches it for CUDA tensors and runs
`vq_argmin_plain`, the same function in plain PyTorch, for CPU tensors.
With `with_dist=True` both also return each token's winning distance, the
value the search compared (a codebook split over tensor-parallel ranks
reduces the ranks' pairs: `ops/quantize.py`).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

launches = 0
# csrc/vq_argmin.cu: tokens per item, codes per tile, channels per chunk
TOKEN_TILE = 128
CODE_TILE = 128
CHANNEL_CHUNK = 32
_slots: Dict[int, int] = {}


def vq_argmin_plain(z_flat: torch.Tensor, codebook: torch.Tensor,
                    with_dist: bool = False):
    """argmin_j ||c_j||^2 - 2 z.c_j in f32, first minimum on ties; with
    with_dist, (indices, the (N,) f32 distances at them)."""
    z = z_flat.float()
    cb = codebook.float()
    d = cb.square().sum(1)[None, :] - 2.0 * (z @ cb.t())
    idx = d.argmin(dim=1)
    if with_dist:
        return idx.to(torch.int32), d.gather(1, idx[:, None])[:, 0]
    return idx.to(torch.int32)


def choose_splits(n: int, k: int, slots: int) -> Tuple[int, int]:
    """(splits, code tiles per split) for N tokens and K codes on a card
    with `slots` resident blocks.

    An item is one 128-token tile against one range of code tiles; its
    time is taken as its code tiles plus a tenth of a tile of fixed cost
    (pipeline fill, fold, writes). The count of ranges minimises whole
    waves of items times that time; ties go to fewer ranges.
    """
    n_tiles = math.ceil(n / TOKEN_TILE)
    k_tiles = math.ceil(k / CODE_TILE)
    best = None
    for want in range(1, k_tiles + 1):
        per = math.ceil(k_tiles / want)
        splits = math.ceil(k_tiles / per)
        cost = math.ceil(n_tiles * splits / slots) * (per + 0.1)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


def _lib():
    lib = _build.load('vq_argmin')
    lib.femasr_vq_argmin.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.femasr_vq_argmin.restype = ctypes.c_int
    lib.femasr_vq_slots.argtypes = []
    lib.femasr_vq_slots.restype = ctypes.c_int
    return lib


def slots(device: torch.device) -> int:
    """Resident blocks of the search kernel on the card (SMs x per SM)."""
    i = device.index if device.index is not None else \
        torch.cuda.current_device()
    if i not in _slots:
        with torch.cuda.device(i):
            got = _lib().femasr_vq_slots()
        if got < 1:     # a negative value is a CUDA error code
            raise RuntimeError(f'vq_argmin: occupancy query gave {got}')
        _slots[i] = got
    return _slots[i]


def vq_argmin(z_flat: torch.Tensor, codebook: torch.Tensor,
              splits: Optional[int] = None, with_dist: bool = False):
    """(N,) int32 index of the nearest code for each of the (N, C) tokens
    (with_dist: and the (N,) f32 distance ||c||^2 - 2 z.c the kernel
    compared for it).

    Tokens and codebook are cast to float32 first, so a bfloat16 model
    searches in f32. The (N, K) distance matrix is never materialized.
    `splits` (ranges of the codebook, each searched by its own blocks)
    overrides `choose_splits`, for measurement.
    """
    _build.refuse_grad('vq_argmin', z_flat, codebook)
    if z_flat.device.type == 'cpu':
        return vq_argmin_plain(z_flat, codebook, with_dist)
    if z_flat.device.type != 'cuda' or codebook.device != z_flat.device:
        raise ValueError(f'vq_argmin: unsupported devices {z_flat.device}, '
                         f'{codebook.device}')
    if z_flat.dim() != 2 or codebook.dim() != 2 \
            or z_flat.shape[1] != codebook.shape[1] or len(codebook) == 0:
        raise ValueError(f'vq_argmin: shapes {tuple(z_flat.shape)} and '
                         f'{tuple(codebook.shape)}')
    if not (z_flat.is_floating_point() and codebook.is_floating_point()):
        raise TypeError('vq_argmin: float inputs only')
    z = z_flat.float().contiguous()
    cb = codebook.detach().float().contiguous()
    n, c = z.shape
    k = cb.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=z.device)
    dist = (torch.empty(n, dtype=torch.float32, device=z.device)
            if with_dist else None)
    if n == 0:
        return (idx, dist) if with_dist else idx
    pad = -c % CHANNEL_CHUNK
    if pad:
        # zero channels add exact zeros to every dot product and norm
        z, cb = F.pad(z, (0, pad)), F.pad(cb, (0, pad))
    k_tiles = math.ceil(k / CODE_TILE)
    if splits is None:
        splits, per = choose_splits(n, k, slots(z.device))
    else:
        per = math.ceil(k_tiles / splits)
        splits = math.ceil(k_tiles / per)
    c2 = torch.empty(k, dtype=torch.float32, device=z.device)
    part_v = torch.empty((splits, n) if splits > 1 else 0,
                         dtype=torch.float32, device=z.device)
    part_i = torch.empty(part_v.shape, dtype=torch.int32, device=z.device)
    err = _lib().femasr_vq_argmin(
        _build.ptr(z), _build.ptr(cb), _build.ptr(c2), _build.ptr(part_v),
        _build.ptr(part_i), _build.ptr(idx), _build.ptr(dist), n, k,
        c + pad, splits, per, _build.stream())
    _build.check(err, 'vq_argmin launch')
    global launches
    launches += 1
    return (idx, dist) if with_dist else idx
