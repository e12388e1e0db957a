"""Host-side logic of the B3 and B6 kernels, on the CPU.

The CUDA kernels run only on the card (tests/test_torch_kernels_cuda.py).
What surrounds them is Python that runs here: the wrappers' choice of
route and of codebook split, B6's packing of int8 weights into the
tensor-core kernel's chunked layout, and a torch twin of B3's search order
(per-thread running minima over ascending codes, a reduction across the
threads of a token, then the merge over code ranges), held against
`vq_argmin_plain` on planted exact ties.
"""

import math

import numpy as np
import pytest
import torch

from femasr_torch.kernels import conv3_w8a8, vq_argmin
from femasr_torch.kernels._w8a8 import quantize_weight, scale_of, tensor_scale


@pytest.mark.parametrize('ci,o,ptr,route', [
    (64, 64, 0, conv3_w8a8.TC), (128, 64, 16, conv3_w8a8.TC),
    (256, 256, 0, conv3_w8a8.TC), (256, 128, 0, conv3_w8a8.TC),
    (64, 3, 0, conv3_w8a8.TC), (128, 8, 0, conv3_w8a8.TC),
    (40, 3, 0, conv3_w8a8.DP4A), (32, 64, 0, conv3_w8a8.DP4A),
    (64, 40, 0, conv3_w8a8.DP4A), (64, 16, 0, conv3_w8a8.DP4A),
    (64, 64, 8, conv3_w8a8.DP4A)])
def test_conv3_w8a8_route_of(ci, o, ptr, route):
    # every conv of the int8 lane (Ci in 64, 128, 256; O in 3, 64, 128,
    # 256) takes the tensor cores; other shapes and unaligned inputs dp4a
    assert conv3_w8a8.route_of(ci, o, ptr) == route


@pytest.mark.parametrize('o,ci', [(64, 64), (3, 64), (128, 128), (256, 256),
                                  (8, 128)])
def test_conv3_w8a8_pack_weight_tc_gathers_codes(o, ci):
    rng = np.random.default_rng(o + ci)
    w = torch.from_numpy(rng.normal(size=(o, ci, 3, 3)).astype(np.float32))
    w_q, _ = quantize_weight(w, (1, 2, 3))
    packed = conv3_w8a8.pack_weight_tc(w_q)
    ot = 8 if o <= 8 else 64
    n_ot = math.ceil(o / ot)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert packed.shape == (n_ot, ci // 64, 9, ot, 64)
    # packed[t, c, 3 * ky + kx, oo, i] = w_q[t * OT + oo, 64 * c + i, ky, kx]
    full = torch.zeros(n_ot * ot, ci, 3, 3, dtype=torch.int8)
    full[:o] = w_q
    want = full.reshape(n_ot, ot, ci // 64, 64, 9).permute(0, 2, 4, 1, 3)
    assert torch.equal(packed, want)
    # one (O tile, Ci chunk) slab is contiguous and holds its codes only
    t, c = n_ot - 1, ci // 64 - 1
    slab = packed.flatten()[(t * (ci // 64) + c) * 9 * ot * 64:][:9 * ot * 64]
    assert torch.equal(slab, want[t, c].flatten())
    if o < ot:
        assert not packed[:, :, :, o:].any()     # zero rows past O


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_tensor_scale_is_max_abs(dtype):
    x = torch.randn(2, 64, 9, 13, generator=torch.Generator().manual_seed(0))
    x = x.to(dtype)
    x[1, 3, 4, 5] = -7.25                 # the largest magnitude, negative
    assert torch.equal(tensor_scale(x), scale_of(x.abs().amax()))
    assert tensor_scale(torch.zeros(3, dtype=dtype)).item() == \
        pytest.approx(1e-12)


@pytest.mark.parametrize('n,k,slots,want', [
    (69696, 1024, 132, (4, 2)), (69696, 1024, 264, (8, 1)),
    (77, 100, 132, (1, 1)), (300, 1000, 132, (8, 1)),
    (10 ** 6, 1024, 132, (1, 8))])
def test_vq_choose_splits(n, k, slots, want):
    splits, per = vq_argmin.choose_splits(n, k, slots)
    assert (splits, per) == want
    k_tiles = math.ceil(k / vq_argmin.CODE_TILE)
    # the ranges cover the tiles, and none is empty
    assert (splits - 1) * per < k_tiles <= splits * per


def _kernel_order_argmin(z, cb, splits):
    """B3's search as the kernel orders it: thread column tx of an item
    keeps a running minimum over its codes k = tx mod 16 of one code range,
    in increasing order, replaced only by a strictly smaller distance; the
    16 columns of a token reduce to the least distance, ties to the lower
    index; the ranges merge in increasing order, again strictly."""
    d = cb.square().sum(1)[None, :] - 2.0 * (z @ cb.t())
    n, k = d.shape
    k_tiles = math.ceil(k / vq_argmin.CODE_TILE)
    per = math.ceil(k_tiles / splits)
    best_v = torch.full((n,), math.inf)
    best_i = torch.zeros(n, dtype=torch.int64)
    for lo in range(0, k, per * vq_argmin.CODE_TILE):
        hi = min(k, lo + per * vq_argmin.CODE_TILE)
        cand_v, cand_i = [], []
        for tx in range(16):
            ks = torch.arange(lo + tx, hi, 16)
            if len(ks) == 0:
                continue
            j = d[:, ks].argmin(1)          # first minimum in code order
            cand_v.append(d[:, ks].gather(1, j[:, None])[:, 0])
            cand_i.append(ks[j])
        v, i = torch.stack(cand_v, 1), torch.stack(cand_i, 1)
        least = v.min(1).values
        i = torch.where(v == least[:, None], i, k).min(1).values
        take = least < best_v
        best_v = torch.where(take, least, best_v)
        best_i = torch.where(take, i, best_i)
    return best_i.to(torch.int32)


@pytest.mark.parametrize('splits', [1, 2, 3, 8])
@pytest.mark.parametrize('k', [1024, 1000])
def test_vq_kernel_order_tie_break_matches_plain(splits, k):
    g = torch.Generator().manual_seed(k + splits)
    cb = torch.randn(k, 32, generator=g) * 4
    # exact duplicates of a code in the same column of a later tile, in
    # another column, in another code range, and last
    firsts = torch.tensor([5, 17, 200, 300])
    cb[torch.tensor([133, 22, 712, k - 1])] = cb[firsts]
    z = torch.cat([cb[firsts].repeat_interleave(8, 0)
                   + 0.01 * torch.randn(32, 32, generator=g),
                   torch.randn(64, 32, generator=g)])
    want = vq_argmin.vq_argmin_plain(z, cb)
    assert torch.equal(want[:32], firsts.repeat_interleave(8).int())
    assert torch.equal(_kernel_order_argmin(z, cb, splits), want)
    # the zero token ties every duplicate pair by the norms alone
    z0 = torch.zeros(1, 32)
    assert torch.equal(_kernel_order_argmin(z0, cb, splits),
                       vq_argmin.vq_argmin_plain(z0, cb))
