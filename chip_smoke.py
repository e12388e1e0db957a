#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases:
  1. build the seven CUDA kernels from femasr_torch/csrc (nvcc, in
     parallel: the six ports of the JAX package's Pallas kernels and the
     port's own act_bf16) and count the tensor-core instructions in each
     library's SASS;
  2. hold each kernel against its plain PyTorch version at the shapes the
     x4 release model gives it for a 512x512 LR image, in f32 (TF32 off)
     and bf16 (B1, B2: within one bf16 ulp, see
     femasr_torch/kernels/tolerance.py; B6 bit for bit), and time kernel,
     plain version and one library call (convolutions: cuDNN's autotuned
     algorithm; B3 must beat cdist().argmin; B5's fc1 and B4's bf16 qkv
     must beat torch._int_mm followed by the plain epilogue, B4's qkv
     within 0.2 ms, and the Swin shapes of B4 and B5 must take the
     tensor-core route; act_bf16's SiLU and GELU at the main path's sizes
     within one bf16 ulp of their op-by-op twins);
  3. serve a 512x512 (whole-image) and a 720x720 (tiled) image through
     `python -m femasr_torch.inference_cli` in bf16 with a seeded
     random-init release-config x4 model, once in the float lane (B1-B3)
     and once in the int8 lane (--int8_tail --int8_levels 3 --int8_enc_up
     --int8_swin --int8_mlp: B2-B6), both through act_bf16, counting
     kernel launches per lane,
     then compare one image in f32 with the kernels against the plain
     versions, per lane, and the float lane in bf16 (kernels and plain
     versions) against its f32 plain output;
  4. profile one warm 512px bf16 forward per lane (device time by kernel
     group; in the int8 lane B6's launches and time per shape, B5's per
     instantiation: fc1 int8 out, fc2 bf16 out, and B4's per route);
  5. print a JSON line of per-kernel numbers, the card's name and power
     limit, and last `{"ok": true, "device": {...}}`.

Any failed phase exits non-zero before the last line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12,    # fp32 on the CUDA cores (no TF32)
              torch.int8: 1979e12}     # dense tensor-core int8
INT8_LANE = dict(int8_tail=True, int8_levels=3, int8_enc_up=True,
                 int8_swin=True, int8_mlp=True)
INT8_FLAGS = ['--int8_tail', '--int8_levels', '3', '--int8_enc_up',
              '--int8_swin', '--int8_mlp']

TPU_SOURCES = {
    'conv3': 'femasr_tpu/ops/pallas/ws2d_conv.py:351',
    'window_attention': 'femasr_tpu/ops/pallas/window_attention.py:97',
    'vq_argmin': 'femasr_tpu/ops/pallas/vq.py:59',
    'matmul_w8a8': 'femasr_tpu/ops/pallas/int8_dense.py:164',
    'matmul_w8a8_q': 'femasr_tpu/ops/pallas/int8_dense.py:292',
    'conv3_w8a8': 'femasr_tpu/ops/pallas/int8_dense.py:437',
    # not a TPU kernel: the activations that the JAX package leaves to XLA
    'act_bf16': 'femasr_tpu/ops/layers.py:167,173 and femasr_tpu/ops/'
                'swin.py:256 (nn.silu, nn.gelu in bf16; XLA, no Pallas '
                'kernel)',
}
# kernels redesigned since their port, and how (their earlier times stand
# in PERF.md)
REDESIGNED = {
    'conv3': 'for the bf16 tensor cores',
    'window_attention': 'for the bf16 tensor cores',
    'vq_argmin': 'as a register-tiled f32 FFMA GEMM with the argmin fused '
                 'in (no tensor cores by design: TF32 would flip near-tie '
                 'indices)',
    'matmul_w8a8': 'for the int8 tensor cores (mma.sync s8 GEMM over rows '
                   'quantized once into shared memory)',
    'matmul_w8a8_q': 'for the int8 tensor cores (mma.sync s8 GEMM; the '
                     'int8-out row max across a cluster of blocks)',
    'conv3_w8a8': 'for the int8 tensor cores (implicit GEMM, mma.sync s8)',
}
# kernels whose SASS must hold tensor-core instructions
TENSOR_CORE_KERNELS = ('conv3', 'window_attention', 'matmul_w8a8',
                       'matmul_w8a8_q', 'conv3_w8a8')
TC_OPS = ('HMMA', 'HGMMA', 'IMMA', 'IGMMA')
BF16_PSNR_SLACK_DB = 0.5  # kernels vs plain versions, float lane in bf16
TPU_FUNCTIONS = {
    'conv3': 'femasr_tpu/ops/pallas/ws2d_conv.py:conv3_ws2d',
    'window_attention':
        'femasr_tpu/ops/pallas/window_attention.py:window_attention_fused',
    'vq_argmin': 'femasr_tpu/ops/pallas/vq.py:vq_argmin',
    'matmul_w8a8': 'femasr_tpu/ops/pallas/int8_dense.py:matmul_w8a8',
    'matmul_w8a8_q': 'femasr_tpu/ops/pallas/int8_dense.py:matmul_w8a8_q',
    'conv3_w8a8': 'femasr_tpu/ops/pallas/int8_dense.py:conv3_w8a8',
    'act_bf16': None,
}
# B4's bf16 Swin qkv (packed weight) must take at most this long
MM_QKV_MAX_MS = 0.2


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of fn() in ms over `reps` launches (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


@contextlib.contextmanager
def counting_off(*mods):
    """Kernel launches made for comparisons do not count for the main path."""
    saved = [m.launches for m in mods]
    try:
        yield
    finally:
        for m, s in zip(mods, saved):
            m.launches = s


@contextlib.contextmanager
def cudnn_autotuned():
    """cuDNN times its algorithms for each new shape and keeps the fastest,
    rather than taking its heuristic's pick: the library time a kernel is
    held to. time_ms's warm-up calls pay the autotuning."""
    saved = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = saved


# -- phase 2: each kernel against its plain version ------------------------

def check_conv3(dev, results):
    from femasr_torch.kernels import conv3 as mod
    from femasr_torch.kernels.tolerance import bf16_agreement
    from femasr_torch.ops.layers import GroupNorm
    g = torch.Generator(device=dev).manual_seed(1)
    b, c, h, w = 1, 64, 2112, 2112
    x32 = torch.randn((b, c, h, w), generator=g, device=dev).contiguous(
        memory_format=torch.channels_last)
    gn = GroupNorm(32, c).to(dev)
    with torch.no_grad():
        gn.weight.uniform_(0.5, 1.5, generator=g)
        gn.bias.uniform_(-0.5, 0.5, generator=g)
    bound = 1.0 / (c * 9) ** 0.5
    # label: (O, prologue, key prefix in the kernels line); the case with
    # no prologue shows what the prologue costs
    cases = {
        'res 64->64 + gn/silu prologue': (64, True, ''),
        'res 64->64, no prologue': (64, False, 'no_prologue_'),
        'out_conv 64->3': (3, False, 'out_conv_'),
    }
    entry, extra = {}, {}
    for label, (o, pre, key) in cases.items():
        wt = (torch.rand((o, c, 3, 3), generator=g, device=dev) * 2 - 1) * bound
        bias = (torch.rand((o,), generator=g, device=dev) * 2 - 1) * bound
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            kw = {}
            xa = x
            if pre:
                a, s = gn.affine(x)
                kw = dict(scale=a, shift=s, pre_act='silu')
                xa = F.silu(x.float() * a[:, :, None, None]
                            + s[:, :, None, None]).to(dtype)
            with counting_off(mod):
                y = mod.conv3(x, wt, bias, **kw)
                torch.cuda.synchronize()
                ref = mod.conv3_plain(x, wt, bias, **kw)
                if dtype == torch.float32:
                    tol = '1e-4'
                    err = (y - ref).abs().max().item()
                    ok = torch.allclose(y, ref, atol=1e-4, rtol=1e-4)
                else:
                    # one flipped prologue rounding moves an output by at
                    # most ulp(x_act) * max|w| <= 2^-7 max|x_act| max|w|
                    atol = (2.0 ** -7 * xa.float().abs().max().item()
                            * wt.abs().max().item())
                    ok, err, beyond = bf16_agreement(y, ref, atol)
                    tol = (f'one bf16 ulp, {beyond:.2e} of outputs beyond '
                           f'it (<= 1e-3), by <= {atol:.2e}')
                ms = time_ms(lambda: mod.conv3(x, wt, bias, **kw))
            plain_ms = time_ms(lambda: mod.conv3_plain(x, wt, bias, **kw))
            wl = wt.to(dtype).contiguous(memory_format=torch.channels_last)
            bl = bias.to(dtype)
            # F.conv2d adds the bias in a pass of its own after cuDNN's
            # convolution: timed with it (the function) and without
            with cudnn_autotuned():
                lib_ms = time_ms(lambda: F.conv2d(xa, wl, bl, padding=1))
                conv_ms = time_ms(lambda: F.conv2d(xa, wl, None, padding=1))
            flops = 2.0 * b * h * w * c * o * 9
            bms, by = bound_ms(nbytes(x, y, wt, bias, kw.get('scale'),
                                      kw.get('shift')), flops, dtype)
            print(f'[conv3] {label} {str(dtype)[6:]}: max_abs_err={err:.3e} '
                  f'(tol {tol}) ms={ms:.4f} plain_ms={plain_ms:.4f} '
                  f'library_ms={lib_ms:.4f} (F.conv2d with bias, cuDNN '
                  f'autotuned; without bias {conv_ms:.4f}) bound_ms={bms:.4f} '
                  f'({by})', flush=True)
            require(ok, f'conv3 {label} {dtype}: kernel disagrees with plain '
                        f'(max abs err {err})')
            if dtype == torch.bfloat16:
                nums = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                            library_conv_only_ms=conv_ms, bound_ms=bms)
                if key:
                    extra.update({key + k: v for k, v in nums.items()})
                else:
                    entry = dict(nums, max_abs_err=err, bound_by=by,
                                 dtype='bfloat16', share_beyond_one_ulp=beyond,
                                 shape='x (1,64,2112,2112) -> 64, gn+silu '
                                       'prologue')
            del y, ref, xa
    results['conv3'] = dict(entry, **extra)


def check_window_attention(dev, results):
    from femasr_torch.kernels import window_attention as mod
    from femasr_torch.kernels.tolerance import bf16_agreement
    from femasr_torch.ops.swin import shifted_window_mask
    g = torch.Generator(device=dev).manual_seed(2)
    b_, n, nh, hd = 1089, 64, 8, 32
    c = nh * hd
    qkv32 = torch.randn((b_, n, 3 * c), generator=g, device=dev)
    bias = (torch.randn((nh, n, n), generator=g, device=dev) * 0.02)
    mask = torch.from_numpy(shifted_window_mask(264, 264, 8, 4)).to(dev)
    entry = None
    for with_mask in (False, True):
        m = mask if with_mask else None
        for dtype in (torch.float32, torch.bfloat16):
            qkv = qkv32.to(dtype)
            q = qkv[..., :c] * torch.tensor(hd ** -0.5, dtype=dtype)
            k, v = qkv[..., c:2 * c], qkv[..., 2 * c:]
            with counting_off(mod):
                y = mod.window_attention(q, k, v, bias, m, nh)
                torch.cuda.synchronize()
                ref = mod.window_attention_plain(q, k, v, bias, m, nh)
                if dtype == torch.float32:
                    tol = '1e-5'
                    err = (y - ref).abs().max().item()
                    ok = torch.allclose(y, ref, atol=1e-5, rtol=1e-5)
                else:
                    # one flipped probability (p < 1, ulp(p) <= 2^-8) moves
                    # an output by at most 2^-8 max|v|
                    atol = 2.0 ** -8 * v.float().abs().max().item()
                    ok, err, beyond = bf16_agreement(y, ref, atol)
                    tol = (f'one bf16 ulp, {beyond:.2e} of outputs beyond '
                           f'it (<= 1e-3), by <= {atol:.2e}')
                ms = time_ms(lambda: mod.window_attention(q, k, v, bias, m,
                                                          nh))
            plain_ms = time_ms(lambda: mod.window_attention_plain(
                q, k, v, bias, m, nh))
            qh = q.reshape(b_, n, nh, hd).transpose(1, 2)
            kh = k.reshape(b_, n, nh, hd).transpose(1, 2)
            vh = v.reshape(b_, n, nh, hd).transpose(1, 2)
            am = bias[None].expand(b_, nh, n, n)
            if with_mask:
                am = am + mask[:, None]
            am = am.to(dtype)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=am, scale=1.0))
            flops = 4.0 * b_ * nh * n * n * hd
            bms, by = bound_ms(nbytes(q, k, v, y, bias, m), flops, dtype)
            print(f'[window_attention] mask={with_mask} {str(dtype)[6:]}: '
                  f'max_abs_err={err:.3e} (tol {tol}) ms={ms:.4f} '
                  f'plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} '
                  f'bound_ms={bms:.4f} ({by})', flush=True)
            require(ok, f'window_attention mask={with_mask} {dtype}: kernel '
                        f'disagrees with plain (max abs err {err})')
            if with_mask and dtype == torch.bfloat16:
                entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by,
                             dtype='bfloat16', share_beyond_one_ulp=beyond,
                             shape='q,k,v (1089,64,256), 8 heads, mask '
                                   '(1089,64,64)')
    results['window_attention'] = entry


def check_vq_argmin(dev, results):
    from femasr_torch.kernels import vq_argmin as mod
    g = torch.Generator(device=dev).manual_seed(3)
    n, k, c = 69696, 1024, 512
    z = torch.randn((n, c), generator=g, device=dev)
    cb = torch.randn((k, c), generator=g, device=dev)
    with counting_off(mod):
        idx = mod.vq_argmin(z, cb)
        torch.cuda.synchronize()
        ref = mod.vq_argmin_plain(z, cb)
        ms = time_ms(lambda: mod.vq_argmin(z, cb))
        # the codebook split into ranges (wave quantization): the wrapper's
        # choice against each count
        by_splits = {sp: time_ms(lambda: mod.vq_argmin(z, cb, splits=sp))
                     for sp in (1, 2, 4, 8)}
    slots = mod.slots(z.device)
    splits, per = mod.choose_splits(n, k, slots)
    print(f'[vq_argmin] {slots} block slots; chosen {splits} code ranges of '
          f'{per} 128-code tiles; ms by ranges: '
          + ', '.join(f'{sp}: {t:.4f}' for sp, t in by_splits.items()),
          flush=True)
    plain_ms = time_ms(lambda: mod.vq_argmin_plain(z, cb))
    lib_ms = time_ms(lambda: torch.cdist(z, cb).argmin(1))
    diff = (idx != ref).nonzero().flatten()
    agree = 1.0 - diff.numel() / n
    worst_gap = dist_err = 0.0
    if diff.numel():
        # exact (f64) distances of the two chosen codes: a near-tie only
        zd, cd = z[diff].double(), cb.double()
        d_k = (zd - cd[idx[diff].long()]).square().sum(1)
        d_p = (zd - cd[ref[diff].long()]).square().sum(1)
        dist_err = (d_k - d_p).abs().max().item()
        worst_gap = ((d_k - d_p).abs() / d_p.abs()).max().item()
    flops = 2.0 * n * k * c + 2.0 * k * c
    bms, by = bound_ms(nbytes(z, cb, idx), flops, torch.float32)
    print(f'[vq_argmin] f32: index agreement={agree:.6f} '
          f'({diff.numel()} differ, worst distance gap {dist_err:.3e}, '
          f'relative {worst_gap:.2e}) '
          f'ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} '
          f'bound_ms={bms:.4f} ({by})', flush=True)
    require(agree >= 0.9999 and worst_gap <= 1e-5,
            f'vq_argmin disagrees: agreement {agree}, gap {worst_gap}')
    # bf16 tokens are searched in f32: same indices as the f32 plain
    # version on the bf16-rounded tokens
    zb = z.to(torch.bfloat16)
    with counting_off(mod):
        idx_b = mod.vq_argmin(zb, cb)
    agree_b = (idx_b == mod.vq_argmin_plain(zb, cb)).float().mean().item()
    print(f'[vq_argmin] bf16 tokens: index agreement={agree_b:.6f}',
          flush=True)
    require(agree_b >= 0.9999, f'vq_argmin bf16 agreement {agree_b}')
    require(ms < lib_ms, f'vq_argmin ({ms} ms) loses to cdist().argmin '
                         f'({lib_ms} ms)')
    results['vq_argmin'] = dict(
        max_abs_err=dist_err, index_agreement=agree, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
        dtype='float32', shape='z (69696,512) x codebook (1024,512)',
        splits=splits, ms_by_splits=by_splits)


def agree_w8a8(y, ref) -> tuple:
    """(ok, max abs err): f32 to 1e-6 relative (the kernel and the plain
    version run the same f32 epilogue on the same exact integer sums), bf16
    to one bf16 ulp (2^-7 relative at most)."""
    rtol = 1e-6 if y.dtype == torch.float32 else 2.0 ** -7
    y, ref = y.float(), ref.float()
    err = (y - ref).abs().max().item()
    return torch.allclose(y, ref, rtol=rtol, atol=1e-6), err


# main-path shapes of B4-B6 for a 512px LR image (padded to 528)
TOKENS = 69696  # 264^2 Swin tokens
MM_CASES = {'qkv 256->768': (256, 768), 'proj 256->256': (256, 256),
            'fc1 256->1024': (256, 1024),
            'fc2 1024->256': (1024, 256)}       # per-tensor (int8_swin)
MMQ_CASES = {'fc1 256->1024 gelu int8-out': (256, 1024, 'gelu', True),
             'fc2 1024->256': (1024, 256, None, False)}   # the MLP chain
CONV_CASES = {'2112^2 64->64': (2112, 64, 64),
              '2112^2 128->64': (2112, 128, 64),
              '528^2 256->256': (528, 256, 256),
              'out_conv 2112^2 64->3': (2112, 64, 3)}


def mm_composite(x, w_q, s_w, bias):
    """B4's function as the per-tensor scale, the quantize, torch._int_mm
    (the integer product) and the plain version's epilogue: the nearest
    library composite, a yardstick only."""
    from femasr_torch.kernels._w8a8 import epilogue, quantize, tensor_scale
    s_x = tensor_scale(x)
    y = epilogue(torch._int_mm(quantize(x, s_x), w_q.t()), s_x * s_w, bias,
                 None)
    return y.to(x.dtype)


def check_matmul_w8a8(dev, results):
    from femasr_torch.kernels import matmul_w8a8 as mod
    from femasr_torch.kernels._w8a8 import (quantize, quantize_weight,
                                            tensor_scale)
    from femasr_torch.kernels.matmul_w8a8_q import weight_tc
    g = torch.Generator(device=dev).manual_seed(4)
    x32 = torch.randn((TOKENS, 1024), generator=g, device=dev)
    entry, extra = None, {}
    for label, (k, n) in MM_CASES.items():
        wt = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
        bias = torch.randn((n,), generator=g, device=dev) * 0.02
        # the weight as a serving LinearInt8 holds it: quantized and packed
        # once, then passed to every call
        packed = weight_tc(wt)
        w_q, s_w = quantize_weight(wt, 1)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32[:, :k].contiguous().to(dtype)
            require(mod.route_of(k, n, x.data_ptr()) == mod.TC,
                    f'matmul_w8a8 {label}: not on the tensor-core route')

            def run(packed=packed):
                return mod.matmul_w8a8(x, wt, bias, packed=packed)
            with counting_off(mod):
                y = run()
                torch.cuda.synchronize()
                ref = mod.matmul_w8a8_plain(x, wt, bias)
                ok, err = agree_w8a8(y, ref)
                ms = time_ms(run)
                # like for like with the earlier kernel's times: the
                # wrapper quantizes and packs the weight in every call
                ms_prep = time_ms(lambda: run(None))
            plain_ms = time_ms(lambda: mod.matmul_w8a8_plain(x, wt, bias))
            x_q = quantize(x, tensor_scale(x))
            w_t = w_q.t()
            lib_ms = time_ms(lambda: torch._int_mm(x_q, w_t))
            # the yardstick computes the same function
            require(torch.equal(mm_composite(x, w_q, s_w, bias), ref),
                    f'matmul_w8a8 {label} {dtype}: composite differs from '
                    f'plain')
            comp_ms = time_ms(lambda: mm_composite(x, w_q, s_w, bias))
            bms, by = bound_ms(nbytes(x, y, w_q, s_w, bias) + 4,
                               2.0 * TOKENS * k * n, torch.int8)
            print(f'[matmul_w8a8] {label} {str(dtype)[6:]} (tensor cores): '
                  f'max_abs_err={err:.3e} ms={ms:.4f} (weight packed once; '
                  f'packed in every call: {ms_prep:.4f}) '
                  f'plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} '
                  f'(torch._int_mm, integer product only) composite_ms='
                  f'{comp_ms:.4f} (tensor_scale + quantize + torch._int_mm '
                  f'+ the plain epilogue) bound_ms={bms:.4f} ({by})',
                  flush=True)
            require(ok, f'matmul_w8a8 {label} {dtype}: kernel disagrees '
                        f'with plain (max abs err {err})')
            nums = dict(ms=ms, ms_packing_each_call=ms_prep,
                        plain_ms=plain_ms, library_ms=lib_ms,
                        composite_ms=comp_ms, bound_ms=bms, bound_by=by,
                        max_abs_err=err)
            if label.startswith('qkv') and dtype == torch.bfloat16:
                require(ms < comp_ms, f'matmul_w8a8 {label}: {ms} ms, not '
                                      f'faster than the composite '
                                      f'({comp_ms} ms)')
                require(ms <= MM_QKV_MAX_MS, f'matmul_w8a8 {label}: {ms} '
                                             f'ms, over {MM_QKV_MAX_MS} ms')
                entry = dict(nums, library='torch._int_mm on the '
                             'pre-quantized operands (integer product only)',
                             composite='tensor_scale + quantize + '
                                       'torch._int_mm + the plain epilogue',
                             dtype='bfloat16',
                             shape='x (69696,256) -> 768 (Swin qkv)')
            elif label.startswith('proj') and dtype == torch.bfloat16:
                extra = {'proj_' + key: v for key, v in nums.items()}
            del y, ref
    results['matmul_w8a8'] = dict(entry, **extra)


def check_act_bf16(dev, results):
    """act_bf16 against its op-by-op twin at the main path's sizes: SiLU on
    the int8 lane's last decoder level, GELU on the Swin MLP's hidden
    activations; F.silu / F.gelu (one rounding, not the same function in
    bf16) are timed for context."""
    from femasr_torch.kernels import act_bf16 as mod
    from femasr_torch.kernels.tolerance import bf16_agreement
    g = torch.Generator(device=dev).manual_seed(7)
    cases = {'silu': ((1, 64, 2112, 2112), F.silu),
             'gelu': ((TOKENS, 1024),
                      lambda t: F.gelu(t, approximate='tanh'))}
    entry, extra = None, {}
    for act, (shape, lib) in cases.items():
        x = (torch.randn(shape, generator=g, device=dev) * 3).to(
            torch.bfloat16)
        if x.dim() == 4:
            x = x.contiguous(memory_format=torch.channels_last)
        with counting_off(mod):
            y = mod.act_bf16(x, act)
            torch.cuda.synchronize()
            ref = mod.act_bf16_plain(x, act)
            ok, err, beyond = bf16_agreement(y, ref, 0.0)
            equal = torch.equal(y, ref)
            ms = time_ms(lambda: mod.act_bf16(x, act))
        plain_ms = time_ms(lambda: mod.act_bf16_plain(x, act))
        ctx_ms = time_ms(lambda: lib(x))
        bms, by = bound_ms(nbytes(x, y), 0.0, torch.bfloat16)
        print(f'[act_bf16] {act} {tuple(shape)} bf16: max_abs_err={err:.3e} '
              f'(bit for bit: {equal}; {beyond:.2e} of outputs beyond one '
              f'bf16 ulp) ms={ms:.4f} plain_ms={plain_ms:.4f} (the op-by-op '
              f'twin) library_ms=null (F.{act} for context, one rounding: '
              f'{ctx_ms:.4f}) bound_ms={bms:.4f} ({by})', flush=True)
        require(ok, f'act_bf16 {act}: kernel disagrees with its twin '
                    f'({beyond} beyond one ulp, max abs err {err})')
        nums = dict(ms=ms, plain_ms=plain_ms, library_ms=None,
                    context_one_rounding_ms=ctx_ms, bound_ms=bms,
                    bound_by=by, max_abs_err=err, bit_for_bit=equal)
        if act == 'silu':
            entry = dict(nums, dtype='bfloat16', tpu_kernel=False,
                         shape='x (1,64,2112,2112), silu (int8 lane '
                               'decoder level)')
        else:
            extra = {'gelu_' + key: v for key, v in nums.items()}
            extra['gelu_shape'] = 'x (69696,1024), tanh gelu (Swin MLP)'
        del x, y, ref
    results['act_bf16'] = dict(entry, **extra)


def mmq_composite(x_q, s_x, w_q, s_w, bias, act, out_int8, dtype):
    """B5's function as torch._int_mm (the integer product) followed by the
    plain version's epilogue: the nearest library composite, a yardstick
    only."""
    from femasr_torch.kernels._w8a8 import epilogue, quantize, scale_of
    y = epilogue(torch._int_mm(x_q, w_q.t()), s_x.reshape(-1, 1) * s_w, bias,
                 act)
    if out_int8:
        s_y = scale_of(y.abs().amax(dim=-1, keepdim=True))
        return quantize(y, s_y), s_y
    return y.to(dtype)


def check_matmul_w8a8_q(dev, results):
    from femasr_torch.kernels import matmul_w8a8_q as mod
    from femasr_torch.kernels._w8a8 import quantize_weight
    from femasr_torch.ops.layers import quantize_rows
    g = torch.Generator(device=dev).manual_seed(5)
    entry, extra = None, {}
    for label, (k, n, act, out_int8) in MMQ_CASES.items():
        x_q, s_x = quantize_rows(torch.randn((TOKENS, k), generator=g,
                                             device=dev))
        require(mod.route_of(k, n, x_q.data_ptr()) == mod.TC,
                f'matmul_w8a8_q {label}: not on the tensor-core route')
        wt = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
        bias = torch.randn((n,), generator=g, device=dev) * 0.02
        w_q, s_w = quantize_weight(wt, 1)
        # the weight as a serving LinearInt8 holds it: quantized and packed
        # once (weight_prep_ms), then passed to every call
        packed = mod.weight_tc(wt)
        for dtype in ((torch.float32,) if out_int8
                      else (torch.float32, torch.bfloat16)):
            def run(packed=packed):
                return mod.matmul_w8a8_q(x_q, s_x, wt, bias, act=act,
                                         out_int8=out_int8, out_dtype=dtype,
                                         packed=packed)

            def plain():
                return mod.matmul_w8a8_q_plain(x_q, s_x, wt, bias, act=act,
                                               out_int8=out_int8,
                                               out_dtype=dtype)
            with counting_off(mod):
                y = run()
                torch.cuda.synchronize()
                ref = plain()
                if out_int8:
                    d = (y[0].int() - ref[0].int()).abs()
                    scale_ok, _ = agree_w8a8(y[1], ref[1])
                    err = d.max().item()
                    off = d.float().mean().item()
                    ok = err <= 1 and off <= 1e-3 and scale_ok
                    note = f'codes off by <=1 on {off:.2e}'
                else:
                    ok, err = agree_w8a8(y, ref)
                    note = ''
                ms = time_ms(run)
                # like for like with PR 5's ms: the wrapper packs the
                # weight on every call
                ms_prep = time_ms(lambda: run(None))
                if out_int8:
                    # where fc1's time goes: the same product in bf16 out
                    # (no row max, no quantize), with and without the GELU
                    split = {f'{a or "no"}_act_bf16_out_ms': time_ms(
                        lambda a=a: mod.matmul_w8a8_q(
                            x_q, s_x, wt, bias, act=a,
                            out_dtype=torch.bfloat16, packed=packed))
                        for a in (act, None)}
                    print(f'[matmul_w8a8_q] {label}, bf16 out instead: '
                          + ', '.join(f'{k}={v:.4f}' for k, v in
                                      split.items()), flush=True)
            # the weight quantize and tensor-core packing, once per weight
            # (weight_tc; not inside ms)
            prep_ms = time_ms(lambda: mod.weight_tc(wt))
            plain_ms = time_ms(plain)
            w_t = w_q.t()
            lib_ms = time_ms(lambda: torch._int_mm(x_q, w_t))
            def comp():
                return mmq_composite(x_q, s_x, w_q, s_w, bias, act, out_int8,
                                     dtype)
            # the yardstick computes the same function
            cy = comp()
            require(torch.equal(cy[0], ref[0]) if out_int8
                    else torch.equal(cy, ref),
                    f'matmul_w8a8_q {label}: composite differs from plain')
            comp_ms = time_ms(comp)
            outs = y if out_int8 else (y,)
            bms, by = bound_ms(nbytes(x_q, s_x, w_q, s_w, bias, *outs),
                               2.0 * TOKENS * k * n, torch.int8)
            out_name = 'int8' if out_int8 else str(dtype)[6:]
            print(f'[matmul_w8a8_q] {label} -> {out_name} (tensor cores): '
                  f'max_abs_err={err:.3e} {note} ms={ms:.4f} (the weight '
                  f'quantize and pack, once per weight: {prep_ms:.4f}; '
                  f'packed in every call: {ms_prep:.4f}) '
                  f'plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} '
                  f'(torch._int_mm, integer product only) composite_ms='
                  f'{comp_ms:.4f} (torch._int_mm + the plain epilogue) '
                  f'bound_ms={bms:.4f} ({by})', flush=True)
            require(ok, f'matmul_w8a8_q {label} {dtype}: kernel disagrees '
                        f'with plain (max err {err})')
            nums = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        composite_ms=comp_ms, weight_prep_ms=prep_ms,
                        ms_packing_each_call=ms_prep,
                        bound_ms=bms, bound_by=by, max_abs_err=err)
            if out_int8:
                require(ms < comp_ms, f'matmul_w8a8_q {label}: {ms} ms, not '
                                      f'faster than torch._int_mm + the '
                                      f'plain epilogue ({comp_ms} ms)')
                entry = dict(nums, **split, library='torch._int_mm on the '
                             'pre-quantized operands (integer product only)',
                             composite='torch._int_mm + the plain epilogue',
                             dtype='int8 in, int8 + f32 row scales out',
                             shape='x_q (69696,256) -> 1024, gelu, int8 out '
                                   '(Swin MLP fc1)')
            elif dtype == torch.bfloat16:
                extra = {'fc2_' + key: v for key, v in nums.items()}
                extra['fc2_shape'] = 'x_q (69696,1024) -> 256, bf16 out'
            del y, ref, cy
    results['matmul_w8a8_q'] = dict(entry, **extra)


def check_conv3_w8a8(dev, results):
    from femasr_torch.kernels import conv3_w8a8 as mod
    from femasr_torch.kernels._w8a8 import quantize_weight, tensor_scale
    g = torch.Generator(device=dev).manual_seed(6)
    entry = None
    for label, (hw, c, o) in CONV_CASES.items():
        x32 = torch.randn((1, c, hw, hw), generator=g, device=dev).contiguous(
            memory_format=torch.channels_last)
        wt = (torch.rand((o, c, 3, 3), generator=g, device=dev) * 2 - 1) \
            * (c * 9) ** -0.5
        bias = (torch.rand((o,), generator=g, device=dev) * 2 - 1) * 0.05
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            with counting_off(mod):
                y = mod.conv3_w8a8(x, wt, bias)
                torch.cuda.synchronize()
                ref = mod.conv3_w8a8_plain(x, wt, bias)
                ok, err = agree_w8a8(y, ref)
                ms = time_ms(lambda: mod.conv3_w8a8(x, wt, bias))
            plain_ms = time_ms(lambda: mod.conv3_w8a8_plain(x, wt, bias),
                               reps=3, warm=1)
            wl = wt.to(dtype).contiguous(memory_format=torch.channels_last)
            bl = bias.to(dtype)
            with cudnn_autotuned():
                ctx_ms = time_ms(lambda: F.conv2d(x, wl, bl, padding=1))
            w_q, s_w = quantize_weight(wt, (1, 2, 3))
            bms, by = bound_ms(nbytes(x, y, w_q, s_w, bias) + 4,
                               2.0 * hw * hw * c * o * 9, torch.int8)
            # the wrapper's max|x| pass (one reduction), inside ms
            scale_ms = time_ms(lambda: tensor_scale(x))
            route = ('tensor cores' if mod.route_of(c, o, x.data_ptr())
                     == mod.TC else 'dp4a')
            print(f'[conv3_w8a8] {label} {str(dtype)[6:]} ({route}): '
                  f'max_abs_err={err:.3e} ms={ms:.4f} (of which the max|x| '
                  f'pass {scale_ms:.4f}) plain_ms={plain_ms:.4f} '
                  f'library_ms=null (no PyTorch call computes an int8 conv; '
                  f'bf16/f32 F.conv2d for context: {ctx_ms:.4f}) '
                  f'bound_ms={bms:.4f} ({by})', flush=True)
            # the integer sums are exact and the epilogue runs the plain
            # version's f32 operations: equal bit for bit
            require(ok and err == 0.0, f'conv3_w8a8 {label} {dtype}: kernel '
                                       f'disagrees with plain (max abs err '
                                       f'{err})')
            if label == next(iter(CONV_CASES)) and dtype == torch.bfloat16:
                entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=None, context_conv2d_ms=ctx_ms,
                             max_abs_pass_ms=scale_ms, bound_ms=bms,
                             bound_by=by, dtype='bfloat16',
                             shape='x (1,64,2112,2112) -> 64')
            del y, ref, x
        del x32
    results['conv3_w8a8'] = entry


# -- phase 3: the main path --------------------------------------------------

def smooth_image(rng, h, w):
    """Seeded smooth RGB uint8 test image (coarse noise, bilinear-upsampled)."""
    coarse = torch.from_numpy(rng.random((1, 3, h // 16 + 1, w // 16 + 1),
                                         dtype=np.float32))
    img = F.interpolate(coarse, size=(h, w), mode='bilinear',
                        align_corners=False)[0]
    img = img + 0.05 * torch.from_numpy(rng.standard_normal(
        (3, h, w)).astype(np.float32))
    return (img.clamp(0, 1).permute(1, 2, 0).numpy() * 255).round().astype(
        np.uint8)


@contextlib.contextmanager
def plain_kernels():
    """Route the model's kernel calls to the plain versions (f32 reference)."""
    from femasr_torch.kernels import (act_bf16, conv3, conv3_w8a8,
                                      matmul_w8a8, matmul_w8a8_q, vq_argmin,
                                      window_attention)
    from femasr_torch.models import femasr_arch
    from femasr_torch.ops import layers, quantize, swin

    def mm_plain(*args, packed=None, **kwargs):  # needs no packed weight
        return matmul_w8a8.matmul_w8a8_plain(*args, **kwargs)

    def mmq_plain(*args, packed=None, **kwargs):
        return matmul_w8a8_q.matmul_w8a8_q_plain(*args, **kwargs)
    saved = [(layers, 'conv3', conv3.conv3_plain),
             (femasr_arch, 'conv3', conv3.conv3_plain),
             (swin, 'window_attention',
              window_attention.window_attention_plain),
             (quantize, 'vq_argmin', vq_argmin.vq_argmin_plain),
             (layers, 'conv3_w8a8', conv3_w8a8.conv3_w8a8_plain),
             (layers, 'matmul_w8a8', mm_plain),
             (layers, 'matmul_w8a8_q', mmq_plain),
             (layers, 'act_bf16', act_bf16.act_bf16_plain)]
    old = [(m, name, getattr(m, name)) for m, name, _ in saved]
    try:
        for m, name, fn in saved:
            setattr(m, name, fn)
        yield
    finally:
        for m, name, fn in old:
            setattr(m, name, fn)


# lane -> (CLI flags, SRInferencer/FeMaSRNet kwargs, kernels it must run)
LANES = {
    'float': ([], {}, ('conv3', 'window_attention', 'vq_argmin',
                       'act_bf16')),
    'int8': (INT8_FLAGS, INT8_LANE, ('window_attention', 'vq_argmin',
                                     'matmul_w8a8', 'matmul_w8a8_q',
                                     'conv3_w8a8', 'act_bf16')),
}
MAX_STEPS = 1e-2  # own vs forced int8-layer input, in quantization steps


def serve_lane(dev, lane, in_dir, pth, work, sizes):
    """The CLI over both images in bf16; counts are zeroed just before the
    run and read just after."""
    import cv2

    from femasr_torch import inference_cli, kernels

    flags, _, needed = LANES[lane]
    out_dir = os.path.join(work, f'sr_{lane}')
    argv = ['-i', in_dir, '-w', pth, '-o', out_dir, '-s', '4',
            '--precision', 'bf16', '--device', str(dev), *flags]
    kernels.reset_launches()
    stats = inference_cli.main(argv)
    sync(dev)
    counts = kernels.launch_counts()
    print(f'[main path] {lane} lane, bf16 CLI run: {stats}; kernel launches '
          f'{counts}', flush=True)
    for name, s in sizes.items():
        out = cv2.imread(os.path.join(out_dir, name), cv2.IMREAD_UNCHANGED)
        require(out is not None and out.shape == (4 * s, 4 * s, 3),
                f'{lane} {name}: output {None if out is None else out.shape}')
        require(out.std() > 0, f'{lane} {name}: constant output')
    for name in needed:
        require(counts[name] > 0,
                f'kernel {name} was not launched on the {lane} lane')
    with counting_off(*kernels.MODULES.values()):
        warm = inference_cli.main(argv)
    print(f'[main path] {lane} lane, bf16 CLI run, warm: {warm}; '
          f'{warm["megapixels"] / warm["seconds"]:.4f} MP/s', flush=True)
    return counts, stats, warm


def int8_boundary_summary(stats: dict) -> dict:
    """Worst own-vs-forced distances over the int8 layers of one run."""
    fl = [v for v in stats.values() if v['kind'] == 'float']
    cd = [v for v in stats.values() if v['kind'] == 'codes']
    return dict(
        layers=len(stats),
        float_max_steps=max(v['max_steps'] for v in fl),
        float_flips=sum(v['flips'] for v in fl),
        float_numel=sum(v['numel'] for v in fl),
        codes_max_diff=max(v['max_code_diff'] for v in cd),
        codes_worst_flip_share=max(v['flips'] / v['numel'] for v in cd),
        codes_scale_rel=max(v['scale_rel'] for v in cd))


def f32_check(dev, lane, state_dict, img, whole):
    """One image in f32 through the lane, kernels against plain versions.

    The int8 lane's plain run takes each int8 layer's input from the kernel
    run (femasr_torch.models.int8_forcing): the attention kernel's f32
    summation order alone moves a few activations across round-half
    boundaries, and a code step then grows through every later layer. The
    own inputs must stay within MAX_STEPS quantization steps of the forced
    ones (chain links: codes off by <= 1 on <= 0.1%). The unforced plain
    run is reported beside it."""
    from femasr_torch import kernels
    from femasr_torch.models import SRInferencer, int8_forcing
    from femasr_torch.models.inference import flip_pad

    sr32 = SRInferencer(state_dict, device=dev, dtype=torch.float32,
                        **LANES[lane][1])
    model = sr32.model
    x = torch.from_numpy(img.transpose(2, 0, 1).copy())[None].to(dev)
    pad = (whole // sr32.wsz + 1) * sr32.wsz - whole
    xp = flip_pad(x, pad, pad)
    s4 = 4 * whole
    info = {}

    def crop(out):
        return out.float().clamp(0, 1)[:, :, :s4, :s4]

    with torch.inference_mode(), counting_off(*kernels.MODULES.values()):
        store = {}
        with int8_forcing.record(model, store) if lane == 'int8' \
                else contextlib.nullcontext():
            out_k, _, idx_k = model(xp)
        out_k = crop(out_k)
        with plain_kernels():
            if lane == 'int8':
                out_u, _, idx_u = model(xp)
                info['unforced_index_agreement'] = (
                    idx_k[0] == idx_u[0]).float().mean().item()
                info['unforced_mean_abs_diff'] = (
                    out_k - crop(out_u)).abs().mean().item()
                del out_u
                stats = {}
                with int8_forcing.force(model, store, stats):
                    out_p, _, idx_p = model(xp)
                info['int8_layers'] = int8_boundary_summary(stats)
            else:
                out_p, _, idx_p = model(xp)
        del store
    sync(dev)
    out_p = crop(out_p)
    agree = (idx_k[0] == idx_p[0]).float().mean().item()
    mean_diff = (out_k - out_p).abs().mean().item()
    max_diff = (out_k - out_p).abs().max().item()
    print(f'[main path] {lane} lane f32 kernels vs plain'
          f'{" (int8 layer inputs forced)" if lane == "int8" else ""}: '
          f'index agreement={agree:.6f} output mean_abs_diff={mean_diff:.3e} '
          f'max_abs_diff={max_diff:.3e}', flush=True)
    require(torch.isfinite(out_k).all().item(), f'{lane} f32 output not '
                                                f'finite')
    require(agree >= 0.999 and mean_diff <= 1e-4,
            f'{lane} f32: agreement {agree}, mean diff {mean_diff}')
    if lane == 'int8':
        b = info['int8_layers']
        print(f'[main path] int8 lane f32: {b["layers"]} int8 layers; own '
              f'vs forced float inputs within {b["float_max_steps"]:.3e} '
              f'steps ({b["float_flips"]} of {b["float_numel"]} codes on a '
              f'round-half boundary); chain codes off by <= '
              f'{b["codes_max_diff"]} on <= {b["codes_worst_flip_share"]:.2e}'
              f', row scales to {b["codes_scale_rel"]:.1e}; unforced plain '
              f'run: index agreement '
              f'{info["unforced_index_agreement"]:.6f}, mean_abs_diff '
              f'{info["unforced_mean_abs_diff"]:.3e}', flush=True)
        require(b['float_max_steps'] <= MAX_STEPS and b['codes_max_diff'] <= 1
                and b['codes_worst_flip_share'] <= 1e-3
                and b['codes_scale_rel'] <= 1e-6,
                f'int8 lane: int8 layer inputs off by more than round-half '
                f'boundary cases: {b}')
    info.update(index_agreement=agree, mean_abs_diff=mean_diff,
                max_abs_diff=max_diff)
    return out_k, (out_p, idx_p[0]), info


def psnr_db(a, b) -> float:
    mse = (a - b).square().mean().item()
    return float(10 * np.log10(1.0 / max(mse, 1e-12)))


def bf16_check(dev, state_dict, img, whole, ref, idx_ref):
    """The float lane's 512px image in bf16, once through the kernels and
    once through the plain versions (which round at the same points), each
    against the f32 plain output `ref` (codebook indices `idx_ref`). The
    kernels may lose at most BF16_PSNR_SLACK_DB to the plain bf16 run."""
    from femasr_torch import kernels
    from femasr_torch.models import SRInferencer
    from femasr_torch.models.inference import flip_pad

    sr = SRInferencer(state_dict, device=dev, dtype=torch.bfloat16)
    x = torch.from_numpy(img.transpose(2, 0, 1).copy())[None].to(dev)
    pad = (whole // sr.wsz + 1) * sr.wsz - whole
    xp = flip_pad(x, pad, pad).to(torch.bfloat16)
    s4 = 4 * whole
    runs = {}
    with torch.inference_mode(), counting_off(*kernels.MODULES.values()):
        for name, ctx in (('kernels', contextlib.nullcontext()),
                          ('plain', plain_kernels())):
            with ctx:
                out, _, idx = sr.model(xp)
            runs[name] = (out.float().clamp(0, 1)[:, :, :s4, :s4], idx[0])
    sync(dev)
    (out_k, idx_k), (out_p, idx_p) = runs['kernels'], runs['plain']
    info = dict(psnr_kernels_db=psnr_db(out_k, ref),
                psnr_plain_db=psnr_db(out_p, ref),
                index_agreement=(idx_k == idx_p).float().mean().item(),
                index_agreement_kernels_vs_f32=(
                    idx_k == idx_ref).float().mean().item(),
                index_agreement_plain_vs_f32=(
                    idx_p == idx_ref).float().mean().item(),
                mean_abs_diff=(out_k - out_p).abs().mean().item())
    print(f'[main path] float lane bf16 vs f32 plain: PSNR kernels '
          f'{info["psnr_kernels_db"]:.3f} dB, plain versions '
          f'{info["psnr_plain_db"]:.3f} dB; kernels vs plain bf16: index '
          f'agreement={info["index_agreement"]:.6f} (vs f32: kernels '
          f'{info["index_agreement_kernels_vs_f32"]:.6f}, plain '
          f'{info["index_agreement_plain_vs_f32"]:.6f}), output '
          f'mean_abs_diff={info["mean_abs_diff"]:.3e}', flush=True)
    require(torch.isfinite(out_k).all().item(), 'bf16 kernel output not '
                                                'finite')
    require(info['psnr_kernels_db'] >= info['psnr_plain_db']
            - BF16_PSNR_SLACK_DB,
            f'float lane bf16: the kernels lose more than '
            f'{BF16_PSNR_SLACK_DB} dB to the plain versions: {info}')
    return info


def main_path(dev, work, whole: int = 512, tiled: int = 720):
    import cv2

    from femasr_torch import kernels
    from femasr_torch.models import FeMaSRNet, SRInferencer, init_weights

    net = FeMaSRNet([[32, 1024, 512]], LQ_stage=True, scale_factor=4,
                    norm_type='gn', act_type='silu')
    init_weights(net, torch.Generator().manual_seed(0))
    pth = os.path.join(work, 'femasr_x4_random.pth')
    torch.save({'params': net.state_dict()}, pth)

    rng = np.random.default_rng(0)
    in_dir = os.path.join(work, 'lq')
    os.makedirs(in_dir)
    sizes = {'whole.png': whole, 'tiled.png': tiled}
    for name, s in sizes.items():
        cv2.imwrite(os.path.join(in_dir, name), smooth_image(rng, s, s))
    img = cv2.cvtColor(cv2.imread(os.path.join(in_dir, 'whole.png')),
                       cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
    s4 = 4 * whole

    counts, extra, outs = {}, {}, {}
    for lane, (_, kw, _) in LANES.items():
        counts[lane], stats, warm = serve_lane(dev, lane, in_dir, pth, work,
                                               sizes)
        sr = SRInferencer(net.state_dict(), device=dev, dtype=torch.bfloat16,
                          **kw)
        with counting_off(*kernels.MODULES.values()):
            out_bf16 = sr(img)
        require(np.isfinite(out_bf16).all() and out_bf16.shape == (s4, s4, 3),
                f'{lane} bf16 whole-image output {out_bf16.shape} not finite')
        del sr
        outs[lane], (ref, idx_ref), info = f32_check(dev, lane,
                                                     net.state_dict(), img,
                                                     whole)
        extra[lane] = dict(bf16_cli=stats, bf16_cli_warm=warm,
                           launches=counts[lane], f32=info)
        if lane == 'float':
            extra[lane]['bf16'] = bf16_check(dev, net.state_dict(), img,
                                             whole, ref, idx_ref)
        del ref
        torch.cuda.empty_cache()
    mse = (outs['int8'] - outs['float']).square().mean().item()
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    print(f'[main path] f32 int8 lane vs float lane (kernels, same weights '
          f'and image): PSNR {psnr:.2f} dB', flush=True)
    extra['int8_vs_float_psnr_db'] = float(psnr)
    return counts, extra


# (group, substrings of the kernel's name): the port's seven kernels first,
# by their __global__ names in femasr_torch/csrc
KERNEL_GROUPS = (('conv3 kernel', ('conv3_tc', 'conv3_ffma')),
                 ('conv3_w8a8 kernel', ('conv3_w8a8_tc', 'conv3_w8a8_dp4a')),
                 ('matmul_w8a8_q kernel', ('mm_w8a8_q_tc', 'mm_w8a8_q_dp4a')),
                 ('matmul_w8a8 kernel', ('mm_w8a8_tc', 'mm_w8a8_dp4a')),
                 ('act_bf16 kernel', ('act_bf16_kernel',)),
                 ('window_attention kernel', ('wattn_tc', 'wattn_f32')),
                 ('vq_argmin kernel', ('vq_tile_argmin', 'vq_merge',
                                       'code_norms')),
                 ('cuDNN conv', ('conv', 'xmma', 'implicit', 'cudnn')),
                 ('GEMM (linears)', ('gemm', 'cutlass', 'cublas', 'nvjet')),
                 ('reduce (norm stats)', ('reduce',)),
                 ('copy / layout', ('copy', 'cat', 'index', 'gather',
                                    'roll', 'upsample', 'nearest')),
                 ('elementwise', ('elementwise', 'vectorized')))


@contextlib.contextmanager
def recording_conv3_w8a8(calls: list):
    """Append (B, Ci, H, W, O, dtype) of each conv3_w8a8 call of the model,
    in call order."""
    from femasr_torch.ops import layers
    fn = layers.conv3_w8a8

    def rec(x, weight, bias=None, act=None):
        calls.append((*x.shape, weight.shape[0], str(x.dtype)[6:]))
        return fn(x, weight, bias, act)
    layers.conv3_w8a8 = rec
    try:
        yield
    finally:
        layers.conv3_w8a8 = fn


def conv3_w8a8_by_shape(calls: list, events: list) -> list:
    """Launches and device time per shape of one forward: the profiled
    conv3_w8a8 kernels, in start order, matched to the recorded calls."""
    require(len(calls) == len(events), f'conv3_w8a8: {len(calls)} calls but '
                                       f'{len(events)} profiled kernels')
    shapes = {}
    for call, e in zip(calls, events):
        d = shapes.setdefault(call, [0, 0.0])
        d[0] += 1
        d[1] += e.time_range.elapsed_us() / 1e3
    rows = []
    for (b, ci, h, w, o, dt), (n, total) in shapes.items():
        size = 2 if dt == 'bfloat16' else 4
        bms, by = bound_ms(b * h * w * (ci + o) * size + 9 * ci * o,
                           2.0 * b * h * w * ci * o * 9, torch.int8)
        rows.append(dict(shape=f'({b},{ci},{h},{w}) -> {o} {dt}', launches=n,
                         ms=total / n, total_ms=total, bound_ms=bms,
                         bound_by=by))
        print(f'[profile]   conv3_w8a8 x ({b},{ci},{h},{w}) -> {o} {dt}: '
              f'{n} launches, {total / n:.4f} ms each, {total:.3f} ms in '
              f'all (bound {bms:.4f} ms, {by})', flush=True)
    return rows


def profile_forward(dev, lane: str, reps: int = 3) -> dict:
    """Device-time breakdown of one warm 512px bf16 whole-image forward;
    in the int8 lane also B6's launches and time per shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from femasr_torch.models import SRInferencer

    sr = SRInferencer(device=dev, dtype=torch.bfloat16, **LANES[lane][1])
    g = torch.Generator().manual_seed(5)
    x = torch.rand((1, 3, 512, 512), generator=g)
    for _ in range(2):
        sr.run_padded(x)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        sr.run_padded(x)
    sync(dev)
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    calls = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            recording_conv3_w8a8(calls):
        sr.run_padded(x)
        sync(dev)
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern.sort(key=lambda e: e.time_range.start)
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups['other'] = 0.0
    by_name, n_by_name = {}, {}
    for e in kern:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        n_by_name[e.name] = n_by_name.get(e.name, 0) + 1
        low = e.name.lower()
        for gname, keys in KERNEL_GROUPS:
            if any(k in low for k in keys):
                groups[gname] += us
                break
        else:
            groups['other'] += us
    for name in LANES[lane][2]:
        require(groups[f'{name} kernel'] > 0, f'profile: no device time '
                f'matched the {name} kernel group on the {lane} lane')
    busy_ms = sum(groups.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f'[profile] {lane} lane, 512px bf16 forward: wall {wall_ms:.3f} '
          f'ms (host clock over {reps}), device busy {busy_ms:.3f} ms in one '
          f'profiled run, {len(kern)} kernels', flush=True)
    for gname, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f'[profile]   {gname:26s} {us / 1e3:9.3f} ms', flush=True)
    for name, us in top:
        print(f'[profile]   top: {us / 1e3:9.3f} ms  {name[:90]}', flush=True)
    out = {'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
           'groups_ms': {k: v / 1e3 for k, v in groups.items()}}
    if calls:
        out['conv3_w8a8_by_shape'] = conv3_w8a8_by_shape(
            calls, [e for e in kern if 'conv3_w8a8_' in e.name])
    # B5 by instantiation: <signed char> is fc1 (int8 out), <__nv_bfloat16>
    # fc2 (bf16 out); B4 and act_bf16 by route and instantiation
    for label, keys in (('matmul_w8a8_q', ('mm_w8a8_q_',)),
                        ('matmul_w8a8', ('mm_w8a8_tc', 'mm_w8a8_dp4a')),
                        ('act_bf16', ('act_bf16_kernel',))):
        rows = {name: (n_by_name[name], us / 1e3)
                for name, us in by_name.items()
                if any(k in name for k in keys)}
        for name, (n, total) in rows.items():
            print(f'[profile]   {label} {name[:70]}: {n} launches, '
                  f'{total / n:.4f} ms each, {total:.3f} ms in all',
                  flush=True)
        if rows:
            out[f'{label}_by_kernel'] = {
                name: dict(launches=n, ms=total / n, total_ms=total)
                for name, (n, total) in rows.items()}
    return out


def tensor_core_counts() -> dict:
    """Tensor-core instructions in the SASS of each kernel library, from
    cuobjdump: HMMA / IMMA (mma.sync, float / integer), HGMMA / IGMMA
    (wgmma)."""
    from femasr_torch import kernels
    from femasr_torch.kernels import _build
    tool = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'cuobjdump')
    counts = {}
    for name in kernels.MODULES:
        sass = subprocess.run([tool, '-sass', _build.load(name)._name],
                              capture_output=True, text=True,
                              check=True).stdout
        ops = re.findall(r'\b(' + '|'.join(TC_OPS) + r')\b', sass)
        counts[name] = {op: ops.count(op) for op in TC_OPS}
    return counts


def sync(dev) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def gpu_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from femasr_torch import kernels
    from femasr_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    card = gpu_line()
    print(f'[device] {torch.cuda.get_device_name(0)} | {card} | torch '
          f'{torch.__version__} cuda {torch.version.cuda}', flush=True)

    t0 = time.time()
    kernels.build_all()
    print(f'[build] {len(kernels.MODULES)} kernels in '
          f'{time.time() - t0:.1f}s', flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'[build] {name}: {line.strip()}', flush=True)
    tc_counts = tensor_core_counts()
    for name, c in tc_counts.items():
        print(f'[build] {name}: tensor-core instructions in SASS {c}',
              flush=True)
    for name in TENSOR_CORE_KERNELS:
        require(sum(tc_counts[name].values()) > 0,
                f'{name}: no tensor-core instruction in its SASS')

    results = {}
    check_conv3(dev, results)
    check_window_attention(dev, results)
    check_vq_argmin(dev, results)
    check_matmul_w8a8(dev, results)
    check_matmul_w8a8_q(dev, results)
    check_conv3_w8a8(dev, results)
    check_act_bf16(dev, results)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        counts, extra = main_path(dev, work)
    for lane in LANES:
        extra[lane]['profile'] = profile_forward(dev, lane)

    for name, how in REDESIGNED.items():
        print(f'[history] {name}: redesigned {how}; its earlier times stand '
              f'in PERF.md', flush=True)
    line = {'kernels': [], 'main_path': extra}
    for name in kernels.MODULES:
        r = results[name]
        # launches: the main-path run of the lane that ported the kernel
        # (float lane for B1-B3 and act_bf16, int8 lane for B4-B6); both
        # lanes beside it
        lane = 'float' if name in LANES['float'][2] else 'int8'
        line['kernels'].append(dict(
            name=name, route='cuda', source=f'femasr_torch/csrc/{name}.cu',
            replaces=TPU_SOURCES[name], tpu_function=TPU_FUNCTIONS[name],
            launches=counts[lane][name],
            launches_by_lane={k: c[name] for k, c in counts.items()},
            max_abs_err=r['max_abs_err'], ms=r['ms'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
            bound_by=r['bound_by'], library_ms=r['library_ms'],
            tensor_core_instructions=tc_counts[name],
            **{k: v for k, v in r.items() if k not in (
                'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                'library_ms')}))
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
