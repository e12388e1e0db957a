#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # needs one CUDA card

Phases:
  1. build the six CUDA kernels from femasr_torch/csrc (nvcc, in parallel);
  2. hold each kernel against its plain PyTorch version at the shapes the
     x4 release model gives it for a 512x512 LR image, in f32 (TF32 off)
     and bf16, and time kernel, plain version and one library call;
  3. serve a 512x512 (whole-image) and a 720x720 (tiled) image through
     `python -m femasr_torch.inference_cli` in bf16 with a seeded
     random-init release-config x4 model, once in the float lane (B1-B3)
     and once in the int8 lane (--int8_tail --int8_levels 3 --int8_enc_up
     --int8_swin --int8_mlp: B2-B6), counting kernel launches per lane,
     then compare one image in f32 with the kernels against the plain
     versions, per lane;
  4. profile one warm 512px bf16 forward per lane (device time by kernel
     group);
  5. print a JSON line of per-kernel numbers, the card's name and power
     limit, and last `{"ok": true, "device": {...}}`.

Any failed phase exits non-zero before the last line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
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
}
TPU_FUNCTIONS = {
    'conv3': 'femasr_tpu/ops/pallas/ws2d_conv.py:conv3_ws2d',
    'window_attention':
        'femasr_tpu/ops/pallas/window_attention.py:window_attention_fused',
    'vq_argmin': 'femasr_tpu/ops/pallas/vq.py:vq_argmin',
    'matmul_w8a8': 'femasr_tpu/ops/pallas/int8_dense.py:matmul_w8a8',
    'matmul_w8a8_q': 'femasr_tpu/ops/pallas/int8_dense.py:matmul_w8a8_q',
    'conv3_w8a8': 'femasr_tpu/ops/pallas/int8_dense.py:conv3_w8a8',
}


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


# -- phase 2: each kernel against its plain version ------------------------

def check_conv3(dev, results):
    from femasr_torch.kernels import conv3 as mod
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
    cases = {
        'res 64->64 + gn/silu prologue': (64, True),
        'out_conv 64->3': (3, False),
    }
    entry = None
    for label, (o, pre) in cases.items():
        wt = (torch.rand((o, c, 3, 3), generator=g, device=dev) * 2 - 1) * bound
        bias = (torch.rand((o,), generator=g, device=dev) * 2 - 1) * bound
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            x = x32.to(dtype)
            kw = {}
            if pre:
                a, s = gn.affine(x)
                kw = dict(scale=a, shift=s, pre_act='silu')
            with counting_off(mod):
                y = mod.conv3(x, wt, bias, **kw)
                torch.cuda.synchronize()
                ref = mod.conv3_plain(x, wt, bias, **kw)
                err = (y.float() - ref.float()).abs().max().item()
                ok = torch.allclose(y.float(), ref.float(), atol=tol,
                                    rtol=tol)
                ms = time_ms(lambda: mod.conv3(x, wt, bias, **kw))
            plain_ms = time_ms(lambda: mod.conv3_plain(x, wt, bias, **kw))
            xa = x
            if pre:
                xa = F.silu(x.float() * kw['scale'][:, :, None, None]
                            + kw['shift'][:, :, None, None]).to(dtype)
            wl, bl = wt.to(dtype), bias.to(dtype)
            lib_ms = time_ms(lambda: F.conv2d(xa, wl, bl, padding=1))
            flops = 2.0 * b * h * w * c * o * 9
            bms, by = bound_ms(nbytes(x, y, wt, bias, kw.get('scale'),
                                      kw.get('shift')), flops, dtype)
            print(f'[conv3] {label} {str(dtype)[6:]}: max_abs_err={err:.3e} '
                  f'(tol {tol}) ms={ms:.4f} plain_ms={plain_ms:.4f} '
                  f'library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by})',
                  flush=True)
            require(ok, f'conv3 {label} {dtype}: kernel disagrees with plain '
                        f'(max abs err {err})')
            if pre and dtype == torch.bfloat16:
                entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by,
                             dtype='bfloat16',
                             shape='x (1,64,2112,2112) -> 64, gn+silu prologue')
            del y, ref
    results['conv3'] = entry


def check_window_attention(dev, results):
    from femasr_torch.kernels import window_attention as mod
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
        for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
            qkv = qkv32.to(dtype)
            q = qkv[..., :c] * hd ** -0.5
            k, v = qkv[..., c:2 * c], qkv[..., 2 * c:]
            with counting_off(mod):
                y = mod.window_attention(q, k, v, bias, m, nh)
                torch.cuda.synchronize()
                ref = mod.window_attention_plain(q, k, v, bias, m, nh)
                err = (y.float() - ref.float()).abs().max().item()
                ok = torch.allclose(y.float(), ref.float(), atol=tol,
                                    rtol=tol)
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
                             dtype='bfloat16',
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
    results['vq_argmin'] = dict(
        max_abs_err=dist_err, index_agreement=agree, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
        dtype='float32', shape='z (69696,512) x codebook (1024,512)')


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


def check_matmul_w8a8(dev, results):
    from femasr_torch.kernels import matmul_w8a8 as mod
    from femasr_torch.kernels._w8a8 import (quantize, quantize_weight,
                                            tensor_scale)
    g = torch.Generator(device=dev).manual_seed(4)
    x32 = torch.randn((TOKENS, 1024), generator=g, device=dev)
    entry = None
    for label, (k, n) in MM_CASES.items():
        wt = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
        bias = torch.randn((n,), generator=g, device=dev) * 0.02
        for dtype in (torch.float32, torch.bfloat16):
            x = x32[:, :k].contiguous().to(dtype)
            with counting_off(mod):
                y = mod.matmul_w8a8(x, wt, bias)
                torch.cuda.synchronize()
                ref = mod.matmul_w8a8_plain(x, wt, bias)
                ok, err = agree_w8a8(y, ref)
                ms = time_ms(lambda: mod.matmul_w8a8(x, wt, bias))
            plain_ms = time_ms(lambda: mod.matmul_w8a8_plain(x, wt, bias))
            w_q, s_w = quantize_weight(wt, 1)
            x_q = quantize(x, tensor_scale(x))
            w_t = w_q.t()
            lib_ms = time_ms(lambda: torch._int_mm(x_q, w_t))
            bms, by = bound_ms(nbytes(x, y, w_q, s_w, bias) + 4,
                               2.0 * TOKENS * k * n, torch.int8)
            print(f'[matmul_w8a8] {label} {str(dtype)[6:]}: max_abs_err='
                  f'{err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} '
                  f'library_ms={lib_ms:.4f} (torch._int_mm, integer product '
                  f'only) bound_ms={bms:.4f} ({by})', flush=True)
            require(ok, f'matmul_w8a8 {label} {dtype}: kernel disagrees '
                        f'with plain (max abs err {err})')
            if label.startswith('qkv') and dtype == torch.bfloat16:
                entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by,
                             library='torch._int_mm on the pre-quantized '
                                     'operands (integer product only)',
                             dtype='bfloat16',
                             shape='x (69696,256) -> 768 (Swin qkv)')
            del y, ref
    results['matmul_w8a8'] = entry


def check_matmul_w8a8_q(dev, results):
    from femasr_torch.kernels import matmul_w8a8_q as mod
    from femasr_torch.kernels._w8a8 import quantize_weight
    from femasr_torch.ops.layers import quantize_rows
    g = torch.Generator(device=dev).manual_seed(5)
    entry = None
    for label, (k, n, act, out_int8) in MMQ_CASES.items():
        x_q, s_x = quantize_rows(torch.randn((TOKENS, k), generator=g,
                                             device=dev))
        wt = torch.randn((n, k), generator=g, device=dev) * k ** -0.5
        bias = torch.randn((n,), generator=g, device=dev) * 0.02
        for dtype in ((torch.float32,) if out_int8
                      else (torch.float32, torch.bfloat16)):
            def run(fn=mod.matmul_w8a8_q):
                return fn(x_q, s_x, wt, bias, act=act, out_int8=out_int8,
                          out_dtype=dtype)
            with counting_off(mod):
                y = run()
                torch.cuda.synchronize()
                ref = run(mod.matmul_w8a8_q_plain)
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
            plain_ms = time_ms(lambda: run(mod.matmul_w8a8_q_plain))
            w_q, s_w = quantize_weight(wt, 1)
            w_t = w_q.t()
            lib_ms = time_ms(lambda: torch._int_mm(x_q, w_t))
            outs = y if out_int8 else (y,)
            bms, by = bound_ms(nbytes(x_q, s_x, w_q, s_w, bias, *outs),
                               2.0 * TOKENS * k * n, torch.int8)
            out_name = 'int8' if out_int8 else str(dtype)[6:]
            print(f'[matmul_w8a8_q] {label} -> {out_name}: '
                  f'max_abs_err={err:.3e} {note} ms={ms:.4f} '
                  f'plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} '
                  f'(torch._int_mm, integer product only) '
                  f'bound_ms={bms:.4f} ({by})', flush=True)
            require(ok, f'matmul_w8a8_q {label} {dtype}: kernel disagrees '
                        f'with plain (max err {err})')
            if out_int8:
                entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by,
                             library='torch._int_mm on the pre-quantized '
                                     'operands (integer product only)',
                             dtype='int8 in, int8 + f32 row scales out',
                             shape='x_q (69696,256) -> 1024, gelu, int8 out '
                                   '(Swin MLP fc1)')
            del y, ref
    results['matmul_w8a8_q'] = entry


def check_conv3_w8a8(dev, results):
    from femasr_torch.kernels import conv3_w8a8 as mod
    from femasr_torch.kernels._w8a8 import quantize_weight
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
            wl, bl = wt.to(dtype), bias.to(dtype)
            ctx_ms = time_ms(lambda: F.conv2d(x, wl, bl, padding=1))
            w_q, s_w = quantize_weight(wt, (1, 2, 3))
            bms, by = bound_ms(nbytes(x, y, w_q, s_w, bias) + 4,
                               2.0 * hw * hw * c * o * 9, torch.int8)
            print(f'[conv3_w8a8] {label} {str(dtype)[6:]}: max_abs_err='
                  f'{err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} '
                  f'library_ms=null (no PyTorch call computes an int8 conv; '
                  f'bf16/f32 F.conv2d for context: {ctx_ms:.4f}) '
                  f'bound_ms={bms:.4f} ({by})', flush=True)
            require(ok, f'conv3_w8a8 {label} {dtype}: kernel disagrees with '
                        f'plain (max abs err {err})')
            if label == next(iter(CONV_CASES)) and dtype == torch.bfloat16:
                entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=None, context_conv2d_ms=ctx_ms,
                             bound_ms=bms, bound_by=by, dtype='bfloat16',
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
    from femasr_torch.kernels import (conv3, conv3_w8a8, matmul_w8a8,
                                      matmul_w8a8_q, vq_argmin,
                                      window_attention)
    from femasr_torch.models import femasr_arch
    from femasr_torch.ops import layers, quantize, swin
    saved = [(layers, 'conv3', conv3.conv3_plain),
             (femasr_arch, 'conv3', conv3.conv3_plain),
             (swin, 'window_attention',
              window_attention.window_attention_plain),
             (quantize, 'vq_argmin', vq_argmin.vq_argmin_plain),
             (layers, 'conv3_w8a8', conv3_w8a8.conv3_w8a8_plain),
             (layers, 'matmul_w8a8', matmul_w8a8.matmul_w8a8_plain),
             (layers, 'matmul_w8a8_q', matmul_w8a8_q.matmul_w8a8_q_plain)]
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
    'float': ([], {}, ('conv3', 'window_attention', 'vq_argmin')),
    'int8': (INT8_FLAGS, INT8_LANE, ('window_attention', 'vq_argmin',
                                     'matmul_w8a8', 'matmul_w8a8_q',
                                     'conv3_w8a8')),
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
    return out_k, info


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
        outs[lane], info = f32_check(dev, lane, net.state_dict(), img, whole)
        extra[lane] = dict(bf16_cli=stats, bf16_cli_warm=warm,
                           launches=counts[lane], f32=info)
        torch.cuda.empty_cache()
    mse = (outs['int8'] - outs['float']).square().mean().item()
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    print(f'[main path] f32 int8 lane vs float lane (kernels, same weights '
          f'and image): PSNR {psnr:.2f} dB', flush=True)
    extra['int8_vs_float_psnr_db'] = float(psnr)
    return counts, extra


KERNEL_GROUPS = (('conv3 kernel', ('conv3_kernel',)),
                 ('conv3_w8a8 kernel', ('conv3_w8a8_kernel',)),
                 ('matmul_w8a8_q kernel', ('mm_w8a8_q_kernel',)),
                 ('matmul_w8a8 kernel', ('mm_w8a8_kernel',)),
                 ('window_attention kernel', ('wattn_kernel',)),
                 ('vq_argmin kernel', ('vq_kernel', 'code_norms')),
                 ('cuDNN conv', ('conv', 'xmma', 'implicit', 'cudnn')),
                 ('GEMM (linears)', ('gemm', 'cutlass', 'cublas', 'nvjet')),
                 ('reduce (norm stats)', ('reduce',)),
                 ('copy / layout', ('copy', 'cat', 'index', 'gather',
                                    'roll', 'upsample', 'nearest')),
                 ('elementwise', ('elementwise', 'vectorized')))


def profile_forward(dev, lane: str, reps: int = 3) -> dict:
    """Device-time breakdown of one warm 512px bf16 whole-image forward."""
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sr.run_padded(x)
        sync(dev)
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups['other'] = 0.0
    by_name = {}
    for e in kern:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        low = e.name.lower()
        for gname, keys in KERNEL_GROUPS:
            if any(k in low for k in keys):
                groups[gname] += us
                break
        else:
            groups['other'] += us
    busy_ms = sum(groups.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f'[profile] {lane} lane, 512px bf16 forward: wall {wall_ms:.3f} '
          f'ms (host clock over {reps}), device busy {busy_ms:.3f} ms in one '
          f'profiled run, {len(kern)} kernels', flush=True)
    for gname, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f'[profile]   {gname:26s} {us / 1e3:9.3f} ms', flush=True)
    for name, us in top:
        print(f'[profile]   top: {us / 1e3:9.3f} ms  {name[:90]}', flush=True)
    return {'wall_ms': wall_ms, 'device_busy_ms': busy_ms,
            'groups_ms': {k: v / 1e3 for k, v in groups.items()}}


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

    results = {}
    check_conv3(dev, results)
    check_window_attention(dev, results)
    check_vq_argmin(dev, results)
    check_matmul_w8a8(dev, results)
    check_matmul_w8a8_q(dev, results)
    check_conv3_w8a8(dev, results)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as work:
        counts, extra = main_path(dev, work)
    for lane in LANES:
        extra[lane]['profile'] = profile_forward(dev, lane)

    line = {'kernels': [], 'main_path': extra}
    for name in kernels.MODULES:
        r = results[name]
        # launches: the main-path run of the lane that ported the kernel
        # (float lane for B1-B3, int8 lane for B4-B6); both lanes beside it
        lane = 'float' if name in LANES['float'][2] else 'int8'
        line['kernels'].append(dict(
            name=name, route='cuda', source=f'femasr_torch/csrc/{name}.cu',
            replaces=TPU_SOURCES[name], tpu_function=TPU_FUNCTIONS[name],
            launches=counts[lane][name],
            launches_by_lane={k: c[name] for k, c in counts.items()},
            max_abs_err=r['max_abs_err'], ms=r['ms'],
            plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
            bound_by=r['bound_by'], library_ms=r['library_ms'],
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
