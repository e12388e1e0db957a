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
  5. train at release width (batch 8, gt 256, f32, TF32 off) through
     `python -m femasr_torch.train_cli` on a seeded folder with seeded
     weights: the LQ stage of options/train_FeMaSR_LQ_stage.yml for 8
     iterations (B1 and B3 launches counted per iteration: 5 and 2, no
     other kernel), resumed from its state at iteration 4 and held to the
     uninterrupted run (1e-3); one LQ generator step held against the
     plain versions (indices by B3's rule, loss 1e-5, gradients 1e-4 of
     their max); the HQ stage of options/train_FeMaSR_HQ_pretrain_stage.yml
     (semantic loss on) for 4 iterations; ms per iteration, images/s, peak
     memory and a profile per stage; B1's f32 and bf16 routes and B3 at
     the training shapes against their plain versions (TF32 off through
     femasr_torch.utils.misc.disable_tf32, as in the CLIs). Validation
     (A10), the release configs' val blocks: the LQ run validates two
     seeded images at
     DIV2K-valid size (LR 510x339 and 339x510, GT x4) at iterations 4 and
     8 and after its loop (psnr, ssim, lpips with the seeded LPIPS; key
     metric lpips), the HQ run one GT image after its loop; launches per
     validation image B1 5, B2 24, B3 1 (HQ: B1 5, B3 1), no other
     kernel; ms per image and peak memory; the trained model's validation
     through the kernels against the plain versions (>= 99.9% equal
     indices, output mean abs diff <= 1e-4, PSNR 0.01 dB, SSIM and LPIPS
     1e-4); `python -m femasr_torch.test_cli` with options/test_FeMaSR.yml
     on net_g_best gives the metrics of the validation that saved it
     (1e-4 dB, 1e-5) and writes the images;
  6. the BSRGAN data (A9), both configurations as shipped on the seeded GT
     folder (BSRGANTrainDataset, their workers): the LQ stage of
     options/train_FeMaSR_LQ_stage_ondevice.yml for 8 iterations with the
     LQ synthesized on the card (B1 5 and B3 2 launches per iteration, no
     other kernel; resumed at 4 and held to the uninterrupted run, 1e-3),
     then the degradation alone on a warm batch of 8 GT crops (host and
     device ms, launches per call, its share of the iteration, no
     synchronizing op under set_sync_debug_mode('error'), and the card's
     LQ against the CPU's under the same draws: >= 99.9% of pixels within
     1e-4, the rest in at most 1% of the final JPEG's 16x16 blocks); the
     HQ stage of options/train_FeMaSR_HQ_pretrain_stage.yml for 4
     iterations with its 8 workers degrading on the host (B3 1 per
     iteration) and a timed host pass over the train set; ms per
     iteration, images/s, idle share, the loop's wait for data and peak
     memory of both;
  7. bf16 and checkpointed training (A8b, A8c), run inside phase 5 before
     phase 6: both release stages with network_g and network_d in
     bfloat16 through train_cli, with their val blocks (per iteration: LQ
     B1 5 on its tensor-core route, B3 2, act_bf16 20 in the frozen prior;
     HQ B3 1; per validation image LQ B1 5, B2 24, B3 1, act_bf16 44, HQ
     B1 5, B3 1, act_bf16 20; finite losses; the first iteration's total
     loss within 5% of the f32 run's from the same init and batch); the LQ
     run resumed at 4 and held to itself (its first iteration 1e-6, the
     next ones 1e-2: the bf16 backward is not bit for bit); one bf16 LQ G
     step through the kernels against the plain versions (prior indices
     >= 99.9% equal, trainee B3's rule, loss 1e-3, gradients 1e-2 of
     their max or twice the spread of two runs through the kernels); then
     the LQ stage with use_checkpoint in f32 and in bf16 for 3 iterations
     (one G step from one state checkpointed and not: the loss
     equal, gradients within 1e-5 relative or twice the run-to-run
     spread); ms per iteration, images/s, peak memory (over the run and
     in the timed iterations) and a profile of each beside the f32 runs;
     B1's bf16 route at the training shape in the kernel checks;
  8. data parallelism (A11), run at the end of phase 5 (`dp_phase`):
     (a) the bf16 LQ release config, batch 8 at gt 256, 2 iterations,
     under `torchrun --nproc_per_node 1 ... train_cli --launcher pytorch`
     (NCCL, DistributedDataParallel) against the same run without a
     launcher: losses and parameters bit for bit or within 1e-6, ms per
     iteration and idle share of both; (b) the f32 LQ config with SGD at
     world 2 x batch 4 against world 1 x batch 8 (two cards under NCCL, or
     two ranks sharing cuda:0 under gloo, as this script chooses), 2
     iterations with the GAN and the D step: losses and parameters within
     4x the spread of two world-1 runs (batch 8, and batch 8 in two chunks
     of 4), never tighter than 1e-5; (c) `inference_cli --dp 2` on the
     float lane's two images in f32 against one process; (d) `test_cli
     --launcher pytorch` at world 2 on the LQ validation folder against one
     process (metrics 1e-6). (a) and (b) run under deterministic
     algorithms. Each rank is this script (`--rank-worker`), which calls
     the CLI's main and counts the kernels' launches per rank (B1 5 and B3
     2 per iteration, act_bf16 20 in bf16; per serving forward and
     evaluation image B1 5, B2 24, B3 1);
  9. tensor parallelism (A11b), run after the dp phase (`tp_phase`), in
     ranks started as the dp phase starts them (two: NCCL on two cards,
     else gloo on cuda:0; four for dp=2 x tp=2): (a) the two serving
     images through `inference_cli --tp 2 --launcher pytorch` (float lane
     f32, int8 lane bf16; PNGs within one level / equal) and whole-image
     probes against one process: float f32 indices equal but for
     certified near-ties and the output within 2e-5 of its max, float
     bf16 PSNR vs the f32 plain output within 0.5 dB of tp=1's, the int8
     lane (never split) bit for bit; (b) in phase 2, B3 on 512 of the
     1024 codes (two shards' (distance, index) pairs reduced by B3's rule
     equal the whole search bit for bit; B3's distance output held to the
     plain version) and B2 on 4 heads, C=128, timed; (c) the f32 LQ config
     with SGD at tp=2 x batch 4 for 2 iterations and at dp=2 x tp=2 for 1
     against world 1 (4x the spread of two world-1 runs, never under
     1e-5), every tensor held whole bit-equal across the ranks, the HQ
     stage at tp=2 for 1 iteration (both codebook shards move), per-rank
     parameter bytes and peak memory; (d) a resume at tp=2 bit for bit
     and the tp=2 net_g .pth served strictly at tp=1 as at tp=2; (e)
     launches per rank on every path (each rank launches what one process
     does);
 10. SwinIR (A12a), run after phase 4 (`swinir_phase`): the four
     published configurations (define_model of the SwinIR repository:
     SwinIR-M classical x4 and real-world x4, SwinIR-S lightweight x4,
     SwinIR-M JPEG CAR) at full width and depth with seeded weights,
     through build_network, on a smooth 256^2 RGB image (x4) and a 504^2
     grayscale one (CAR), once in f32 and once in bf16: launches of one
     forward (B2 36 / 36 / 24 / 36 and no other kernel; in bf16 also
     act_bf16 once a block), ms per forward, peak memory, the whole model
     through the kernels against the plain versions (f32 max abs 1e-4;
     bf16 PSNR vs the f32 plain output within 0.5 dB of the plain bf16
     run's); in phase 2, B2 at SwinIR's shapes ((1024,64,180), (1024,64,60),
     (5184,49,180), 6 heads; packed qkv slices) with and without the mask
     in f32 and bf16 against its plain version, timed beside its bound,
     its plain version and SDPA, and FeMaSR's shape on its own route;
     in phases 3-9 (serving lanes, profiles, training, validation, every
     dp and tp rank) no FeMaSR B2 launch takes the padded route;
 11. print a JSON line of per-kernel numbers (and the training and SwinIR
     numbers), the card's name and power limit, and last `{"ok": true,
     "device": {...}}`.

Any failed phase exits non-zero before the last line is printed.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import hashlib
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
# B3's distance output against the plain version's, of the largest
# distance (both f32, summed in other orders)
VQ_DIST_RTOL = 1e-5
# FeMaSR's B2 time on this card before B2 took SwinIR's shapes (PERF.md)
FEMASR_B2_EARLIER_MS = (0.102, 0.105)


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
def femasr_b2_routes(where: str):
    """FeMaSR's window attention within the block never takes B2's padded
    route (TC, SwinIR's): in bf16 it stays on the N = 64, head_dim 32
    kernel (TC64). Counted from the wrapper's launches by route, comparison
    launches included (they are at FeMaSR's shapes too)."""
    from femasr_torch.kernels import window_attention as mod
    before = list(mod.route_launches)
    yield
    n = [a - b for a, b in zip(mod.route_launches, before)]
    print(f'[window_attention] {where}: B2 launches by route (f32, N = 64 '
          f'tensor cores, padded) {n}', flush=True)
    require(n[mod.TC] == 0, f'window_attention: {where}: FeMaSR took the '
                            f'padded route {n[mod.TC]} times')


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
                with torch.no_grad():   # gn's parameters require grad
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
                # FeMaSR's shape keeps its N = 64, head_dim 32 kernel
                route = mod.route_of(q, k, v, nh)
                print(f'[window_attention] FeMaSR bf16 with the mask: route '
                      f'{route} (TC64 = {mod.TC64}), {ms:.4f} ms beside the '
                      f'earlier {FEMASR_B2_EARLIER_MS[0]}-'
                      f'{FEMASR_B2_EARLIER_MS[1]} ms', flush=True)
                require(route == mod.TC64, f'window_attention: FeMaSR\'s '
                                           f'shape takes route {route}')
                entry = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             library_ms=lib_ms, bound_ms=bms, bound_by=by,
                             dtype='bfloat16', share_beyond_one_ulp=beyond,
                             b2_route=route,
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
    # the distance the kernel compared (the split codebook's reduction
    # reads it): the same indices, and the plain version's distance at
    # each token within f32 rounding of its size
    with counting_off(mod):
        idx_d, dist_k = mod.vq_argmin(z, cb, with_dist=True)
    _, dist_p = mod.vq_argmin_plain(z, cb, with_dist=True)
    out_err = (dist_k - dist_p).abs().max().item()
    dist_rel = out_err / dist_p.abs().max().item()
    print(f'[vq_argmin] with its distance: indices equal to the plain '
          f'call\'s {torch.equal(idx_d, idx)}; distance vs the plain '
          f'version max_abs_err={out_err:.3e} (relative {dist_rel:.2e}, '
          f'tol {VQ_DIST_RTOL})', flush=True)
    require(torch.equal(idx_d, idx) and dist_rel <= VQ_DIST_RTOL,
            f'vq_argmin distance output: indices equal '
            f'{torch.equal(idx_d, idx)}, relative error {dist_rel}')
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
        dist_output_rel_err=dist_rel,
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


def plain_kernels():
    """Route the model's kernel calls to the plain versions (f32 reference)."""
    from femasr_torch.kernels import plain_versions
    return plain_versions()


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
            out_k, _, _, idx_k = model(xp)
        out_k = crop(out_k)
        with plain_kernels():
            if lane == 'int8':
                out_u, _, _, idx_u = model(xp)
                info['unforced_index_agreement'] = (
                    idx_k[0] == idx_u[0]).float().mean().item()
                info['unforced_mean_abs_diff'] = (
                    out_k - crop(out_u)).abs().mean().item()
                del out_u
                stats = {}
                with int8_forcing.force(model, store, stats):
                    out_p, _, _, idx_p = model(xp)
                info['int8_layers'] = int8_boundary_summary(stats)
            else:
                out_p, _, _, idx_p = model(xp)
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
                out, _, _, idx = sr.model(xp)
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


def serving_inputs(work, whole: int = 512, tiled: int = 720) -> tuple:
    """The seeded random-init x4 release model (saved as a reference .pth)
    and a folder of two seeded images: (net, pth, folder, {name: side})."""
    import cv2

    from femasr_torch.models import FeMaSRNet, init_weights
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
    return net, pth, in_dir, sizes


def main_path(dev, work, whole: int = 512, tiled: int = 720):
    import cv2

    from femasr_torch import kernels
    from femasr_torch.models import SRInferencer

    net, pth, in_dir, sizes = serving_inputs(work, whole, tiled)
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


def group_kernels(prof) -> tuple:
    """The profile's kernels in start order, their device time (us) by
    KERNEL_GROUPS group and by name, and their launches by name."""
    kern = device_kernels(prof)
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
    return kern, groups, by_name, n_by_name


def profile_forward(dev, lane: str, reps: int = 3) -> dict:
    """Device-time breakdown of one warm 512px bf16 whole-image forward;
    in the int8 lane also B6's launches and time per shape."""
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
    kern, groups, by_name, n_by_name = group_kernels(prof)
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


# -- phase 5: training ---------------------------------------------------------

LQ_YML = 'options/train_FeMaSR_LQ_stage.yml'
HQ_YML = 'options/train_FeMaSR_HQ_pretrain_stage.yml'
TRAIN_IMAGES, TRAIN_GT = 16, 256
LQ_ITERS, LQ_SAVE_AT, HQ_ITERS = 8, 4, 4
# kernel launches per training iteration: LQ, the frozen HQ prior's conv3
# tail (4 ResBlock convs + out_conv) and search, and the trainee's search
# on detached tokens; HQ, the trainee's search only. No other kernel runs.
TRAIN_LAUNCHES = {'lq': {'conv3': 5, 'vq_argmin': 2},
                  'hq': {'conv3': 0, 'vq_argmin': 1}}
RESUME_RTOL = 1e-3
# a training iteration's kernels by group: the serving groups, then what
# autograd and the f32 convs add (cuDNN's FFT and Winograd convolutions,
# its weight-gradient kernels, the resize and pooling backward passes)
TRAIN_KERNEL_GROUPS = KERNEL_GROUPS[:7] + (
    ('depthwise conv (the on-device degradation\'s blurs)',
     ('conv_depthwise2d',)),
    ('cuDNN conv', ('conv', 'xmma', 'implicit', 'cudnn', 'fft', 'winograd',
                    'wgrad', 'dgrad')),) + KERNEL_GROUPS[8:]
# one LQ G step through the kernels vs the plain versions: f32 (B3's rule
# for both searches) and bf16 (the prior's tokens round to bf16 through
# B1's tensor-core route and act_bf16, as the plain versions round them
# within one ulp; the bf16 backward is not bit for bit on the card, so
# the gradients are held within grad_tol or twice the spread of two runs
# of the step through the kernels, which this script measures: 7.6e-3
# of their max at the release width on an H100)
G_STEP_F32 = dict(loss_rtol=1e-5, grad_tol=1e-4, prior_min=0.9999,
                  prior_gap=1e-5, spread=False)
G_STEP_BF16 = dict(loss_rtol=1e-3, grad_tol=1e-2, prior_min=0.999,
                   prior_gap=None, spread=True)
TRAIN_LOSSES = ('l_codebook', 'l_pix', 'l_percep', 'l_g_gan', 'l_d_real',
                'l_d_fake')
# validation (A10): two seeded smooth images at DIV2K-valid size, LR
# 510x339 (landscape) and 339x510 (portrait), GT at x4; the LQ run
# validates every LQ_VAL_FREQ iterations and once after its loop, the HQ run
# once after its loop on the landscape GT (the HQ config's val set is GT on
# both sides)
VAL_LR = ((339, 510), (510, 339))
LQ_VAL_FREQ = 4
# kernel launches per validation image: the serving forward in f32
VAL_LAUNCHES = {'lq': {'conv3': 5, 'window_attention': 24, 'vq_argmin': 1},
                'hq': {'conv3': 5, 'vq_argmin': 1}}
# validation through the kernels vs the plain versions, and the offline
# evaluation of net_g_best vs the in-training validation that saved it
VAL_TOL = {'psnr': 0.01, 'ssim': 1e-4, 'lpips': 1e-4}
EVAL_TOL = {'psnr': 1e-4, 'ssim': 1e-5, 'lpips': 1e-5}
TEST_YML = 'options/test_FeMaSR.yml'


def seed_convs(module, gen) -> None:
    """Conv weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)) and biases
    N(0, 0.05) from `gen`: frozen loss networks made from a seed."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d):
                bound = m.weight[0].numel() ** -0.5
                m.weight.copy_((torch.rand(m.weight.shape, generator=gen)
                                * 2 - 1) * bound)
                m.bias.copy_(torch.randn(m.bias.shape, generator=gen) * 0.05)


def train_inputs(work: str) -> dict:
    """A seeded folder of TRAIN_IMAGES GT images and their x4 LQ (area
    downsampling in numpy), and seeded weights in the reference formats:
    an HQ prior (release config), LPIPS-VGG (lpips package keys) and a
    whole VGG19 (torchvision keys)."""
    import cv2

    from femasr_torch.losses import LPIPS, lpips_package_state
    from femasr_torch.models import FeMaSRNet, init_weights
    from femasr_torch.models.vgg_arch import (VGGFeatureExtractor,
                                              torchvision_state)
    paths = {k: os.path.join(work, k) for k in ('gt', 'lq')}
    for p in paths.values():
        os.makedirs(p)
    rng = np.random.default_rng(8)
    s = TRAIN_GT
    for i in range(TRAIN_IMAGES):
        gt = smooth_image(rng, s, s)
        lq = gt.reshape(s // 4, 4, s // 4, 4, 3).mean(axis=(1, 3))
        cv2.imwrite(os.path.join(paths['gt'], f'{i:02d}.png'), gt)
        cv2.imwrite(os.path.join(paths['lq'], f'{i:02d}.png'),
                    lq.round().astype(np.uint8))
    hq = FeMaSRNet([[32, 1024, 512]], LQ_stage=False)
    init_weights(hq, torch.Generator().manual_seed(11))
    lp = LPIPS()
    gen = torch.Generator().manual_seed(12)
    seed_convs(lp, gen)
    with torch.no_grad():
        for i in range(5):
            w = getattr(lp, f'lin{i}')
            w.copy_(torch.rand(w.shape, generator=gen) / w.numel())
    vgg = VGGFeatureExtractor(['pool5'], 'vgg19')
    seed_convs(vgg, gen)
    for name, obj in (('hq', {'params': hq.state_dict()}),
                      ('lpips', lpips_package_state(lp)),
                      ('vgg19', torchvision_state(vgg))):
        paths[name] = os.path.join(work, f'{name}.pth')
        torch.save(obj, paths[name])
    return paths


def release_options(yml: str, name: str, inputs: dict, iters: int,
                    save_every: float, val_root: str = None,
                    val_freq: float = None, as_shipped: bool = False) -> dict:
    """A release training YAML at its own widths, losses and optimizers,
    on the seeded folder and weights, for `iters` iterations. Its train set
    becomes a PairedImageDataset of the seeded GT and LQ with 2 workers,
    or with as_shipped stays the YAML's own (type, workers, degradation)
    on the seeded GT. With val_root, its own val block (metrics, key
    metric, save_img) validates on that folder's lq/ and gt/ every
    `val_freq` iterations and after the loop; without, the val block is
    dropped."""
    opt = load_yml(yml)
    val = opt.pop('val')
    data = opt['datasets']['train']
    if as_shipped:
        data.update(dataroot_gt=inputs['gt'])
    else:
        data.update(type='PairedImageDataset', dataroot_gt=inputs['gt'],
                    dataroot_lq=inputs['lq'], num_worker_per_gpu=2)
    opt['datasets'] = {'train': data}
    if val_root is not None:
        opt['datasets']['val'] = {
            'name': 'smoke_val', 'type': 'PairedImageDataset',
            'dataroot_gt': os.path.join(val_root, 'gt'),
            'dataroot_lq': os.path.join(val_root, 'lq')}
        opt['val'] = dict(val, val_freq=val_freq)
    opt.update(name=name, device='cuda', manual_seed=0)
    opt['train']['total_iter'] = iters
    opt['logger'] = {'print_freq': 1, 'save_checkpoint_freq': save_every,
                     'save_latest_freq': 1e9, 'use_tb_logger': False}
    return opt


def load_yml(yml: str) -> dict:
    """An option file of the repository, as the port's CLIs read it."""
    from femasr_torch.utils.options import load_options
    return load_options(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), yml))


def run_train_cli(work: str, opt: dict, *extra) -> tuple:
    """python -m femasr_torch.train_cli -opt <json> in `work`; returns the
    model and the run's log records."""
    from femasr_torch import train_cli
    opt_path = os.path.join(work, f'{opt["name"]}.json')
    with open(opt_path, 'w') as f:
        json.dump(opt, f)
    log = os.path.join(work, 'experiments', opt['name'], 'train_log.jsonl')
    seen = 0
    if os.path.exists(log):
        with open(log) as f:
            seen = len(f.readlines())
    cwd = os.getcwd()
    os.chdir(work)
    try:
        model = train_cli.main(['-opt', opt_path, *extra])
    finally:
        os.chdir(cwd)
    sync(model.device)
    with open(log) as f:
        records = [json.loads(line) for line in f.readlines()[seen:]]
    return model, records


def check_launches(counts: dict, stage: str, iters: int) -> None:
    want = {name: TRAIN_LAUNCHES[stage].get(name, 0) * iters
            for name in counts}
    print(f'[train] {stage} stage, {iters} iterations: kernel launches '
          f'{counts} (expected {want})', flush=True)
    require(counts == want, f'{stage} training launches {counts}, expected '
                            f'{want}')


def check_losses(records: list, stage: str) -> None:
    for r in records:
        vals = [v for k, v in r.items() if k.startswith('l_')]
        require(vals and np.isfinite(vals).all(),
                f'{stage} iteration {r["iter"]}: non-finite losses {r}')


def val_inputs(work: str) -> dict:
    """The seeded validation folders: `lq` holds the VAL_LR pairs (LR and
    its x4 GT, area downsampling in numpy), `hq` the landscape GT on both
    sides."""
    import cv2
    roots = {k: os.path.join(work, f'val_{k}') for k in ('lq', 'hq')}
    rng = np.random.default_rng(9)
    for i, (h, w) in enumerate(VAL_LR):
        gt = smooth_image(rng, 4 * h, 4 * w)
        lq = gt.reshape(h, 4, w, 4, 3).mean(axis=(1, 3)).round().astype(
            np.uint8)
        subs = [('lq', 'gt', gt), ('lq', 'lq', lq)]
        if i == 0:
            subs += [('hq', 'gt', gt), ('hq', 'lq', gt)]
        for root, sub, img in subs:
            os.makedirs(os.path.join(roots[root], sub), exist_ok=True)
            cv2.imwrite(os.path.join(roots[root], sub, f'{i:02d}.png'), img)
    return roots


@contextlib.contextmanager
def probe_validation(dev, calls: list):
    """Every FeMaSRModel.validation inside the block appends to `calls` its
    iteration, image count, host ms (synchronized), kernel launches (the
    counts set to 0 just before it and read just after, then added back),
    the memory allocated before it and its peak max_memory_allocated (the
    peak before it is kept as `peak_before`, so the stage's own peak is the
    max of all), and its metrics and best records."""
    from femasr_torch import kernels
    from femasr_torch.train import FeMaSRModel
    orig = FeMaSRModel.validation

    def validation(self, loader, current_iter, tb_logger, save_img=False):
        saved = kernels.launch_counts()
        sync(dev)
        peak_before = torch.cuda.max_memory_allocated(dev)
        allocated = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        orig(self, loader, current_iter, tb_logger, save_img)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        counts = kernels.launch_counts()
        for name, mod in kernels.MODULES.items():
            mod.launches = saved[name] + counts[name]
        name = loader.dataset.opt['name']
        calls.append(dict(
            iter=current_iter, dataset=name, images=len(loader), ms=ms,
            ms_per_image=ms / len(loader), launches=counts,
            allocated_before_bytes=allocated, peak_before=peak_before,
            peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
            metrics=dict(self.metric_results),
            best={m: dict(r) for m, r in
                  self.best_metric_results.get(name, {}).items()}))
    FeMaSRModel.validation = validation
    try:
        yield
    finally:
        FeMaSRModel.validation = orig


def check_val_launches(calls: list, stage: str) -> dict:
    """Each validation launched VAL_LAUNCHES[stage] per image, every other
    kernel 0; returns the per-image counts."""
    for c in calls:
        want = {name: VAL_LAUNCHES[stage].get(name, 0) * c['images']
                for name in c['launches']}
        require(c['launches'] == want,
                f'{stage} validation at {c["iter"]}: launches '
                f'{c["launches"]}, expected {want}')
    n = sum(c['images'] for c in calls)
    per_image = {name: sum(c['launches'][name] for c in calls) / n
                 for name in calls[0]['launches']}
    print(f'[validate] {stage}: {len(calls)} validations of '
          f'{calls[0]["images"]} image(s): kernel launches per image '
          f'{per_image} (expected {VAL_LAUNCHES[stage]}, others 0)',
          flush=True)
    return per_image


def stage_counts_and_peak(dev, calls: list) -> tuple:
    """A training run's own kernel launches (the run's minus its
    validations') and its peak max_memory_allocated over the whole run
    (the validations reset the peak statistics; each kept the peak before
    it)."""
    from femasr_torch import kernels
    counts = kernels.launch_counts()
    for c in calls:
        counts = {k: v - c['launches'][k] for k, v in counts.items()}
    peak = max([torch.cuda.max_memory_allocated(dev)]
               + [c[k] for c in calls for k in ('peak_before',
                                                'peak_memory_bytes')])
    return counts, peak


def print_validations(calls: list, stage: str) -> None:
    for c in calls:
        print(f'[validate] {stage} at iteration {c["iter"]}: '
              f'{c["ms_per_image"]:.1f} ms per image (host clock, '
              f'synchronized, metrics and image writes included), peak '
              f'max_memory_allocated {c["peak_memory_bytes"] / 2**30:.2f} '
              f'GiB ({c["allocated_before_bytes"] / 2**30:.2f} GiB held '
              f'before it); metrics '
              + ', '.join(f'{k} {v:.6f}' for k, v in c['metrics'].items()),
              flush=True)
        vals = [v for v in c['metrics'].values()]
        require(vals and np.isfinite(vals).all(),
                f'{stage} validation at {c["iter"]}: metrics {c["metrics"]}')


def val_records(calls: list) -> list:
    """The probe's records for the JSON line (without the best records,
    which may hold infinities)."""
    return [{k: v for k, v in c.items() if k != 'best'} for c in calls]


def last_saving_validation(calls: list, key: str) -> dict:
    """The last validation that improved the key metric's record: the one
    whose weights net_g_best holds."""
    saving = [c for c in calls if c['best'][key]['iter'] == c['iter']]
    require(saving, f'no validation improved {key}')
    return saving[-1]


def validation_kernels_vs_plain(model, loader) -> dict:
    """The trained model's validation through the kernels, then with every
    wrapper on its plain version: per image the codebook indices (>= 99.9%
    equal) and the f32 output (mean abs diff <= 1e-4), and the metrics
    (VAL_TOL). Best records and checkpoints are left as they were."""
    from femasr_torch import kernels
    from femasr_torch.models.inference import flip_pad
    best = json.loads(json.dumps(model.best_metric_results))
    model._save_best_models = lambda: None
    sr = model._get_inferencer()
    runs = {}
    try:
        with counting_off(*kernels.MODULES.values()):
            for name, ctx in (('kernels', contextlib.nullcontext()),
                              ('plain', plain_kernels())):
                outs = []
                with ctx:
                    model.validation(loader, 'kernels_vs_plain', None)
                    metrics = dict(model.metric_results)
                    for batch in loader:
                        x = batch['lq'].to(model.device)
                        h, w = x.shape[2:]
                        xp = flip_pad(x, (h // sr.wsz + 1) * sr.wsz - h,
                                      (w // sr.wsz + 1) * sr.wsz - w)
                        with torch.no_grad():
                            out, _, _, idx = model.eval_net()(xp)
                        outs.append((out.float().clamp(0, 1)[
                            :, :, :4 * h, :4 * w], idx[0]))
                runs[name] = (metrics, outs)
    finally:
        del model._save_best_models
        model.best_metric_results = best
    (mk, ok), (mp, op) = runs['kernels'], runs['plain']
    info = dict(metrics_kernels=mk, metrics_plain=mp, images=[])
    for (out_k, idx_k), (out_p, idx_p) in zip(ok, op):
        info['images'].append(dict(
            index_agreement=(idx_k == idx_p).float().mean().item(),
            mean_abs_diff=(out_k - out_p).abs().mean().item(),
            max_abs_diff=(out_k - out_p).abs().max().item()))
    diffs = {k: abs(mk[k] - mp[k]) for k in mk}
    info['metric_abs_diff'] = diffs
    print('[validate] LQ validation f32, kernels vs plain versions: '
          + '; '.join(f'image {i}: index agreement '
                      f'{r["index_agreement"]:.6f}, output mean_abs_diff '
                      f'{r["mean_abs_diff"]:.3e} max_abs_diff '
                      f'{r["max_abs_diff"]:.3e}'
                      for i, r in enumerate(info['images']))
          + '; metrics ' + ', '.join(f'{k} {mk[k]:.6f} vs {mp[k]:.6f}'
                                     for k in mk), flush=True)
    require(sorted(mk) == ['lpips', 'psnr', 'ssim'],
            f'validation metrics {sorted(mk)}')
    for r in info['images']:
        require(r['index_agreement'] >= 0.999 and r['mean_abs_diff'] <= 1e-4,
                f'validation kernels vs plain: {r}')
    for k, tol in VAL_TOL.items():
        require(diffs[k] <= tol, f'validation {k}: kernels vs plain differ '
                                 f'by {diffs[k]} (tol {tol})')
    return info


def validation_breakdown(model, loader, work: str, reps: int = 2) -> dict:
    """ms per LQ validation image by part, on the host clock with a
    synchronize after each part, over `reps` passes of the val set: reading
    the pair, the forward (model.test), the 8-bit levels and the GT on the
    card, each metric, the PNG write."""
    from femasr_torch import kernels
    from femasr_torch.utils.img_util import imwrite, round_8bit
    dev = model.device
    funcs = model._metric_funcs()
    parts = dict.fromkeys(['read pair (cv2)', 'forward (model.test)',
                           '8-bit levels, GT to card']
                          + [f'metric {m}' for m in funcs]
                          + ['PNG write (cv2)'], 0.0)
    path = os.path.join(work, 'breakdown.png')

    def timed(part, fn):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        parts[part] += (time.perf_counter() - t0) * 1e3
        return out
    data = loader.dataset
    with counting_off(*kernels.MODULES.values()):
        for _ in range(reps):
            for i in range(len(data)):
                item = timed('read pair (cv2)', lambda: data[i])
                sr = timed('forward (model.test)',
                           lambda: model.test(item['lq'][None]))
                levels, gt = timed('8-bit levels, GT to card', lambda: (
                    round_8bit(sr)[0].permute(1, 2, 0),
                    item['gt'].permute(1, 2, 0).to(dev)))
                for m, fn in funcs.items():
                    timed(f'metric {m}', lambda: fn(levels / 255.0, gt))
                timed('PNG write (cv2)', lambda: imwrite(
                    levels.flip(-1).to(torch.uint8).cpu().numpy(), path))
    n = reps * len(data)
    out = {k: v / n for k, v in parts.items()}
    print('[validate] LQ validation image, ms by part (host clock, '
          'synchronized, warm): ' + ', '.join(f'{k} {v:.1f}'
                                             for k, v in out.items())
          + f'; sum {sum(out.values()):.1f}', flush=True)
    return out


def offline_evaluation(dev, work: str, best_pth: str, lpips_pth: str,
                       val_root: str, want: dict) -> dict:
    """python -m femasr_torch.test_cli -opt <options/test_FeMaSR.yml on the
    val set, pointed at best_pth> in `work`: the metrics of the in-training
    validation that saved best_pth (EVAL_TOL), the images written, and the
    launches per image."""
    from femasr_torch import kernels, test_cli
    opt = load_yml(TEST_YML)
    data = opt['datasets']['test_1']
    data.update(dataroot_gt=os.path.join(val_root, 'gt'),
                dataroot_lq=os.path.join(val_root, 'lq'))
    opt.update(name='smoke_eval', device=str(dev))
    opt['path'].update(pretrain_network_g=best_pth, pretrain_lpips=lpips_pth)
    opt_path = os.path.join(work, 'smoke_eval.json')
    with open(opt_path, 'w') as f:
        json.dump(opt, f)
    cwd = os.getcwd()
    os.chdir(work)
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        model = test_cli.main(['-opt', opt_path])
    finally:
        os.chdir(cwd)
    sync(dev)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    got = dict(model.metric_results)
    vis = os.path.join(work, 'results', 'smoke_eval', 'visualization',
                       data['name'])
    written = sorted(os.listdir(vis)) if os.path.isdir(vis) else []
    n = len(VAL_LR)
    diffs = {k: abs(got[k] - want[k]) for k in want}
    print(f'[evaluate] test_cli on net_g_best, {n} images in {seconds:.1f} '
          f's (model build included): '
          + ', '.join(f'{k} {got[k]:.6f} (in training {want[k]:.6f})'
                      for k in want)
          + f'; launches {counts}; wrote {written}', flush=True)
    require(sorted(got) == sorted(want), f'evaluation metrics {sorted(got)}')
    for k, tol in EVAL_TOL.items():
        require(diffs[k] <= tol, f'evaluation {k}: {got[k]} vs '
                                 f'{want[k]} in training (tol {tol})')
    require(len(written) == n and all(
        f.endswith(f'_{opt["name"]}.png') for f in written),
        f'evaluation images {written} in {vis}')
    want_counts = {k: VAL_LAUNCHES['lq'].get(k, 0) * n for k in counts}
    require(counts == want_counts, f'evaluation launches {counts}, '
                                   f'expected {want_counts}')
    return dict(metrics=got, metric_abs_diff=diffs, seconds=seconds,
                launches=counts, images_written=written)


def near_ties(z: torch.Tensor, cb: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor) -> tuple:
    """(agreement, worst relative distance gap) of two index maps of the
    same tokens: B3's rule (>= 0.9999 equal, the rest near-ties)."""
    a, b = a.reshape(-1), b.reshape(-1)
    diff = (a != b).nonzero().flatten()
    gap = 0.0
    if diff.numel():
        zd, cd = z[diff].double(), cb.double()
        d_a = (zd - cd[a[diff].long()]).square().sum(1)
        d_b = (zd - cd[b[diff].long()]).square().sum(1)
        gap = ((d_a - d_b).abs() / d_b.abs()).max().item()
    return 1.0 - diff.numel() / a.numel(), gap


def g_step_kernels_vs_plain(model, batch, gates: dict = None) -> dict:
    """One LQ generator step through the kernels, then with every wrapper
    on its plain version: the prior's and the trainee's indices, the loss
    and every gradient tensor (of its max), held to `gates` (G_STEP_F32:
    f32, B3's rule for both searches; G_STEP_BF16: bf16, the prior's
    indices >= 99.9% equal, as its tokens round to bf16 through B1's
    tensor-core route and act_bf16)."""
    gates = gates or G_STEP_F32
    from femasr_torch import kernels
    model.feed_data(batch)
    tokens = {}

    def grab(key):
        def hook(mod, args, out):
            z = args[0].detach()
            tokens[key] = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1])
        return hook
    hooks = [model.net_hq.quantize_group[0].register_forward_hook(
                 grab('prior')),
             model.net_g.quantize_group[0].register_forward_hook(
                 grab('trainee'))]
    runs = {}
    try:
        repeat = (('kernels again', contextlib.nullcontext()),) if gates[
            'spread'] else ()
        for name, ctx in (('kernels', contextlib.nullcontext()), *repeat,
                          ('plain', plain_kernels())):
            with ctx, counting_off(*kernels.MODULES.values()):
                model.opt_g.zero_grad(set_to_none=True)
                total, _, _, idx, gt_idx = model.g_backward(model.lq,
                                                            model.gt)
                grads = {n: p.grad.clone() for n, p in
                         model.net_g.named_parameters() if p.grad is not None}
            runs[name] = (total.item(), idx, gt_idx[0], grads,
                          dict(tokens))
    finally:
        for h in hooks:
            h.remove()
        model.opt_g.zero_grad(set_to_none=True)
    (lk, ik, gk, grk, tok), (lp, ip, gp, grp, _) = runs['kernels'], \
        runs['plain']
    cb_hq = model.net_hq.quantize_group[0].embedding.weight.detach()
    cb_g = model.net_g.quantize_group[0].embedding.weight.detach()
    prior = near_ties(tok['prior'], cb_hq, gk, gp)
    trainee = near_ties(tok['trainee'], cb_g, ik, ip)
    loss_rel = abs(lk - lp) / abs(lp)
    def worst_of_max(a, b):
        return max(((a[n] - b[n]).abs().max() / b[n].abs().max().clamp_min(
            1e-30)).item() for n in b)
    worst = worst_of_max(grk, grp)
    spread = (worst_of_max(runs['kernels again'][3], grk) if gates['spread']
              else 0.0)
    grad_tol = max(gates['grad_tol'], 2 * spread)
    info = dict(loss_kernels=lk, loss_plain=lp, loss_rel_diff=loss_rel,
                worst_grad_diff_of_max=worst, grad_tensors=len(grp),
                run_to_run_worst_grad_diff_of_max=spread,
                prior_index_agreement=prior[0], prior_worst_gap=prior[1],
                trainee_index_agreement=trainee[0],
                trainee_worst_gap=trainee[1])
    info['gates'] = gates
    print(f'[train] LQ G step {str(model.dtype)[6:]}, kernels vs plain '
          f'versions: loss {lk:.6f} vs {lp:.6f} (rel {loss_rel:.2e}, tol '
          f'{gates["loss_rtol"]}); {len(grp)} gradient tensors, worst '
          f'{worst:.2e} of max (tol {grad_tol:.2e}; the kernels run to run '
          f'{spread:.2e}); prior indices '
          f'{prior[0]:.6f} equal (worst gap {prior[1]:.1e}; gate '
          f'>= {gates["prior_min"]}), trainee {trainee[0]:.6f} (worst gap '
          f'{trainee[1]:.1e})', flush=True)
    require(grk.keys() == grp.keys(), 'G step: different gradient sets')
    require(prior[0] >= gates['prior_min'] and (
        gates['prior_gap'] is None or prior[1] <= gates['prior_gap']),
        f'G step prior indices disagree: {info}')
    require(trainee[0] >= 0.9999 and trainee[1] <= 1e-5,
            f'G step trainee indices disagree beyond near-ties: {info}')
    require(loss_rel <= gates['loss_rtol'] and worst <= grad_tol,
            f'G step kernels vs plain: {info}')
    return info


def time_iterations(model, batch, reps: int, warm: int = 1) -> dict:
    """ms per iteration and images/s on the host clock over synchronized
    warm iterations of one batch, and the peak max_memory_allocated of
    these iterations alone (the run's peak also holds its validations and
    first iterations)."""
    from femasr_torch import kernels
    model.feed_data(batch)
    sync(model.device)
    torch.cuda.reset_peak_memory_stats(model.device)
    with counting_off(*kernels.MODULES.values()):
        for _ in range(warm):
            model.optimize_parameters()
        sync(model.device)
        t0 = time.perf_counter()
        for _ in range(reps):
            model.optimize_parameters()
        sync(model.device)
    ms = (time.perf_counter() - t0) * 1e3 / reps
    return dict(ms_per_iteration=ms, images_per_s=batch['gt'].shape[0]
                * 1e3 / ms, reps=reps, gt_batch=list(batch['gt'].shape),
                iteration_peak_bytes=torch.cuda.max_memory_allocated(
                    model.device))


def profile_iteration(model, batch, stage: str, wall_ms: float) -> dict:
    """Device busy time of one warm iteration and its top kernel groups
    (torch.profiler); the idle share is taken against `wall_ms`, the
    iteration's time without the profiler (which slows the host)."""
    from torch.profiler import ProfilerActivity, profile

    from femasr_torch import kernels
    model.feed_data(batch)
    with counting_off(*kernels.MODULES.values()):
        sync(model.device)
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.optimize_parameters()
            sync(model.device)
        wall = (time.perf_counter() - t0) * 1e3
    kern = device_kernels(prof)
    groups = {name: 0.0 for name, _ in TRAIN_KERNEL_GROUPS}
    groups['other'] = 0.0
    by_name = {}
    for e in kern:
        low = e.name.lower()
        ms = e.time_range.elapsed_us() / 1e3
        gname = next((g for g, keys in TRAIN_KERNEL_GROUPS
                      if any(k in low for k in keys)), 'other')
        groups[gname] += ms
        by_name[e.name] = by_name.get(e.name, 0.0) + ms
    busy = sum(groups.values())
    idle = max(0.0, 1 - busy / wall_ms)
    # the union of the kernels' intervals: kernels on other streams (DDP's
    # all-reduce) overlap the compute, and the sum counts them twice
    union, end = 0.0, None
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kern):
        if end is None or a > end:
            union, end = union + (b - a), b
        elif b > end:
            union, end = union + (b - end), b
    union /= 1e3
    top = sorted(((g, v) for g, v in groups.items() if v > 0),
                 key=lambda kv: -kv[1])
    print(f'[train] {stage} profile, one warm iteration: device busy '
          f'{busy:.1f} ms of {wall_ms:.1f} ms unprofiled (idle share '
          f'{idle:.3f}; {wall:.1f} ms under the profiler); top groups: '
          + ', '.join(f'{g} {v:.1f} ms' for g, v in top), flush=True)
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f'[train]   top: {ms:8.2f} ms  {name[:100]}', flush=True)
    return dict(unprofiled_wall_ms=wall_ms, profiled_wall_ms=wall,
                device_busy_ms=busy, idle_share=idle, kernels=len(kern),
                device_union_ms=union,
                idle_share_union=max(0.0, 1 - union / wall_ms),
                groups_ms=dict(top),
                conv3_routes_ms={n: ms for n, ms in by_name.items()
                                 if 'conv3' in n and 'w8a8' not in n})


def check_train_shapes(dev, results) -> None:
    """B1's f32 FFMA route and B3 at the training shapes (batch 8, gt 256):
    the kernel against its plain version, with its time, the plain
    version's, the library call's and the bound."""
    from femasr_torch.kernels import conv3 as c3
    from femasr_torch.kernels import vq_argmin as vq
    from femasr_torch.ops.layers import GroupNorm
    g = torch.Generator(device=dev).manual_seed(9)
    b, c, h, w = 8, 64, 256, 256
    x = torch.randn((b, c, h, w), generator=g, device=dev).contiguous(
        memory_format=torch.channels_last)
    gn = GroupNorm(32, c).to(dev)
    wt = (torch.rand((c, c, 3, 3), generator=g, device=dev) * 2 - 1) \
        * (c * 9) ** -0.5
    bias = torch.rand((c,), generator=g, device=dev) * 0.1
    with torch.no_grad():
        a, s = gn.affine(x)
        xa = F.silu(x * a[:, :, None, None] + s[:, :, None, None])
        kw = dict(scale=a, shift=s, pre_act='silu')
        with counting_off(c3):
            y = c3.conv3(x, wt, bias, **kw)
            sync(dev)
            ref = c3.conv3_plain(x, wt, bias, **kw)
            err = (y - ref).abs().max().item()
            ms = time_ms(lambda: c3.conv3(x, wt, bias, **kw), reps=5)
        plain_ms = time_ms(lambda: c3.conv3_plain(x, wt, bias, **kw),
                           reps=5)
        with cudnn_autotuned():
            lib_ms = time_ms(lambda: F.conv2d(xa, wt, bias, padding=1),
                             reps=5)
    bms, by = bound_ms(nbytes(x, y, wt, bias, a, s),
                       2.0 * b * h * w * c * c * 9, torch.float32)
    ok = torch.allclose(y, ref, atol=1e-4, rtol=1e-4)
    print(f'[conv3] training shape x (8,64,256,256) -> 64 f32 (FFMA route), '
          f'gn/silu prologue: max_abs_err={err:.3e} (tol 1e-4) ms={ms:.4f} '
          f'plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (F.conv2d with '
          f'bias, cuDNN autotuned, TF32 off) bound_ms={bms:.4f} ({by})',
          flush=True)
    require(ok, f'conv3 training shape: kernel disagrees ({err})')
    results['conv3']['training'] = dict(
        shape='x (8,64,256,256) -> 64 f32, gn+silu prologue (FFMA route)',
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bms, bound_by=by)
    del y, ref, xa

    # bf16 (the frozen prior of a bf16 run): the tensor-core route
    from femasr_torch.kernels.tolerance import bf16_agreement
    xb = x.to(torch.bfloat16)
    with torch.no_grad():
        a, s = gn.affine(xb)
        xa = F.silu(xb.float() * a[:, :, None, None]
                    + s[:, :, None, None]).to(torch.bfloat16)
        kw = dict(scale=a, shift=s, pre_act='silu')
        with counting_off(c3):
            y = c3.conv3(xb, wt, bias, **kw)
            sync(dev)
            ref = c3.conv3_plain(xb, wt, bias, **kw)
            atol = (2.0 ** -7 * xa.float().abs().max().item()
                    * wt.abs().max().item())
            ok, err, beyond = bf16_agreement(y, ref, atol)
            ms = time_ms(lambda: c3.conv3(xb, wt, bias, **kw), reps=5)
        plain_ms = time_ms(lambda: c3.conv3_plain(xb, wt, bias, **kw), reps=5)
        wl = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bl = bias.to(torch.bfloat16)
        with cudnn_autotuned():
            lib_ms = time_ms(lambda: F.conv2d(xa, wl, bl, padding=1), reps=5)
            conv_ms = time_ms(lambda: F.conv2d(xa, wl, None, padding=1),
                              reps=5)
    bms, by = bound_ms(nbytes(xb, y, wt, bias, a, s),
                       2.0 * b * h * w * c * c * 9, torch.bfloat16)
    print(f'[conv3] training shape x (8,64,256,256) -> 64 bf16 (tensor-core '
          f'route), gn/silu prologue: max_abs_err={err:.3e} (tol one bf16 '
          f'ulp, {beyond:.2e} of outputs beyond it (<= 1e-3), by <= '
          f'{atol:.2e}) ms={ms:.4f} plain_ms={plain_ms:.4f} '
          f'library_ms={lib_ms:.4f} (F.conv2d bf16 with bias, cuDNN '
          f'autotuned; without bias {conv_ms:.4f}) bound_ms={bms:.4f} ({by})',
          flush=True)
    require(ok, f'conv3 bf16 training shape: kernel disagrees ({err}, '
                f'{beyond} beyond one ulp)')
    results['conv3']['training_bf16'] = dict(
        shape='x (8,64,256,256) -> 64 bf16, gn+silu prologue (tensor-core '
              'route)', max_abs_err=err, share_beyond_one_ulp=beyond, ms=ms,
        plain_ms=plain_ms, library_ms=lib_ms, library_conv_only_ms=conv_ms,
        bound_ms=bms, bound_by=by)
    del x, xb, y, ref, xa

    n, k, cdim = 8 * 32 * 32, 1024, 512
    z = torch.randn((n, cdim), generator=g, device=dev)
    cb = torch.randn((k, cdim), generator=g, device=dev)
    with counting_off(vq):
        idx = vq.vq_argmin(z, cb)
        sync(dev)
        ms = time_ms(lambda: vq.vq_argmin(z, cb))
    ref = vq.vq_argmin_plain(z, cb)
    agree, gap = near_ties(z, cb, idx, ref)
    plain_ms = time_ms(lambda: vq.vq_argmin_plain(z, cb))
    lib_ms = time_ms(lambda: torch.cdist(z, cb).argmin(1))
    bms, by = bound_ms(nbytes(z, cb, idx), 2.0 * n * k * cdim + 2.0 * k
                       * cdim, torch.float32)
    print(f'[vq_argmin] training shape z (8192,512) x (1024,512) f32: index '
          f'agreement={agree:.6f} (worst gap {gap:.1e}) ms={ms:.4f} '
          f'plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} '
          f'(cdist().argmin) bound_ms={bms:.4f} ({by})', flush=True)
    require(agree >= 0.9999 and gap <= 1e-5,
            f'vq_argmin training shape: agreement {agree}, gap {gap}')
    results['vq_argmin']['training'] = dict(
        shape='z (8192,512) x codebook (1024,512) f32', index_agreement=agree,
        max_abs_err=gap, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound_ms=bms, bound_by=by)


def first_batch(opt: dict) -> dict:
    """A batch of the options' train set, as its loader makes it."""
    from femasr_torch.data import build_dataset
    dopt = dict(opt['datasets']['train'], phase='train', scale=opt['scale'])
    data = build_dataset(dopt)
    return torch.utils.data.default_collate(
        [data[i] for i in range(dopt['batch_size_per_gpu'])])


def train_phase(dev, work: str) -> dict:
    """The port's training path at release width: the LQ stage through
    train_cli (launches counted per iteration, resumed from its saved state
    and held to the uninterrupted run), one G step held against the plain
    versions, then the HQ stage; times, peak memory and a profile."""
    from femasr_torch import kernels
    from femasr_torch.data import build_dataset, build_eval_loader
    inputs = train_inputs(work)
    vals = val_inputs(work)
    out = {}

    # LQ stage, uninterrupted, saving the state at LQ_SAVE_AT, validating
    # at LQ_VAL_FREQ and after the loop
    lq_opt = release_options(LQ_YML, 'smoke_lq', inputs, LQ_ITERS,
                             LQ_SAVE_AT, vals['lq'], LQ_VAL_FREQ)
    lq_opt['path'] = {'pretrain_network_hq': inputs['hq'],
                      'pretrain_lpips': inputs['lpips'], 'strict_load': False}
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    lq_calls = []
    t0 = time.perf_counter()
    with probe_validation(dev, lq_calls):
        model, full = run_train_cli(work, lq_opt)
    lq_seconds = time.perf_counter() - t0
    counts, peak = stage_counts_and_peak(dev, lq_calls)
    require(model.cri_perceptual is not None and model.use_dis,
            'LQ stage: LPIPS or the GAN loss is off')
    require([r['iter'] for r in full] == list(range(1, LQ_ITERS + 1)),
            f'LQ stage logged {[r["iter"] for r in full]}')
    check_losses(full, 'LQ')
    check_launches(counts, 'lq', LQ_ITERS)
    want_iters = list(range(LQ_VAL_FREQ, LQ_ITERS + 1, LQ_VAL_FREQ)) + [
        LQ_ITERS]
    require([c['iter'] for c in lq_calls] == want_iters,
            f'LQ stage validated at {[c["iter"] for c in lq_calls]}, '
            f'expected {want_iters}')
    print_validations(lq_calls, 'LQ')
    out['lq'] = dict(iterations=LQ_ITERS, seconds=lq_seconds,
                     launches=counts, peak_memory_bytes=peak,
                     losses=full[-1], first_iteration=full[0],
                     validations=val_records(lq_calls),
                     validation_launches_per_image=check_val_launches(
                         lq_calls, 'lq'))
    print(f'[train] LQ stage: {LQ_ITERS} iterations in {lq_seconds:.1f} s '
          f'(model build, the first iterations and {len(lq_calls)} '
          f'validations included); peak max_memory_allocated '
          f'{peak / 2**30:.2f} GiB; last losses '
          + ', '.join(f'{k} {full[-1][k]:.4f}' for k in TRAIN_LOSSES),
          flush=True)

    # resumed at LQ_SAVE_AT (without validation): its losses against the
    # uninterrupted run's
    state = os.path.join(work, 'experiments', 'smoke_lq', 'training_states',
                         f'{LQ_SAVE_AT}.state')
    resume_opt = {k: v for k, v in lq_opt.items() if k != 'val'}
    resume_opt['datasets'] = {'train': lq_opt['datasets']['train']}
    with counting_off(*kernels.MODULES.values()):
        resumed, again = run_train_cli(
            work, resume_opt, '--force_yml', f'path:resume_state={state}')
    require([r['iter'] for r in again] == list(range(LQ_SAVE_AT + 1,
                                                     LQ_ITERS + 1)),
            f'resumed run logged {[r["iter"] for r in again]}')
    worst = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12)
                for a, b in zip(full[LQ_SAVE_AT:], again)
                for k in TRAIN_LOSSES)
    print(f'[train] LQ stage resumed at {LQ_SAVE_AT}: iterations '
          f'{LQ_SAVE_AT + 1}-{LQ_ITERS} within {worst:.2e} relative of the '
          f'uninterrupted run (tol {RESUME_RTOL})', flush=True)
    require(worst <= RESUME_RTOL, f'resumed losses off by {worst}')
    out['lq']['resume_worst_rel_diff'] = worst
    del resumed

    # offline evaluation of net_g_best, then the trained model's validation
    # through the kernels against the plain versions
    saver = last_saving_validation(lq_calls, lq_opt['val']['key_metric'])
    out['lq']['evaluation'] = offline_evaluation(
        dev, work, os.path.join(work, 'experiments', 'smoke_lq', 'models',
                                'net_g_best.pth'),
        inputs['lpips'], vals['lq'], saver['metrics'])
    out['lq']['evaluation']['of_validation_at'] = saver['iter']
    torch.cuda.empty_cache()
    loader = build_eval_loader(build_dataset(dict(
        lq_opt['datasets']['val'], phase='val')))
    out['lq']['validation_kernels_vs_plain'] = validation_kernels_vs_plain(
        model, loader)
    out['lq']['validation_ms_by_part'] = validation_breakdown(model, loader,
                                                              work)

    batch = first_batch(lq_opt)
    out['lq']['g_step_kernels_vs_plain'] = g_step_kernels_vs_plain(model,
                                                                   batch)
    out['lq']['timing'] = time_iterations(model, batch, reps=3)
    out['lq']['profile'] = profile_iteration(
        model, batch, 'LQ', out['lq']['timing']['ms_per_iteration'])
    del model
    torch.cuda.empty_cache()

    # HQ stage: the HQ prior trained on, with the semantic loss
    # (one validation, after the loop, of one image)
    hq_opt = release_options(HQ_YML, 'smoke_hq', inputs, HQ_ITERS, 1e9,
                             vals['hq'], 1e9)
    hq_opt['path'] = {'pretrain_network_g': inputs['hq'],
                      'pretrain_lpips': inputs['lpips'],
                      'pretrain_vgg': inputs['vgg19'], 'strict_load': False}
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    hq_calls = []
    t0 = time.perf_counter()
    with probe_validation(dev, hq_calls):
        model, records = run_train_cli(work, hq_opt)
    hq_seconds = time.perf_counter() - t0
    counts, peak = stage_counts_and_peak(dev, hq_calls)
    require(model.use_semantic and model.cri_perceptual is not None,
            'HQ stage: the semantic or the LPIPS loss is off')
    check_losses(records, 'HQ')
    check_launches(counts, 'hq', HQ_ITERS)
    got = [(c['iter'], c['images']) for c in hq_calls]
    require(got == [(HQ_ITERS, 1)], f'HQ stage validations {got}')
    print_validations(hq_calls, 'HQ')
    start = torch.load(inputs['hq'])['params'][
        'quantize_group.0.embedding.weight']
    moved = (model.net_g.quantize_group[0].embedding.weight.detach().cpu()
             - start).abs().max().item()
    print(f'[train] HQ stage: {HQ_ITERS} iterations in {hq_seconds:.1f} s; '
          f'peak max_memory_allocated {peak / 2**30:.2f} GiB; the codebook '
          f'moved by up to {moved:.3e}; last losses '
          + ', '.join(f'{k} {v:.4f}' for k, v in records[-1].items()
                      if k.startswith('l_')), flush=True)
    require(moved > 0, 'HQ stage: the codebook did not change')
    out['hq'] = dict(iterations=HQ_ITERS, seconds=hq_seconds,
                     launches=counts, peak_memory_bytes=peak,
                     codebook_max_change=moved, losses=records[-1],
                     first_iteration=records[0],
                     validations=val_records(hq_calls),
                     validation_launches_per_image=check_val_launches(
                         hq_calls, 'hq'))
    batch = first_batch(hq_opt)
    out['hq']['timing'] = time_iterations(model, batch, reps=2)
    out['hq']['profile'] = profile_iteration(
        model, batch, 'HQ', out['hq']['timing']['ms_per_iteration'])
    for stage in ('lq', 'hq'):
        t = out[stage]['timing']
        print(f'[train] {stage.upper()} stage, gt batch {t["gt_batch"]}, f32 '
              f'(TF32 off): {t["ms_per_iteration"]:.1f} ms per iteration, '
              f'{t["images_per_s"]:.2f} images/s (host clock over '
              f'{t["reps"]} synchronized warm iterations)', flush=True)
    del model
    torch.cuda.empty_cache()
    out.update(bf16_phase(dev, work, inputs, vals, out))
    out.update(bsrgan_phase(dev, work, inputs, {
        stage: out[stage]['timing']['ms_per_iteration']
        for stage in ('lq', 'hq')}))
    out['dp'] = dp_phase(dev, work, inputs, vals)
    out['tp'] = tp_phase(dev, work, inputs)
    return out


# -- phase 7: bf16 and checkpointed training (A8b, A8c) ------------------------

# kernel launches per bf16 iteration: the frozen prior in bf16 (B1 on its
# tensor-core route, its 20 SiLUs through act_bf16: 12 in the encoder's
# three down blocks, 8 in the first two decoder levels; the last level's
# SiLUs are B1's prologue) and both searches; the trainee takes the plain
# versions. Per bf16 validation image: the serving forward (LQ: 4 + 8 + 8
# SiLUs and the 24 Swin GELUs).
TRAIN_LAUNCHES.update(lq_bf16={'conv3': 5, 'vq_argmin': 2, 'act_bf16': 20},
                      hq_bf16={'vq_argmin': 1})
VAL_LAUNCHES.update(lq_bf16={'conv3': 5, 'window_attention': 24,
                             'vq_argmin': 1, 'act_bf16': 44},
                    hq_bf16={'conv3': 5, 'vq_argmin': 1, 'act_bf16': 20})
FIRST_LOSS_RTOL = 0.05     # bf16 vs f32, the first iteration's l_g_total
# a bf16 run resumed: its first iteration is the saved state's forward
# (exact); the next ones drift as the bf16 backward is not bit for bit on
# the card (the first chip run: 1.3e-3 after three iterations)
RESUME_FIRST_RTOL, RESUME_BF16_RTOL = 1e-6, 1e-2
REMAT_ITERS = 3
REMAT_GRAD_RTOL = 1e-5


def with_precision(opt: dict, bf16: bool, checkpoint: bool = False) -> dict:
    """The options with network_g / network_d in bfloat16, and with
    network_g.use_checkpoint."""
    if bf16:
        opt['network_g']['dtype'] = 'bfloat16'
        opt['network_d']['dtype'] = 'bfloat16'
    if checkpoint:
        opt['network_g']['use_checkpoint'] = True
    return opt


def checkpoint_gate(model, batch) -> dict:
    """One G step from one state with the Swin blocks checkpointed, then
    twice without (cuDNN deterministic): the loss equal, each gradient
    tensor within REMAT_GRAD_RTOL relative L2 of the step without, or
    within twice the two steps without (the index backward's atomics are
    not bit for bit)."""
    from femasr_torch import kernels
    from femasr_torch.ops.swin import BasicLayer
    layers = [m for m in model.net_g.modules() if isinstance(m, BasicLayer)]
    require(len(layers) == 4 and all(m.use_checkpoint for m in layers),
            'use_checkpoint did not reach the Swin layers')
    model.feed_data(batch)
    runs = []
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with counting_off(*kernels.MODULES.values()):
            for on in (True, False, False):
                for m in layers:
                    m.use_checkpoint = on
                model.opt_g.zero_grad(set_to_none=True)
                total = model.g_backward(model.lq, model.gt)[0]
                runs.append((total.item(), {
                    n: p.grad.clone() for n, p in
                    model.net_g.named_parameters() if p.grad is not None}))
    finally:
        for m in layers:
            m.use_checkpoint = True
        torch.backends.cudnn.deterministic = saved
        model.opt_g.zero_grad(set_to_none=True)

    def rel(a, b):
        return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
    (lc, gc), (lp, gp), (lp2, gp2) = runs
    worst = max(rel(gc[n], gp[n]) for n in gp)
    spread = max(rel(gp2[n], gp[n]) for n in gp)
    info = dict(loss_checkpointed=lc, loss=lp, loss_again=lp2,
                worst_grad_rel_l2=worst, run_to_run_worst_grad_rel_l2=spread,
                grad_tensors=len(gp))
    print(f'[train] use_checkpoint, one LQ G step {str(model.dtype)[6:]} '
          f'from one state: loss {lc:.6f} checkpointed, {lp:.6f} and '
          f'{lp2:.6f} without; {len(gp)} gradient tensors, worst relative '
          f'L2 {worst:.2e} (tol {REMAT_GRAD_RTOL}, or twice the '
          f'run-to-run {spread:.2e})', flush=True)
    require(gc.keys() == gp.keys(), 'checkpointed step: other gradients')
    require(lc == lp, f'checkpointed step: loss {lc} vs {lp}')
    require(worst <= max(REMAT_GRAD_RTOL, 2 * spread),
            f'checkpointed step gradients: {info}')
    return info


def precision_run(dev, work: str, inputs: dict, vals: dict, stage: str,
                  f32: dict) -> dict:
    """A bf16 release run through train_cli with its val block: launches
    per iteration and per validation image, finite losses, the first
    iteration's total loss against the f32 run's from the same init and
    batch; returns the model, its options, its log records and the run's
    numbers."""
    from femasr_torch import kernels
    lq = stage == 'lq'
    if lq:
        opt = release_options(LQ_YML, 'smoke_lq_bf16', inputs, LQ_ITERS,
                              LQ_SAVE_AT, vals['lq'], LQ_VAL_FREQ)
        opt['path'] = {'pretrain_network_hq': inputs['hq'],
                       'pretrain_lpips': inputs['lpips'],
                       'strict_load': False}
    else:
        opt = release_options(HQ_YML, 'smoke_hq_bf16', inputs, HQ_ITERS, 1e9,
                              vals['hq'], 1e9)
        opt['path'] = {'pretrain_network_g': inputs['hq'],
                       'pretrain_lpips': inputs['lpips'],
                       'pretrain_vgg': inputs['vgg19'], 'strict_load': False}
    opt = with_precision(opt, True)
    iters = LQ_ITERS if lq else HQ_ITERS
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    calls = []
    t0 = time.perf_counter()
    with probe_validation(dev, calls):
        model, records = run_train_cli(work, opt)
    seconds = time.perf_counter() - t0
    counts, peak = stage_counts_and_peak(dev, calls)
    name = f'{stage.upper()} bf16'
    require(model.dtype == torch.bfloat16
            and model.net_d.dtype == torch.bfloat16,
            f'{name}: the networks are not bf16')
    require(model.cri_perceptual is not None and model.use_dis
            and (lq or model.use_semantic), f'{name}: a loss is off')
    require([r['iter'] for r in records] == list(range(1, iters + 1)),
            f'{name} logged {[r["iter"] for r in records]}')
    check_losses(records, name)
    check_launches(counts, f'{stage}_bf16', iters)
    want = (list(range(LQ_VAL_FREQ, iters + 1, LQ_VAL_FREQ)) + [iters]
            if lq else [iters])
    require([c['iter'] for c in calls] == want,
            f'{name} validated at {[c["iter"] for c in calls]}')
    print_validations(calls, name)
    first = records[0]['l_g_total']
    ref = f32[stage]['first_iteration']['l_g_total']
    first_rel = abs(first - ref) / abs(ref)
    print(f'[train] {name}: first iteration l_g_total {first:.6f}, f32 '
          f'{ref:.6f} from the same init and batch (rel {first_rel:.2e}, '
          f'tol {FIRST_LOSS_RTOL}); {iters} iterations in {seconds:.1f} s; '
          f'peak max_memory_allocated {peak / 2**30:.2f} GiB', flush=True)
    require(first_rel <= FIRST_LOSS_RTOL,
            f'{name}: first loss {first} vs f32 {ref}')
    return model, opt, records, dict(
        iterations=iters, seconds=seconds, launches=counts,
        peak_memory_bytes=peak, losses=records[-1],
        first_iteration_l_g_total=first, f32_first_iteration_l_g_total=ref,
        first_iteration_rel_diff=first_rel, validations=val_records(calls),
        validation_launches_per_image=check_val_launches(
            calls, f'{stage}_bf16'))


def remat_run(dev, work: str, inputs: dict, bf16: bool) -> dict:
    """The LQ release config with use_checkpoint through train_cli for
    REMAT_ITERS iterations (no val block): launches, finite losses, the
    checkpoint gate, ms per iteration and peak memory."""
    from femasr_torch import kernels
    tag = 'bf16' if bf16 else 'f32'
    opt = with_precision(release_options(
        LQ_YML, f'smoke_lq_{tag}_checkpointed', inputs, REMAT_ITERS, 1e9),
        bf16, checkpoint=True)
    opt['path'] = {'pretrain_network_hq': inputs['hq'],
                   'pretrain_lpips': inputs['lpips'], 'strict_load': False}
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    model, records = run_train_cli(work, opt)
    peak = torch.cuda.max_memory_allocated(dev)
    counts = kernels.launch_counts()
    check_losses(records, f'LQ {tag} checkpointed')
    check_launches(counts, 'lq_bf16' if bf16 else 'lq', REMAT_ITERS)
    batch = first_batch(opt)
    run = dict(iterations=REMAT_ITERS, launches=counts,
               peak_memory_bytes=peak, losses=records[-1],
               checkpoint_gate=checkpoint_gate(model, batch))
    run['timing'] = time_iterations(model, batch, reps=3)
    run['profile'] = profile_iteration(
        model, batch, f'LQ {tag} checkpointed',
        run['timing']['ms_per_iteration'])
    del model
    torch.cuda.empty_cache()
    return run


def bf16_phase(dev, work: str, inputs: dict, vals: dict, f32: dict) -> dict:
    """Both release stages in bf16 through train_cli (the LQ run resumed
    and held to itself, one G step against the plain versions), then the
    LQ stage with use_checkpoint in f32 and in bf16; ms per iteration,
    peak memory and a profile of each beside the f32 runs."""
    out = {}
    model, opt, full, run = precision_run(dev, work, inputs, vals, 'lq', f32)
    state = os.path.join(work, 'experiments', 'smoke_lq_bf16',
                         'training_states', f'{LQ_SAVE_AT}.state')
    resume_opt = {k: v for k, v in opt.items() if k != 'val'}
    resume_opt['datasets'] = {'train': opt['datasets']['train']}
    from femasr_torch import kernels
    with counting_off(*kernels.MODULES.values()):
        resumed, again = run_train_cli(
            work, resume_opt, '--force_yml', f'path:resume_state={state}')
    require([r['iter'] for r in again] == list(range(LQ_SAVE_AT + 1,
                                                     LQ_ITERS + 1)),
            f'resumed bf16 run logged {[r["iter"] for r in again]}')
    def worst_rel(pairs):
        return max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12)
                   for a, b in pairs for k in TRAIN_LOSSES)
    pairs = list(zip(full[LQ_SAVE_AT:], again))
    first, worst = worst_rel(pairs[:1]), worst_rel(pairs)
    print(f'[train] LQ bf16 resumed at {LQ_SAVE_AT}: iteration '
          f'{LQ_SAVE_AT + 1} within {first:.2e} relative of the '
          f'uninterrupted run (tol {RESUME_FIRST_RTOL}), iterations '
          f'{LQ_SAVE_AT + 1}-{LQ_ITERS} within {worst:.2e} (tol '
          f'{RESUME_BF16_RTOL})', flush=True)
    require(first <= RESUME_FIRST_RTOL and worst <= RESUME_BF16_RTOL,
            f'resumed bf16 losses off by {first} (first), {worst}')
    run['resume_first_rel_diff'] = first
    run['resume_worst_rel_diff'] = worst
    del resumed
    batch = first_batch(opt)
    run['g_step_kernels_vs_plain'] = g_step_kernels_vs_plain(model, batch,
                                                             G_STEP_BF16)
    run['timing'] = time_iterations(model, batch, reps=3)
    run['profile'] = profile_iteration(model, batch, 'LQ bf16',
                                       run['timing']['ms_per_iteration'])
    routes = run['profile']['conv3_routes_ms']
    require(routes and all('conv3_tc' in n for n in routes),
            f'LQ bf16: the prior\'s conv3 took {sorted(routes)}')
    out['lq_bf16'] = run
    del model
    torch.cuda.empty_cache()

    model, opt, _, run = precision_run(dev, work, inputs, vals, 'hq', f32)
    batch = first_batch(opt)
    run['timing'] = time_iterations(model, batch, reps=2)
    run['profile'] = profile_iteration(model, batch, 'HQ bf16',
                                       run['timing']['ms_per_iteration'])
    out['hq_bf16'] = run
    del model
    torch.cuda.empty_cache()

    for bf16 in (False, True):
        key = f'lq_{"bf16" if bf16 else "f32"}_checkpointed'
        out[key] = remat_run(dev, work, inputs, bf16)

    rows = (('LQ f32', f32['lq']), ('LQ bf16', out['lq_bf16']),
            ('LQ f32 use_checkpoint', out['lq_f32_checkpointed']),
            ('LQ bf16 use_checkpoint', out['lq_bf16_checkpointed']),
            ('HQ f32', f32['hq']), ('HQ bf16', out['hq_bf16']))
    for label, r in rows:
        t, prof = r['timing'], r['profile']
        print(f'[train] {label}, batch {t["gt_batch"][0]} at gt '
              f'{t["gt_batch"][-1]}: {t["ms_per_iteration"]:.1f} ms per '
              f'iteration, {t["images_per_s"]:.2f} images/s; peak '
              f'max_memory_allocated {r["peak_memory_bytes"] / 2**30:.2f} GiB '
              f'over the run, {t["iteration_peak_bytes"] / 2**30:.2f} GiB in '
              f'the timed iterations; device busy '
              f'{prof["device_busy_ms"]:.1f} ms, idle share '
              f'{prof["idle_share"]:.3f}', flush=True)
    return out


# -- phase 6: the BSRGAN data (A9) ---------------------------------------------

LQ_ONDEVICE_YML = 'options/train_FeMaSR_LQ_stage_ondevice.yml'
# the degradation alone: calls timed and profiled (each seed one draw), and
# DEGRADE_DRAWS draws held card against CPU: >= 99.9% of LQ pixels within
# 1e-4, and the pixels beyond it in at most 1% of the final JPEG's 16x16
# blocks. A near-tie of round(coeff / q) between two f32 summation orders
# moves a whole JPEG block: up to ~300 pixels, ~1% of one draw's 8 x 64^2
# LQ pixels, so the share is taken over 16 draws
# the runs' one cut of their train set: TRAIN_IMAGES x 4 samples make one
# epoch longer than either run (with the shipped ratio 1 the 16 seeded
# images end an epoch every 2 iterations, and the loader starts its 8
# workers anew each time)
BSRGAN_ENLARGE = 4
DEGRADE_SEEDS = tuple(range(100, 108))
DEGRADE_DRAWS, DEGRADE_STAGE_DRAWS = 16, 4
DEGRADE_AGREE, DEGRADE_TOL, DEGRADE_BLOCK_SHARE = 0.999, 1e-4, 0.01


@contextlib.contextmanager
def probe_iterations(dev, marks: list):
    """Every FeMaSRModel.optimize_parameters inside the block appends
    (entry, exit) host times, the exit after a synchronize: the loop's wall
    per iteration is the distance between exits, the step's own the
    distance from entry to exit, the rest the wait for the batch."""
    from femasr_torch.train import FeMaSRModel
    orig = FeMaSRModel.optimize_parameters

    def optimize_parameters(self, current_iter=None):
        t0 = time.perf_counter()
        orig(self, current_iter)
        sync(dev)
        marks.append((t0, time.perf_counter()))
    FeMaSRModel.optimize_parameters = optimize_parameters
    try:
        yield
    finally:
        FeMaSRModel.optimize_parameters = orig


def loop_times(marks: list) -> dict:
    """Per-iteration wall, step and wait (ms) of the loop after its first
    iteration (worker start-up and first-use costs); the wait holds the
    wait for the batch and the loop's logging and checkpoints, so the
    medians are the steady state."""
    exits = [b for _, b in marks]
    wall = [(b - a) * 1e3 for a, b in zip(exits, exits[1:])]
    step = [(b - a) * 1e3 for a, b in marks[1:]]
    wait = [w - s for w, s in zip(wall, step)]
    return dict(wall_ms=wall, step_ms=step, wait_ms=wait,
                median_wall_ms=float(np.median(wall)),
                median_wait_ms=float(np.median(wait)),
                median_wait_share=float(np.median(
                    [x / w for x, w in zip(wait, wall)])))


def bsrgan_run(dev, work: str, opt: dict, stage: str) -> tuple:
    """A run of train_cli with its train set as shipped: launches per
    iteration checked, finite losses, peak memory, the loop's times."""
    from femasr_torch import kernels
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    marks = []
    t0 = time.perf_counter()
    with probe_iterations(dev, marks):
        model, records = run_train_cli(work, opt)
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    iters = opt['train']['total_iter']
    require([r['iter'] for r in records] == list(range(1, iters + 1)),
            f'{opt["name"]} logged {[r["iter"] for r in records]}')
    check_losses(records, opt['name'])
    check_launches(counts, stage, iters)
    return model, records, dict(
        iterations=iters, seconds=seconds, launches=counts,
        peak_memory_bytes=torch.cuda.max_memory_allocated(dev),
        losses=records[-1], loop=loop_times(marks))


def degradation_alone(dev, gt: torch.Tensor, iteration_ms: float,
                      busy_ms: float) -> dict:
    """The on-device degradation of a warm GT batch: host ms (synchronized)
    and device ms (profiler) per call, launches per call, its share of the
    on-device LQ iteration, no synchronizing op in a warm call, and the
    card's LQ against the CPU's under the same draws."""
    from torch.profiler import ProfilerActivity, profile

    from femasr_torch.ops import degradations as D

    def gen(seed):
        return torch.Generator(dev).manual_seed(seed)

    def run_all():
        for seed in DEGRADE_SEEDS:
            D.degradation_bsrgan(gt, gen(seed), 4)
    run_all()                   # builds every matrix these draws use
    sync(dev)
    torch.cuda.set_sync_debug_mode('error')
    try:
        lq = D.degradation_bsrgan(gt, gen(DEGRADE_SEEDS[0]), 4)
    except RuntimeError as e:
        raise PhaseError(f'the degradation synchronized: {e}') from e
    finally:
        torch.cuda.set_sync_debug_mode(0)
    require(lq.shape == (gt.shape[0], 3, gt.shape[2] // 4, gt.shape[3] // 4)
            and bool(torch.isfinite(lq).all()), f'degradation LQ {lq.shape}')
    sync(dev)
    t0 = time.perf_counter()
    run_all()
    sync(dev)
    host_ms = (time.perf_counter() - t0) * 1e3 / len(DEGRADE_SEEDS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_all()
        sync(dev)
    kern = device_kernels(prof)
    device_ms = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / len(
        DEGRADE_SEEDS)
    launches = len(kern) / len(DEGRADE_SEEDS)

    # card against CPU, the same draws (kernels and noise fields handed in):
    # the whole pipeline, then stage by stage with the CPU fed the card's
    # input (only the JPEG stages may differ beyond 1e-4, in whole blocks)
    gt_cpu = gt.cpu()
    good = total = blocks = blocks_bad = 0
    worst = 0.0
    stage_worst, jpeg_touched, jpeg_blocks = {}, 0, 0
    for seed in range(DEGRADE_DRAWS):
        draws = D.draw_degradation(gen(seed), gt.shape, 4)
        card = D.apply_degradation(gt, draws, 4).cpu()
        ref = D.apply_degradation(gt_cpu, draws.to('cpu'), 4)
        diff = (card - ref).abs().amax(dim=1)       # per pixel (B, h, w)
        worst = max(worst, float(diff.max()))
        good += int((diff <= DEGRADE_TOL).sum())
        total += diff.numel()
        n, bad = jpeg_blocks_touched(diff)
        blocks += n
        blocks_bad += bad
        if seed >= DEGRADE_STAGE_DRAWS:
            continue
        x = gt
        for (name, on_card), (_, on_cpu) in zip(
                D.degradation_stages(draws, *gt.shape[-2:], 4),
                D.degradation_stages(draws.to('cpu'), *gt.shape[-2:], 4)):
            y = on_card(x)
            d = (y.cpu() - on_cpu(x.cpu())).abs().amax(dim=1)
            if 'jpeg' in name:
                n, bad = jpeg_blocks_touched(d)
                jpeg_blocks += n
                jpeg_touched += bad
            else:
                stage_worst[name] = max(stage_worst.get(name, 0.0),
                                        float(d.max()))
            x = y
    agree = good / total
    out = dict(gt_batch=list(gt.shape), calls=len(DEGRADE_SEEDS),
               host_ms=host_ms, device_ms=device_ms,
               launches_per_call=launches, share_of_iteration=host_ms
               / iteration_ms, device_share_of_busy=device_ms / busy_ms,
               sync_free=True, card_vs_cpu=dict(
                   draws=DEGRADE_DRAWS, pixels_within=agree,
                   max_abs_diff=worst, jpeg_blocks_touched=blocks_bad,
                   jpeg_blocks=blocks, stage_draws=DEGRADE_STAGE_DRAWS,
                   stage_max_abs_diff=stage_worst,
                   stage_jpeg_blocks_touched=jpeg_touched,
                   stage_jpeg_blocks=jpeg_blocks))
    print(f'[degrade] batch {list(gt.shape)} f32, {len(DEGRADE_SEEDS)} '
          f'warm calls: {host_ms:.3f} ms per call on the host clock '
          f'(synchronized), {device_ms:.3f} ms device time, {launches:.1f} '
          f'launches per call; {100 * host_ms / iteration_ms:.2f}% of the '
          f'on-device LQ iteration ({iteration_ms:.1f} ms), device '
          f'{100 * device_ms / busy_ms:.2f}% of its busy time; no '
          f'synchronizing op in a warm call (set_sync_debug_mode error)',
          flush=True)
    print(f'[degrade] card vs CPU, {DEGRADE_DRAWS} draws handed to both '
          f'(kernels and noise fields included): {100 * agree:.4f}% of LQ '
          f'pixels within {DEGRADE_TOL} (need {100 * DEGRADE_AGREE}%), max '
          f'{worst:.3e}; pixels beyond it in {blocks_bad} of {blocks} final '
          f'JPEG 16x16 blocks (at most {100 * DEGRADE_BLOCK_SHARE}%)',
          flush=True)
    print(f'[degrade] stage by stage, {DEGRADE_STAGE_DRAWS} draws, the CPU '
          f'fed the card\'s input: max abs diff '
          + ', '.join(f'{k} {v:.2e}' for k, v in stage_worst.items())
          + f' (tol {DEGRADE_TOL}); the JPEG stages differ beyond it in '
          f'{jpeg_touched} of {jpeg_blocks} 16x16 blocks', flush=True)
    require(agree >= DEGRADE_AGREE and blocks_bad <= DEGRADE_BLOCK_SHARE
            * blocks and max(stage_worst.values()) <= DEGRADE_TOL
            and jpeg_touched <= DEGRADE_BLOCK_SHARE * jpeg_blocks,
            f'degradation card vs CPU: {out["card_vs_cpu"]}')
    return out


def jpeg_blocks_touched(diff: torch.Tensor) -> tuple:
    """(16x16 blocks, blocks holding a pixel beyond DEGRADE_TOL) of a
    per-pixel difference (B, h, w), h and w multiples of 16."""
    b, h, w = diff.shape
    bad = (diff > DEGRADE_TOL).reshape(b, h // 16, 16, w // 16, 16)
    return b * (h // 16) * (w // 16), int(bad.any(dim=4).any(dim=2).sum())


def worker_pass(opt: dict) -> dict:
    """ms per item of the train set on the host, as a loader worker makes
    it (read, crop, the host BSRGAN degradation, flips), over one epoch."""
    from femasr_torch.data import build_dataset
    data = build_dataset(dict(opt['datasets']['train'], phase='train',
                              scale=opt['scale']))
    ms = []
    for pos in range(len(data)):
        t0 = time.perf_counter()
        data[(pos, (opt['manual_seed'], 0, pos))]
        ms.append((time.perf_counter() - t0) * 1e3)
    return dict(items=len(ms), median_ms=float(np.median(ms)),
                max_ms=float(np.max(ms)), ms=ms)


def bsrgan_phase(dev, work: str, inputs: dict, paired_ms: dict) -> dict:
    """The two training configurations that need the BSRGAN data, as
    shipped: the LQ stage with on-device degradation (8 iterations, resumed
    at 4), the degradation alone, and the HQ stage with the workers'
    host degradation (4 iterations). Their ms per iteration are printed
    beside `paired_ms`, the same stages' on the paired data."""
    from femasr_torch import kernels
    out = {}

    # LQ stage, on-device degradation, its BSRGANTrainDataset and workers
    opt = release_options(LQ_ONDEVICE_YML, 'smoke_lq_ondevice', inputs,
                          LQ_ITERS, LQ_SAVE_AT, as_shipped=True)
    opt['path'] = {'pretrain_network_hq': inputs['hq'],
                   'pretrain_lpips': inputs['lpips'], 'strict_load': False}
    data = opt['datasets']['train']
    require(data['type'] == 'BSRGANTrainDataset'
            and data['on_device_degradation'],
            f'{LQ_ONDEVICE_YML}: train set {data}')
    data['dataset_enlarge_ratio'] = BSRGAN_ENLARGE
    model, full, run = bsrgan_run(dev, work, opt, 'lq')
    require(model.degrade_on_device and model.cri_perceptual is not None
            and model.use_dis, 'on-device LQ stage: degradation, LPIPS or '
            'GAN loss off')
    state = os.path.join(work, 'experiments', opt['name'], 'training_states',
                         f'{LQ_SAVE_AT}.state')
    with counting_off(*kernels.MODULES.values()):
        resumed, again = run_train_cli(
            work, opt, '--force_yml', f'path:resume_state={state}')
    require([r['iter'] for r in again] == list(range(LQ_SAVE_AT + 1,
                                                     LQ_ITERS + 1)),
            f'resumed on-device run logged {[r["iter"] for r in again]}')
    worst = max(abs(a[k] - b[k]) / max(abs(a[k]), 1e-12)
                for a, b in zip(full[LQ_SAVE_AT:], again)
                for k in TRAIN_LOSSES)
    print(f'[train] on-device LQ stage resumed at {LQ_SAVE_AT}: iterations '
          f'{LQ_SAVE_AT + 1}-{LQ_ITERS} (their degradations replayed) within '
          f'{worst:.2e} relative of the uninterrupted run (tol '
          f'{RESUME_RTOL})', flush=True)
    require(worst <= RESUME_RTOL, f'resumed on-device losses off by {worst}')
    run['resume_worst_rel_diff'] = worst
    del resumed
    batch = first_batch(opt)
    require('lq' not in batch, 'on-device train set shipped an LQ')
    run['timing'] = time_iterations(model, batch, reps=3)
    run['profile'] = profile_iteration(
        model, batch, 'LQ on-device', run['timing']['ms_per_iteration'])
    run['degradation'] = degradation_alone(
        dev, batch['gt'].to(dev), run['timing']['ms_per_iteration'],
        run['profile']['device_busy_ms'])
    out['lq_ondevice'] = run
    del model
    torch.cuda.empty_cache()

    # HQ stage as shipped: BSRGANTrainDataset, its 8 workers degrading on
    # the host (the HQ stage trains on GT; the LQ is made and unused)
    opt = release_options(HQ_YML, 'smoke_hq_bsrgan', inputs, HQ_ITERS, 1e9,
                          as_shipped=True)
    opt['path'] = {'pretrain_network_g': inputs['hq'],
                   'pretrain_lpips': inputs['lpips'],
                   'pretrain_vgg': inputs['vgg19'], 'strict_load': False}
    data = opt['datasets']['train']
    require(data['type'] == 'BSRGANTrainDataset'
            and not data.get('on_device_degradation'),
            f'{HQ_YML}: train set {data}')
    data['dataset_enlarge_ratio'] = BSRGAN_ENLARGE
    model, _, run = bsrgan_run(dev, work, opt, 'hq')
    run['workers'] = int(data['num_worker_per_gpu'])
    batch = first_batch(opt)
    require(batch['lq'].shape[-1] * 4 == batch['gt'].shape[-1],
            f'HQ batch lq {batch["lq"].shape} gt {batch["gt"].shape}')
    run['timing'] = time_iterations(model, batch, reps=2)
    run['profile'] = profile_iteration(
        model, batch, 'HQ BSRGAN', run['timing']['ms_per_iteration'])
    run['host_items'] = worker_pass(opt)
    out['hq_bsrgan'] = run
    del model
    torch.cuda.empty_cache()

    for name, stage in (('lq_ondevice', 'lq'), ('hq_bsrgan', 'hq')):
        r = out[name]
        t, loop = r['timing'], r['loop']
        print(f'[train] {name}: {t["ms_per_iteration"]:.1f} ms per iteration '
              f'(model, host clock over {t["reps"]} synchronized warm '
              f'iterations; {stage.upper()} on paired data '
              f'{paired_ms[stage]:.1f} ms), '
              f'{t["images_per_s"]:.2f} images/s, idle share '
              f'{r["profile"]["idle_share"]:.3f}; the loop, median after '
              f'its first iteration: {loop["median_wall_ms"]:.1f} ms per '
              f'iteration, {loop["median_wait_ms"]:.1f} ms of it waiting '
              f'for the batch ({100 * loop["median_wait_share"]:.1f}%); '
              f'peak max_memory_allocated '
              f'{r["peak_memory_bytes"] / 2**30:.2f} GiB', flush=True)
    h = out['hq_bsrgan']['host_items']
    print(f'[train] hq_bsrgan: a train item on the host (read, crop, host '
          f'degradation, flips) median {h["median_ms"]:.1f} ms, max '
          f'{h["max_ms"]:.1f} ms over {h["items"]} items; '
          f'{out["hq_bsrgan"]["workers"]} workers', flush=True)
    return out


# -- phase 8: data parallelism (A11) -------------------------------------------

# (a) and (b) train DP_ITERS iterations; (a) then times DP_TIME_REPS warm
# iterations with and without DDP. Both compare runs under deterministic
# algorithms (cuDNN's deterministic convolutions, deterministic index_put
# and scatter; CUBLAS_WORKSPACE_CONFIG in the workers' environment): the
# card's bf16 and f32 backward passes are otherwise not bit for bit from
# one run to the next (see the bf16 resume gate), which would hide what DDP
# changes. The timing runs drop them again.
DP_ITERS, DP_TIME_REPS = 2, 4
DP_A_RTOL = 1e-6           # (a): DDP at world 1 against no launcher
# (b): world 2 x 4 against world 1 x 8 within DP_B_SPREADS times the
# spread between two world-1 runs (x 8, and x 8 in two chunks of 4: the
# per-rank batch), and never tighter than DP_B_FLOOR: both differences are
# rounding in other summation orders, one sample each (a CPU rehearsal at
# gt 64: parameters 2.1e-5 against a spread of 9.0e-6, in a bias). (b) trains with SGD (DP_B_OPTIM):
# Adam's first update lr * g / (|g| + eps) turns the rounding noise of a
# gradient whose true value is zero (the attention's key bias: softmax
# ignores a constant added to every key) into a step of full size, so two
# world-1 runs at other batch sizes differ by ~lr in such parameters and
# in every loss after the first update (a CPU rehearsal: 2.6e-2 of a
# tensor's largest value)
DP_B_FLOOR, DP_B_SPREADS = 1e-5, 4
DP_B_OPTIM = {'type': 'SGD', 'lr': 1e-2}
DP_SERVE_TOL = 1e-4         # (c): f32 outputs, mean abs diff of [0, 1]
DP_EVAL_RTOL = 1e-6         # (d): test_cli metrics at world 2 vs world 1
DP_TIMEOUT = 420
DP_ENV = {'CUBLAS_WORKSPACE_CONFIG': ':4096:8'}
DP_LOSSES = TRAIN_LOSSES + ('l_g_total', 'codebook_perplexity',
                            'out_d_real', 'out_d_fake')


def lq_train_options(inputs: dict, batch: int, iters: int,
                     bf16: bool = False, sgd: bool = False, **train) -> dict:
    """The LQ release config on the seeded folder at `batch` per rank for
    `iters` iterations, with SGD (DP_B_OPTIM) for parameter checks."""
    opt = release_options(LQ_YML, 'dp', inputs, iters, 1e9)
    opt['path'] = {'pretrain_network_hq': inputs['hq'],
                   'pretrain_lpips': inputs['lpips'], 'strict_load': False}
    opt['datasets']['train']['batch_size_per_gpu'] = batch
    opt['train'].update(train)
    if sgd:
        opt['train'].update(optim_g=dict(DP_B_OPTIM),
                            optim_d=dict(DP_B_OPTIM))
    return with_precision(opt, bf16)


def deterministic(on: bool) -> None:
    torch.use_deterministic_algorithms(on, warn_only=True)
    torch.backends.cudnn.deterministic = on


def rank_worker(plan_path: str) -> int:
    """One process of the dp phase (`chip_smoke.py --rank-worker plan`,
    under torchrun or alone): runs the plan's CLI jobs in order through
    their `main` (the modules `python -m femasr_torch.<cli>` runs), with
    the kernel counts zeroed just before each and read just after, and
    writes <out>.rank<r>.json."""
    import importlib

    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from femasr_torch import kernels
    from femasr_torch.parallel.dist_util import shutdown
    from femasr_torch.utils.misc import disable_tf32
    disable_tf32()
    with open(plan_path) as f:
        plan = json.load(f)
    rank = int(os.environ.get('RANK', 0))
    results = {}
    for job in plan['jobs']:
        deterministic(job['deterministic'])
        cwd = os.getcwd()
        os.chdir(job['cwd'])
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            with femasr_b2_routes(f"rank {rank} {job['name']}"):
                out = (tp_probe(job) if job['module'] == 'probe' else
                       importlib.import_module(job['module']).main(
                           job['argv']))
        finally:
            os.chdir(cwd)
        dev = (torch.device('cuda', torch.cuda.current_device())
               if torch.cuda.is_available() else torch.device('cpu'))
        sync(dev)
        r = dict(launches=kernels.launch_counts(),
                 seconds=time.perf_counter() - t0, device=str(dev),
                 backend=dist.get_backend() if dist.is_initialized()
                 else None,
                 peak_memory_bytes=(torch.cuda.max_memory_allocated()
                                    if dev.type == 'cuda' else None))
        if job['module'] == 'probe':
            r['probe'] = out
        elif job['module'].endswith('test_cli'):
            r['metrics'] = dict(out.metric_results)
        elif job['module'].endswith('train_cli'):
            r['ddp'] = type(out.net_g_train).__name__
            r['device'] = str(out.device)
            # tensor parallelism: the rank's split tensors, the bytes of
            # its net_g, and a digest of every tensor it holds whole
            r['split'] = len(out.layout_g)
            r['param_bytes_g'] = sum(p.numel() * p.element_size()
                                     for p in out.net_g.parameters())
            whole = {f'{net}.{k}': v.detach().cpu().contiguous()
                     for net, m in (('net_g', out.net_g),
                                    ('net_d', out.net_d))
                     for k, v in m.state_dict().items()
                     if net == 'net_d' or k not in out.layout_g}
            r['whole_digests'] = {k: hashlib.sha1(v.numpy().tobytes())
                                  .hexdigest() for k, v in whole.items()}
            r['whole_sums'] = {k: v.double().sum().item()
                               for k, v in whole.items()}
            if job.get('timing'):
                deterministic(False)
                with open(job['opt']) as f:
                    batch = first_batch(json.load(f))
                r['timing'] = time_iterations(out, batch, job['timing'])
                r['profile'] = profile_iteration(
                    out, batch, f"dp {job['name']} rank {rank}",
                    r['timing']['ms_per_iteration'])
        else:
            r['stats'] = out
        results[job['name']] = r
        del out
        gc.collect()
        torch.cuda.empty_cache()
    with open(f"{plan['out']}.rank{rank}.json", 'w') as f:
        json.dump(results, f)
    shutdown()
    return 0


def launch_ranks(work: str, name: str, jobs: list, nproc: int,
                 card: str) -> list:
    """The jobs in `nproc` ranks under torchrun (0: one process without a
    launcher), each rank `chip_smoke.py --rank-worker`; the process group
    is killed whole at DP_TIMEOUT. Returns the ranks' results."""
    import signal
    import socket
    plan = os.path.join(work, f'{name}.plan.json')
    with open(plan, 'w') as f:
        json.dump({'jobs': jobs, 'out': os.path.join(work, name)}, f)
    me = [os.path.abspath(__file__), '--rank-worker', plan]
    if nproc:
        with socket.socket() as s:
            s.bind(('127.0.0.1', 0))
            port = s.getsockname()[1]
        cmd = [sys.executable, '-m', 'torch.distributed.run',
               '--nproc_per_node', str(nproc), '--master_addr', '127.0.0.1',
               '--master_port', str(port), *me]
    else:
        cmd = [sys.executable, *me]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=dict(os.environ, **DP_ENV),
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=DP_TIMEOUT)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    seconds = time.perf_counter() - t0
    with open(os.path.join(work, f'{name}.log'), 'w') as f:
        f.write(log)
    for line in log.splitlines():
        if line.startswith('[train] dp '):
            print(f'{line} | {card}', flush=True)
        elif line.startswith('[train] '):
            print(line, flush=True)
    if proc.returncode != 0:
        print(log[-6000:], flush=True)
    require(proc.returncode == 0, f'dp {name}: exit code {proc.returncode}')
    print(f'[dp] {name}: {max(nproc, 1)} process(es) in {seconds:.1f} s '
          f'(start, model builds and runs) | {card}', flush=True)
    return [json.load(open(os.path.join(work, f'{name}.rank{r}.json')))
            for r in range(max(nproc, 1))]


def read_run(work: str, exp: str, at: str = 'latest') -> tuple:
    """A training run's log records and its saved networks (latest, or as
    saved at iteration `at`, with the records up to it)."""
    root = os.path.join(work, 'experiments', exp)
    with open(os.path.join(root, 'train_log.jsonl')) as f:
        records = [json.loads(line) for line in f]
    if at != 'latest':
        records = [r for r in records if r['iter'] <= int(at)]
    nets = {k: torch.load(os.path.join(root, 'models', f'{k}_{at}.pth'),
                          weights_only=True)['params']
            for k in ('net_g', 'net_d')}
    return records, nets


def run_diff(a: tuple, b: tuple) -> dict:
    """Worst relative differences of two runs: logged losses, and every
    tensor of both networks against its largest value; equal: bit for
    bit."""
    (ra, na), (rb, nb) = a, b
    require([r['iter'] for r in ra] == [r['iter'] for r in rb],
            'the runs logged other iterations')
    losses = max(abs(x[k] - y[k]) / max(abs(x[k]), 1e-12)
                 for x, y in zip(ra, rb) for k in DP_LOSSES if k in x)
    params, worst = 0.0, None
    equal = all(x[k] == y[k] for x, y in zip(ra, rb) for k in DP_LOSSES
                if k in x)
    for net in na:
        for k, t in na[net].items():
            u = nb[net][k]
            equal = equal and torch.equal(t, u)
            d = ((t.double() - u.double()).abs().max()
                 / t.double().abs().max().clamp_min(1e-12)).item()
            if d > params:
                params, worst = d, f'{net}.{k}'
    return dict(losses_rel=losses, params_rel=params, worst_tensor=worst,
                bit_for_bit=equal)


def dp_launches(dp: dict, name: str) -> dict:
    """A kernel's launches per rank in the dp phase's runs."""
    return dict(
        a_nccl_world1_per_iteration=dp['a']['ddp']['launches'][name]
        / DP_ITERS,
        b_world2_per_rank_per_iteration=[
            r['launches'][name] / DP_ITERS for r in dp['b']['ranks']],
        c_serving_world2_per_rank=[
            r[name] for r in dp['c']['launches_per_rank']],
        d_evaluation_world2_per_rank=[
            r[name] for r in dp['d']['launches_per_rank']])


def degradation_by_batch(dev, batches=(8, 16)) -> dict:
    """Host ms (synchronized) and device ms (profiler) of one on-device
    degradation call per GT batch size at gt 256, over DEGRADE_SEEDS: at
    world W every rank degrades the global batch W x B."""
    from torch.profiler import ProfilerActivity, profile

    from femasr_torch.ops import degradations as D
    out = {}
    for b in batches:
        gt = torch.rand((b, 3, TRAIN_GT, TRAIN_GT),
                        generator=torch.Generator().manual_seed(b)).to(dev)

        def run_all():
            for seed in DEGRADE_SEEDS:
                D.degradation_bsrgan(gt, torch.Generator(dev).manual_seed(
                    seed), 4)
        run_all()
        sync(dev)
        t0 = time.perf_counter()
        run_all()
        sync(dev)
        host = (time.perf_counter() - t0) * 1e3 / len(DEGRADE_SEEDS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run_all()
            sync(dev)
        device = sum(e.time_range.elapsed_us() for e in device_kernels(
            prof)) / 1e3 / len(DEGRADE_SEEDS)
        out[b] = dict(host_ms=host, device_ms=device)
    return out


def dp_arrangement(dev, n: int = 2) -> dict:
    """n ranks: NCCL on n cards, or, on fewer cards, gloo with every rank
    on cuda:0 (NCCL refuses two ranks on one device). The choice is this
    script's; the package takes what it is given. (On the CPU, for a
    rehearsal: gloo.)"""
    words = {2: 'two', 4: 'four'}[n]
    if dev.type == 'cpu':
        return dict(name='gloo on the CPU', device='cpu', argv=[],
                    backend='gloo')
    if torch.cuda.device_count() >= n:
        return dict(name=f'NCCL on {words} cards', device='cuda', argv=[],
                    backend=None)
    return dict(name=f'gloo, {words} ranks sharing cuda:0', device='cuda:0',
                argv=['--dist_backend', 'gloo'], backend='gloo')


def dp_phase(dev, work: str, inputs: dict, vals: dict) -> dict:
    """Data parallelism (A11) through the CLIs: (a) bf16 LQ training under
    torchrun at world 1 (NCCL, DDP) against the same run without a
    launcher; (b) f32 LQ training at world 2 x 4 against world 1 x 8; (c)
    inference_cli --dp 2 against one process; (d) test_cli at world 2
    against world 1. Launches per rank of every run."""
    import cv2
    card = gpu_line()
    work = os.path.join(work, 'dp')
    os.makedirs(work)
    arr = dp_arrangement(dev)
    base = dev.type         # 'cuda': rank r on cuda:LOCAL_RANK
    launcher = ['--launcher', 'pytorch']
    net, pth, in_dir, sizes = serving_inputs(work)
    del net
    out = {'arrangement': arr['name'], 'card': card}

    def train_job(name, opt, argv=(), timing=0, device=base):
        opt = dict(opt, name=name, device=device)
        path = os.path.join(work, f'{name}.json')
        with open(path, 'w') as f:
            json.dump(opt, f)
        return dict(name=name, module='femasr_torch.train_cli', cwd=work,
                    argv=['-opt', path, *argv], deterministic=True,
                    timing=timing, opt=path)

    def lq_opt(batch, bf16=False, sgd=False, **train):
        return lq_train_options(inputs, batch, DP_ITERS, bf16, sgd, **train)

    def serve_job(name, device, *argv):
        return dict(name=name, module='femasr_torch.inference_cli', cwd=work,
                    deterministic=False, argv=[
                        '-i', in_dir, '-w', pth, '-o',
                        os.path.join(work, name), '-s', '4', '--precision',
                        'f32', '--device', device, *argv])

    test_opt = load_yml(TEST_YML)
    test_opt['datasets']['test_1'].update(
        dataroot_gt=os.path.join(vals['lq'], 'gt'),
        dataroot_lq=os.path.join(vals['lq'], 'lq'))
    test_opt['path'].update(pretrain_network_g=pth,
                            pretrain_lpips=inputs['lpips'])

    def eval_job(name, device, *argv):
        path = os.path.join(work, f'{name}.json')
        with open(path, 'w') as f:
            json.dump(dict(test_opt, name=name, device=device), f)
        return dict(name=name, module='femasr_torch.test_cli', cwd=work,
                    deterministic=False, argv=['-opt', path, *argv])

    torch.cuda.empty_cache()
    one = launch_ranks(work, 'world1', [
        train_job('a_bare', lq_opt(8, bf16=True), timing=DP_TIME_REPS),
        train_job('b_w1', lq_opt(8, sgd=True)),
        train_job('b_w1_chunks', lq_opt(8, sgd=True, grad_accum_chunks=2)),
        serve_job('c_w1', base), eval_job('d_w1', base)], 0, card)[0]
    ddp = launch_ranks(work, 'nccl1', [train_job(
        'a_ddp', lq_opt(8, bf16=True), launcher, DP_TIME_REPS)], 1,
        card)[0]
    two = launch_ranks(work, 'world2', [
        train_job('b_w2', lq_opt(4, sgd=True), launcher + arr['argv'],
                  device=arr['device']),
        serve_job('c_w2', arr['device'], '--dp', '2', *launcher,
                  *arr['argv']),
        eval_job('d_w2', arr['device'], *launcher, *arr['argv'])], 2, card)

    # (a) NCCL at world 1
    a = run_diff(read_run(work, 'a_bare'), read_run(work, 'a_ddp'))
    require(ddp['a_ddp']['ddp'] == 'DistributedDataParallel'
            and ddp['a_ddp']['backend'] == ('nccl' if base == 'cuda'
                                             else 'gloo')
            and one['a_bare']['ddp'] == 'FeMaSRNet',
            f"(a) ran {ddp['a_ddp']['ddp']} on {ddp['a_ddp']['backend']}")
    for r in (one['a_bare'], ddp['a_ddp']):
        want = {k: TRAIN_LAUNCHES['lq_bf16'].get(k, 0) * DP_ITERS
                for k in r['launches']}
        require(r['launches'] == want, f"(a) launches {r['launches']}, "
                                       f'expected {want}')
    print(f'[dp] (a) bf16 LQ, batch 8, {DP_ITERS} iterations, torchrun '
          f'--nproc_per_node 1 --launcher pytorch (NCCL, DDP) vs no '
          f"launcher: bit for bit {a['bit_for_bit']}; losses within "
          f"{a['losses_rel']:.2e}, parameters within {a['params_rel']:.2e} "
          f"relative (tol {DP_A_RTOL}); launches per rank "
          f"{ddp['a_ddp']['launches']}", flush=True)
    require(max(a['losses_rel'], a['params_rel']) <= DP_A_RTOL,
            f'(a) DDP at world 1 off by {a}')
    for label, r in (('no launcher', one['a_bare']),
                     ('DDP at world 1', ddp['a_ddp'])):
        t, prof = r['timing'], r['profile']
        print(f'[dp] (a) bf16 LQ, batch 8 at gt 256, {label}: '
              f"{t['ms_per_iteration']:.1f} ms per iteration over "
              f"{t['reps']} warm iterations, idle share "
              f"{prof['idle_share_union']:.3f} (the device busy "
              f"{prof['device_union_ms']:.1f} ms: the union of its "
              f"kernels; their sum {prof['device_busy_ms']:.1f} ms) | "
              f'{card}', flush=True)
    out['a'] = dict(diff=a, bare=one['a_bare'], ddp=ddp['a_ddp'])

    # (b) two ranks against one process at the global batch
    w1 = read_run(work, 'b_w1')
    spread = run_diff(w1, read_run(work, 'b_w1_chunks'))
    b = run_diff(w1, read_run(work, 'b_w2'))
    bound = {k: max(DP_B_SPREADS * spread[k], DP_B_FLOOR)
             for k in ('losses_rel', 'params_rel')}
    ranks = two[0]['b_w2'], two[1]['b_w2']
    for r in ranks:
        want = {k: TRAIN_LAUNCHES['lq'].get(k, 0) * DP_ITERS
                for k in r['launches']}
        require(r['ddp'] == 'DistributedDataParallel'
                and r['launches'] == want,
                f"(b) rank ran {r['ddp']}, launches {r['launches']}")
    print(f"[dp] (b) f32 LQ (SGD), {arr['name']}: world 2 x batch 4 vs world 1 x "
          f"batch 8 after {DP_ITERS} iterations: losses {b['losses_rel']:.2e}"
          f" (bound {bound['losses_rel']:.2e}), parameters "
          f"{b['params_rel']:.2e} (bound {bound['params_rel']:.2e}, worst "
          f"{b['worst_tensor']}); the spread of two world-1 runs (batch 8, "
          f"and batch 8 in two chunks of 4): losses {spread['losses_rel']:.2e}"
          f", parameters {spread['params_rel']:.2e} ({spread['worst_tensor']}"
          f"); launches per rank {[r['launches'] for r in ranks]}",
          flush=True)
    require(b['losses_rel'] <= bound['losses_rel']
            and b['params_rel'] <= bound['params_rel'],
            f'(b) world 2 off world 1 by {b}, bound {bound}')
    out['b'] = dict(diff=b, spread=spread, bound=bound,
                    ranks=[dict(launches=r['launches'], device=r['device'],
                                backend=r['backend']) for r in ranks])

    # (c) data-parallel serving
    worst = {}
    for name in sizes:
        x = cv2.imread(os.path.join(work, 'c_w1', name)).astype(np.float64)
        y = cv2.imread(os.path.join(work, 'c_w2', name)).astype(np.float64)
        worst[name] = dict(max_levels=float(np.abs(x - y).max()),
                           mean_abs=float(np.abs(x - y).mean() / 255))
    # forwards per rank: the whole image (batch 1 padded to 2) and the
    # tiles, one per rank per forward
    tiles = (-(-sizes['tiled.png'] // 240)) ** 2
    fwd = 1 + (tiles + 1) // 2
    want = {k: v * fwd for k, v in VAL_LAUNCHES['lq'].items()}
    serve_counts = [two[r]['c_w2']['launches'] for r in (0, 1)]
    print(f'[dp] (c) inference_cli --dp 2 (f32, {arr["name"]}) vs one '
          f'process: {worst} (tol mean {DP_SERVE_TOL}, max 1 level); '
          f'launches per rank {serve_counts} (one process '
          f"{one['c_w1']['launches']}); wall {two[0]['c_w2']['seconds']:.1f} "
          f"s vs {one['c_w1']['seconds']:.1f} s: a correctness run, not a "
          f'scaling number | {card}', flush=True)
    for r in serve_counts:
        require(all(r.get(k, 0) == v for k, v in want.items()),
                f'(c) launches per rank {r}, expected {want}')
    require(all(w['mean_abs'] <= DP_SERVE_TOL and w['max_levels'] <= 1
                for w in worst.values()), f'(c) outputs differ: {worst}')
    out['c'] = dict(diff=worst, launches_per_rank=serve_counts,
                    world1_launches=one['c_w1']['launches'])

    # (d) evaluation
    m1 = one['d_w1']['metrics']
    d_counts = [two[r]['d_w2']['launches'] for r in (0, 1)]
    diffs = []
    for r in (0, 1):
        m2 = two[r]['d_w2']['metrics']
        require(sorted(m2) == sorted(m1), f'(d) metrics {sorted(m2)}')
        diffs.append({k: abs(m2[k] - m1[k]) / max(abs(m1[k]), 1e-12)
                      for k in m1})
    print(f'[dp] (d) test_cli --launcher pytorch at world 2 ({arr["name"]}) '
          f'vs one process: {m1}; relative differences per rank {diffs} '
          f'(tol {DP_EVAL_RTOL}); launches per rank {d_counts}', flush=True)
    require(all(v <= DP_EVAL_RTOL for d in diffs for v in d.values()),
            f'(d) metrics differ: {diffs}')
    for r in d_counts:
        want = {k: VAL_LAUNCHES['lq'].get(k, 0) for k in r}
        require(r == want, f'(d) launches per rank {r}, expected {want}')
    out['d'] = dict(metrics=m1, rel_diff=diffs, launches_per_rank=d_counts)

    if dev.type == 'cuda':
        deg = degradation_by_batch(dev)
        print('[dp] the on-device degradation per call (each rank degrades '
              'the global batch): ' + ', '.join(
                  f"batch {b}: host {v['host_ms']:.2f} ms, device "
                  f"{v['device_ms']:.2f} ms" for b, v in deg.items())
              + f' | {card}', flush=True)
        out['degradation_by_global_batch'] = deg
    return out


# -- phase 9: tensor parallelism (A11b) ----------------------------------------

TP = 2
TP_ITERS, TP_BATCH = 2, 4
TP_SERVE_RTOL = 2e-5    # (a) f32 float lane vs one process, of the max
# the whole-image probes: (name, lane, dtype, through the plain versions)
TP_RUNS = (('f32', 'float', 'float32', False),
           ('bf16', 'float', 'bfloat16', False),
           ('int8', 'int8', 'bfloat16', False))


def check_tp_kernels(dev, results) -> None:
    """(b) The kernels at the shapes a tp=2 rank gives them on the main
    path: B3 on 512 of the 1024 codes, the two shards' (distance, index)
    pairs reduced by B3's rule equal to the whole search bit for bit; B2
    on 4 of the 8 heads (C = 128) in bf16 with the shift mask, against
    its plain version. Times, bounds and library times of both."""
    from femasr_torch.kernels import vq_argmin as vq
    from femasr_torch.kernels import window_attention as wa
    from femasr_torch.kernels.tolerance import bf16_agreement
    from femasr_torch.ops.swin import shifted_window_mask
    from femasr_torch.parallel.tensor_parallel import first_minimum
    g = torch.Generator(device=dev).manual_seed(3)
    n, k, c = 69696, 1024, 512
    z = torch.randn((n, c), generator=g, device=dev)
    cb = torch.randn((k, c), generator=g, device=dev)
    half = k // TP
    with counting_off(vq):
        whole = vq.vq_argmin(z, cb)
        parts = [vq.vq_argmin(z, cb[r * half:(r + 1) * half], with_dist=True)
                 for r in range(TP)]
        split = first_minimum([d for _, d in parts],
                              [i.long() + r * half
                               for r, (i, _) in enumerate(parts)])
        sync(dev)
        shard = cb[:half].contiguous()
        ms = time_ms(lambda: vq.vq_argmin(z, shard, with_dist=True))
    plain_ms = time_ms(lambda: vq.vq_argmin_plain(z, shard, with_dist=True))
    lib_ms = time_ms(lambda: torch.cdist(z, shard).min(1))
    bms, by = bound_ms(nbytes(z, shard, parts[0][0], parts[0][1]),
                       2.0 * n * half * c + 2.0 * half * c, torch.float32)
    equal = torch.equal(split.to(torch.int32), whole)
    print(f'[tp] (b) vq_argmin split over {TP} ranks ({half} codes each): '
          f'the reduced (distance, index) pairs equal the whole search bit '
          f'for bit {equal} ({(split.to(torch.int32) != whole).sum().item()}'
          f' differ); one shard with its distance ms={ms:.4f} '
          f'plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} (cdist().min) '
          f'bound_ms={bms:.4f} ({by})', flush=True)
    require(equal, 'vq_argmin: the split search differs from the whole one')
    results['vq_argmin']['tp_shard'] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
        bound_by=by, split_equals_whole=equal,
        shape=f'z ({n},{c}) x codebook ({half},{c}), distance out')

    b_, nt, nh, hd = 1089, 64, 8 // TP, 32
    ch = nh * hd
    qkv = torch.randn((b_, nt, 3 * ch), generator=g,
                      device=dev).to(torch.bfloat16)
    q = qkv[..., :ch] * torch.tensor(hd ** -0.5, dtype=torch.bfloat16)
    kk, v = qkv[..., ch:2 * ch], qkv[..., 2 * ch:]
    bias = torch.randn((nh, nt, nt), generator=g, device=dev) * 0.02
    mask = torch.from_numpy(shifted_window_mask(264, 264, 8, 4)).to(dev)
    with counting_off(wa):
        y = wa.window_attention(q, kk, v, bias, mask, nh)
        ref = wa.window_attention_plain(q, kk, v, bias, mask, nh)
        ok, err, beyond = bf16_agreement(
            y, ref, 2.0 ** -8 * v.float().abs().max().item())
        ms = time_ms(lambda: wa.window_attention(q, kk, v, bias, mask, nh))
    plain_ms = time_ms(lambda: wa.window_attention_plain(q, kk, v, bias,
                                                         mask, nh))
    heads = [t.reshape(b_, nt, nh, hd).transpose(1, 2) for t in (q, kk, v)]
    am = (bias[None] + mask[:, None]).to(torch.bfloat16).expand(
        b_, nh, nt, nt)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *heads, attn_mask=am, scale=1.0))
    bms, by = bound_ms(nbytes(q, kk, v, y, bias, mask),
                       4.0 * b_ * nh * nt * nt * hd, torch.bfloat16)
    print(f'[tp] (b) window_attention on {nh} heads (C={ch}), bf16, mask: '
          f'max_abs_err={err:.3e} ({beyond:.2e} of outputs beyond one ulp) '
          f'ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} '
          f'bound_ms={bms:.4f} ({by})', flush=True)
    require(ok, f'window_attention on {nh} heads disagrees with plain '
                f'({err})')
    results['window_attention']['tp_shard'] = dict(
        ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
        bound_by=by, max_abs_err=err, share_beyond_one_ulp=beyond,
        shape=f'q,k,v ({b_},{nt},{ch}), {nh} heads, mask ({b_},{nt},{nt})')


def tp_probe(job: dict) -> dict:
    """A probe job of the tp phase (in a rank under torchrun, or alone):
    the whole image's forward through SRInferencer on the job's mesh, the
    state dict loaded strictly, for each of job['runs'] (name, lane,
    dtype, plain); the outputs and indices (with 'tokens', the f32 run's
    quantizer input too) saved to <out>.rank<r>.pt. Its launches are
    comparisons: they do not count."""
    import cv2

    from femasr_torch import kernels
    from femasr_torch.models import SRInferencer
    from femasr_torch.models.convert import load_torch_checkpoint
    from femasr_torch.models.inference import flip_pad
    from femasr_torch.parallel import create_mesh, init_dist
    dev, mesh = torch.device(job['device']), None
    if 'RANK' in os.environ:
        dev = init_dist('pytorch', job['backend'], job['device'])
        mesh = create_mesh(model=job['tp'], device_type=dev.type)
    sd = load_torch_checkpoint(job['weights'])
    img = cv2.cvtColor(cv2.imread(job['image']), cv2.COLOR_BGR2RGB)
    img = img.astype(np.float32) / 255.0
    side = img.shape[0]
    saved = {}
    for name, lane, dtype, plain in job['runs']:
        dt = getattr(torch, dtype)
        sr = SRInferencer(sd, device=dev, dtype=dt, mesh=mesh, strict=True,
                          codebook_params=job['codebook'], **LANES[lane][1])
        x = torch.from_numpy(img.transpose(2, 0, 1).copy())[None].to(dev)
        pad = (side // sr.wsz + 1) * sr.wsz - side
        xp = flip_pad(x, pad, pad).to(dt)
        tokens = {}
        hook = sr.model.before_quant_group[0].register_forward_hook(
            lambda m, i, o: tokens.update(z=o))
        with torch.inference_mode(), \
                counting_off(*kernels.MODULES.values()), \
                plain_kernels() if plain else contextlib.nullcontext():
            out, _, _, idx = sr.model(xp)
        hook.remove()
        rec = dict(out=out.float().clamp(0, 1)[:, :, :4 * side, :4 * side]
                   .cpu(), idx=idx[0].cpu())
        if job.get('tokens') and name == 'f32':
            z = tokens['z']
            rec['z'] = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1]).float(
            ).cpu()
        saved[name] = rec
        del sr, out, tokens
    path = f"{job['out']}.rank{int(os.environ.get('RANK', 0))}.pt"
    torch.save(saved, path)
    return {'path': path}


def tp_f32_serving(ref: dict, got: dict, cb: torch.Tensor) -> dict:
    """(a), (d): a split f32 float-lane forward against one process's:
    indices equal but where B3's near-tie rule certifies a tie; the output
    within TP_SERVE_RTOL of its max when every index agrees, else within
    DP_SERVE_TOL on average (a flipped code moves its neighbourhood)."""
    agree, gap = near_ties(ref['z'], cb, got['idx'], ref['idx'])
    diff = (got['out'] - ref['out']).abs()
    rel = (diff.max() / ref['out'].abs().max()).item()
    ok = agree >= 0.9999 and gap <= 1e-5 and (
        rel <= TP_SERVE_RTOL if agree == 1.0
        else diff.mean().item() <= DP_SERVE_TOL)
    return dict(index_agreement=agree, worst_gap=gap, max_rel=rel,
                mean_abs=diff.mean().item(), ok=ok)


def tp_phase(dev, work: str, inputs: dict) -> dict:
    """Tensor parallelism (A11b) through the CLIs at tp=2 (`--tp 2`,
    `model_parallel: 2`) against one process: (a) serving, the float lane
    in f32 and bf16 and the int8 lane, through inference_cli and
    whole-image probes; (c) LQ training (f32, SGD) at tp=2 and at dp=2 x
    tp=2 against world 1, the HQ stage at tp=2; (d) a resume at tp=2 and
    the tp=2 .pth served at tp=1; (e) launches per rank. (b) is
    `check_tp_kernels`."""
    import cv2

    from femasr_torch.models.convert import load_torch_checkpoint
    card = gpu_line()
    work = os.path.join(work, 'tp')
    os.makedirs(work)
    arr, arr4 = dp_arrangement(dev, 2), dp_arrangement(dev, 4)
    base = dev.type
    launcher = ['--launcher', 'pytorch']
    _, pth, in_dir, sizes = serving_inputs(work)
    out = {'arrangement': arr['name'], 'arrangement_dp2_tp2': arr4['name'],
           'card': card}

    def train_job(name, opt, argv=(), device=base):
        opt = dict(opt, name=name, device=device)
        path = os.path.join(work, f'{name}.json')
        with open(path, 'w') as f:
            json.dump(opt, f)
        return dict(name=name, module='femasr_torch.train_cli', cwd=work,
                    argv=['-opt', path, *argv], deterministic=True,
                    timing=0, opt=path)

    def lq(batch, iters=TP_ITERS, split=False, resume=None, **train):
        """f32 SGD, a checkpoint every iteration; split: model_parallel."""
        opt = lq_train_options(inputs, batch, iters, sgd=True, **train)
        opt['logger']['save_checkpoint_freq'] = 1
        if split:
            opt['model_parallel'] = TP
        if resume:
            opt['path']['resume_state'] = resume
        return opt

    hq = release_options(HQ_YML, 'tp_hq', inputs, 1, 1e9)
    hq['path'] = {'pretrain_network_g': inputs['hq'],
                  'pretrain_lpips': inputs['lpips'],
                  'pretrain_vgg': inputs['vgg19'], 'strict_load': False}
    hq['datasets']['train']['batch_size_per_gpu'] = TP_BATCH

    def serve_job(name, lane, device, precision, *argv):
        return dict(name=name, module='femasr_torch.inference_cli', cwd=work,
                    deterministic=False, argv=[
                        '-i', in_dir, '-w', pth, '-o',
                        os.path.join(work, name), '-s', '4', '--precision',
                        precision, '--device', device, '--strict_load',
                        *LANES[lane][0], *argv])

    def probe_job(name, device, runs, weights=pth,
                  codebook=((32, 1024, 512),), **kw):
        return dict(name=name, module='probe', cwd=work, deterministic=False,
                    device=device, weights=weights, runs=runs,
                    codebook=codebook, image=os.path.join(in_dir, 'whole.png'),
                    out=os.path.join(work, name), **kw)

    split = dict(tp=TP, backend=arr['backend'])
    tp_args = ['--dp', '1', '--tp', str(TP), *launcher, *arr['argv']]
    tp_pth = os.path.join(work, 'experiments', 'tp_lq', 'models',
                          'net_g_latest.pth')
    state = os.path.join(work, 'experiments', 'tp_lq', 'training_states',
                         '1.state')
    trained = lq(TP_BATCH)['network_g']['codebook_params']
    torch.cuda.empty_cache()
    # tp_warm first: a process keeps the cuDNN plan it first chose for a
    # convolution, and chooses among plans by its cached free memory, so
    # the uninterrupted and the resumed run that follow reuse one plan set
    two = launch_ranks(work, 'tp2', [
        train_job('tp_warm', lq(TP_BATCH, iters=1, split=True),
                  launcher + arr['argv'], arr['device']),
        train_job('tp_lq', lq(TP_BATCH, split=True), launcher + arr['argv'],
                  arr['device']),
        train_job('tp_lq_again', lq(TP_BATCH, split=True, resume=state),
                  launcher + arr['argv'], arr['device']),
        train_job('tp_hq', dict(hq, model_parallel=TP),
                  launcher + arr['argv'], arr['device']),
        serve_job('tp_float', 'float', arr['device'], 'f32', *tp_args),
        serve_job('tp_int8', 'int8', arr['device'], 'bf16', *tp_args),
        probe_job('tp_probe', arr['device'], TP_RUNS, **split),
        probe_job('tp_probe_pth', arr['device'], TP_RUNS[:1], tp_pth,
                  trained, **split)], TP, card)
    one = launch_ranks(work, 'tp1', [
        train_job('w1_lq', lq(TP_BATCH)),
        train_job('w1_lq_chunks', lq(TP_BATCH, grad_accum_chunks=2)),
        serve_job('w1_float', 'float', base, 'f32'),
        serve_job('w1_int8', 'int8', base, 'bf16'),
        probe_job('w1_probe', base, TP_RUNS + (
            ('f32_plain', 'float', 'float32', True),), tokens=True),
        probe_job('w1_probe_pth', base, TP_RUNS[:1], tp_pth, trained,
                  tokens=True)], 0, card)[0]
    four = launch_ranks(work, 'tp4', [train_job(
        'tp4_lq', lq(TP_BATCH // 2, iters=1, split=True),
        launcher + arr4['argv'], arr4['device'])], 2 * TP, card)

    # (a) serving
    cb = load_torch_checkpoint(pth)['quantize_group.0.embedding.weight']
    ref = torch.load(one['w1_probe']['probe']['path'])
    got = [torch.load(two[r]['tp_probe']['probe']['path'])
           for r in range(TP)]
    psnr1 = psnr_db(ref['bf16']['out'], ref['f32_plain']['out'])
    a = []
    for r, g in enumerate(got):
        f32 = tp_f32_serving(ref['f32'], g['f32'], cb)
        bf16 = dict(psnr_db=psnr_db(g['bf16']['out'], ref['f32_plain']['out']),
                    psnr_tp1_db=psnr1)
        int8 = dict(bit_for_bit=torch.equal(g['int8']['out'],
                                            ref['int8']['out'])
                    and torch.equal(g['int8']['idx'], ref['int8']['idx']))
        a.append(dict(f32=f32, bf16=bf16, int8=int8, ranks_equal=all(
            torch.equal(g[k]['out'], got[0][k]['out']) for k in g)))
        print(f'[tp] (a) rank {r}, 512px whole image, tp={TP} vs one '
              f'process: float f32 index agreement '
              f"{f32['index_agreement']:.6f} (worst gap {f32['worst_gap']:.2e}"
              f"), output max {f32['max_rel']:.3e} of its max (tol "
              f"{TP_SERVE_RTOL}), mean {f32['mean_abs']:.3e}; float bf16 "
              f"PSNR vs the f32 plain output {bf16['psnr_db']:.3f} dB (tp=1 "
              f'{psnr1:.3f}, slack {BF16_PSNR_SLACK_DB}); int8 lane bit for '
              f"bit {int8['bit_for_bit']}; ranks equal "
              f"{a[-1]['ranks_equal']}", flush=True)
        require(f32['ok'], f'(a) f32 float lane at tp={TP}: {f32}')
        require(bf16['psnr_db'] >= psnr1 - BF16_PSNR_SLACK_DB,
                f'(a) bf16 float lane at tp={TP}: {bf16}')
        require(int8['bit_for_bit'], f'(a) int8 lane at tp={TP} differs')
        require(a[-1]['ranks_equal'], '(a) the ranks served other outputs')
    images = {}
    for lane in ('float', 'int8'):
        for name in sizes:
            x = cv2.imread(os.path.join(work, f'w1_{lane}', name))
            y = cv2.imread(os.path.join(work, f'tp_{lane}', name))
            images[f'{lane} {name}'] = int(np.abs(
                x.astype(int) - y.astype(int)).max())
        counts = [two[r][f'tp_{lane}']['launches'] for r in range(TP)]
        want = one[f'w1_{lane}']['launches']
        print(f'[tp] (a) inference_cli {lane} lane --tp {TP} '
              f"({'f32' if lane == 'float' else 'bf16'}, {arr['name']}): "
              f'launches per rank {counts} (one process {want}); wall '
              f"{two[0][f'tp_{lane}']['seconds']:.1f} s vs "
              f"{one[f'w1_{lane}']['seconds']:.1f} s: a correctness run, not "
              f'a scaling number | {card}', flush=True)
        require(all(c == want for c in counts),
                f'(a) {lane} launches per rank {counts}, one process {want}')
        for k in LANES[lane][2]:
            require(want[k] > 0 or (lane == 'float' and k == 'act_bf16'),
                    f'(a) {lane} lane: {k} not launched')
    print(f'[tp] (a) PNGs, largest level difference from one process: '
          f'{images} (float f32 <= 1, int8 0)', flush=True)
    require(all(v <= (1 if k.startswith('float') else 0)
                for k, v in images.items()), f'(a) PNGs differ: {images}')
    out['a'] = dict(ranks=a, png_max_levels=images, launches_per_rank={
        lane: [two[r][f'tp_{lane}']['launches'] for r in range(TP)]
        for lane in ('float', 'int8')})

    # (c) training
    w1 = read_run(work, 'w1_lq')
    spread = run_diff(w1, read_run(work, 'w1_lq_chunks'))
    bound = {k: max(DP_B_SPREADS * spread[k], DP_B_FLOOR)
             for k in ('losses_rel', 'params_rel')}
    tp_run = read_run(work, 'tp_lq')
    c = run_diff(w1, tp_run)
    c4 = run_diff(read_run(work, 'w1_lq', at='1'), read_run(work, 'tp4_lq'))
    check_losses(read_run(work, 'tp4_lq')[0], 'dp2 x tp2 LQ')
    ranks = [two[r]['tp_lq'] for r in range(TP)]
    ranks4 = [four[r]['tp4_lq'] for r in range(2 * TP)]
    for name, rs, iters in (('tp=2', ranks, TP_ITERS),
                            ('dp=2 x tp=2', ranks4, 1)):
        want = {k: TRAIN_LAUNCHES['lq'].get(k, 0) * iters
                for k in rs[0]['launches']}
        differ = sorted({k for r in rs for k, h in r['whole_digests'].items()
                         if h != rs[0]['whole_digests'][k]})
        require(all(r['launches'] == want and r['split'] == 169
                    for r in rs) and not differ,
                f'(c) {name}: launches {[r["launches"] for r in rs]} '
                f'(expected {want}), split tensors '
                f'{[r["split"] for r in rs]}; {len(differ)} tensors held '
                'whole differ across the ranks, e.g. ' + ', '.join(
                    f"{k} (sums {[r['whole_sums'][k] for r in rs]})"
                    for k in differ[:8]))
    w1r = one['w1_lq']
    print(f'[tp] (c) f32 LQ (SGD), batch {TP_BATCH}, {TP_ITERS} iterations, '
          f"tp={TP} ({arr['name']}) vs world 1: losses {c['losses_rel']:.2e} "
          f"(bound {bound['losses_rel']:.2e}), parameters "
          f"{c['params_rel']:.2e} (bound {bound['params_rel']:.2e}, worst "
          f"{c['worst_tensor']}); dp=2 x tp=2 ({arr4['name']}) after 1 "
          f"iteration: losses {c4['losses_rel']:.2e}, parameters "
          f"{c4['params_rel']:.2e} ({c4['worst_tensor']}); the spread of two "
          f"world-1 runs: {spread['losses_rel']:.2e}, "
          f"{spread['params_rel']:.2e}; every tensor held whole is bit-equal "
          f'across the model ranks; launches per rank '
          f"{[r['launches'] for r in ranks]}", flush=True)
    def gib(r):
        peak = r['peak_memory_bytes']
        return 'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'
    print(f"[tp] (c) net_g per rank at tp={TP}: "
          f"{ranks[0]['param_bytes_g'] / 2**20:.1f} MiB of parameters, peak "
          f"{[gib(r) for r in ranks]}; tp=1: "
          f"{w1r['param_bytes_g'] / 2**20:.1f} MiB, peak {gib(w1r)} (batch "
          f'{TP_BATCH}, f32, the LQ run) | {card}', flush=True)
    for name, d in (('tp=2', c), ('dp=2 x tp=2', c4)):
        require(d['losses_rel'] <= bound['losses_rel']
                and d['params_rel'] <= bound['params_rel'],
                f'(c) {name} off world 1 by {d}, bound {bound}')
    hq_records, hq_nets = read_run(work, 'tp_hq')
    check_losses(hq_records, 'tp HQ')
    key = 'quantize_group.0.embedding.weight'
    moved = (hq_nets['net_g'][key] != load_torch_checkpoint(
        inputs['hq'])[key]).any(1)
    shards_moved = [bool(moved[r * len(moved) // TP:
                               (r + 1) * len(moved) // TP].any())
                    for r in range(TP)]
    print(f'[tp] (c) HQ stage at tp={TP}, 1 iteration: losses '
          f"{ {k: v for k, v in hq_records[-1].items() if k.startswith('l_')} }"
          f'; codebook shards updated {shards_moved}; launches per rank '
          f"{[two[r]['tp_hq']['launches'] for r in range(TP)]}", flush=True)
    require(all(shards_moved), f'(c) HQ codebook shards moved {shards_moved}')
    out['c'] = dict(
        diff=c, diff_dp2_tp2=c4, spread=spread, bound=bound,
        param_bytes_g=dict(tp2=ranks[0]['param_bytes_g'],
                           tp1=w1r['param_bytes_g']),
        peak_memory_bytes=dict(tp2=[r['peak_memory_bytes'] for r in ranks],
                               tp1=w1r['peak_memory_bytes']),
        launches_per_rank=dict(
            lq=[r['launches'] for r in ranks],
            hq=[two[r]['tp_hq']['launches'] for r in range(TP)],
            dp2_tp2=[r['launches'] for r in ranks4]))

    # (d) checkpoints
    records, nets = tp_run
    again = read_run(work, 'tp_lq_again')
    d = run_diff(([r for r in records if r['iter'] > 1], nets), again)
    ref_pth = torch.load(one['w1_probe_pth']['probe']['path'])
    pth_cmp = [tp_f32_serving(ref_pth['f32'], torch.load(
        two[r]['tp_probe_pth']['probe']['path'])['f32'],
        load_torch_checkpoint(tp_pth)[key]) for r in range(TP)]
    print(f'[tp] (d) resumed at tp={TP} from iteration 1: bit for bit '
          f"{d['bit_for_bit']} (losses {d['losses_rel']:.2e}, parameters "
          f"{d['params_rel']:.2e}); the tp={TP} net_g .pth served at tp=1 "
          f'(strict) vs at tp={TP}: {pth_cmp}', flush=True)
    require(d['bit_for_bit'], f'(d) the resume at tp={TP} differs: {d}')
    require(all(p['ok'] for p in pth_cmp), f'(d) .pth at tp=1: {pth_cmp}')
    out['d'] = dict(resume=d, pth_at_tp1=pth_cmp)
    return out


def tp_launches(tp: dict, name: str) -> dict:
    """A kernel's launches per rank on the tp phase's paths."""
    return dict(
        serving_float_f32_per_rank=[
            r[name] for r in tp['a']['launches_per_rank']['float']],
        serving_int8_bf16_per_rank=[
            r[name] for r in tp['a']['launches_per_rank']['int8']],
        lq_training_per_rank_per_iteration=[
            r[name] / TP_ITERS for r in tp['c']['launches_per_rank']['lq']],
        hq_training_per_rank_per_iteration=[
            r[name] for r in tp['c']['launches_per_rank']['hq']],
        dp2_tp2_lq_per_rank_per_iteration=[
            r[name] for r in tp['c']['launches_per_rank']['dp2_tp2']])


# -- phase 10: SwinIR (A12a) ---------------------------------------------------

# The four published SwinIR configurations as define_model in
# main_test_swinir.py of the SwinIR repository builds them (mlp_ratio 2,
# resi_connection '1conv'), at full width and depth with seeded weights:
# name -> (build_network options, LR side of the smoke's input, B2
# launches a forward). The x4 models take a smooth 256^2 RGB image, the
# JPEG model a 504^2 grayscale one (5184 windows of 49 tokens).
SWINIR_M = dict(img_size=64, window_size=8, img_range=1.0, depths=[6] * 6,
                embed_dim=180, num_heads=[6] * 6, mlp_ratio=2,
                resi_connection='1conv')
SWINIR_CONFIGS = {
    'M_classical_x4': (dict(SWINIR_M, upscale=4, in_chans=3,
                            upsampler='pixelshuffle'), 256, 36),
    'M_realworld_x4': (dict(SWINIR_M, upscale=4, in_chans=3,
                            upsampler='nearest+conv'), 256, 36),
    'S_lightweight_x4': (dict(SWINIR_M, upscale=4, in_chans=3,
                              depths=[6] * 4, embed_dim=60,
                              num_heads=[6] * 4,
                              upsampler='pixelshuffledirect'), 256, 24),
    'M_jpeg_car': (dict(SWINIR_M, upscale=1, in_chans=1, img_size=126,
                        window_size=7, img_range=255.0, upsampler=''),
                   504, 36),
}
# B2 at the shapes those inputs give it: (windows, N, C, heads, side of the
# padded map, window), q, k, v column slices of one packed qkv as in the
# model (C = 180: 4-byte aligned head slices)
SWINIR_ATTN = {
    'SwinIR-M x4': (1024, 64, 180, 6, 256, 8),
    'SwinIR-S x4': (1024, 64, 60, 6, 256, 8),
    'SwinIR-M CAR': (5184, 49, 180, 6, 504, 7),
}
# the whole model through the kernels against the plain versions: f32 max
# abs; bf16 PSNR against the f32 plain output, the kernels within this of
# the plain bf16 run's (B2 keeps its logits in f32 either way, so the two
# round at the same points)
SWINIR_F32_ATOL = 1e-4
SWINIR_BF16_PSNR_SLACK_DB = 0.5


def attention_case(dev, g, b_, n, c, nh, side, ws, with_mask, dtype):
    """One B2 case: packed qkv slices (q scaled), the bias and the shift
    mask of a side x side map; the kernel against its plain version, its
    time, the plain version's, SDPA's with the bias as attn_mask, and the
    bound. Returns the numbers and whether they agree."""
    from femasr_torch.kernels import window_attention as mod
    from femasr_torch.kernels.tolerance import bf16_agreement
    from femasr_torch.ops.swin import shifted_window_mask
    hd = c // nh
    qkv = torch.randn((b_, n, 3 * c), generator=g, device=dev).to(dtype)
    q = qkv[..., :c] * torch.tensor(hd ** -0.5, dtype=dtype)
    k, v = qkv[..., c:2 * c], qkv[..., 2 * c:]
    bias = torch.randn((nh, n, n), generator=g, device=dev) * 0.02
    mask = (torch.from_numpy(shifted_window_mask(side, side, ws, ws // 2))
            .to(dev) if with_mask else None)
    with counting_off(mod):
        y = mod.window_attention(q, k, v, bias, mask, nh)
        sync(dev)
        ref = mod.window_attention_plain(q, k, v, bias, mask, nh)
        if dtype == torch.float32:
            tol = '1e-5'
            err = (y - ref).abs().max().item()
            ok = torch.allclose(y, ref, atol=1e-5, rtol=1e-5)
            beyond = None
        else:
            # one flipped probability (p < 1, ulp(p) <= 2^-8) moves an
            # output by at most 2^-8 max|v|
            atol = 2.0 ** -8 * v.float().abs().max().item()
            ok, err, beyond = bf16_agreement(y, ref, atol)
            tol = (f'one bf16 ulp, {beyond:.2e} of outputs beyond it '
                   f'(<= 1e-3), by <= {atol:.2e}')
        ms = time_ms(lambda: mod.window_attention(q, k, v, bias, mask, nh))
    plain_ms = time_ms(lambda: mod.window_attention_plain(q, k, v, bias,
                                                          mask, nh))
    heads = [t.reshape(b_, n, nh, hd).transpose(1, 2) for t in (q, k, v)]
    am = bias[None].expand(b_, nh, n, n)
    if mask is not None:
        am = am + mask.repeat(b_ // mask.shape[0], 1, 1)[:, None]
    am = am.to(dtype)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        *heads, attn_mask=am, scale=1.0))
    bms, by = bound_ms(nbytes(q, k, v, y, bias, mask),
                       4.0 * b_ * nh * n * n * hd, dtype)
    return dict(ok=ok, max_abs_err=err, tol=tol, share_beyond_one_ulp=beyond,
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                bound_by=by, b2_route=mod.route_of(q, k, v, nh))


def check_swinir_attention(dev, results) -> None:
    """B2 at every SwinIR shape, with and without the shift mask, in f32
    and bf16 (the padded tensor-core route), against its plain version."""
    g = torch.Generator(device=dev).manual_seed(4)
    shapes = {}
    for label, (b_, n, c, nh, side, ws) in SWINIR_ATTN.items():
        cases = {}
        for with_mask in (False, True):
            for dtype in (torch.float32, torch.bfloat16):
                r = attention_case(dev, g, b_, n, c, nh, side, ws, with_mask,
                                   dtype)
                print(f'[swinir] window_attention {label} ({b_},{n},{c}) '
                      f'{nh} heads mask={with_mask} {str(dtype)[6:]} route '
                      f'{r["b2_route"]}: max_abs_err={r["max_abs_err"]:.3e} '
                      f'(tol {r["tol"]}) ms={r["ms"]:.4f} '
                      f'plain_ms={r["plain_ms"]:.4f} '
                      f'library_ms={r["library_ms"]:.4f} (SDPA) '
                      f'bound_ms={r["bound_ms"]:.4f} ({r["bound_by"]})',
                      flush=True)
                require(r['ok'], f'window_attention {label} mask={with_mask} '
                                 f'{dtype}: kernel disagrees with plain '
                                 f'({r["max_abs_err"]})')
                cases[f'{"mask" if with_mask else "nomask"}_'
                      f'{str(dtype)[6:]}'] = {
                    k: v for k, v in r.items() if k not in ('ok', 'tol')}
        shapes[label] = dict(shape=f'q,k,v ({b_},{n},{c}), {nh} heads',
                             **cases)
    results['window_attention']['swinir'] = shapes


def swinir_input(cfg: dict, side: int, dev) -> torch.Tensor:
    """The smoke's seeded smooth image, grayscale for one channel."""
    img = torch.from_numpy(smooth_image(np.random.default_rng(21), side,
                                        side)).float().div(255)
    x = img.permute(2, 0, 1)[None]
    if cfg['in_chans'] == 1:
        x = x.mean(1, keepdim=True)
    return x.to(dev)


def expected_launches(cfg: dict, b2: int, dtype) -> dict:
    """A forward launches B2 once a block and, in bf16, act_bf16 once a
    block (the MLP's GELU, rounded as JAX rounds); no other kernel."""
    from femasr_torch import kernels
    want = {name: 0 for name in kernels.MODULES}
    want['window_attention'] = b2
    if dtype == torch.bfloat16:
        want['act_bf16'] = sum(cfg['depths'])
    return want


def profile_swinir(dev, model, x, name: str, tag: str, ms: float) -> dict:
    """Device time by kernel group of one warm forward (torch.profiler),
    and the idle share against the forward's time `ms`."""
    from torch.profiler import ProfilerActivity, profile

    from femasr_torch import kernels
    with counting_off(*kernels.MODULES.values()), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        model(x)
        sync(dev)
    kern, groups, _, _ = group_kernels(prof)
    busy = sum(groups.values()) / 1e3
    top = {k: v / 1e3 for k, v in sorted(groups.items(),
                                         key=lambda kv: -kv[1]) if v}
    print(f'[swinir] profile {name} {tag}: {len(kern)} kernels, device busy '
          f'{busy:.2f} ms of {ms:.2f} ms (idle {1 - busy / ms:.1%}); '
          + ', '.join(f'{k} {v:.2f}' for k, v in top.items()), flush=True)
    return dict(kernels=len(kern), device_busy_ms=busy,
                idle_share=1 - busy / ms, groups_ms=top)


def swinir_phase(dev) -> dict:
    """The four published configurations through build_network, once in
    f32 and once in bf16: launches of one forward (counts zeroed just
    before, read just after), ms per forward and peak memory, the whole
    model through the kernels against the plain versions."""
    from femasr_torch import kernels
    from femasr_torch.models import build_network, init_weights
    out = {}
    for name, (cfg, side, b2) in SWINIR_CONFIGS.items():
        net = build_network(dict(cfg, type='SwinIR')).to(dev).eval()
        init_weights(net, torch.Generator().manual_seed(20))
        net16 = build_network(dict(cfg, type='SwinIR', dtype='bfloat16'))
        net16.load_state_dict(net.state_dict())
        net16 = net16.to(dev).eval()
        x = swinir_input(cfg, side, dev)
        scale = cfg['upscale']
        entry = dict(input=list(x.shape))
        refs = {}
        with torch.inference_mode():
            for tag, model in (('f32', net), ('bf16', net16)):
                dtype = model.dtype
                kernels.reset_launches()
                y = model(x)
                sync(dev)
                counts = kernels.launch_counts()
                want = expected_launches(cfg, b2, dtype)
                require(counts == want, f'SwinIR {name} {tag}: launches '
                                        f'{counts}, want {want}')
                require(tuple(y.shape) == (1, cfg['in_chans'], side * scale,
                                           side * scale)
                        and torch.isfinite(y).all().item(),
                        f'SwinIR {name} {tag}: output {tuple(y.shape)} not '
                        'finite or of the wrong shape')
                with plain_kernels():
                    ref = model(x)
                sync(dev)
                refs[tag] = (y.float(), ref.float())
                with counting_off(*kernels.MODULES.values()):
                    torch.cuda.reset_peak_memory_stats(dev)
                    ms = time_ms(lambda: model(x), reps=3, warm=1)
                    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
                entry[tag] = dict(launches_per_forward={
                    k: v for k, v in counts.items() if v}, ms_per_forward=ms,
                    peak_memory_gib=peak,
                    profile=profile_swinir(dev, model, x, name, tag, ms))
                del y, ref
        (y32, ref32), (y16, ref16) = refs['f32'], refs['bf16']
        err = (y32 - ref32).abs().max().item()
        psnr_k, psnr_p = psnr_db(y16, ref32), psnr_db(ref16, ref32)
        entry['f32']['max_abs_err_vs_plain'] = err
        entry['bf16'].update(psnr_kernels_vs_f32_plain_db=psnr_k,
                             psnr_plain_vs_f32_plain_db=psnr_p)
        print(f'[swinir] {name} {tuple(x.shape)} -> x{scale}: f32 '
              f'{entry["f32"]["ms_per_forward"]:.2f} ms/forward, peak '
              f'{entry["f32"]["peak_memory_gib"]:.2f} GiB, launches '
              f'{entry["f32"]["launches_per_forward"]}, kernels vs plain max '
              f'abs {err:.3e} (tol {SWINIR_F32_ATOL}); bf16 '
              f'{entry["bf16"]["ms_per_forward"]:.2f} ms/forward, peak '
              f'{entry["bf16"]["peak_memory_gib"]:.2f} GiB, launches '
              f'{entry["bf16"]["launches_per_forward"]}, PSNR vs the f32 '
              f'plain output: kernels {psnr_k:.3f} dB, plain {psnr_p:.3f} dB',
              flush=True)
        require(err <= SWINIR_F32_ATOL, f'SwinIR {name} f32: the kernels '
                                        f'differ from the plain versions by '
                                        f'{err}')
        require(psnr_k >= psnr_p - SWINIR_BF16_PSNR_SLACK_DB,
                f'SwinIR {name} bf16: the kernels lose more than '
                f'{SWINIR_BF16_PSNR_SLACK_DB} dB to the plain versions '
                f'({psnr_k:.3f} vs {psnr_p:.3f})')
        out[name] = entry
        del net, net16, refs, y32, ref32, y16, ref16
        torch.cuda.empty_cache()
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


def device_kernels(prof) -> list:
    """The profile's kernels on the card; a record_function range that the
    profiler also puts on the card's timeline (DistributedDataParallel.
    forward, Optimizer.step) is no kernel."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, 'is_user_annotation', False)]


def sync(dev) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def gpu_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--rank-worker', metavar='PLAN',
                        help='run as one process of the dp phase (the '
                             'script starts these itself)')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if args.rank_worker:
        return rank_worker(args.rank_worker)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from femasr_torch import kernels
    from femasr_torch.kernels import _build

    from femasr_torch.utils.misc import disable_tf32
    disable_tf32()
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

    def stamp(done: str) -> None:
        print(f'[time] {done} at {time.time() - t0:.1f} s', flush=True)

    stamp('build')
    results = {}
    check_conv3(dev, results)
    check_window_attention(dev, results)
    check_vq_argmin(dev, results)
    check_tp_kernels(dev, results)
    check_matmul_w8a8(dev, results)
    check_matmul_w8a8_q(dev, results)
    check_conv3_w8a8(dev, results)
    check_act_bf16(dev, results)
    check_swinir_attention(dev, results)
    stamp('kernel checks (phase 2)')
    torch.cuda.empty_cache()
    with femasr_b2_routes('serving lanes and their profiles'):
        with tempfile.TemporaryDirectory() as work:
            counts, extra = main_path(dev, work)
        stamp('main path (phase 3)')
        for lane in LANES:
            extra[lane]['profile'] = profile_forward(dev, lane)
    torch.cuda.empty_cache()
    stamp('profiles (phase 4)')
    swinir = swinir_phase(dev)
    stamp('SwinIR (phase 10)')
    with femasr_b2_routes('training, validation, dp and tp'), \
            tempfile.TemporaryDirectory() as work:
        train = train_phase(dev, work)
    check_train_shapes(dev, results)
    stamp('training, BSRGAN, dp and tp (phases 5-9)')

    for name, how in REDESIGNED.items():
        print(f'[history] {name}: redesigned {how}; its earlier times stand '
              f'in PERF.md', flush=True)
    line = {'kernels': [], 'main_path': extra, 'train': train,
            'swinir': swinir}
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
            # the training path's own counts, per iteration
            launches_training={f'{stage}_per_iteration': train[stage][
                'launches'][name] / train[stage]['iterations']
                for stage in ('lq', 'hq', 'lq_ondevice', 'hq_bsrgan')},
            # the bf16 and checkpointed training runs', per iteration
            launches_training_bf16={f'{stage}_per_iteration': train[stage][
                'launches'][name] / train[stage]['iterations']
                for stage in ('lq_bf16', 'hq_bf16', 'lq_f32_checkpointed',
                              'lq_bf16_checkpointed')},
            launches_validation_bf16={f'{stage}_per_image': train[
                f'{stage}_bf16']['validation_launches_per_image'][name]
                for stage in ('lq', 'hq')},
            # the data-parallel runs', per rank (dp phase)
            launches_dp=dp_launches(train['dp'], name),
            # the tensor-parallel runs', per rank (tp phase)
            launches_tp=tp_launches(train['tp'], name),
            # the SwinIR phase's, per forward, by configuration and dtype
            launches_swinir={cfg: {tag: e[tag]['launches_per_forward'].get(
                name, 0) for tag in ('f32', 'bf16')}
                for cfg, e in swinir.items()},
            # the validation path's, per image, and test_cli's
            launches_validation=dict(
                {f'{stage}_per_image': train[stage][
                    'validation_launches_per_image'][name]
                 for stage in ('lq', 'hq')},
                evaluation_per_image=train['lq']['evaluation']['launches'][
                    name] / len(VAL_LR)),
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
