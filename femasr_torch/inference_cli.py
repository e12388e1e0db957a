"""FeMaSR super-resolution CLI on the PyTorch/CUDA port.

Example:
    python -m femasr_torch.inference_cli -i ./testset -w FeMaSR_SRX4_model_g.pth \
        -o results_x4/ -s 4

Data-parallel serving, one process per card (each forward's batch is
sharded over the ranks; rank 0 writes the images):
    torchrun --nproc_per_node 2 -m femasr_torch.inference_cli -i ./testset \
        -w FeMaSR_SRX4_model_g.pth -o results_x4/ --dp 2 --launcher pytorch

Tensor-parallel serving (the Swin linears by head and hidden width and the
codebook by codes split over --tp ranks, which run each forward together;
--dp x --tp = the number of processes):
    torchrun --nproc_per_node 4 -m femasr_torch.inference_cli -i ./testset \
        -w FeMaSR_SRX4_model_g.pth -o results_x4/ --dp 2 --tp 2 \
        --launcher pytorch
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch

IMAGE_EXTS = ('.png', '.jpg', '.jpeg', '.bmp', '.webp')


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description='FeMaSR super-resolution (PyTorch/CUDA port)')
    parser.add_argument('-i', '--input', type=str, default='./testset',
                        help='Input image file or folder')
    parser.add_argument('-w', '--weight', type=str, required=True,
                        help='Reference-format torch .pth weights')
    parser.add_argument('-o', '--output', type=str, default='results',
                        help='Output folder')
    parser.add_argument('-s', '--out_scale', type=int, default=4,
                        help='SR scale: 2 or 4')
    parser.add_argument('--suffix', type=str, default='',
                        help='Suffix for restored filenames')
    parser.add_argument('--max_size', type=int, default=600,
                        help='Whole-image path if h*w < max_size^2, else tiled')
    parser.add_argument('--tile_size', type=int, default=240)
    parser.add_argument('--tile_pad', type=int, default=16)
    parser.add_argument('--tile_batch', type=int, default=None,
                        help='Tiles per batched forward (default 1; with '
                             '--dp one tile per data rank)')
    parser.add_argument('--precision', type=str, default='bf16',
                        choices=['bf16', 'f32'],
                        help='Compute dtype (parameters stay f32)')
    parser.add_argument('--bucket', type=int, default=0,
                        help='>0: bucketed batched folder inference (pads '
                             'shapes to multiples of this)')
    parser.add_argument('--int8_tail', action='store_true',
                        help='run the last decoder level + out_conv in w8a8 '
                             'int8 (checkpoint-free dynamic quantization)')
    parser.add_argument('--int8_levels', type=int, default=1,
                        help='with --int8_tail: how many decoder levels '
                             '(from the output end) run int8 (1-3)')
    parser.add_argument('--int8_enc_up', action='store_true',
                        help='also quantize the LQ-encoder up blocks (skips '
                             'the pre-quantizer convs so codebook indices '
                             'stay float-exact)')
    parser.add_argument('--int8_swin', action='store_true',
                        help='quantize the swin qkv/proj/mlp linears w8a8 '
                             '(may flip near-tie codebook indices, the same '
                             'class as bf16 serving divergence)')
    parser.add_argument('--int8_mlp', action='store_true',
                        help='run the swin MLPs as the per-token int8 chain '
                             '(fc1 + GELU emits int8 for fc2; wins over '
                             '--int8_swin for the MLP; same index caveat)')
    parser.add_argument('--strict_load', action='store_true',
                        help='fail unless the checkpoint\'s keys and shapes '
                             'match the model\'s exactly (default: overlay '
                             'it onto the seed-0 init, counting unused, '
                             'missing and skipped keys)')
    parser.add_argument('--device', type=str, default='cuda',
                        help='cuda (under a launcher cuda:LOCAL_RANK), '
                             'cuda:i (every rank on card i) or cpu')
    parser.add_argument('--dp', type=int, default=0,
                        help='>0: shard each batch over a data-parallel mesh '
                             'of this many ranks (the world size of '
                             '--launcher pytorch|slurm)')
    parser.add_argument('--tp', type=int, default=1,
                        help='>1: split the model over this many ranks of '
                             'each data group (the mesh\'s model axis; '
                             '--dp x --tp = the world size of --launcher '
                             'pytorch|slurm)')
    parser.add_argument('--launcher', choices=['none', 'pytorch', 'slurm'],
                        default='none',
                        help='pytorch: one process per card started by '
                             'torchrun; slurm: by srun')
    parser.add_argument('--dist_backend', choices=['nccl', 'gloo'],
                        default=None,
                        help='with a launcher: the process group\'s backend '
                             '(default nccl on the card, gloo on the CPU)')
    return parser.parse_args(argv)


def serving_mesh(args: argparse.Namespace):
    """Join the launcher's process group and build the --dp x --tp mesh
    (None for one process); refuses --dp or --tp above 1 without a
    launcher, and a --dp x --tp other than the world size. Sets
    args.device to this rank's device."""
    from .parallel.dist_util import get_dist_info, init_dist
    from .parallel.mesh import create_mesh
    if args.tp < 1:
        raise SystemExit(f'--tp {args.tp}: give 1 or more')
    dp = max(args.dp, 1 if args.tp > 1 else 2)
    n = dp * args.tp
    command = (f'torchrun --nproc_per_node {n} -m '
               f'femasr_torch.inference_cli ... --dp {dp}'
               + (f' --tp {args.tp}' if args.tp > 1 else '')
               + ' --launcher pytorch')
    if args.launcher == 'none':
        if args.dist_backend is not None:
            raise SystemExit('--dist_backend needs a launcher (--launcher '
                             'pytorch or slurm)')
        if args.dp > 1 or args.tp > 1:
            raise SystemExit(f'--dp {args.dp} --tp {args.tp} needs one '
                             'process per rank, started by a launcher: '
                             f'{command}')
        return None
    device = init_dist(args.launcher, args.dist_backend, args.device)
    args.device = str(device)
    world = get_dist_info()[1]
    if args.dp * args.tp != world:
        raise SystemExit(
            f'--dp {args.dp}, but the launcher started {world} processes '
            f'(--dp x --tp = {args.dp} x {args.tp} must equal the world '
            f'size): give --dp {world // args.tp} with --tp {args.tp}, or '
            f'start {args.dp * args.tp} ({command})')
    return create_mesh(data=args.dp, model=args.tp,
                       device_type=device.type)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Run the CLI; returns {'images': n, 'megapixels': mp, 'seconds': s}."""
    args = parse_args(argv)
    from .models.inference import load_inferencer
    from .parallel.mesh import is_main_process
    from .utils.img_util import imread_rgb, imwrite, rgb_to_bgr_uint8, scandir
    from .utils.misc import disable_tf32

    mesh = serving_mesh(args)
    main_rank = is_main_process()
    log = print if main_rank else (lambda *a, **k: None)
    disable_tf32()
    if args.tile_batch is None:
        args.tile_batch = max(1, args.dp)   # one tile per data rank

    dtype = torch.bfloat16 if args.precision == 'bf16' else torch.float32
    sr = load_inferencer(args.weight, scale_factor=args.out_scale,
                         dtype=dtype, device=args.device, mesh=mesh,
                         max_tile_batch=args.tile_batch,
                         int8_tail=args.int8_tail,
                         int8_levels=args.int8_levels,
                         int8_enc_up=args.int8_enc_up,
                         int8_swin=args.int8_swin, int8_mlp=args.int8_mlp,
                         strict=args.strict_load)

    if main_rank:
        os.makedirs(args.output, exist_ok=True)
    if os.path.isfile(args.input):
        paths = [args.input]
    else:
        paths = sorted(os.path.join(args.input, p)
                       for p in scandir(args.input, recursive=True)
                       if p.lower().endswith(IMAGE_EXTS))
    if not paths:
        raise SystemExit(f'No images found under {args.input}')

    def rel_name(path):
        if os.path.isfile(args.input):
            return os.path.basename(path)
        return os.path.relpath(path, args.input)

    def save(img_name, out):
        if not main_rank:
            return
        base, _ = os.path.splitext(img_name)
        suffix = f'_{args.suffix}' if args.suffix else ''
        imwrite(rgb_to_bgr_uint8(out),
                os.path.join(args.output, f'{base}{suffix}.png'))

    def sync():
        if sr.device.type == 'cuda':
            torch.cuda.synchronize(sr.device)

    if args.bucket > 0:
        imgs, names = [], []
        for path in paths:
            rgb = imread_rgb(path)
            if rgb is None:
                log(f'  ! cannot read {path}, skipping')
                continue
            imgs.append(rgb)
            names.append(rel_name(path))
        t0 = time.time()
        outs = sr.run_bucketed(imgs, bucket=args.bucket,
                               max_batch=args.tile_batch)
        sync()
        dt = time.time() - t0
        for name, out in zip(names, outs):
            save(name, out)
        mp = sum(im.shape[0] * im.shape[1] for im in imgs) / 1e6
        log(f'{len(imgs)} images ({mp:.3f} MP input) in {dt:.3f}s '
            f'({mp / dt:.3f} MP/s)', flush=True)
        return {'images': len(imgs), 'megapixels': mp, 'seconds': dt}

    total_mp = total_s = 0.0
    n = 0
    for idx, path in enumerate(paths):
        img_name = rel_name(path)
        log(f'[{idx + 1}/{len(paths)}] Processing: {img_name}', flush=True)
        rgb = imread_rgb(path)
        if rgb is None:
            log(f'  ! cannot read {path}, skipping')
            continue
        t0 = time.time()
        out = sr(rgb, max_size=args.max_size, tile_size=args.tile_size,
                 tile_pad=args.tile_pad)
        sync()
        dt = time.time() - t0
        save(img_name, out)
        mp = rgb.shape[0] * rgb.shape[1] / 1e6
        total_mp, total_s, n = total_mp + mp, total_s + dt, n + 1
        log(f'  {rgb.shape[1]}x{rgb.shape[0]} -> '
            f'{out.shape[1]}x{out.shape[0]} in {dt:.3f}s '
            f'({mp / dt:.3f} MP/s input)', flush=True)
    return {'images': n, 'megapixels': total_mp, 'seconds': total_s}


if __name__ == '__main__':
    main()
    from .parallel.dist_util import shutdown
    shutdown()
