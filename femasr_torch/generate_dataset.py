"""Offline LQ synthesis with the BSRGAN degradation (counterpart of
generate_dataset.py): walks an HQ tree and writes the degraded images to
a mirrored `LQ_sub_X{scale}` tree under the output folder.

  --device cuda   (the default) batches of `--batch` images on the card
                  (`ops/degradations.py`), drawn from a CUDA generator
                  seeded with `--seed`; every HQ image must have one size
                  (cut them with `femasr_torch.scripts.extract_subimages`)
  --device cpu    the host pipeline (`data/degradations.py`) in `--nproc`
                  processes; image i draws from default_rng((seed, i))

Both repeat under one seed. `--device cuda` without a card raises.

    python -m femasr_torch.generate_dataset -i ../datasets/HQ_sub \
        -o ../datasets -s 4
"""

from __future__ import annotations

import argparse
import os
from functools import partial
from multiprocessing import Pool
from os import path as osp
from typing import List, Tuple

import numpy as np
import torch

from .data.data_util import make_dataset
from .data.datasets import read_rgb
from .data.degradations import degradation_bsrgan
from .utils.img_util import imwrite, rgb_to_bgr_uint8


def degrade_one(job: Tuple[int, str, str], sf: int, seed: int) -> bool:
    """Degrade image `i` of the tree on the host and write it; an image that
    fails is reported and skipped."""
    i, src, dst = job
    try:
        rgb = read_rgb(src)
        lq, _ = degradation_bsrgan(
            rgb, np.random.default_rng((seed, i)), sf=sf,
            lq_patchsize=min(rgb.shape[0], rgb.shape[1]) // sf // 2,
            use_crop=False)
    except Exception as e:  # noqa: BLE001 -- one image, not the run
        print(f'  ! skipping {src}: {type(e).__name__}: {e}', flush=True)
        return False
    imwrite(rgb_to_bgr_uint8(lq), dst)
    return True


def one_size_batch(imgs: List[np.ndarray]) -> torch.Tensor:
    """(B, 3, H, W) of HWC images of one size; mixed sizes are refused."""
    shapes = {im.shape for im in imgs}
    if len(shapes) != 1:
        raise ValueError(f'--device cuda needs HQ images of one size, got '
                         f'{sorted(shapes)}; cut them with '
                         'femasr_torch.scripts.extract_subimages first')
    return torch.from_numpy(np.stack(imgs).transpose(0, 3, 1, 2))


def synthesize(gt: torch.Tensor, generator: torch.Generator, sf: int):
    """The LQ batch (B, 3, H/sf, W/sf) of a GT batch on the generator's
    device, before rounding to 8 bits, and the draws it was made with."""
    from .ops.degradations import apply_degradation, draw_degradation
    draws = draw_degradation(generator, gt.shape, sf)
    return apply_degradation(gt, draws, sf), draws


def degrade_on_card(pairs: List[Tuple[str, str]], sf: int, batch: int,
                    seed: int) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError('--device cuda: no CUDA device is available '
                           '(use --device cpu for the host pipeline)')
    dev = torch.device('cuda', torch.cuda.current_device())
    generator = torch.Generator(dev).manual_seed(seed)
    done = 0
    for i in range(0, len(pairs), batch):
        chunk = pairs[i:i + batch]
        gt = one_size_batch([read_rgb(src) for src, _ in chunk])
        lq, _ = synthesize(gt.pin_memory().to(dev, non_blocking=True),
                           generator, sf)
        for (_, dst), img in zip(chunk, lq.permute(0, 2, 3, 1).cpu().numpy()):
            imwrite(rgb_to_bgr_uint8(img), dst)
        done += len(chunk)
        print(f'{done}/{len(pairs)}', flush=True)
    return done


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('-i', '--input', type=str, required=True,
                        help='HQ image tree (e.g. ../datasets/HQ_sub)')
    parser.add_argument('-o', '--output', type=str, required=True,
                        help='output parent dir (LQ_sub_X{scale} is created)')
    parser.add_argument('-s', '--scale', type=int, default=4)
    parser.add_argument('--device', choices=['cpu', 'cuda'], default='cuda')
    parser.add_argument('--nproc', type=int, default=os.cpu_count())
    parser.add_argument('--batch', type=int, default=8,
                        help='batch size for --device cuda')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)

    paths = make_dataset(args.input)
    out_root = osp.join(args.output, f'LQ_sub_X{args.scale}')
    pairs = [(p, osp.join(out_root, osp.relpath(p, args.input)))
             for p in paths]
    print(f'{len(pairs)} images -> {out_root}')
    if args.device == 'cuda':
        return degrade_on_card(pairs, args.scale, args.batch, args.seed)
    import scipy.linalg  # noqa: F401 -- the host pipeline's, loaded once
    import scipy.ndimage  # noqa: F401 -- before the workers are forked
    with Pool(max(args.nproc, 1)) as pool:
        results = pool.map(partial(degrade_one, sf=args.scale,
                                   seed=args.seed),
                           [(i, s, d) for i, (s, d) in enumerate(pairs)])
    print(f'done: {sum(results)}/{len(pairs)} converted')
    return sum(results)


if __name__ == '__main__':
    main()
