"""Data (counterpart of femasr_tpu/data/datasets.py, sampler.py and
loader.py): PairedImageDataset for training and validation,
BSRGANTrainDataset (GT only, LQ synthesized by the BSRGAN degradation in
the workers or on the device) for training and SingleImageDataset (LQ only)
for evaluation, through plain torch DataLoaders.

Randomness is explicit and independent of the worker count: the sampler
(`EpochSampler`) yields (index, seed) items, and the dataset draws its
crop, flips and (BSRGANTrainDataset) degradation from
numpy.random.default_rng(seed), the seed being (manual_seed, epoch,
position in the epoch). The order of an epoch is a permutation from
(manual_seed, epoch). So a run resumed at iteration k sees the batches the
uninterrupted run saw (`EpochSampler.start`).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import numpy as np
import torch
from torch.utils.data import DataLoader, Dataset, Sampler

from ..utils.matlab_functions import rgb2ycbcr
from .data_util import make_dataset, paths_from_folder
from .degradations import degradation_bsrgan
from .transforms import augment, paired_random_crop, random_crop


def read_rgb(path: str) -> np.ndarray:
    """HWC float32 RGB in [0, 1]."""
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f'cannot read image: {path}')
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def random_resize(img: np.ndarray, factor: float) -> np.ndarray:
    import cv2
    return cv2.resize(img, None, fx=factor, fy=factor,
                      interpolation=cv2.INTER_CUBIC)


def _chw(img: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))


def _folder(root: str):
    if root.endswith('.fmrs'):
        raise NotImplementedError(
            f'{root}: the JAX package\'s .fmrs shard store is not ported; '
            'give an image folder')
    return make_dataset(root)


class PairedImageDataset(Dataset):
    """LQ/GT pairs from two folders, paired by sorted order. In the train
    phase: use_resize_crop (a random rescale of both, then matching
    gt_size crops), use_flip, use_rot. In the val and test phases the whole
    images, or with crop_eval_size a matching crop of that GT size (drawn
    from the item's index). Items are dicts of (3, H, W) float32 tensors in
    [0, 1] and the two paths."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.gt_paths = _folder(opt['dataroot_gt'])
        self.lq_paths = _folder(opt['dataroot_lq'])
        if len(self.gt_paths) != len(self.lq_paths):
            raise ValueError(f'{len(self.gt_paths)} GT images but '
                             f'{len(self.lq_paths)} LQ images')

    def __len__(self) -> int:
        return len(self.gt_paths)

    def __getitem__(self, item) -> Dict:
        index, seed = item if isinstance(item, tuple) else (item, (item,))
        rng = np.random.default_rng(seed)
        gt_path, lq_path = self.gt_paths[index], self.lq_paths[index]
        img_gt, img_lq = read_rgb(gt_path), read_rgb(lq_path)
        if self.opt['phase'] == 'train':
            gt_size = self.opt['gt_size']
            scale = img_gt.shape[0] // img_lq.shape[0]
            if self.opt.get('use_resize_crop', False):
                size = int(rng.integers(gt_size, img_gt.shape[0] + 1))
                size -= size % scale
                factor = size / img_gt.shape[0]
                img_gt = random_resize(img_gt, factor)
                img_lq = random_resize(img_lq, factor)
                img_gt, img_lq = paired_random_crop(img_gt, img_lq, gt_size,
                                                    scale, rng, gt_path)
            img_gt, img_lq = augment([img_gt, img_lq],
                                     self.opt.get('use_flip', False),
                                     self.opt.get('use_rot', False), rng)
        elif self.opt.get('crop_eval_size'):
            img_gt, img_lq = paired_random_crop(
                img_gt, img_lq, self.opt['crop_eval_size'],
                img_gt.shape[0] // img_lq.shape[0], rng, gt_path)
        return {'lq': _chw(img_lq), 'gt': _chw(img_gt), 'lq_path': lq_path,
                'gt_path': gt_path}


class SingleImageDataset(Dataset):
    """LQ-only images for evaluation: the files of `dataroot_lq`, or the
    first field of each line of `meta_info_file` under it. color: y gives
    the MATLAB Y channel; mean / std normalize. Items are {'lq': (C, H, W)
    float32 tensor, 'lq_path'}."""

    def __init__(self, opt: dict):
        self.opt = opt
        if opt.get('meta_info_file') is not None:
            with open(opt['meta_info_file']) as f:
                self.lq_paths = [
                    f"{opt['dataroot_lq']}/{line.strip().split(' ')[0]}"
                    for line in f]
        else:
            self.lq_paths = paths_from_folder(opt['dataroot_lq'])

    def __len__(self) -> int:
        return len(self.lq_paths)

    def __getitem__(self, index: int) -> Dict:
        lq_path = self.lq_paths[index]
        img_lq = read_rgb(lq_path)
        if self.opt.get('color') == 'y':
            img_lq = rgb2ycbcr(img_lq, y_only=True)[..., None]
        mean, std = self.opt.get('mean'), self.opt.get('std')
        if mean is not None or std is not None:
            img_lq = ((img_lq - np.asarray(mean or 0.0, np.float32))
                      / np.asarray(std or 1.0, np.float32))
        return {'lq': _chw(img_lq), 'lq_path': lq_path}


class BSRGANTrainDataset(Dataset):
    """GT images of a folder; the LQ is synthesized by the BSRGAN
    degradation. In the train phase: use_resize_crop (a random cubic
    rescale to a side in [gt_size, the image's]), a gt_size crop, then
    use_flip and use_rot. With on_device_degradation the item holds the
    GT only, and the trainer degrades the batch on the device; else the
    host pipeline (data/degradations.py) synthesizes the x`scale` LQ here.
    Items are dicts of (3, H, W) float32 tensors in [0, 1] and the path
    (as lq_path and gt_path)."""

    def __init__(self, opt: dict):
        self.opt = opt
        self.gt_paths = _folder(opt['dataroot_gt'])

    def __len__(self) -> int:
        return len(self.gt_paths)

    def __getitem__(self, item) -> Dict:
        index, seed = item if isinstance(item, tuple) else (item, (item,))
        rng = np.random.default_rng(seed)
        gt_path = self.gt_paths[index]
        img_gt = read_rgb(gt_path)
        gt_size = self.opt['gt_size']
        flip, rot = self.opt.get('use_flip', False), self.opt.get('use_rot',
                                                                  False)
        if self.opt['phase'] == 'train':
            if self.opt.get('use_resize_crop', False):
                size = int(rng.integers(gt_size, img_gt.shape[0] + 1))
                img_gt = random_resize(img_gt, size / img_gt.shape[0])
            img_gt = random_crop(img_gt, gt_size, rng)
        item = {'lq_path': gt_path, 'gt_path': gt_path}
        if self.opt.get('on_device_degradation', False):
            item['gt'] = _chw(augment(img_gt, flip, rot, rng))
            return item
        img_lq, img_gt = degradation_bsrgan(
            img_gt, rng, sf=self.opt['scale'],
            lq_patchsize=gt_size // self.opt['scale'], use_crop=False)
        img_gt, img_lq = augment([img_gt, img_lq], flip, rot, rng)
        item.update(lq=_chw(img_lq), gt=_chw(img_gt))
        return item


DATASETS = {'PairedImageDataset': PairedImageDataset,
            'BSRGANTrainDataset': BSRGANTrainDataset,
            'SingleImageDataset': SingleImageDataset}


def build_dataset(opt: dict) -> Dataset:
    if opt['type'] not in DATASETS:
        raise NotImplementedError(f'dataset {opt["type"]!r} is not ported')
    return DATASETS[opt['type']](opt)


class EpochSampler(Sampler):
    """A seeded permutation per epoch over the (enlarged) dataset; yields
    (index, per-sample seed). `start(epoch, skip)` sets the epoch and skips
    its first `skip` positions.

    Data parallel: the epoch's one order is cut into global batches of
    world_size x batch positions, and rank r takes block r of each (so the
    ranks' batches, concatenated in rank order, are the world-1 batch of
    world_size x batch); positions past the last whole global batch are
    dropped, on every rank alike. Positions and `skip` count in the global
    order, and the seed of a sample is (seed, epoch, global position) at
    every world size."""

    def __init__(self, dataset_size: int, seed: int, ratio: int = 1,
                 rank: int = 0, world_size: int = 1, batch: int = 1):
        self.dataset_size = dataset_size
        self.seed = int(seed)
        self.num_samples = math.ceil(dataset_size * ratio)
        self.rank, self.world_size, self.batch = rank, world_size, batch
        self.epoch, self.skip = 0, 0

    def start(self, epoch: int, skip: int = 0) -> None:
        self.epoch, self.skip = epoch, skip

    def _positions(self) -> range:
        gb = self.batch * self.world_size
        return range(self.skip, self.num_samples // gb * gb)

    def __iter__(self) -> Iterator[Tuple[int, Tuple[int, int, int]]]:
        order = np.random.default_rng((self.seed, self.epoch)).permutation(
            self.num_samples) % self.dataset_size
        gb, lo = self.batch * self.world_size, self.rank * self.batch
        for pos in self._positions():
            if lo <= pos % gb < lo + self.batch:
                yield int(order[pos]), (self.seed, self.epoch, pos)

    def __len__(self) -> int:
        return len(self._positions()) // self.world_size


def build_train_loader(dataset: Dataset, opt: dict, seed: int,
                       pin_memory: bool = False, rank: int = 0,
                       world_size: int = 1
                       ) -> Tuple[DataLoader, EpochSampler]:
    """A DataLoader of full batches of `batch_size_per_gpu` over an
    EpochSampler, with `num_worker_per_gpu` workers; with world_size > 1
    rank `rank`'s blocks of the global batches."""
    batch = opt['batch_size_per_gpu']
    sampler = EpochSampler(len(dataset), seed,
                           opt.get('dataset_enlarge_ratio', 1), rank,
                           world_size, batch)
    workers = int(opt.get('num_worker_per_gpu', 0))
    loader = DataLoader(
        dataset, batch_size=batch, sampler=sampler,
        num_workers=workers, drop_last=True, pin_memory=pin_memory,
        generator=torch.Generator().manual_seed(seed),
        persistent_workers=False)
    return loader, sampler


def build_eval_loader(dataset: Dataset) -> DataLoader:
    """A validation / test loader: batch 1, in order, no workers. Its
    generator is its own, so iterating it draws nothing from torch's
    global random stream."""
    return DataLoader(dataset, batch_size=1, shuffle=False, num_workers=0,
                      generator=torch.Generator().manual_seed(0))
