"""Training, validation and test data (counterpart of femasr_tpu/data)."""

from .data_util import make_dataset, paths_from_folder
from .datasets import (BSRGANTrainDataset, EpochSampler, ImageSource,
                       PairedImageDataset, SingleImageDataset, build_dataset,
                       build_eval_loader, build_train_loader)
from .loader import DevicePrefetcher
from .shardstore import make_shard_from_folder
from .transforms import augment, paired_random_crop, random_crop

__all__ = ['make_dataset', 'paths_from_folder', 'BSRGANTrainDataset',
           'EpochSampler', 'ImageSource', 'PairedImageDataset',
           'SingleImageDataset', 'build_dataset', 'build_eval_loader',
           'build_train_loader', 'DevicePrefetcher', 'make_shard_from_folder',
           'augment', 'paired_random_crop', 'random_crop']
