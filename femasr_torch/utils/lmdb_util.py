"""Training archives in the reference's LMDB interface, written as `.fmrs`
shards (counterpart of femasr_tpu/utils/lmdb_util.py): a path ending in
`.lmdb` becomes `.fmrs`, and `<shard>.meta_info.txt` lists each image as
`key.png (h,w,c) compress_level`."""

from __future__ import annotations

from os import path as osp
from typing import List, Optional

import numpy as np


def _shard_path(lmdb_path: str) -> str:
    if lmdb_path.endswith('.lmdb'):
        lmdb_path = lmdb_path[:-5] + '.fmrs'
    assert lmdb_path.endswith('.fmrs'), "archive path should end with '.fmrs'"
    return lmdb_path


def make_lmdb_from_imgs(data_path: str, lmdb_path: str,
                        img_path_list: Optional[List[str]] = None,
                        keys: Optional[List[str]] = None,
                        batch: int = 5000, compress_level: int = 1,
                        multiprocessing_read: bool = False,
                        n_thread: int = 40, map_size=None) -> str:
    """Pack the images `img_path_list` (relative to `data_path`; default:
    every image under it, keyed by its relative path without extension)
    into a shard, RGB. Returns the shard's path. `batch`,
    `multiprocessing_read`, `n_thread` and `map_size` are LMDB's and
    unused."""
    import cv2

    from ..data.data_util import make_dataset
    from ..data.shardstore import ShardStoreWriter
    lmdb_path = _shard_path(lmdb_path)
    if img_path_list is None:
        img_path_list = [osp.relpath(p, data_path)
                         for p in make_dataset(data_path)]
        keys = [osp.splitext(p)[0] for p in img_path_list]
    assert keys is not None and len(keys) == len(img_path_list)
    meta_lines = []
    with ShardStoreWriter(lmdb_path) as writer:
        for rel, key in zip(img_path_list, keys):
            img = cv2.imread(osp.join(data_path, rel), cv2.IMREAD_COLOR)
            if img is None:
                continue
            rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            writer.add(key, rgb)
            h, w, c = rgb.shape
            meta_lines.append(f'{key}.png ({h},{w},{c}) {compress_level}\n')
    with open(lmdb_path + '.meta_info.txt', 'w') as f:
        f.writelines(meta_lines)
    return lmdb_path


class LmdbMaker:
    """Add images one by one (`put`), then `close` writes the shard and its
    meta-info file."""

    def __init__(self, lmdb_path: str, map_size=None, batch: int = 5000,
                 compress_level: int = 1):
        from ..data.shardstore import ShardStoreWriter
        self.lmdb_path = _shard_path(lmdb_path)
        self.compress_level = compress_level
        self._writer = ShardStoreWriter(self.lmdb_path)
        self._meta: List[str] = []

    def put(self, img_byte, key: str, img_shape) -> None:
        """img_byte: an encoded image's bytes, or an HWC uint8 RGB array."""
        if isinstance(img_byte, np.ndarray):
            img = img_byte
        else:
            import cv2
            img = cv2.cvtColor(cv2.imdecode(np.frombuffer(img_byte, np.uint8),
                                            cv2.IMREAD_COLOR),
                               cv2.COLOR_BGR2RGB)
        self._writer.add(key, img)
        h, w, c = img.shape
        self._meta.append(f'{key}.png ({h},{w},{c}) {self.compress_level}\n')

    def close(self) -> None:
        self._writer.close()
        with open(self.lmdb_path + '.meta_info.txt', 'w') as f:
            f.writelines(self._meta)
