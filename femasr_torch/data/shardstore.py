"""The `.fmrs` shard store (counterpart of femasr_tpu/native/shardstore.py):
one file of raw uint8 HWC images behind a header and an index, read by
key through mmap with no decode.

`ShardStoreWriter` packs images (streamed to a spool file, so a training
set is never held in memory). `ShardStoreReader` reads through the C++
library `csrc/shardstore.cpp`, built with g++ on first use into
`build/femasr_torch/` (`kernels/_build.py`); a failed build raises, there
is no Python fallback. Its `sample_batch` draws augmented crops in C++
threads with xorshift128+ generators seeded from (seed, index, position),
as the JAX package's C++ reader does, so both packages draw the same
batches. `PlainShardReader` is the same reader in numpy (the header
checks, `read` and the same draws bit for bit), the reference the tests
hold the library to.

File layout (little-endian): magic "FMRS1\\0\\0\\0", u64 n_items, n_items
index entries {u64 offset; u32 h, w, c, flags; char key[64]} (88 bytes),
then the images' bytes.
"""

from __future__ import annotations

import ctypes
import os
import struct
from os import path as osp
from typing import List, Optional, Sequence, Tuple

import numpy as np

FMRS_SUFFIX = '.fmrs'
MAGIC = b'FMRS1\x00\x00\x00'
ENTRY = struct.Struct('<QIIII64s')
HEADER_BYTES = 16
MAX_SIDE, MAX_CHANNELS = 1 << 21, 16
MASK64 = (1 << 64) - 1

_lib: Optional[ctypes.CDLL] = None


def native_library() -> ctypes.CDLL:
    """The shard store's C++ library (built on first use; raises if the
    build fails)."""
    global _lib
    if _lib is None:
        from ..kernels import _build
        lib = _build.load('shardstore')
        lib.fmrs_open.restype = ctypes.c_void_p
        lib.fmrs_open.argtypes = [ctypes.c_char_p]
        lib.fmrs_close.argtypes = [ctypes.c_void_p]
        lib.fmrs_count.restype = ctypes.c_uint64
        lib.fmrs_count.argtypes = [ctypes.c_void_p]
        lib.fmrs_meta.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.POINTER(ctypes.c_uint32),
                                  ctypes.c_char_p]
        lib.fmrs_read.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                  ctypes.POINTER(ctypes.c_uint8)]
        lib.fmrs_sample_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        _lib = lib
    return _lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class ShardStoreWriter:
    """Pack HWC uint8 images into one .fmrs file. Pixels are spooled to
    `<path>.data.tmp` as they are added and stitched behind the header and
    index at `close`; leaving a `with` block on an exception discards the
    spool and writes no shard (a partial shard would look whole)."""

    def __init__(self, path: str):
        if not path.endswith(FMRS_SUFFIX):
            raise ValueError(f'{path}: a shard path ends with {FMRS_SUFFIX}')
        self.path = path
        self._meta: List[Tuple[bytes, int, int, int]] = []
        os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
        self._data_path = path + '.data.tmp'
        self._data = open(self._data_path, 'wb')

    def add(self, key: str, img: np.ndarray) -> None:
        if img.dtype != np.uint8 or img.ndim != 3:
            raise ValueError(f'{key}: an HWC uint8 image is required, got '
                             f'{img.dtype} {img.shape}')
        # the reader's header checks: a shard written here always opens
        if (img.shape[0] > MAX_SIDE or img.shape[1] > MAX_SIDE
                or img.shape[2] > MAX_CHANNELS):
            raise ValueError(f'{key}: image too large: {img.shape}')
        kb = key.encode('utf-8')
        if len(kb) > 63:
            raise ValueError(f'shard key exceeds 63 utf-8 bytes: {key!r} '
                             '(truncated keys would collide)')
        self._meta.append((kb, *img.shape))
        self._data.write(np.ascontiguousarray(img).tobytes())

    def close(self) -> None:
        if self._data is None:
            return
        self._data.close()
        self._data = None
        offset = HEADER_BYTES + len(self._meta) * ENTRY.size
        with open(self.path, 'wb') as f:
            f.write(MAGIC)
            f.write(struct.pack('<Q', len(self._meta)))
            for kb, h, w, c in self._meta:
                f.write(ENTRY.pack(offset, h, w, c, 0, kb.ljust(64, b'\0')))
                offset += h * w * c
            with open(self._data_path, 'rb') as data:
                while True:
                    chunk = data.read(1 << 24)
                    if not chunk:
                        break
                    f.write(chunk)
        os.remove(self._data_path)

    def abort(self) -> None:
        """Discard the spool; no shard is written."""
        if self._data is not None:
            self._data.close()
            self._data = None
        if osp.exists(self._data_path):
            os.remove(self._data_path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class ShardStoreReader:
    """A shard through the C++ library: `keys`, `meta`, `read` and
    `sample_batch`. A file that is not a whole shard is refused when it
    is opened (IOError)."""

    def __init__(self, path: str, num_threads: Optional[int] = None):
        self.path = path
        self.num_threads = num_threads or max(os.cpu_count() or 1, 1)
        self._lib = native_library()
        self._handle = self._lib.fmrs_open(path.encode())
        if not self._handle:
            raise IOError(f'cannot open shard store: {path}')
        meta = (ctypes.c_uint32 * 3)()
        key = ctypes.create_string_buffer(64)
        self._meta = []
        for i in range(int(self._lib.fmrs_count(self._handle))):
            self._lib.fmrs_meta(self._handle, i, meta, key)
            self._meta.append((meta[0], meta[1], meta[2],
                               key.value.decode()))

    def __len__(self) -> int:
        return len(self._meta)

    def keys(self) -> List[str]:
        return [m[3] for m in self._meta]

    def meta(self, idx: int) -> Tuple[int, int, int, str]:
        return self._meta[idx]

    def read(self, idx: int) -> np.ndarray:
        h, w, c, _ = self._meta[idx]
        out = np.empty((h, w, c), np.uint8)
        if self._lib.fmrs_read(self._handle, idx, _u8(out)) != 0:
            raise IndexError(f'{self.path}: no item {idx}')
        return out

    def sample_batch(self, indices: Sequence[int], crop: int,
                     hflip: bool = True, vflip: bool = True,
                     rot90: bool = True, seed: int = 0) -> np.ndarray:
        """(B, crop, crop, 3) uint8: a random crop of each item, each
        flipped and transposed at random."""
        if crop <= 0:
            # the library reads crop 0 as whole images, of per-item shapes
            raise ValueError(f'crop must be positive, got {crop}')
        out = np.empty((len(indices), crop, crop, 3), np.uint8)
        idx = (ctypes.c_uint64 * len(indices))(*indices)
        rc = self._lib.fmrs_sample_batch(
            self._handle, idx, len(indices), crop, int(hflip), int(vflip),
            int(rot90), seed & MASK64, self.num_threads, _u8(out))
        if rc != 0:
            raise RuntimeError(f'fmrs_sample_batch failed: {rc}')
        return out

    def close(self) -> None:
        if getattr(self, '_handle', None):     # None if the open failed
            self._lib.fmrs_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Xorshift128Plus:
    """The library's per-sample generator, in Python integers (uint64
    arithmetic with wraparound)."""

    def __init__(self, seed: int):
        seed &= MASK64
        self.s0 = (seed * 0x9E3779B97F4A7C15 + 1) & MASK64
        self.s1 = (seed ^ 0xBF58476D1CE4E5B9) | 1

    def next(self) -> int:
        x, y = self.s0, self.s1
        self.s0 = y
        x ^= (x << 23) & MASK64
        self.s1 = x ^ y ^ (x >> 17) ^ (y >> 26)
        return (self.s1 + y) & MASK64

    def below(self, n: int) -> int:
        return self.next() % n if n else 0


class PlainShardReader:
    """The reader in numpy: the library's header checks, `read` and
    `sample_batch` with its draws, bit for bit."""

    def __init__(self, path: str):
        self.path = path
        self._mmap = np.memmap(path, dtype=np.uint8, mode='r') \
            if osp.getsize(path) else np.zeros(0, np.uint8)
        size = self._mmap.size
        if size < HEADER_BYTES or bytes(self._mmap[:8]) != MAGIC:
            raise IOError(f'cannot open shard store: {path}')
        n = struct.unpack('<Q', bytes(self._mmap[8:16]))[0]
        if n > (size - HEADER_BYTES) // ENTRY.size:
            raise IOError(f'cannot open shard store: {path}')
        index_end = HEADER_BYTES + n * ENTRY.size
        self._entries = []
        for i in range(n):
            at = HEADER_BYTES + i * ENTRY.size
            off, h, w, c, _, key = ENTRY.unpack(
                bytes(self._mmap[at:at + ENTRY.size]))
            if h > MAX_SIDE or w > MAX_SIDE or c > MAX_CHANNELS:
                raise IOError(f'cannot open shard store: {path}')
            if off < index_end or off > size or h * w * c > size - off:
                raise IOError(f'cannot open shard store: {path}')
            self._entries.append((off, h, w, c, key.rstrip(b'\0').decode()))

    def __len__(self) -> int:
        return len(self._entries)

    def keys(self) -> List[str]:
        return [e[4] for e in self._entries]

    def meta(self, idx: int) -> Tuple[int, int, int, str]:
        return self._entries[idx][1:]

    def read(self, idx: int) -> np.ndarray:
        if not 0 <= idx < len(self._entries):
            raise IndexError(f'{self.path}: no item {idx}')
        off, h, w, c, _ = self._entries[idx]
        return np.array(self._mmap[off:off + h * w * c]).reshape(h, w, c)

    def sample_batch(self, indices: Sequence[int], crop: int,
                     hflip: bool = True, vflip: bool = True,
                     rot90: bool = True, seed: int = 0) -> np.ndarray:
        if crop <= 0:
            raise ValueError(f'crop must be positive, got {crop}')
        out = np.empty((len(indices), crop, crop, 3), np.uint8)
        for b, idx in enumerate(indices):
            if not 0 <= idx < len(self._entries):
                raise RuntimeError('fmrs_sample_batch failed: -1')
            _, h, w, c, _ = self._entries[idx]
            if c != 3:
                raise RuntimeError('fmrs_sample_batch failed: -2')
            if h < crop or w < crop:
                raise RuntimeError('fmrs_sample_batch failed: -3')
            rng = Xorshift128Plus(seed * 0x100000001B3 + idx * 1315423911
                                  + b)
            top, left = rng.below(h - crop + 1), rng.below(w - crop + 1)
            fh = hflip and rng.next() & 1
            fv = vflip and rng.next() & 1
            r90 = rot90 and rng.next() & 1
            patch = self.read(idx)[top:top + crop, left:left + crop]
            if fv:
                patch = patch[::-1]
            if fh:
                patch = patch[:, ::-1]
            out[b] = patch.transpose(1, 0, 2) if r90 else patch
        return out


def make_shard_from_folder(folder: str, out_path: str) -> int:
    """Pack the images under `folder` (recursively, sorted) into a shard,
    RGB, keyed by their paths relative to `folder` without the extension.
    Returns the number of image files found."""
    import cv2

    from .data_util import make_dataset
    paths = make_dataset(folder)
    with ShardStoreWriter(out_path) as writer:
        for p in paths:
            img = cv2.imread(p, cv2.IMREAD_COLOR)
            if img is None:
                continue
            writer.add(osp.splitext(osp.relpath(p, folder))[0],
                       cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    return len(paths)
