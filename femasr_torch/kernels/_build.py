"""Build and load the port's native libraries.

Each `csrc/<name>.cu` is compiled with nvcc for sm_90a into its own shared
library with a plain C interface and loaded with ctypes (no PyTorch headers,
so a build takes seconds). A host library, `csrc/<name>.cpp` (the `.fmrs`
shard store), is compiled the same way with g++. Libraries go to
`build/femasr_torch/` at the repository root and are rebuilt when the hash
of the source (and, for CUDA, of the headers in `csrc/`) changes; each is
written under a temporary name and renamed into place. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Optional

import torch

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), 'csrc')
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), 'build', 'femasr_torch')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
GXX_FLAGS = ['-O3', '-std=c++17', '-shared', '-fPIC', '-pthread']

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    path = os.path.join(home, 'bin', 'nvcc')
    return path if os.path.exists(path) else 'nvcc'


def _command(name: str) -> tuple:
    """(source, files hashed, compiler command) of csrc/<name>.cpp (host
    C++, g++) or csrc/<name>.cu (CUDA, nvcc)."""
    cpp = os.path.join(CSRC, f'{name}.cpp')
    if os.path.exists(cpp):
        return cpp, [cpp], ['g++', *GXX_FLAGS]
    src = os.path.join(CSRC, f'{name}.cu')
    return (src, [src] + sorted(glob.glob(os.path.join(CSRC, '*.cuh'))),
            [_nvcc(), *NVCC_FLAGS])


def _compile(name: str) -> str:
    src, hashed, cmd = _command(name)
    h = hashlib.sha256()
    for path in hashed:
        with open(path, 'rb') as f:
            h.update(f.read())
    digest = h.hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f'lib{name}_{digest}.so')
    if not os.path.exists(out):
        tmp = f'{out}.{os.getpid()}.tmp'
        try:
            proc = subprocess.run([*cmd, '-o', tmp, src],
                                  capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f'{cmd[0]} failed for {src}: {e}') from e
        if proc.returncode != 0:
            raise RuntimeError(f'{cmd[0]} failed for {src}:\n{proc.stderr}')
        os.replace(tmp, out)
        build_log[name] = proc.stderr
    return out


def build(names: Iterable[str]) -> None:
    """Compile the named kernels in parallel (one nvcc each) and load them."""
    names = [n for n in names if n not in _libs]
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        paths = list(pool.map(_compile, names))
    with _lock:
        for name, path in zip(names, paths):
            _libs.setdefault(name, ctypes.CDLL(path))


def load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build([name])
    return _libs[name]


def refuse_grad(what: str, *tensors) -> None:
    """A kernel writes its result through a raw pointer into a fresh tensor,
    which has no autograd edge: a kernel call on an input that needs a
    gradient would cut the gradients of everything upstream. Raise instead
    (on every device, so the CPU sees it too); a differentiable caller takes
    the plain version itself."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f'{what}: an input requires grad and the kernel has no backward; '
            f'call it under torch.no_grad() or take {what}_plain')


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err}')


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """The tensor's device pointer (null for None: an optional output)."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
