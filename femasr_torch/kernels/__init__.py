"""Hand-written CUDA kernels of the port, one module per kernel.

Each module holds the wrapper (launches the kernel for CUDA tensors), the
plain PyTorch version of the same function (used for CPU tensors and as
the reference on the card) and an integer `launches` count.
"""

from . import (conv3, conv3_w8a8, matmul_w8a8, matmul_w8a8_q, vq_argmin,
               window_attention)

MODULES = {'conv3': conv3, 'window_attention': window_attention,
           'vq_argmin': vq_argmin, 'matmul_w8a8': matmul_w8a8,
           'matmul_w8a8_q': matmul_w8a8_q, 'conv3_w8a8': conv3_w8a8}


def build_all() -> None:
    """Compile every kernel (in parallel) and load it."""
    from . import _build
    _build.build(MODULES)


def reset_launches() -> None:
    for mod in MODULES.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in MODULES.items()}
