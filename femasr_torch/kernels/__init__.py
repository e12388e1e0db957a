"""Hand-written CUDA kernels of the port, one module per kernel.

Each module holds the wrapper (launches the kernel for CUDA tensors), the
plain PyTorch version of the same function (used for CPU tensors and as
the reference on the card) and an integer `launches` count.
`plain_versions()` routes the model's kernel calls to the plain versions
for a reference run on the card.
"""

import contextlib

from . import (act_bf16, conv3, conv3_w8a8, matmul_w8a8, matmul_w8a8_q,
               vq_argmin, window_attention)

MODULES = {'conv3': conv3, 'window_attention': window_attention,
           'vq_argmin': vq_argmin, 'matmul_w8a8': matmul_w8a8,
           'matmul_w8a8_q': matmul_w8a8_q, 'conv3_w8a8': conv3_w8a8,
           'act_bf16': act_bf16}


def build_all() -> None:
    """Compile every kernel (in parallel) and load it."""
    from . import _build
    _build.build(MODULES)


def reset_launches() -> None:
    for mod in MODULES.values():
        mod.launches = 0


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in MODULES.items()}


@contextlib.contextmanager
def plain_versions():
    """Within the block, the model's layers call each kernel's plain
    version instead of its wrapper (an f32 reference run on the card);
    the wrappers are restored on exit."""
    from ..models import femasr_arch
    from ..ops import layers, quantize, swin

    def mm_plain(*args, packed=None, **kwargs):  # needs no packed weight
        return matmul_w8a8.matmul_w8a8_plain(*args, **kwargs)

    def mmq_plain(*args, packed=None, **kwargs):
        return matmul_w8a8_q.matmul_w8a8_q_plain(*args, **kwargs)
    swaps = [(layers, 'conv3', conv3.conv3_plain),
             (femasr_arch, 'conv3', conv3.conv3_plain),
             (swin, 'window_attention',
              window_attention.window_attention_plain),
             (quantize, 'vq_argmin', vq_argmin.vq_argmin_plain),
             (layers, 'conv3_w8a8', conv3_w8a8.conv3_w8a8_plain),
             (layers, 'matmul_w8a8', mm_plain),
             (layers, 'matmul_w8a8_q', mmq_plain),
             (layers, 'act_bf16', act_bf16.act_bf16_plain)]
    old = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    try:
        for m, name, fn in swaps:
            setattr(m, name, fn)
        yield
    finally:
        for m, name, fn in old:
            setattr(m, name, fn)
