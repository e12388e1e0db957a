"""No silent gradient loss through a kernel: every kernel wrapper writes its
result into a fresh tensor that has no autograd edge, so each one refuses
an input that requires grad while grad mode is on, before its device
dispatch (so the refusal shows on the CPU too), and works under
torch.no_grad(). A differentiable caller (the training forward) takes the
plain versions itself."""

import pytest
import torch

from femasr_torch.kernels import (act_bf16, conv3, conv3_w8a8, matmul_w8a8,
                                  matmul_w8a8_q, vq_argmin, window_attention)
import torch_port_util  # noqa: F401  (caps torch at 2 threads)


def _g():
    return torch.Generator().manual_seed(0)


def _call(name):
    """(wrapper call, the float inputs that may require grad)."""
    g = _g()
    if name == 'conv3':
        x = torch.randn(1, 8, 6, 6, generator=g).contiguous(
            memory_format=torch.channels_last)
        w = torch.randn(4, 8, 3, 3, generator=g)
        return lambda: conv3.conv3(x, w, torch.zeros(4)), [x, w]
    if name == 'window_attention':
        q, k, v = (torch.randn(2, 64, 64, generator=g) for _ in range(3))
        bias = torch.zeros(2, 64, 64)
        return (lambda: window_attention.window_attention(
            q, k, v, bias, None, 2), [q, k, v, bias])
    if name == 'vq_argmin':
        z, cb = torch.randn(10, 8, generator=g), torch.randn(5, 8,
                                                            generator=g)
        return lambda: vq_argmin.vq_argmin(z, cb), [z, cb]
    if name == 'act_bf16':
        x = torch.randn(4, 8, generator=g).bfloat16()
        return lambda: act_bf16.act_bf16(x, 'silu'), [x]
    if name == 'matmul_w8a8':
        x, w = torch.randn(6, 8, generator=g), torch.randn(4, 8, generator=g)
        return lambda: matmul_w8a8.matmul_w8a8(x, w), [x, w]
    if name == 'matmul_w8a8_q':
        x_q = torch.randint(-127, 128, (6, 8), dtype=torch.int8, generator=g)
        s_x = torch.rand(6, 1, generator=g) + 0.1
        w = torch.randn(4, 8, generator=g)
        return (lambda: matmul_w8a8_q.matmul_w8a8_q(x_q, s_x, w),
                [s_x, w])
    x = torch.randn(1, 8, 6, 6, generator=g).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(4, 8, 3, 3, generator=g)
    return lambda: conv3_w8a8.conv3_w8a8(x, w), [x, w]


WRAPPERS = ['conv3', 'window_attention', 'vq_argmin', 'act_bf16',
            'matmul_w8a8', 'matmul_w8a8_q', 'conv3_w8a8']


@pytest.mark.parametrize('name', WRAPPERS)
def test_wrapper_refuses_inputs_that_need_grad(name):
    run, inputs = _call(name)
    run()                                   # plain inputs: no refusal
    for t in inputs:
        t.requires_grad_(True)
        with pytest.raises(RuntimeError, match='requires grad'):
            run()
        with torch.no_grad():
            out = run()
        assert not (out[0] if isinstance(out, tuple) else out).requires_grad
        t.requires_grad_(False)
