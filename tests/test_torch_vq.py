"""B3 VQ argmin: the port's plain version (what the CUDA kernel computes)
against the JAX Pallas kernel (interpret mode), and the quantizer against
the flax VectorQuantizer, on the CPU. Indices must be exactly equal;
z_q and losses agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch.kernels import vq_argmin as vq_mod
from femasr_torch.ops.quantize import VectorQuantizer as TVQ
from femasr_tpu.ops.pallas.vq import vq_argmin
from femasr_tpu.ops.quantize import VectorQuantizer
from torch_port_util import nchw, nhwc


def _tokens(seed, n, k, c):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, c)).astype(np.float32),
            rng.normal(size=(k, c)).astype(np.float32))


@pytest.mark.parametrize('n,k,c,max_codes', [(64, 128, 32, 2048),
                                             (300, 1024, 512, 2048),
                                             (200, 1024, 64, 256)])
def test_vq_argmin_plain_matches_pallas(n, k, c, max_codes):
    z, cb = _tokens(0, n, k, c)
    ref = vq_argmin(jnp.asarray(z), jnp.asarray(cb), tn=128,
                    max_codes_vmem=max_codes, interpret=True)
    out = vq_mod.vq_argmin(torch.from_numpy(z), torch.from_numpy(cb))
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_vq_argmin_plain_tie_break_first_minimum():
    cb = np.tile(np.eye(4, dtype=np.float32), (2, 1))        # rows repeat
    z = np.eye(4, dtype=np.float32)
    ref = vq_argmin(jnp.asarray(z), jnp.asarray(cb), tn=128, interpret=True)
    out = vq_mod.vq_argmin(torch.from_numpy(z), torch.from_numpy(cb))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(out.numpy(), [0, 1, 2, 3])


def test_vq_argmin_plain_searches_bf16_tokens_in_f32():
    z, cb = _tokens(1, 128, 256, 32)
    zb = torch.from_numpy(z).bfloat16()
    out = vq_mod.vq_argmin(zb, torch.from_numpy(cb))
    ref = vq_argmin(jnp.asarray(zb.float().numpy()), jnp.asarray(cb),
                    tn=128, interpret=True)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize('lq_stage', [False, True])
def test_vector_quantizer_matches_flax(lq_stage):
    # serving: no gt indices, so both stages give q_latent + beta * e_latent
    rng = np.random.default_rng(2)
    z = rng.normal(size=(2, 4, 5, 32)).astype(np.float32)
    cb = rng.normal(size=(64, 32)).astype(np.float32)
    gt = rng.integers(0, 64, size=(2, 4, 5)).astype(np.int32)
    vq = VectorQuantizer(n_e=64, e_dim=32, lq_stage=lq_stage)
    zq, loss, idx = vq.apply({'params': {'embedding': jnp.asarray(cb)}},
                             jnp.asarray(z))
    tvq = TVQ(64, 32)
    tvq.load_state_dict({'embedding.weight': torch.from_numpy(cb)})
    with torch.no_grad():
        tzq, tloss, tidx = tvq(nchw(z))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    np.testing.assert_allclose(nhwc(tzq), np.asarray(zq), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-5,
                               atol=1e-6)
    entry = vq.apply({'params': {'embedding': jnp.asarray(cb)}},
                     jnp.asarray(gt), method=VectorQuantizer.get_codebook_entry)
    np.testing.assert_array_equal(
        nhwc(tvq.get_codebook_entry(torch.from_numpy(gt))), np.asarray(entry))
