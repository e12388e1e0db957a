"""The slice as a whole: the port's FeMaSRNet (LQ stage, x4 and x2) against
the JAX FeMaSRNet on the same converted weights, in f32 on the CPU. The
output agrees to rel 2e-3 (the JAX suite's whole-model bound, PARITY.md
§A) and the codebook indices are identical. Plus the key set and the
flax <-> torch conversion."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch.models import FeMaSRNet, init_weights
from femasr_torch.models.convert import from_flax
from femasr_tpu.models.convert import (convert_femasr_checkpoint,
                                       femasr_param_mapping)
from femasr_tpu.models.femasr_arch import FeMaSRNet as JFeMaSRNet
from torch_port_util import nchw, nhwc

SMALL = [[32, 16, 32]]
RELEASE = [[32, 1024, 512]]


def _seeded_flax_params(codebook, lq, scale, seed=0):
    """Flax params for the JAX model, made from a seeded port init through
    the JAX package's own torch -> flax converter."""
    net = FeMaSRNet(codebook, LQ_stage=lq, scale_factor=scale)
    init_weights(net, torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    return convert_femasr_checkpoint(sd, codebook_params=codebook,
                                     LQ_stage=lq, scale_factor=scale)


@pytest.mark.parametrize('lq,scale', [(True, 4), (True, 2), (False, 1)])
def test_femasr_slice_matches_jax(lq, scale):
    params = _seeded_flax_params(SMALL, lq, scale)
    x = np.random.default_rng(scale).random((1, 32, 32, 3),
                                            dtype=np.float32)
    jnet = JFeMaSRNet(codebook_params=SMALL, LQ_stage=lq,
                      scale_factor=scale)
    out_j, loss_j, _, idx_j = jax.jit(
        lambda p, x: jnet.apply({'params': p}, x))(params, jnp.asarray(x))

    net = FeMaSRNet(SMALL, LQ_stage=lq, scale_factor=scale)
    net.load_state_dict(from_flax(params, SMALL, LQ_stage=lq,
                                  scale_factor=scale), strict=True)
    with torch.no_grad():
        out, loss, _, idx = net(nchw(x))
    out_j = np.asarray(out_j)
    assert out.shape == (1, 3, 32 * scale, 32 * scale)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(idx_j[0]))
    rel = np.abs(nhwc(out) - out_j).max() / np.abs(out_j).max()
    assert rel < 2e-3, rel
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)

    # decode_indices on the same codes
    dec_j = jax.jit(lambda p, i: jnet.apply(
        {'params': p}, i, method=JFeMaSRNet.decode_indices))(params,
                                                             idx_j[0])
    with torch.no_grad():
        dec = net.decode_indices(idx[0])
    dec_j = np.asarray(dec_j)
    assert np.abs(nhwc(dec) - dec_j).max() / np.abs(dec_j).max() < 2e-3


@pytest.mark.parametrize('scale', [4, 2])
def test_release_state_dict_keys_match_reference_mapping(scale):
    net = FeMaSRNet(RELEASE, LQ_stage=True, scale_factor=scale,
                    norm_type='gn', act_type='silu')
    mapping = femasr_param_mapping(RELEASE, LQ_stage=True,
                                   scale_factor=scale, act_type='silu')
    torch_keys = {key for key, _ in mapping.values()}
    assert set(net.state_dict()) == torch_keys
    # the port's copy of the table is the same table
    from femasr_torch.models.convert import femasr_param_mapping as tmap
    ours = tmap(RELEASE, LQ_stage=True, scale_factor=scale)
    assert {p: k for p, (k, _) in ours.items()} == \
        {p: k for p, (k, _) in mapping.items()}


def test_from_flax_inverts_the_jax_converter():
    net = FeMaSRNet(SMALL, LQ_stage=True, scale_factor=4)
    init_weights(net, torch.Generator().manual_seed(1))
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    params = convert_femasr_checkpoint(sd, codebook_params=SMALL,
                                       LQ_stage=True, scale_factor=4)
    back = from_flax(params, SMALL, LQ_stage=True, scale_factor=4)
    assert set(back) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_codebook_scale_on_kernel_level_is_refused():
    with pytest.raises(AssertionError):
        FeMaSRNet([[128, 16, 32]], LQ_stage=False)
