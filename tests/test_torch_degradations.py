"""The port's on-device BSRGAN degradation (femasr_torch/ops/degradations.py,
diffjpeg.py, resize.py) against the JAX package's
(femasr_tpu/ops/degradations_jax.py, diffjpeg.py, resize.py), on the CPU at
small canvases.

The deterministic parts are compared directly: the resize matrices
exactly, the resizes, canvas round trips, blur and JPEG at float32
tolerances. Torch cannot reproduce JAX's random streams, so the kernels and
the Gaussian noise are built from JAX's own draws (the split / uniform /
randint calls of the JAX functions, made here with JAX) and compared with
JAX's output; the whole pipeline is compared by its statistics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from femasr_torch.ops import degradations as P
from femasr_torch.ops import diffjpeg as PJ
from femasr_torch.ops import resize as PR
from femasr_tpu.ops import degradations_jax as J
from femasr_tpu.ops import diffjpeg as JJ
from femasr_tpu.ops import resize as JR
from torch_port_util import nchw, nhwc

RESIZES = [(40, 10, 0.25), (40, 20, 0.5), (17, 51, 3.0), (48, 18, 0.375),
           (10, 40, 4.0), (56, 49, 0.875)]


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize('n_in,n_out,scale', RESIZES)
def test_resize_matrices_equal_jax(n_in, n_out, scale):
    np.testing.assert_array_equal(
        PR.matlab_resize_matrix(n_in, n_out, scale),
        JR.matlab_resize_matrix(n_in, n_out, scale))
    np.testing.assert_array_equal(P._area_matrix(n_in, n_out),
                                  J._area_matrix(n_in, n_out))
    np.testing.assert_array_equal(P._bilinear_matrix(n_in, n_out),
                                  J._bilinear_matrix(n_in, n_out))


@pytest.mark.parametrize('scale', [0.25, 0.5, 2.0, 1 / 3])
def test_imresize_matches_jax(scale):
    x = _rand(0, 2, 36, 44, 3)
    ref = np.asarray(JR.imresize(jnp.asarray(x), scale))
    np.testing.assert_allclose(nhwc(PR.imresize(nchw(x), scale)), ref,
                               atol=1e-5)
    np.testing.assert_array_equal(PR.imresize_np(x[0], scale),
                                  JR.imresize_np(x[0], scale))


@pytest.mark.parametrize('method', [0, 1, 2], ids=['bilinear', 'bicubic',
                                                   'area'])
@pytest.mark.parametrize('h,w,oh,ow', [(40, 48, 10, 12), (10, 12, 40, 48),
                                       (40, 48, 25, 30)])
def test_resize_branches_match_jax(method, h, w, oh, ow):
    x = _rand(1, 2, h, w, 3)
    ref = np.asarray(J.resize_branches(h, w, oh, ow)[method](jnp.asarray(x)))
    out = P.resize_branches(h, w, oh, ow, torch.device('cpu'))[method](
        nchw(x))
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-5)


# the six canvas scales; 1/sf (sf 4 and 2) are 0.25 and 0.5 among them
@pytest.mark.parametrize('scale', J.CANVAS_SCALES)
def test_canvas_rescale_matches_jax(scale):
    assert P.CANVAS_SCALES == J.CANVAS_SCALES
    x = _rand(2, 2, 40, 48, 3)
    rescale = jax.jit(J.canvas_rescale, static_argnums=1)
    for method in range(3):
        ref = np.asarray(rescale(jnp.asarray(x), scale, jnp.asarray(method)))
        np.testing.assert_allclose(
            nhwc(P.canvas_rescale(nchw(x), scale, method)), ref, atol=1e-5)


def test_depthwise_blur_matches_jax():
    x = _rand(3, 3, 40, 36, 3)
    # a centred Gaussian, a random kernel and one with no symmetry at all:
    # a correlation would not match the last two
    c = np.arange(25, dtype=np.float32) - 12
    kernels = np.stack([np.exp(-(c[None] ** 2 + c[:, None] ** 2) / 20),
                        _rand(4, 25, 25),
                        _rand(5, 25, 25) * np.linspace(0, 1, 25) ** 3])
    kernels = (kernels / kernels.sum(axis=(1, 2), keepdims=True)).astype(
        np.float32)
    ref = np.asarray(jax.jit(J.depthwise_blur)(jnp.asarray(x),
                                               jnp.asarray(kernels)))
    out = P.depthwise_blur(nchw(x), torch.from_numpy(kernels))
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-5)


@pytest.mark.parametrize('sf', [2, 4])
def test_gaussian_kernels_from_jax_draws(sf):
    b, key = 16, jax.random.PRNGKey(sf)

    @jax.jit
    def kernels_and_draws(key):
        # the draws of random_gaussian_kernels (degradations_jax.py:85-95)
        _, k_theta, k_l, k_sigma, k_mode, k_rad = jax.random.split(key, 6)
        return J.random_gaussian_kernels(key, b, sf), [
            jax.random.uniform(k_theta, (b,)) * jnp.pi,
            jax.random.uniform(k_l, (b, 2)) * (4.0 + sf),
            jax.random.uniform(k_sigma, (b,)) * (2.0 + 0.2 * sf),
            jax.random.uniform(k_mode, (b,)) < 0.5,
            jax.random.randint(k_rad, (b,), 2, 12).astype(jnp.float32) + 1.5]

    ref, draws = kernels_and_draws(key)
    ref = np.asarray(ref)
    aniso = np.asarray(draws[3])
    assert aniso.any() and not aniso.all()
    out = P.gaussian_kernels(*(torch.from_numpy(np.array(d))
                               for d in draws))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(out.sum(dim=(1, 2)).numpy(), 1.0, rtol=1e-5)


def test_gaussian_noise_from_jax_draws():
    b, h, w = 12, 24, 20
    x = _rand(5, b, h, w, 3)

    @jax.jit
    def noise_and_draws(key, x):
        # the draws of add_gaussian_noise_jax (degradations_jax.py:215-229)
        k_lvl, k_mode, k_n1, k_n2, k_cov, k_q = jax.random.split(key, 6)
        return J.add_gaussian_noise_jax(key, x), dict(
            level=jax.random.randint(k_lvl, (b, 1, 1, 1), 2, 26).astype(
                jnp.float32) / 255.,
            mode=jax.random.uniform(k_mode, (b, 1, 1, 1)),
            n1=jax.random.normal(k_n1, x.shape).transpose(0, 3, 1, 2),
            n2=jax.random.normal(k_n2, (b, h, w, 1)).transpose(0, 3, 1, 2),
            u=jax.random.uniform(k_cov, (b, 3, 3)),
            d=jax.random.uniform(k_q, (b, 3)))

    ref, draws = noise_and_draws(jax.random.PRNGKey(7), jnp.asarray(x))
    mode = np.asarray(draws['mode'])
    # every mode is exercised: colour, grey and correlated
    assert (mode > 0.6).any() and (mode < 0.4).any()
    assert ((mode >= 0.4) & (mode <= 0.6)).any()
    out = P.gaussian_noise(nchw(x), **{k: torch.from_numpy(np.array(v))
                                       for k, v in draws.items()})
    np.testing.assert_allclose(nhwc(out), ref, atol=1e-5)


def test_noise_ops_match_jax_statistics():
    x = _rand(6, 8, 32, 32, 3)
    for port, jax_fn in ((P.add_gaussian_noise, J.add_gaussian_noise_jax),
                         (P.add_speckle_noise, J.add_speckle_noise_jax),
                         (P.add_poisson_noise, J.add_poisson_noise_jax),
                         (P.add_jpeg_noise, J.add_jpeg_noise_jax)):
        out = port(nchw(x), torch.Generator().manual_seed(0))
        ref = np.asarray(jax.jit(jax_fn)(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
        assert 0 <= float(out.min()) and float(out.max()) <= 1
        e_port = np.abs(nhwc(out) - x).mean()
        e_jax = np.abs(ref - x).mean()
        assert 0.5 < e_port / e_jax < 2.0, (port.__name__, e_port, e_jax)


def test_quality_to_factor_and_diff_round_exact():
    # against the jitted JAX functions: the pipeline runs under jit, where
    # XLA multiplies by 1/100 instead of dividing (qualities 13, 15, ...
    # differ from eager JAX by an ulp, and quality 95 moves 4 entries of
    # round(Y_TABLE * factor))
    q = np.arange(1, 101, dtype=np.float32)
    np.testing.assert_array_equal(
        PJ.quality_to_factor(torch.from_numpy(q)).numpy(),
        np.asarray(jax.jit(JJ.quality_to_factor)(q)))
    v = np.concatenate([np.arange(-40, 40, dtype=np.float32) / 8,
                        _rand(7, 200) * 100 - 50])
    np.testing.assert_array_equal(
        PJ.diff_round(torch.from_numpy(v)).numpy(),
        np.asarray(jax.jit(JJ.diff_round)(jnp.asarray(v))))
    np.testing.assert_array_equal(PJ._dct_basis()[0], JJ._dct_basis()[0])
    np.testing.assert_array_equal(PJ._dct_basis()[1], JJ._dct_basis()[1])


@pytest.mark.parametrize('differentiable', [False, True])
def test_jpeg_compress_matches_jax(differentiable):
    # 40 x 56: padded with edge values to 48 x 64 and cropped back
    x = _rand(8, 4, 40, 56, 3)
    q = np.array([30, 50, 75, 95], np.float32)
    ref = np.asarray(jax.jit(JJ.jpeg_compress, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(q).reshape(4, 1, 1, 1, 1), differentiable))
    out = nhwc(PJ.jpeg_compress(nchw(x), torch.from_numpy(q),
                                differentiable=differentiable))
    assert out.shape == x.shape
    # round(coeff / q) may flip a quantum on a near-tie between two f32
    # summation orders (a whole block moves): bound the share, not the max
    err = np.abs(out - ref)
    assert (err <= 1e-4).mean() >= 0.999 and err.mean() <= 1e-5, (
        (err <= 1e-4).mean(), err.mean())
    assert np.abs(out - x).mean() > 1e-3       # it did compress


def test_shuffled_order_keeps_rescale_before_downsample():
    firsts = set()
    for seed in range(200):
        order = P._shuffled_order(np.random.default_rng(seed))
        assert sorted(order) == list(range(7))
        assert order.index(P.RESCALE) < order.index(P.DOWNSAMPLE)
        firsts.add(order[0])
    assert firsts == set(range(7)) - {P.DOWNSAMPLE}


@pytest.mark.parametrize('sf', [2, 4])
def test_degradation_bsrgan_shapes_range_and_determinism(sf):
    gt = torch.from_numpy(_rand(9, 2, 3, 64, 64))
    lq = P.degradation_bsrgan(gt, torch.Generator().manual_seed(0), sf=sf)
    assert lq.shape == (2, 3, 64 // sf, 64 // sf) and lq.dtype == torch.float32
    assert 0 <= float(lq.min()) and float(lq.max()) <= 1
    again = P.degradation_bsrgan(gt, torch.Generator().manual_seed(0), sf=sf)
    assert torch.equal(lq, again)
    other = P.degradation_bsrgan(gt, torch.Generator().manual_seed(1), sf=sf)
    assert (lq - other).abs().max() > 1e-3
    # the same draws give the same LQ through apply_degradation
    draws = P.draw_degradation(torch.Generator().manual_seed(0), gt.shape, sf)
    assert torch.equal(P.apply_degradation(gt, draws.to('cpu'), sf), lq)


def test_degradation_statistics_match_jax():
    """Mean error against a clean MATLAB-bicubic downsample within 0.5-2x
    of the JAX pipeline's on the same GT, over 12 seeds of a batch of 4."""
    import cv2
    base = _rand(10, 16, 16, 3)
    gt = cv2.resize(base, (64, 64), interpolation=cv2.INTER_CUBIC).clip(0, 1)
    clean = JR.imresize_np(gt, 0.25)
    batch = np.repeat(gt[None], 4, axis=0)
    port, ref = [], []
    for seed in range(12):
        lq = P.degradation_bsrgan(nchw(batch),
                                  torch.Generator().manual_seed(seed), sf=4)
        port.append(np.abs(nhwc(lq) - clean).mean())
        lq_j, _ = J.degradation_bsrgan_jax(jax.random.PRNGKey(seed),
                                           jnp.asarray(batch), sf=4)
        ref.append(np.abs(np.asarray(lq_j) - clean).mean())
    p, r = np.mean(port), np.mean(ref)
    assert p > 0.005, f'port degradation too weak: {p}'
    assert 0.5 < p / r < 2.0, f'port / JAX degradation: {p} vs {r}'
