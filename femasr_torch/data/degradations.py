"""BSRGAN degradation synthesis on the host (the port's copy of
femasr_tpu/data/degradations.py): numpy, cv2 and scipy, for the dataset
workers of BSRGANTrainDataset.

Kernel generators (anisotropic Gaussian, fspecial, gen_kernel), the stage
ops (blur, resize, Gaussian / speckle / Poisson noise, JPEG, sharpening)
and the shuffled pipelines (degradation_bsrgan, 7 ops;
degradation_bsrgan_plus, 13). Every function that draws takes an explicit
numpy.random.Generator `rng`, never the global `random` or `np.random`
state, so an item drawn from `default_rng(seed)` is the same in any worker.
"""

from __future__ import annotations

import math
from typing import Tuple

import cv2
import numpy as np

from ..ops.resize import imresize_np

_INTERPOLATIONS = (1, 2, 3)   # cv2 INTER_LINEAR, INTER_CUBIC, INTER_AREA


def _interp(rng: np.random.Generator) -> int:
    return _INTERPOLATIONS[int(rng.integers(3))]


def _randint(rng: np.random.Generator, lo: int, hi: int) -> int:
    """An integer in [lo, hi], both included (random.randint)."""
    return int(rng.integers(lo, hi + 1))


# -- kernels ------------------------------------------------------------------

def gaussian_pdf_grid(cov: np.ndarray, size: int) -> np.ndarray:
    """A zero-mean 2D Gaussian on the kernel grid, coordinates
    (x - size/2 + 0.5) for x in [0, size), normalized."""
    center = size / 2.0 + 0.5
    coords = np.arange(size, dtype=np.float64) - center + 1
    xx, yy = np.meshgrid(coords, coords)  # xx: x (cols), yy: y (rows)
    pts = np.stack([xx, yy], axis=-1)
    inv = np.linalg.inv(cov)
    det = np.linalg.det(cov)
    quad = np.einsum('...i,ij,...j->...', pts, inv, pts)
    k = np.exp(-0.5 * quad) / (2 * np.pi * math.sqrt(det))
    return k / k.sum()


def anisotropic_gaussian_kernel(ksize: int = 15, theta: float = np.pi,
                                l1: float = 6, l2: float = 6) -> np.ndarray:
    """Rotated anisotropic Gaussian kernel."""
    v = np.array([np.cos(theta), np.sin(theta)])
    V = np.array([[v[0], v[1]], [v[1], -v[0]]])
    D = np.array([[l1, 0.0], [0.0, l2]])
    cov = V @ D @ np.linalg.inv(V)
    return gaussian_pdf_grid(cov, ksize)


def fspecial_gaussian(hsize: int, sigma: float) -> np.ndarray:
    """MATLAB fspecial('gaussian')."""
    siz = (hsize - 1.0) / 2.0
    y, x = np.mgrid[-siz:siz + 1, -siz:siz + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(float).eps * h.max()] = 0
    s = h.sum()
    return h / s if s != 0 else h


def fspecial_laplacian(alpha: float) -> np.ndarray:
    alpha = max(0.0, min(alpha, 1.0))
    h1 = alpha / (alpha + 1)
    h2 = (1 - alpha) / (alpha + 1)
    return np.array([[h1, h2, h1], [h2, -4 / (alpha + 1), h2], [h1, h2, h1]])


def fspecial(filter_type: str, *args, **kwargs) -> np.ndarray:
    if filter_type == 'gaussian':
        return fspecial_gaussian(*args, **kwargs)
    if filter_type == 'laplacian':
        return fspecial_laplacian(*args, **kwargs)
    raise ValueError(filter_type)


def gen_kernel(rng: np.random.Generator, k_size=(15, 15), scale_factor=(4, 4),
               min_var: float = 0.6, max_var: float = 10.,
               noise_level: float = 0) -> np.ndarray:
    """Random-covariance Gaussian kernel, optionally with multiplicative
    noise."""
    k_size = np.asarray(k_size)
    scale_factor = np.asarray(scale_factor)
    lambda_1 = min_var + rng.random() * (max_var - min_var)
    lambda_2 = min_var + rng.random() * (max_var - min_var)
    theta = rng.random() * np.pi
    noise = -noise_level + rng.random(tuple(k_size)) * noise_level * 2

    lam = np.diag([lambda_1, lambda_2])
    q = np.array([[np.cos(theta), -np.sin(theta)],
                  [np.sin(theta), np.cos(theta)]])
    sigma = q @ lam @ q.T
    inv_sigma = np.linalg.inv(sigma)

    mu = k_size // 2 - 0.5 * (scale_factor - 1)
    xx, yy = np.meshgrid(range(k_size[0]), range(k_size[1]))
    z = np.stack([xx, yy], -1).astype(np.float64) - mu
    quad = np.einsum('...i,ij,...j->...', z, inv_sigma, z)
    raw = np.exp(-0.5 * quad) * (1 + noise)
    return raw / raw.sum()


def shift_pixel(x: np.ndarray, sf: int, upper_left: bool = True) -> np.ndarray:
    """Sub-pixel shift by (sf-1)/2 with bilinear resampling."""
    h, w = x.shape[:2]
    shift = (sf - 1) * 0.5
    xv = np.arange(w, dtype=np.float64)
    yv = np.arange(h, dtype=np.float64)
    x1 = np.clip(xv + shift if upper_left else xv - shift, 0, w - 1)
    y1 = np.clip(yv + shift if upper_left else yv - shift, 0, h - 1)

    def interp(plane):
        # separable linear interpolation on the grid
        x0 = np.floor(x1).astype(int)
        xfrac = x1 - x0
        x0p = np.minimum(x0 + 1, w - 1)
        tmp = plane[:, x0] * (1 - xfrac) + plane[:, x0p] * xfrac
        y0 = np.floor(y1).astype(int)
        yfrac = (y1 - y0)[:, None]
        y0p = np.minimum(y0 + 1, h - 1)
        return tmp[y0] * (1 - yfrac) + tmp[y0p] * yfrac

    if x.ndim == 2:
        return interp(x)
    out = x.copy()
    for c in range(x.shape[-1]):
        out[:, :, c] = interp(x[:, :, c])
    return out


def filter2d_mirror(img: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """True convolution of each channel with mirror boundary
    (scipy.ndimage.convolve, mode='mirror')."""
    from scipy import ndimage
    return ndimage.convolve(img, kernel[:, :, None], mode='mirror')


# -- stage ops ----------------------------------------------------------------

def add_sharpening(img: np.ndarray, weight: float = 0.5, radius: int = 50,
                   threshold: int = 10) -> np.ndarray:
    """USM sharpening."""
    if radius % 2 == 0:
        radius += 1
    blur = cv2.GaussianBlur(img, (radius, radius), 0)
    residual = img - blur
    mask = (np.abs(residual) * 255 > threshold).astype('float32')
    soft_mask = cv2.GaussianBlur(mask, (radius, radius), 0)
    sharp = np.clip(img + weight * residual, 0, 1)
    return soft_mask * sharp + (1 - soft_mask) * img


def add_blur(img: np.ndarray, rng: np.random.Generator,
             sf: int = 4) -> np.ndarray:
    wd2 = 4.0 + sf
    wd = 2.0 + 0.2 * sf
    if rng.random() < 0.5:
        k = anisotropic_gaussian_kernel(
            ksize=2 * _randint(rng, 2, 11) + 3, theta=rng.random() * np.pi,
            l1=wd2 * rng.random(), l2=wd2 * rng.random())
    else:
        k = fspecial('gaussian', 2 * _randint(rng, 2, 11) + 3,
                     wd * rng.random())
    return filter2d_mirror(img, k)


def add_resize(img: np.ndarray, rng: np.random.Generator,
               sf: int = 4) -> np.ndarray:
    rnum = rng.random()
    if rnum > 0.8:
        sf1 = rng.uniform(1, 2)
    elif rnum < 0.7:
        sf1 = rng.uniform(0.5 / sf, 1)
    else:
        sf1 = 1.0
    img = cv2.resize(img, (int(sf1 * img.shape[1]), int(sf1 * img.shape[0])),
                     interpolation=_interp(rng))
    return np.clip(img, 0.0, 1.0)


def _correlated(rng: np.random.Generator, noise_level2: int,
                shape) -> np.ndarray:
    """Channel-correlated noise, covariance |L^2 U^T D U|."""
    from scipy.linalg import orth
    ll = noise_level2 / 255.
    d = np.diag(rng.random(3))
    u = orth(rng.random((3, 3)))
    cov = np.abs(ll ** 2 * (u.T @ d @ u))
    return rng.multivariate_normal([0, 0, 0], cov, shape).astype(np.float32)


def add_gaussian_noise(img: np.ndarray, rng: np.random.Generator,
                       noise_level1: int = 2,
                       noise_level2: int = 25) -> np.ndarray:
    noise_level = _randint(rng, noise_level1, noise_level2)
    rnum = rng.random()
    if rnum > 0.6:  # color
        img = img + rng.normal(0, noise_level / 255.0,
                               img.shape).astype(np.float32)
    elif rnum < 0.4:  # gray
        img = img + rng.normal(0, noise_level / 255.0,
                               (*img.shape[:2], 1)).astype(np.float32)
    else:  # channel-correlated
        img = img + _correlated(rng, noise_level2, img.shape[:2])
    return np.clip(img, 0.0, 1.0)


def add_speckle_noise(img: np.ndarray, rng: np.random.Generator,
                      noise_level1: int = 2,
                      noise_level2: int = 25) -> np.ndarray:
    noise_level = _randint(rng, noise_level1, noise_level2)
    img = np.clip(img, 0.0, 1.0)
    rnum = rng.random()
    if rnum > 0.6:
        img = img + img * rng.normal(
            0, noise_level / 255.0, img.shape).astype(np.float32)
    elif rnum < 0.4:
        img = img + img * rng.normal(
            0, noise_level / 255.0, (*img.shape[:2], 1)).astype(np.float32)
    else:
        img = img + img * _correlated(rng, noise_level2, img.shape[:2])
    return np.clip(img, 0.0, 1.0)


def add_poisson_noise(img: np.ndarray, rng: np.random.Generator
                      ) -> np.ndarray:
    img = np.clip((img * 255.0).round(), 0, 255) / 255.
    vals = 10 ** (2 * rng.random() + 2.0)
    if rng.random() < 0.5:
        img = rng.poisson(img * vals).astype(np.float32) / vals
    else:
        gray = img[..., :3] @ np.array([0.299, 0.587, 0.114])
        gray = np.clip((gray * 255.0).round(), 0, 255) / 255.
        noise_gray = (rng.poisson(gray * vals).astype(np.float32) / vals
                      - gray)
        img = img + noise_gray[:, :, None]
    return np.clip(img, 0.0, 1.0)


def add_jpeg_noise(img: np.ndarray, rng: np.random.Generator = None,
                   quality: int = None) -> np.ndarray:
    """cv2 / libjpeg round trip at `quality`, or at a random one in
    [30, 95] from `rng`."""
    if quality is None:
        quality = _randint(rng, 30, 95)
    bgr = cv2.cvtColor((np.clip(img, 0, 1) * 255.0).round().astype(np.uint8),
                       cv2.COLOR_RGB2BGR)
    _, enc = cv2.imencode('.jpg', bgr, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
    dec = cv2.imdecode(enc, 1)
    return cv2.cvtColor(dec, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


def random_crop_pair(lq: np.ndarray, hq: np.ndarray, rng: np.random.Generator,
                     sf: int = 4, lq_patchsize: int = 64
                     ) -> Tuple[np.ndarray, np.ndarray]:
    h, w = lq.shape[:2]
    rnd_h = _randint(rng, 0, h - lq_patchsize)
    rnd_w = _randint(rng, 0, w - lq_patchsize)
    lq = lq[rnd_h:rnd_h + lq_patchsize, rnd_w:rnd_w + lq_patchsize, :]
    hq = hq[rnd_h * sf:(rnd_h + lq_patchsize) * sf,
            rnd_w * sf:(rnd_w + lq_patchsize) * sf, :]
    return lq, hq


# -- pipelines ----------------------------------------------------------------

def degradation_bsrgan(img: np.ndarray, rng: np.random.Generator, sf: int = 4,
                       lq_patchsize: int = 72, isp_model=None,
                       use_crop: bool = True
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """BSRGAN random-shuffled 7-op degradation of an HWC RGB [0, 1] image.
    Returns (lq, hq)."""
    isp_prob, jpeg_prob, scale2_prob = 0.25, 0.9, 0.25
    sf_ori = sf

    h1, w1 = img.shape[:2]
    # the reference's mod crop swaps h and w in its bounds; kept, so that
    # the distribution of crops is the reference's
    img = img.copy()[:w1 - w1 % sf, :h1 - h1 % sf, ...]
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f'img size ({h1}X{w1}) is too small!')

    hq = img.copy()

    if sf == 4 and rng.random() < scale2_prob:  # optional x2 pre-downsample
        if rng.random() < 0.5:
            img = cv2.resize(img, (int(img.shape[1] / 2), int(img.shape[0] / 2)),
                             interpolation=_interp(rng))
        else:
            img = imresize_np(img, 1 / 2, True)
        img = np.clip(img, 0.0, 1.0)
        sf = 2

    shuffle_order = rng.permutation(7).tolist()
    idx1, idx2 = shuffle_order.index(2), shuffle_order.index(3)
    if idx1 > idx2:  # keep the to-1/sf downsample after the random rescale
        shuffle_order[idx1], shuffle_order[idx2] = (shuffle_order[idx2],
                                                    shuffle_order[idx1])

    a, b = img.shape[1], img.shape[0]
    for i in shuffle_order:
        if i == 0 or i == 1:
            img = add_blur(img, rng, sf=sf)
        elif i == 2:
            a, b = img.shape[1], img.shape[0]
            if rng.random() < 0.75:
                sf1 = rng.uniform(1, 2 * sf)
                img = cv2.resize(img, (int(img.shape[1] / sf1),
                                       int(img.shape[0] / sf1)),
                                 interpolation=_interp(rng))
            else:
                k = fspecial('gaussian', 25, rng.uniform(0.1, 0.6 * sf))
                k_shifted = shift_pixel(k, sf)
                k_shifted = k_shifted / k_shifted.sum()
                img = filter2d_mirror(img, k_shifted)
                img = img[0::sf, 0::sf, ...]
            img = np.clip(img, 0.0, 1.0)
        elif i == 3:
            img = cv2.resize(img, (int(a / sf), int(b / sf)),
                             interpolation=_interp(rng))
            img = np.clip(img, 0.0, 1.0)
        elif i == 4:
            img = add_gaussian_noise(img, rng, noise_level1=2, noise_level2=25)
        elif i == 5:
            if rng.random() < jpeg_prob:
                img = add_jpeg_noise(img, rng)
        elif i == 6:
            if rng.random() < isp_prob and isp_model is not None:
                img, hq = isp_model.forward(img.copy(), hq)

    img = add_jpeg_noise(img, rng)

    if use_crop:
        img, hq = random_crop_pair(img, hq, rng, sf_ori, lq_patchsize)
    return img, hq


def degradation_bsrgan_plus(img: np.ndarray, rng: np.random.Generator,
                            sf: int = 4, shuffle_prob: float = 0.5,
                            use_sharp: bool = True, lq_patchsize: int = 64,
                            isp_model=None, use_crop: bool = True
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """BSRGAN+ 13-op hybrid pipeline (test-set synthesis)."""
    h1, w1 = img.shape[:2]
    img = img.copy()[:w1 - w1 % sf, :h1 - h1 % sf, ...]
    h, w = img.shape[:2]
    if h < lq_patchsize * sf or w < lq_patchsize * sf:
        raise ValueError(f'img size ({h1}X{w1}) is too small!')

    if use_sharp:
        img = add_sharpening(img)
    hq = img.copy()

    if rng.random() < shuffle_prob:
        shuffle_order = rng.permutation(13).tolist()
    else:
        shuffle_order = list(range(13))
        # local shuffle of the noise operators
        shuffle_order[2:6] = rng.permutation(shuffle_order[2:6]).tolist()
        shuffle_order[9:13] = rng.permutation(shuffle_order[9:13]).tolist()
    poisson_prob, speckle_prob, isp_prob = 0.1, 0.1, 0.1

    for i in shuffle_order:
        if i in (0, 8):
            img = add_blur(img, rng, sf=sf)
        elif i in (1, 9):
            img = add_resize(img, rng, sf=sf)
        elif i in (2, 10):
            img = add_gaussian_noise(img, rng, noise_level1=2, noise_level2=25)
        elif i in (3, 11):
            if rng.random() < poisson_prob:
                img = add_poisson_noise(img, rng)
        elif i in (4, 12):
            if rng.random() < speckle_prob:
                img = add_speckle_noise(img, rng)
        elif i == 5:
            if rng.random() < isp_prob and isp_model is not None:
                img, hq = isp_model.forward(img.copy(), hq)
        elif i == 6:
            img = add_jpeg_noise(img, rng)
        elif i == 7:
            img = imresize_np(np.clip(img, 0, 1), 1 / sf, True)
            img = np.clip(img, 0.0, 1.0)

    # resize to the LQ size if an op chain left it off the grid
    img = cv2.resize(img, (int(w / sf), int(h / sf)),
                     interpolation=_interp(rng))
    img = add_jpeg_noise(img, rng)

    if use_crop:
        img, hq = random_crop_pair(img, hq, rng, sf, lq_patchsize)
    return img, hq
