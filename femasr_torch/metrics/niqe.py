"""NIQE, the Natural Image Quality Evaluator (counterpart of
femasr_tpu/metrics/niqe.py; numpy and cv2 on the host, as there).

MSCN coefficients, GGD / AGGD feature fits, multiscale 96x96 block
features, and the distance to a pristine multivariate Gaussian. The
standard pristine parameters are not redistributable, so
`fit_niqe_params` derives them from a folder of pristine images, and
`load_niqe_pris_params` reads basicsr's and MATLAB's files.
"""

from __future__ import annotations

import math
from typing import Tuple

import cv2
import numpy as np

from ..data.data_util import make_dataset
from ..utils.matlab_functions import rgb2ycbcr

_GAMMA_RANGE = np.arange(0.2, 10.001, 0.001)
_GAMMA_LOOKUP = (np.square(np.vectorize(math.gamma)(2.0 / _GAMMA_RANGE))
                 / (np.vectorize(math.gamma)(1.0 / _GAMMA_RANGE)
                    * np.vectorize(math.gamma)(3.0 / _GAMMA_RANGE)))


def estimate_ggd_param(vec: np.ndarray) -> Tuple[float, float]:
    """Generalized Gaussian distribution (alpha, sigma) moment estimate."""
    sigma_sq = np.mean(vec ** 2)
    sigma = math.sqrt(sigma_sq)
    e = np.mean(np.abs(vec))
    rho = sigma_sq / (e ** 2 + 1e-12)
    idx = np.argmin(np.abs(_GAMMA_LOOKUP - 1.0 / (rho + 1e-12)))
    return float(_GAMMA_RANGE[idx]), sigma


def estimate_aggd_param(vec: np.ndarray) -> Tuple[float, float, float]:
    """Asymmetric GGD (alpha, beta_l, beta_r) estimate.

    Canonical Lasmar/basicsr estimator: r_hat = E[|x|]^2 / E[x^2], then
    r_hat_norm = r_hat * (g^3+1)(g+1)/(g^2+1)^2 with g = sigma_l/sigma_r,
    and alpha = argmin (r_gam - r_hat_norm)^2 over the gamma lookup.
    """
    left = vec[vec < 0]
    right = vec[vec >= 0]
    sigma_l = math.sqrt(np.mean(left ** 2)) if left.size else 1e-6
    sigma_r = math.sqrt(np.mean(right ** 2)) if right.size else 1e-6
    gamma_hat = sigma_l / (sigma_r + 1e-12)
    e = np.mean(np.abs(vec))
    r_hat = (e ** 2) / (np.mean(vec ** 2) + 1e-12)
    r_hat_norm = r_hat * (gamma_hat ** 3 + 1) * (gamma_hat + 1) / (
        (gamma_hat ** 2 + 1) ** 2)
    idx = np.argmin((_GAMMA_LOOKUP - r_hat_norm) ** 2)
    alpha = float(_GAMMA_RANGE[idx])
    g1 = math.gamma(1 / alpha)
    g2 = math.gamma(2 / alpha)
    g3 = math.gamma(3 / alpha)
    beta_l = sigma_l * math.sqrt(g1 / g3)
    beta_r = sigma_r * math.sqrt(g1 / g3)
    del g2
    return alpha, beta_l, beta_r


def _mscn(img: np.ndarray,
          window: np.ndarray | None = None) -> np.ndarray:
    """Mean-subtracted contrast-normalized coefficients (7x7 Gaussian).

    When `window` is given (e.g. the `gaussian_window` stored in basicsr's
    niqe_pris_params.npz) it is used verbatim via filter2D for canonical
    agreement; the default GaussianBlur((7,7), 7/6) kernel is the same
    normalized window.
    """
    if window is None:
        mu = cv2.GaussianBlur(img, (7, 7), 7 / 6)
        ex2 = cv2.GaussianBlur(img * img, (7, 7), 7 / 6)
    else:
        w = np.asarray(window, np.float64)
        w = w / w.sum()
        # basicsr's NIQE convolves with scipy mode='nearest' (edge
        # replicate) — match it so border blocks agree and scores are
        # literature-comparable
        mu = cv2.filter2D(img, -1, w, borderType=cv2.BORDER_REPLICATE)
        ex2 = cv2.filter2D(img * img, -1, w,
                           borderType=cv2.BORDER_REPLICATE)
    sigma = np.sqrt(np.abs(ex2 - mu * mu))
    return (img - mu) / (sigma + 1.0)


def _block_features(mscn: np.ndarray) -> np.ndarray:
    """18 NSS features for one block: GGD of MSCN + AGGD of 4 pairwise
    products."""
    feats = []
    alpha, sigma = estimate_ggd_param(mscn.flatten())
    feats += [alpha, sigma ** 2]
    shifts = [(0, 1), (1, 0), (1, 1), (1, -1)]
    for dy, dx in shifts:
        shifted = np.roll(np.roll(mscn, dy, axis=0), dx, axis=1)
        pair = (mscn * shifted).flatten()
        alpha, beta_l, beta_r = estimate_aggd_param(pair)
        g1 = math.gamma(1 / alpha)
        g2 = math.gamma(2 / alpha)
        mean = (beta_r - beta_l) * (g2 / g1)
        feats += [alpha, mean, beta_l ** 2, beta_r ** 2]
    return np.asarray(feats, np.float64)


def niqe_features(img_gray: np.ndarray, block: int = 96,
                  window: np.ndarray | None = None) -> np.ndarray:
    """(n_blocks, 36) multiscale NSS features of a [0,255] grayscale image."""
    h, w = img_gray.shape
    nbh, nbw = h // block, w // block
    img_gray = img_gray[:nbh * block, :nbw * block].astype(np.float64)

    feats_scales = []
    cur = img_gray
    for scale in range(2):
        mscn = _mscn(cur, window)
        b = block // (2 ** scale)
        feats = []
        for by in range(nbh):
            for bx in range(nbw):
                blk = mscn[by * b:(by + 1) * b, bx * b:(bx + 1) * b]
                feats.append(_block_features(blk))
        feats_scales.append(np.stack(feats))
        if scale == 0:
            cur = cv2.resize(cur, (cur.shape[1] // 2, cur.shape[0] // 2),
                             interpolation=cv2.INTER_AREA)
    return np.concatenate(feats_scales, axis=1)


def calculate_niqe(img: np.ndarray, mu_pris: np.ndarray,
                   cov_pris: np.ndarray, crop_border: int = 0,
                   gaussian_window: np.ndarray | None = None,
                   **kwargs) -> float:
    """NIQE score of a [0,1] HWC RGB (or HW gray) image; lower is better."""
    if img.ndim == 3 and img.shape[2] == 3:
        gray = rgb2ycbcr(img.astype(np.float32), y_only=True)
    else:
        gray = img
    gray = np.asarray(gray, np.float64) * 255.0
    if crop_border:
        gray = gray[crop_border:-crop_border, crop_border:-crop_border]

    feats = niqe_features(gray, window=gaussian_window)
    mu_img = np.nanmean(feats, axis=0)
    diff = feats - mu_img
    mask = ~np.isnan(diff).any(axis=1)
    cov_img = np.cov(feats[mask].T)
    cov = (cov_pris + cov_img) / 2.0
    inv = np.linalg.pinv(cov)
    d = mu_pris - mu_img
    return float(math.sqrt(max(d @ inv @ d, 0.0)))


def load_niqe_pris_params(path: str
                          ) -> Tuple[np.ndarray, np.ndarray,
                                     np.ndarray | None]:
    """Load pristine-MVG parameters from any of the standard artifacts.

    Supported layouts (auto-detected by key):
    - basicsr `niqe_pris_params.npz`: keys `mu_pris_param` ((1,36) or
      (36,)), `cov_pris_param` (36,36), `gaussian_window` (7,7)
    - the original MATLAB release `modelparameters.mat` (via scipy.io):
      keys `pop_mu`, `pop_cov`
    - a fitted cache (`fit_niqe_params`, saved with np.savez): keys `mu`,
      `cov`

    Returns (mu (36,), cov (36,36), gaussian_window or None). With the
    basicsr artifact the returned window makes `calculate_niqe` produce
    literature-comparable numbers.
    """
    if path.endswith('.mat'):
        from scipy.io import loadmat
        data = loadmat(path)
    else:
        data = dict(np.load(path))
    for mu_key, cov_key in (('mu_pris_param', 'cov_pris_param'),
                            ('pop_mu', 'pop_cov'), ('mu', 'cov')):
        if mu_key in data:
            mu = np.asarray(data[mu_key], np.float64).reshape(-1)
            cov = np.asarray(data[cov_key], np.float64)
            win = data.get('gaussian_window')
            if win is not None:
                win = np.asarray(win, np.float64)
            if mu.shape != (36,) or cov.shape != (36, 36):
                raise ValueError(f'unexpected NIQE param shapes {mu.shape}/'
                                 f'{cov.shape}')
            return mu, cov, win
    raise KeyError(
        f'{path}: no recognized NIQE param keys (have {sorted(data)})')


def fit_niqe_params(pristine_dir: str, block: int = 96
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Fit the pristine MVG (mu, cov) from a folder of high-quality images."""
    all_feats = []
    for p in make_dataset(pristine_dir):
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            continue
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.
        gray = np.asarray(rgb2ycbcr(rgb, y_only=True), np.float64) * 255.0
        if gray.shape[0] < block or gray.shape[1] < block:
            continue
        all_feats.append(niqe_features(gray, block))
    feats = np.concatenate(all_feats, axis=0)
    feats = feats[~np.isnan(feats).any(axis=1)]
    return feats.mean(axis=0), np.cov(feats.T)
