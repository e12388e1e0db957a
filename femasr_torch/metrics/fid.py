"""FID, the Frechet Inception Distance (counterpart of
femasr_tpu/metrics/fid.py).

The Frechet distance and the feature statistics are numpy / scipy, as
there; the feature extractor is any `feature_fn(batch_nhwc) -> (B, D)`,
such as `inception.InceptionV3FID` with the pt_inception weights (the
canonical backbone) or `vgg_feature_fn` (spatially pooled VGG features).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import numpy as np
import torch
from scipy import linalg

from ..data.data_util import make_dataset


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def feature_statistics(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    return np.mean(features, axis=0), np.cov(features, rowvar=False)


def extract_features(folder: str, feature_fn: Callable, batch_size: int = 8,
                     size: Optional[int] = None) -> np.ndarray:
    """`feature_fn` over every image of a folder, batched per distinct
    (H, W): at native resolution by default, so the backbone's own resize
    applies (as pytorch-fid, which never resizes on the host); size=N
    resizes each image to N x N with cv2.INTER_AREA first."""
    import cv2
    groups: dict = {}
    for p in make_dataset(folder):
        img = cv2.imread(p, cv2.IMREAD_COLOR)
        if img is None:
            continue
        rgb = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.
        if size is not None:
            rgb = cv2.resize(rgb, (size, size), interpolation=cv2.INTER_AREA)
        groups.setdefault(rgb.shape[:2], []).append(rgb)
    feats = []
    for imgs in groups.values():
        for i in range(0, len(imgs), batch_size):
            feats.append(np.asarray(feature_fn(
                np.stack(imgs[i:i + batch_size]))))
    return np.concatenate(feats, axis=0)


def vgg_feature_fn(vgg_params: Mapping[str, torch.Tensor],
                   layer: str = 'relu5_3', vgg_type: str = 'vgg16',
                   device='cpu') -> Callable:
    """Spatially pooled VGG features as an FID backbone. vgg_params: a
    VGGFeatureExtractor state dict (`models.vgg_arch`)."""
    from ..models.vgg_arch import VGGFeatureExtractor, vgg_truncated_state
    net = VGGFeatureExtractor([layer], vgg_type)
    net.load_state_dict(vgg_truncated_state(vgg_params, net))
    net.requires_grad_(False).eval().to(device)

    def fn(batch):
        x = torch.as_tensor(batch, dtype=torch.float32, device=device)
        with torch.no_grad():
            feats = net(x.permute(0, 3, 1, 2))[layer]
        return feats.mean(dim=(2, 3)).cpu().numpy()
    return fn


def _folder_or_stats(path: str, feature_fn: Callable, batch_size: int
                     ) -> Tuple[np.ndarray, np.ndarray, Optional[str]]:
    """(mu, sigma, backbone label) of an image folder, or of a stats .npz
    (keys mu, sigma and optionally backbone)."""
    if path.endswith('.npz'):
        with np.load(path) as z:
            backbone = str(z['backbone']) if 'backbone' in z else None
            return z['mu'], z['sigma'], backbone
    mu, sigma = feature_statistics(
        extract_features(path, feature_fn, batch_size))
    return mu, sigma, None


def calculate_fid(folder1: str, folder2: str, feature_fn: Callable,
                  batch_size: int = 8) -> float:
    """FID between two image folders (either may be a stats .npz)."""
    mu1, s1, b1 = _folder_or_stats(folder1, feature_fn, batch_size)
    mu2, s2, b2 = _folder_or_stats(folder2, feature_fn, batch_size)
    if b1 and b2 and b1 != b2:
        raise ValueError(f'stats backbones differ: {b1} vs {b2}')
    if mu1.shape != mu2.shape:
        raise ValueError(
            f'feature dims differ ({mu1.shape} vs {mu2.shape}): the stats '
            '.npz was computed with a different backbone than this run')
    return frechet_distance(mu1, s1, mu2, s2)
