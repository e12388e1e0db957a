"""BSRGAN degradation synthesis on the device (counterpart of
femasr_tpu/ops/degradations_jax.py).

The LQ batch of the on-device LQ stage: per-sample random Gaussian blur
kernels built in closed form, blur as one grouped depthwise convolution,
rescaling as products with resize matrices, noise drawn on the device and
JPEG through the DCT-quantization op with a quality per sample, all in
stock PyTorch ops on the batch's device.

As in the JAX package, every op keeps the full canvas: a rescale is a
down -> up round trip, and the one true decimation to S/sf comes at the
end, before the final JPEG. The op order is shuffled with the random
rescale kept before the to-1/sf downsample; the camera ISP op is absent
(the release configs' isp_model=None).

Randomness comes in two parts (`draw_degradation`). The batch-level
choices (op order, the x2 pre-downsample and its method, the rescale
scale and method, the downsample method, the mid-pipeline JPEG gate and
the final method) are drawn on the host, so they become Python branches
with no device-to-host read. The per-sample draws (kernels, noise levels,
modes and fields, JPEG qualities) are drawn with the caller's generator on
its device. `apply_degradation` is deterministic given the draws, so the
same draws give the same LQ on the card and on the CPU. Nothing in a warm
call synchronizes with the host: the resize matrices and JPEG constants
stay on the device, and the per-sample 3x3 factors of the correlated noise
are built in closed form. A division by a constant is written as the
product with its reciprocal, as XLA compiles the JAX package's jitted
pipeline, which is also what the card computes for a division by a Python
number.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .diffjpeg import jpeg_compress
from .resize import matlab_resize_matrix, on_device, resize_with

CANVAS_SCALES = (0.25, 0.375, 0.5, 0.625, 0.75, 0.875)
MAX_KSIZE = 25
# the op ids of the shuffled pipeline
BLUR1, BLUR2, RESCALE, DOWNSAMPLE, NOISE, JPEG, ISP = range(7)


# -- kernels ------------------------------------------------------------------

def _kernel_grid(ksize: int) -> np.ndarray:
    """(2, k, k): x (columns) and y (rows) offsets from the centre."""
    coords = np.arange(ksize, dtype=np.float32) - (ksize // 2)
    return np.stack(np.meshgrid(coords, coords))


def gaussian_kernels(theta: torch.Tensor, l12: torch.Tensor,
                     sigma: torch.Tensor, aniso: torch.Tensor,
                     radius: torch.Tensor, ksize: int = MAX_KSIZE
                     ) -> torch.Tensor:
    """(B, k, k) normalized kernels from per-sample draws: anisotropic
    (rotation theta, variances l12 (B, 2)) where `aniso`, else isotropic
    (sigma), truncated to |x|, |y| <= radius."""
    xx, yy = on_device(_kernel_grid, (ksize,), theta.device)
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    l1 = torch.clamp_min(l12[:, 0], 1e-3)[:, None, None]
    l2 = torch.clamp_min(l12[:, 1], 1e-3)[:, None, None]
    # the inverse covariance of the rotated anisotropic Gaussian
    inv_a = c * c / l1 + s * s / l2
    inv_b = c * s / l1 - c * s / l2
    inv_d = s * s / l1 + c * c / l2
    quad_aniso = inv_a * xx * xx + 2 * inv_b * xx * yy + inv_d * yy * yy
    sig2 = torch.clamp_min(sigma, 1e-3)[:, None, None] ** 2
    quad_iso = (xx * xx + yy * yy) / sig2
    quad = torch.where(aniso[:, None, None], quad_aniso, quad_iso)
    r = radius[:, None, None]
    k = torch.exp(-0.5 * quad) * ((xx.abs() <= r) & (yy.abs() <= r))
    return k / k.sum(dim=(1, 2), keepdim=True)


def random_gaussian_kernels(generator: torch.Generator, batch: int, sf: int,
                            ksize: int = MAX_KSIZE) -> torch.Tensor:
    """Per-sample random blur kernels (B, k, k) on the generator's device:
    half anisotropic with l1, l2 ~ U(0, 4+sf), theta ~ U(0, pi), half
    isotropic with sigma ~ U(0, 2+0.2sf); truncation radius in
    {3.5, ..., 12.5} (the kernel sizes 7..25)."""
    dev = generator.device
    u = functools.partial(torch.rand, generator=generator, device=dev)
    theta = u((batch,)) * math.pi
    l12 = u((batch, 2)) * (4.0 + sf)
    sigma = u((batch,)) * (2.0 + 0.2 * sf)
    aniso = u((batch,)) < 0.5
    radius = torch.randint(2, 12, (batch,), generator=generator,
                           device=dev).float() + 1.5
    return gaussian_kernels(theta, l12, sigma, aniso, radius, ksize)


def depthwise_blur(x: torch.Tensor, kernels: torch.Tensor) -> torch.Tensor:
    """Blur (B, C, H, W) with per-sample (B, k, k) kernels, reflect
    boundary (H, W > k // 2). A true convolution: F.conv2d correlates, so
    the kernels are flipped."""
    b, c, h, w = x.shape
    k = kernels.shape[-1]
    p = k // 2
    xp = F.pad(x, (p, p, p, p), mode='reflect')
    wt = kernels.flip(-2, -1)[:, None].repeat_interleave(c, dim=0)
    out = F.conv2d(xp.reshape(1, b * c, h + 2 * p, w + 2 * p), wt,
                   groups=b * c)
    return out.reshape(b, c, h, w)


# -- resizing -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _area_matrix(in_len: int, out_len: int) -> np.ndarray:
    """cv2 INTER_AREA-style averaging matrix (out, in)."""
    mat = np.zeros((out_len, in_len), np.float32)
    ratio = in_len / out_len
    for o in range(out_len):
        lo, hi = o * ratio, (o + 1) * ratio
        i0, i1 = int(math.floor(lo)), int(math.ceil(hi))
        for i in range(i0, min(i1, in_len)):
            mat[o, i] = min(hi, i + 1) - max(lo, i)
        mat[o] /= mat[o].sum()
    return mat


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(in_len: int, out_len: int) -> np.ndarray:
    """Half-pixel bilinear resize matrix (out, in) (cv2 INTER_LINEAR)."""
    mat = np.zeros((out_len, in_len), np.float32)
    scale = in_len / out_len
    for o in range(out_len):
        src = (o + 0.5) * scale - 0.5
        i0 = int(math.floor(src))
        frac = src - i0
        ia = min(max(i0, 0), in_len - 1)
        ib = min(max(i0 + 1, 0), in_len - 1)
        mat[o, ia] += 1 - frac
        mat[o, ib] += frac
    return mat


def resize_branches(h: int, w: int, oh: int, ow: int,
                    device: torch.device) -> list:
    """[bilinear, bicubic (MATLAB), area] resizes (..., h, w) ->
    (..., oh, ow); area upscaling degenerates to bilinear."""
    def mats(builder, *extra):
        return (on_device(builder, (h, oh) + extra[:1], device),
                on_device(builder, (w, ow) + extra[1:], device))

    def bilinear(x):
        return resize_with(*mats(_bilinear_matrix), x)

    def bicubic(x):
        return resize_with(*mats(matlab_resize_matrix, oh / h, ow / w), x)

    def area(x):
        if oh >= h:
            return bilinear(x)
        return resize_with(*mats(_area_matrix), x)

    return [bilinear, bicubic, area]


def canvas_rescale(x: torch.Tensor, scale: float, method: int
                   ) -> torch.Tensor:
    """Down -> up round trip of the canvas at `scale` with interpolation
    `method` (0 bilinear, 1 bicubic, 2 area)."""
    h, w = x.shape[-2:]
    oh, ow = max(int(round(h * scale)), 8), max(int(round(w * scale)), 8)
    down = resize_branches(h, w, oh, ow, x.device)[method](x)
    up = resize_branches(oh, ow, h, w, x.device)[method](down)
    return torch.clamp(up, 0.0, 1.0)


# -- noise ----------------------------------------------------------------------

def _orthonormal_columns(a: torch.Tensor) -> torch.Tensor:
    """Q of the QR factorization of (B, 3, 3) matrices, up to the sign of
    each column (Gram-Schmidt in elementwise ops: no solver, no sync)."""
    cols = []
    for j in range(3):
        v = a[:, :, j]
        for q in cols:
            v = v - (q * v).sum(dim=1, keepdim=True) * q
        cols.append(v / torch.linalg.vector_norm(v, dim=1, keepdim=True))
    return torch.stack(cols, dim=2)


def _cholesky3(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (B, 3, 3) SPD matrices in closed form
    (elementwise ops: no solver, no info check, no sync)."""
    l00 = torch.sqrt(a[:, 0, 0])
    l10 = a[:, 1, 0] / l00
    l20 = a[:, 2, 0] / l00
    l11 = torch.sqrt(a[:, 1, 1] - l10 * l10)
    l21 = (a[:, 2, 1] - l20 * l10) / l11
    l22 = torch.sqrt(a[:, 2, 2] - l20 * l20 - l21 * l21)
    zero = torch.zeros_like(l00)
    return torch.stack([l00, zero, zero, l10, l11, zero, l20, l21, l22],
                       dim=1).reshape(-1, 3, 3)


def draw_gaussian_noise(generator: torch.Generator, shape: Sequence[int],
                        noise_level1: int = 2, noise_level2: int = 25
                        ) -> Dict[str, torch.Tensor]:
    """Per-sample draws of `gaussian_noise` for a (B, C, H, W) batch: the
    level (an integer in [noise_level1, noise_level2], over 255), the mode,
    the colour / correlated field n1 (B, C, H, W), the grey field n2
    (B, 1, H, W) and the covariance's raw factors u (B, 3, 3), d (B, 3)."""
    b, c, h, w = shape
    dev = generator.device
    kw = dict(generator=generator, device=dev)
    return dict(
        level=torch.randint(noise_level1, noise_level2 + 1, (b,),
                            **kw).float() * (1 / 255.0),
        mode=torch.rand((b,), **kw),
        n1=torch.randn((b, c, h, w), **kw),
        n2=torch.randn((b, 1, h, w), **kw),
        u=torch.rand((b, 3, 3), **kw),
        d=torch.rand((b, 3), **kw))


def gaussian_noise(x: torch.Tensor, level: torch.Tensor, mode: torch.Tensor,
                   n1: torch.Tensor, n2: torch.Tensor, u: torch.Tensor,
                   d: torch.Tensor, noise_level2: float = 25.0
                   ) -> torch.Tensor:
    """Three-mode Gaussian noise from its draws, per sample: colour
    (mode > 0.6), grey (mode < 0.4), else channel-correlated with
    covariance |L^2 U^T D U| (U orthonormalized from u, D = diag(d),
    L = noise_level2 / 255). The colour and correlated modes share the
    field n1, as in the JAX package: a sample takes only one mode."""
    level = level.reshape(-1, 1, 1, 1)
    mode = mode.reshape(-1, 1, 1, 1)
    color = n1 * level
    gray = n2 * level
    q = _orthonormal_columns(u)
    ll = noise_level2 / 255.0
    cov = torch.abs(ll ** 2 * torch.einsum('bji,bj,bjl->bil', q, d, q))
    chol = _cholesky3(cov + 1e-12 * torch.eye(3, device=x.device))
    corr = torch.einsum('bchw,bdc->bdhw', n1, chol)
    noise = torch.where(mode > 0.6, color,
                        torch.where(mode < 0.4, gray, corr))
    return torch.clamp(x + noise, 0.0, 1.0)


def add_gaussian_noise(x: torch.Tensor, generator: torch.Generator,
                       noise_level1: int = 2, noise_level2: int = 25
                       ) -> torch.Tensor:
    return gaussian_noise(x, **draw_gaussian_noise(
        generator, x.shape, noise_level1, noise_level2),
        noise_level2=noise_level2)


def add_speckle_noise(x: torch.Tensor, generator: torch.Generator,
                      noise_level1: int = 2, noise_level2: int = 25
                      ) -> torch.Tensor:
    """Multiplicative speckle noise, a level per sample."""
    kw = dict(generator=generator, device=generator.device)
    level = torch.randint(noise_level1, noise_level2 + 1,
                          (x.shape[0], 1, 1, 1), **kw).float() * (1 / 255.0)
    x = torch.clamp(x, 0.0, 1.0)
    return torch.clamp(x + x * torch.randn(x.shape, **kw) * level, 0.0, 1.0)


def add_poisson_noise(x: torch.Tensor, generator: torch.Generator
                      ) -> torch.Tensor:
    """Shot noise with vals in 10^[2, 4] per sample, as a Gaussian of the
    Poisson's variance (tight for vals >= 100)."""
    kw = dict(generator=generator, device=generator.device)
    vals = 10 ** (2 * torch.rand((x.shape[0], 1, 1, 1), **kw) + 2.0)
    xq = torch.clamp(torch.round(x * 255.0), 0, 255) * (1 / 255.0)
    std = torch.sqrt(torch.clamp_min(xq, 1e-6) / vals)
    return torch.clamp(xq + torch.randn(x.shape, **kw) * std, 0.0, 1.0)


def draw_jpeg_quality(generator: torch.Generator, batch: int,
                      q_low: int = 30, q_high: int = 95) -> torch.Tensor:
    """A JPEG quality per sample, an integer in [q_low, q_high] (float)."""
    return torch.randint(q_low, q_high + 1, (batch,), generator=generator,
                         device=generator.device).float()


def add_jpeg_noise(x: torch.Tensor, generator: torch.Generator,
                   q_low: int = 30, q_high: int = 95) -> torch.Tensor:
    """JPEG round trip at a random quality per sample."""
    return jpeg_compress(x, draw_jpeg_quality(generator, x.shape[0], q_low,
                                              q_high), differentiable=False)


# -- the pipeline -----------------------------------------------------------------

def _shuffled_order(rng: np.random.Generator) -> List[int]:
    """A random order of the 7 ops with the rescale before the to-1/sf
    downsample (the two swap places when drawn the other way)."""
    order = rng.permutation(7).tolist()
    i, j = order.index(RESCALE), order.index(DOWNSAMPLE)
    if i > j:
        order[i], order[j] = order[j], order[i]
    return order


@dataclasses.dataclass
class DegradationDraws:
    """The random choices of one `apply_degradation` call. Batch-level
    (host): op order, the x2 pre-downsample's method (None: no
    pre-downsample), the rescale's scale index and method, the downsample
    method, the mid-pipeline JPEG gate, the final method. Per sample
    (tensors): the two blur kernels, the Gaussian noise draws, the two
    JPEG qualities."""
    order: List[int]
    pre_method: Optional[int]
    scale_idx: int
    resize_method: int
    down_method: int
    jpeg_mid: bool
    final_method: int
    kernels1: torch.Tensor
    kernels2: torch.Tensor
    noise: Dict[str, torch.Tensor]
    q_mid: torch.Tensor
    q_final: torch.Tensor

    def to(self, device) -> 'DegradationDraws':
        return dataclasses.replace(
            self, kernels1=self.kernels1.to(device),
            kernels2=self.kernels2.to(device),
            noise={k: v.to(device) for k, v in self.noise.items()},
            q_mid=self.q_mid.to(device), q_final=self.q_final.to(device))


def draw_degradation(generator: torch.Generator, shape: Sequence[int],
                     sf: int = 4) -> DegradationDraws:
    """The draws of one degradation of a (B, C, H, W) batch.

    The batch-level choices come from a numpy generator seeded with the
    torch generator's state at the call (a card generator keeps its seed
    and offset on the host, so reading it does not synchronize); the
    per-sample draws then advance the generator, so the next call with it
    draws anew."""
    rng = np.random.default_rng(generator.get_state().numpy())
    pre_method = None
    if sf == 4 and rng.random() < 0.25:
        pre_method = int(rng.integers(3))
    order = _shuffled_order(rng)
    scale_idx = int(rng.integers(len(CANVAS_SCALES)))
    resize_method, down_method, final_method = (
        int(m) for m in rng.integers(3, size=3))
    jpeg_mid = bool(rng.random() < 0.9)

    b = shape[0]
    return DegradationDraws(
        order=order, pre_method=pre_method, scale_idx=scale_idx,
        resize_method=resize_method, down_method=down_method,
        jpeg_mid=jpeg_mid, final_method=final_method,
        kernels1=random_gaussian_kernels(generator, b, sf),
        kernels2=random_gaussian_kernels(generator, b, sf),
        noise=draw_gaussian_noise(generator, shape),
        q_mid=draw_jpeg_quality(generator, b),
        q_final=draw_jpeg_quality(generator, b))


def degradation_stages(draws: DegradationDraws, h: int, w: int, sf: int = 4
                       ) -> List[Tuple[str, Callable]]:
    """The ops of one degradation of an H x W canvas, in order, as
    (name, fn) pairs; each fn maps a (B, 3, ., .) batch to the next. The
    camera ISP op is absent (isp_model=None) and the mid-pipeline JPEG
    takes its place only when its gate is open."""
    bind = functools.partial
    ops = {BLUR1: ('blur1', bind(depthwise_blur, kernels=draws.kernels1)),
           BLUR2: ('blur2', bind(depthwise_blur, kernels=draws.kernels2)),
           RESCALE: ('rescale', bind(
               canvas_rescale, scale=CANVAS_SCALES[draws.scale_idx],
               method=draws.resize_method)),
           # the to-1/sf low-pass, kept on the canvas
           DOWNSAMPLE: ('downsample', bind(canvas_rescale, scale=1.0 / sf,
                                           method=draws.down_method)),
           NOISE: ('noise', bind(gaussian_noise, **draws.noise)),
           JPEG: ('jpeg', bind(jpeg_compress, quality=draws.q_mid,
                               differentiable=False))}
    stages = []
    if draws.pre_method is not None:
        stages.append(('pre-downsample', bind(canvas_rescale, scale=0.5,
                                              method=draws.pre_method)))
    stages += [ops[op] for op in draws.order
               if op != ISP and (op != JPEG or draws.jpeg_mid)]
    # the true decimation to S/sf, then the final JPEG
    decimate = resize_branches(h, w, h // sf, w // sf,
                               draws.kernels1.device)[draws.final_method]
    stages += [('decimate', lambda x: torch.clamp(decimate(x), 0.0, 1.0)),
               ('final jpeg', bind(jpeg_compress, quality=draws.q_final,
                                   differentiable=False))]
    return stages


def apply_degradation(gt: torch.Tensor, draws: DegradationDraws,
                      sf: int = 4) -> torch.Tensor:
    """The LQ batch (B, 3, H/sf, W/sf) of a GT batch (B, 3, H, W) in
    [0, 1] (H, W > 24 and divisible by sf) under the given draws."""
    img = gt.float()
    for _, op in degradation_stages(draws, *gt.shape[-2:], sf):
        img = op(img)
    return img


def degradation_bsrgan(gt: torch.Tensor, generator: torch.Generator,
                       sf: int = 4) -> torch.Tensor:
    """Batched BSRGAN degradation of a GT batch (B, 3, H, W) in [0, 1] on
    the generator's device: the LQ batch (B, 3, H/sf, W/sf), float32."""
    return apply_degradation(gt, draw_degradation(generator, gt.shape, sf),
                             sf)
