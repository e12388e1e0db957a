"""Serving: whole-image and tiled super-resolution
(counterpart of femasr_tpu/models/inference.py).

Images are NCHW float tensors in [0, 1] (`run_padded`, `run_tiled`) or HWC
numpy arrays (`__call__`, `run_bucketed`). The model runs in eval mode
under torch.inference_mode() (a live module, `model=`: torch.no_grad()) in
the chosen dtype (float32 or bfloat16) with float32 parameters; outputs are
clamped to [0, 1] in float32. With a mesh (`parallel.mesh.create_mesh`),
every forward shards its batch over the 'data' ranks, and a 'model' axis
above 1 splits the model over its ranks (counterpart of the JAX
SRInferencer's mesh= and tensor_parallel=True).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from ..parallel.mesh import data_size, gather_batch, local_slice, local_state
from ..parallel.tensor_parallel import model_axis
from .convert import load_torch_checkpoint, merge_state_dict
from .femasr_arch import FeMaSRNet, init_weights


def resolve_device(device) -> torch.device:
    """The requested device; 'cuda' without a card raises (no CPU fallback)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('CUDA device requested but torch.cuda is not '
                           'available; pass device="cpu" explicitly')
    return device


def flip_pad(x: torch.Tensor, h_pad: int, w_pad: int) -> torch.Tensor:
    """Pad bottom/right of an NCHW tensor by flip-concat
    (femasr_arch.py:459-460)."""
    h, w = x.shape[2:]
    if h_pad > 0:
        x = torch.cat([x, x.flip(2)], 2)[:, :, :h + h_pad]
    if w_pad > 0:
        x = torch.cat([x, x.flip(3)], 3)[:, :, :, :w + w_pad]
    return x


def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source indices of numpy 'reflect' padding by (lo, hi), any size."""
    idx = torch.arange(-lo, n + hi, device=device)
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n - 2
    idx = idx.remainder(period)
    return torch.where(idx < n, idx, period - idx)


def reflect_pad(x: torch.Tensor, top: int, bottom: int, left: int,
                right: int) -> torch.Tensor:
    h, w = x.shape[2:]
    x = x.index_select(2, _reflect_index(h, top, bottom, x.device))
    return x.index_select(3, _reflect_index(w, left, right, x.device))


def seeded_init(model: torch.nn.Module) -> None:
    """The serving default weights: init_weights from seed 0."""
    init_weights(model, torch.Generator().manual_seed(0))


class SRInferencer:
    """A FeMaSRNet with frozen weights on one device, plus the serving
    paths.

    lq_stage, gt_resolution, norm_type, act_type: the model, with the JAX
    SRInferencer's defaults (the LQ-stage x4 release model, gn + silu).
    lq_stage=False serves the HQ model's reconstruction (scale 1). A gn +
    silu model runs its last decoder level through the conv3 kernel; any
    other norm or activation takes the plain layers there. `in` and `bn`
    are not ported (ROADMAP A12) and raise.

    state_dict: reference-key state dict; None gives a seeded (seed 0)
    random init. It is overlaid onto that init as the JAX package's
    SRInferencer(init_merge=True) does (`convert.merge_state_dict`: unknown
    keys ignored, missing or mis-shaped parameters keep the init, the
    counts printed); strict=True loads it with load_state_dict(strict=True)
    instead. int8_tail, int8_levels, int8_enc_up, int8_swin, int8_mlp: the
    int8 serving lane of FeMaSRNet (same state dict).

    mesh: a ('data', 'model') mesh of the run's ranks: each forward's
    batch is padded to a multiple of the data axis by repeating its last
    item, each data group runs its contiguous block, and the outputs are
    gathered onto every rank. With a model axis above 1 the model is split
    over the model ranks of each data group, which run the same block
    together (`FeMaSRNet(tp=...)`; state_dict stays whole: each rank takes
    its part). max_tile_batch defaults to the data axis's size (one tile
    per data group), else 1.

    model: serve this live FeMaSRNet as it stands (the JAX SRInferencer's
    model=..., init_merge=False form; validation serves the trainee this
    way): nothing is built, loaded or moved, and the architecture
    arguments, state_dict and device are ignored. Each forward runs it in
    eval mode under torch.no_grad() and leaves its train/eval mode and its
    weights as it found them; no_grad, not inference_mode, so that a tensor
    cached during the forward (the Swin shift masks) stays usable by
    autograd in the next training step.
    """

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 codebook_params: Sequence[Sequence[int]] = ((32, 1024, 512),),
                 scale_factor: int = 4, dtype: torch.dtype = torch.float32,
                 max_tile_batch: Optional[int] = None, device='cuda',
                 int8_tail: bool = False, int8_levels: int = 1,
                 int8_enc_up: bool = False, int8_swin: bool = False,
                 int8_mlp: bool = False, strict: bool = False,
                 lq_stage: bool = True, gt_resolution: int = 256,
                 norm_type: str = 'gn', act_type: str = 'silu',
                 model: Optional[FeMaSRNet] = None, mesh=None):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f'dtype must be float32 or bfloat16, got {dtype}')
        self.dtype = dtype
        self.mesh = mesh
        self._dp = data_size(mesh) if mesh is not None else 1
        self.max_tile_batch = max_tile_batch or self._dp
        self.live = model is not None
        if self.live:
            self.device = next(model.parameters()).device
            self._set_model(model)
            return
        self.device = resolve_device(device)
        model = FeMaSRNet(codebook_params=[list(p) for p in codebook_params],
                          LQ_stage=lq_stage, scale_factor=scale_factor,
                          gt_resolution=gt_resolution, norm_type=norm_type,
                          act_type=act_type,
                          int8_tail=int8_tail, int8_levels=int8_levels,
                          int8_enc_up=int8_enc_up, int8_swin=int8_swin,
                          int8_mlp=int8_mlp, tp=model_axis(mesh))
        if state_dict is None:
            seeded_init(model)
        elif strict:
            model.load_state_dict(local_state(model, state_dict),
                                  strict=True)
        else:
            merge_state_dict(model, state_dict, seeded_init)
        self._set_model(model.to(self.device).eval())

    def _set_model(self, model: FeMaSRNet) -> None:
        self.model = model
        self.scale = model.scale_factor
        # pad target: multiple of window_size * 8 at the Swin resolution
        self.wsz = max(8 // self.scale, 1) * 8

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        """One batch through the model; under a mesh, this rank's block of
        the batch padded to the data axis, the outputs gathered."""
        if self.mesh is None:
            return self._forward(x)
        b = x.shape[0]
        pad = (-b) % self._dp
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        out = self._forward(local_slice(x, self.mesh))
        return gather_batch(out, self.mesh)[:b]

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.no_grad() if self.live else torch.inference_mode():
                out = self.model(x.to(self.device, self.dtype))[0]
                return out.float().clamp_(0.0, 1.0)
        finally:
            self.model.train(was_training)

    # -- whole image -------------------------------------------------------

    def run_padded(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [0, 1] -> (B, 3, H*s, W*s) float32, flip-padded
        to the next window multiple first."""
        h_old, w_old = x.shape[2:]
        h_pad = (h_old // self.wsz + 1) * self.wsz - h_old
        w_pad = (w_old // self.wsz + 1) * self.wsz - w_old
        out = self._run(flip_pad(x.to(self.device), h_pad, w_pad))
        return out[:, :, :h_old * self.scale, :w_old * self.scale]

    # -- tiles -------------------------------------------------------------

    def run_tiled(self, x: torch.Tensor, tile_size: int = 240,
                  tile_pad: int = 16) -> torch.Tensor:
        """Overlap-tiled SR: reflect pad, a uniform tile grid run in chunks
        of max_tile_batch, centers stitched back."""
        x = x.to(self.device)
        b, c, h, w = x.shape
        s = self.scale
        padded_tile = math.ceil((tile_size + 2 * tile_pad) / self.wsz) \
            * self.wsz
        pad_lo = (padded_tile - tile_size) // 2
        pad_hi = padded_tile - tile_size - pad_lo
        tiles_y, tiles_x = math.ceil(h / tile_size), math.ceil(w / tile_size)
        grid_h, grid_w = tiles_y * tile_size, tiles_x * tile_size
        xp = reflect_pad(x, pad_lo, grid_h - h + pad_hi, pad_lo,
                         grid_w - w + pad_hi)
        tiles = [xp[:, :, ty * tile_size:ty * tile_size + padded_tile,
                    tx * tile_size:tx * tile_size + padded_tile]
                 for ty in range(tiles_y) for tx in range(tiles_x)]
        batch = torch.cat(tiles, 0)
        outs = [self._run(batch[i:i + self.max_tile_batch])
                for i in range(0, batch.shape[0], self.max_tile_batch)]
        out_tiles = torch.cat(outs, 0)

        out = torch.zeros((b, c, grid_h * s, grid_w * s), dtype=torch.float32,
                          device=self.device)
        lo, size = pad_lo * s, tile_size * s
        for k, (ty, tx) in enumerate((ty, tx) for ty in range(tiles_y)
                                     for tx in range(tiles_x)):
            out[:, :, ty * size:(ty + 1) * size,
                tx * size:(tx + 1) * size] = \
                out_tiles[k * b:(k + 1) * b, :, lo:lo + size, lo:lo + size]
        return out[:, :, :h * s, :w * s]

    # -- folders -----------------------------------------------------------

    def run_bucketed(self, imgs, bucket: int = 64, max_batch: int = 4):
        """SR a list of HWC [0, 1] images, batching images whose
        flip-padded shapes fall in the same bucket. Returns HWC float32
        numpy outputs in input order."""
        bucket = max(bucket, self.wsz)
        groups = {}
        for i, img in enumerate(imgs):
            h, w = img.shape[:2]
            key = (math.ceil((h + 1) / bucket) * bucket,
                   math.ceil((w + 1) / bucket) * bucket)
            groups.setdefault(key, []).append(i)
        outputs = [None] * len(imgs)
        s = self.scale
        for (bh, bw), idxs in groups.items():
            for start in range(0, len(idxs), max_batch):
                chunk = idxs[start:start + max_batch]
                batch = []
                for i in chunk:
                    x = _to_nchw(imgs[i]).to(self.device)
                    batch.append(flip_pad(x, bh - x.shape[2], bw - x.shape[3]))
                out = self._run(torch.cat(batch, 0))
                for j, i in enumerate(chunk):
                    h, w = imgs[i].shape[:2]
                    outputs[i] = _to_hwc(out[j:j + 1, :, :h * s, :w * s])
        return outputs

    # -- dispatcher --------------------------------------------------------

    def __call__(self, img: np.ndarray, max_size: int = 600,
                 tile_size: int = 240, tile_pad: int = 16) -> np.ndarray:
        """SR one HWC [0, 1] RGB image: whole-image below max_size**2
        pixels, tiled above (inference_femasr.py:58-63)."""
        x = _to_nchw(img)
        h, w = img.shape[:2]
        if h * w < max_size ** 2:
            out = self.run_padded(x)
        else:
            out = self.run_tiled(x, tile_size=tile_size, tile_pad=tile_pad)
        return _to_hwc(out)


def _to_nchw(img: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(img, np.float32).transpose(2, 0, 1)))[None]


def _to_hwc(x: torch.Tensor) -> np.ndarray:
    return x[0].permute(1, 2, 0).cpu().numpy()


def load_inferencer(weight_path: str, scale_factor: int = 4,
                    dtype: torch.dtype = torch.float32, device='cuda',
                    **kwargs) -> SRInferencer:
    """SRInferencer from a reference-format torch .pth (kwargs go to
    SRInferencer: codebook_params, max_tile_batch, the int8 flags, strict,
    lq_stage, gt_resolution, norm_type, act_type, mesh)."""
    resolve_device(device)
    sd = load_torch_checkpoint(weight_path)
    return SRInferencer(sd, scale_factor=scale_factor, dtype=dtype,
                        device=device, **kwargs)
