"""Device prefetch of training batches (counterpart of
femasr_tpu/data/loader.py `DevicePrefetcher`).

On a card, while the caller works on batch N, batch N+1 is already being
copied from the loader's pinned host memory on a CUDA stream of its own.
Handing a batch over, the prefetcher makes the caller's stream wait for
that copy's event and records the staged tensors as used on the caller's
stream, so the caching allocator does not reuse their memory while the
caller's work is queued. Nothing here synchronizes the host with the
card. A CPU tensor that is not pinned is refused (its copy would be
synchronous). On the CPU the prefetcher passes the loader's batches
through.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, Optional, Tuple

import torch


class DevicePrefetcher:
    """Iterate `loader`'s batches (dicts; tensors are staged, other values
    passed as they are) as tensors on `device`, batch N+1's copy in flight
    while the caller works on batch N."""

    def __init__(self, loader: Iterable, device):
        self.loader = loader
        self.device = torch.device(device)
        self.stream: Optional[torch.cuda.Stream] = None

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        if self.device.type != 'cuda':
            yield from self.loader
            return
        if self.device.index is None:
            self.device = torch.device('cuda', torch.cuda.current_device())
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        batches = iter(self.loader)
        staged = self._stage(next(batches, None))
        while staged is not None:
            batch, ready = staged
            staged = self._stage(next(batches, None))
            yield self._hand_over(batch, ready)

    def _stage(self, batch: Optional[Dict[str, Any]]
               ) -> Optional[Tuple[Dict[str, Any], torch.cuda.Event]]:
        """Queue the copy of each tensor of `batch` on the side stream;
        the batch of card tensors and the copies' event."""
        if batch is None:
            return None
        out = {}
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                if isinstance(v, torch.Tensor) and v.device.type == 'cpu':
                    if not v.is_pinned():
                        raise ValueError(
                            f'DevicePrefetcher: batch[{k!r}] is not in '
                            'pinned memory, so its copy would be '
                            'synchronous; build the loader with '
                            'pin_memory=True')
                    v = v.to(self.device, non_blocking=True)
                out[k] = v
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return out, ready

    def _hand_over(self, batch: Dict[str, Any], ready: torch.cuda.Event
                   ) -> Dict[str, Any]:
        current = torch.cuda.current_stream(self.device)
        current.wait_event(ready)
        for v in batch.values():
            if isinstance(v, torch.Tensor) and v.is_cuda:
                v.record_stream(current)
        return batch
