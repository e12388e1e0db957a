"""Helpers shared by the tests/test_torch_*.py parity tests (JAX reference
on the CPU vs the PyTorch port). Inputs are made with numpy and handed to
both; parameters are carried JAX -> torch through the port's copy of the
flax-path -> torch-key table."""

import jax
import numpy as np
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
# the tier-1 run puts six pytest workers on one host: a torch thread pool
# per worker as wide as the host oversubscribes its cores and slows every
# worker, the JAX ones too
torch.set_num_threads(2)


def randomize(params, seed: int, std: float = 0.1):
    """Replace every leaf of a flax param tree (arrays, or shapes from
    jax.eval_shape) with seeded numpy values (norm scales around 1,
    everything else around 0)."""
    rng = np.random.default_rng(seed)
    flat = flatten_dict(params)
    out = {}
    for path, v in flat.items():
        vals = rng.normal(size=v.shape).astype(np.float32) * std
        out[path] = vals + (1.0 if path[-1] == 'scale' else 0.0)
    return unflatten_dict(out)


def carry(params, entries, prefix: str):
    """Flax params -> torch state dict through (flax path -> (torch key,
    transform)) entries whose torch keys start with `prefix.`."""
    sd = {}
    for path, (key, to_torch) in entries.items():
        node = params
        for p in path:
            node = node[p]
        assert key.startswith(prefix + '.'), key
        sd[key[len(prefix) + 1:]] = torch.from_numpy(
            to_torch(np.asarray(node, np.float32)).copy())
    return sd


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)
