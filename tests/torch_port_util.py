"""Helpers shared by the tests/test_torch_*.py parity tests (JAX reference
on the CPU vs the PyTorch port). Inputs are made with numpy and handed to
both; parameters are carried JAX -> torch through the port's copy of the
flax-path -> torch-key table."""

import json
import os
import socket
import subprocess
import sys
import time

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


def jit_quick(fn, *args):
    """fn(*args) jitted with XLA's CPU backend at optimization level 0: the
    same HLO program, compiled in about a third of the time where LLVM's
    passes dominate the compile (small programs; a large one runs slower
    unoptimized). It may contract a multiply-add that level 3 leaves
    apart: a last-bit f32 difference. XLA's excess precision is off, so
    bf16 values round where the JAX source rounds them."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        'xla_backend_optimization_level': 0,
        'xla_allow_excess_precision': False})(*args)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


# -- data-parallel runs on the CPU (tests/test_torch_dist*.py) ---------------

DIST_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'torch_dist_worker.py')
LAUNCHER_ENV = ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                'MASTER_PORT')


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def start_ranks(jobs, out, world: int = 2) -> dict:
    """Start the worker's `jobs` (tests/torch_dist_worker.py) in `world`
    gloo ranks on the CPU, with torchrun's variables on a free local port,
    or with world 0 as one process without a launcher; each process on one
    thread. `wait_ranks` collects them."""
    os.makedirs(out, exist_ok=True)
    plan = os.path.join(out, f'plan_w{world}_{len(os.listdir(out))}.json')
    with open(plan, 'w') as f:
        json.dump({'jobs': jobs, 'out': out}, f)
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    env.update(OMP_NUM_THREADS='1', MKL_NUM_THREADS='1')
    port = free_port()
    procs = []
    for rank in range(max(world, 1)):
        e = dict(env)
        if world:
            e.update(RANK=str(rank), WORLD_SIZE=str(world),
                     LOCAL_RANK=str(rank), MASTER_ADDR='127.0.0.1',
                     MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, DIST_WORKER, plan], env=e, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return {'procs': procs, 'jobs': jobs, 'out': out}


def wait_ranks(*runs, timeout: float = 120.0) -> list:
    """Wait for started runs; a rank that fails or outlives `timeout`
    seconds fails the caller, and every process is killed. Returns per run
    {job name: [result of rank 0, ...]}."""
    deadline = time.monotonic() + timeout
    procs = [p for run in runs for p in run['procs']]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, (
            f'a rank failed (rc {p.returncode}):\n{log[-3000:]}')
    return [{job['name']: [torch.load(os.path.join(
        run['out'], f"{job['name']}.rank{r}.pt"), weights_only=False)
        for r in range(len(run['procs']))] for job in run['jobs']}
        for run in runs]


def run_ranks(jobs, out, world: int = 2, timeout: float = 120.0) -> dict:
    """start_ranks + wait_ranks of one run."""
    return wait_ranks(start_ranks(jobs, out, world), timeout=timeout)[0]
