"""One rank of a data-parallel CPU test of the port (tests/test_torch_dist*.py).

    python tests/torch_dist_worker.py <plan.json>

The plan is {'jobs': [...], 'out': <dir>}; the rank runs its jobs in order
in one process, under torchrun's environment variables when the test sets
them (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), else as one
process. It imports torch and the port only, never jax, and computes on
one thread. Each job writes <out>/<name>.rank<r>.pt:

- train / test: train_cli / test_cli on `opt` with `argv`; fingerprints of
  the networks (train: with tensor parallelism the rank's parts, and the
  bytes of every whole-on-every-rank tensor) or the metric results (test);
- serve: SRInferencer of a seeded state dict over `images` through
  run_padded, run_tiled and run_bucketed, on a mesh under a launcher
  (`tp`: the size of its model axis; `strict`: a strict load);
- cli: inference_cli with `argv`;
- util: the dist_util and mesh surface (ranks, master_only, barrier,
  broadcast, local_slice, gather_batch, the mesh's axes);
- options: parse_options on `opt` and `argv`: the options or the error.
"""

import hashlib
import json
import os
import sys
import traceback

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
torch.set_num_threads(1)


def _run_cli(module, job):
    os.makedirs(job['cwd'], exist_ok=True)
    # one file per rank: ranks that share a directory would otherwise
    # read each other's half-written file
    opt_path = os.path.join(job['cwd'], f"{job['name']}.rank"
                            f"{os.environ.get('RANK', 0)}.json")
    with open(opt_path, 'w') as f:
        json.dump(job['opt'], f)
    cwd = os.getcwd()
    os.chdir(job['cwd'])
    try:
        return module.main(['-opt', opt_path, *job.get('argv', [])])
    finally:
        os.chdir(cwd)


def fingerprint(module):
    """Per tensor of the state dict: its sum and sum of squares in float64
    (equal tensors give equal prints; the networks themselves are in the
    run's models/*_latest.pth)."""
    return {k: (v.double().sum().item(), v.double().square().sum().item())
            for k, v in module.state_dict().items()}


def digests(module, skip=()):
    """Per tensor of the state dict not in `skip`: a hash of its bytes."""
    return {k: hashlib.sha1(v.detach().cpu().contiguous().numpy()
                            .tobytes()).hexdigest()
            for k, v in module.state_dict().items() if k not in skip}


def train(job):
    from femasr_torch import train_cli
    model = _run_cli(train_cli, job)
    return {'net_g': fingerprint(model.net_g),
            'net_d': fingerprint(model.net_d),
            'ddp': type(model.net_g_train).__name__,
            'split': sorted(model.layout_g),
            'whole_g': digests(model.net_g, model.layout_g),
            'no_grad': sorted(n for n, p in model.net_g.named_parameters()
                              if p.requires_grad and p.grad is None)}


def test(job):
    from femasr_torch import test_cli
    model = _run_cli(test_cli, job)
    return {'metrics': dict(model.metric_results)}


def serve(job):
    import numpy as np

    from femasr_torch.models import SRInferencer
    from femasr_torch.parallel import create_mesh, is_dist
    sd = torch.load(job['weights'])['params']
    mesh = (create_mesh(model=job.get('tp', 1), device_type='cpu')
            if is_dist() else None)
    kw = dict(codebook_params=job['codebook'], scale_factor=4,
              device='cpu', mesh=mesh, strict=job.get('strict', False))
    sr = SRInferencer(sd, **kw)
    imgs = [np.asarray(i, np.float32) for i in np.load(job['images'])]
    x = torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2)
    return {'padded': sr.run_padded(x),
            'tiled': sr.run_tiled(x, tile_size=16, tile_pad=4),
            'bucketed': sr.run_bucketed(imgs, bucket=32, max_batch=3),
            'tile_batch': sr.max_tile_batch}


def cli(job):
    from femasr_torch import inference_cli
    try:
        return {'stats': inference_cli.main(job['argv'])}
    except SystemExit as e:
        return {'exit': str(e)}


def util(job):
    from femasr_torch.parallel import (barrier, create_mesh, gather_batch,
                                       get_dist_info, init_dist,
                                       local_slice, master_only)
    from femasr_torch.parallel.dist_util import broadcast_object
    device = init_dist('pytorch', device='cpu')
    rank, world = get_dist_info()
    ran = master_only(lambda: 'ran')()
    barrier()
    mesh = create_mesh(device_type='cpu')
    batch = torch.arange(world * 3 * 2, dtype=torch.float32).reshape(-1, 2)
    block = local_slice(batch, mesh)
    return {'rank': rank, 'world': world, 'device': str(device),
            'master_only': ran, 'seed': broadcast_object(100 + rank),
            'block': block, 'gathered': gather_batch(block + 0, mesh),
            'mesh': (mesh['data'].size(), mesh['model'].size(),
                     mesh.mesh_dim_names)}


def options(job):
    from femasr_torch.utils.options import parse_options
    try:
        opt, _ = parse_options('.', opt=job['opt'], argv=job.get('argv', []))
    except Exception as e:      # the refusal is the result
        return {'error': f'{type(e).__name__}: {e}'}
    return {k: opt[k] for k in ('dist', 'rank', 'world_size', 'num_gpu',
                                'manual_seed', 'device')} | {
        'draw': torch.rand(()).item()}


JOBS = {'train': train, 'test': test, 'serve': serve, 'cli': cli,
        'util': util, 'options': options}


def main(plan_path):
    with open(plan_path) as f:
        plan = json.load(f)
    rank = int(os.environ.get('RANK', 0))
    if 'RANK' in os.environ:
        from femasr_torch.parallel import init_dist
        init_dist('pytorch', device='cpu')
    for job in plan['jobs']:
        result = JOBS[job['kind']](job)
        torch.save(result, os.path.join(plan['out'],
                                        f"{job['name']}.rank{rank}.pt"))
    print(f'rank {rank}: done', flush=True)


if __name__ == '__main__':
    try:
        main(sys.argv[1])
    except BaseException:
        traceback.print_exc()
        sys.exit(1)
    from femasr_torch.parallel.dist_util import shutdown
    shutdown()
