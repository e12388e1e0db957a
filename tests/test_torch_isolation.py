"""The port stands alone: no module of femasr_torch, and not chip_smoke.py,
imports jax, flax or femasr_tpu; the package imports with jax blocked;
and its entry points (serving, the trainer's train_cli and the evaluation's
test_cli) default to the card rather than falling back to the CPU."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ('jax', 'flax', 'femasr_tpu')


def _port_sources():
    files = [os.path.join(ROOT, 'chip_smoke.py')]
    for dirpath, _, names in os.walk(os.path.join(ROOT, 'femasr_torch')):
        files += [os.path.join(dirpath, n) for n in names
                  if n.endswith('.py')]
    return sorted(files)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or '').split('.')[0]


@pytest.mark.parametrize('path', _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_module_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f'{os.path.relpath(path, ROOT)} imports {bad}'


_PROBE = r'''
import sys
for name in ('jax', 'flax', 'femasr_tpu'):
    sys.modules[name] = None           # any import of these now fails
import torch
import femasr_torch, femasr_torch.kernels, femasr_torch.inference_cli
import femasr_torch.train_cli, femasr_torch.test_cli, femasr_torch.parallel
import femasr_torch.parallel.tensor_parallel
from femasr_torch.models import SRInferencer
from femasr_torch.models.inference import load_inferencer
OPT = {'name': 'probe', 'model_type': 'FeMaSRModel', 'manual_seed': 0,
       'network_g': {'type': 'FeMaSRNet', 'codebook_params': [[32, 16, 32]]},
       'datasets': {'train': {'type': 'PairedImageDataset'}},
       'path': {}, 'train': {'total_iter': 1}, 'logger': {'print_freq': 1}}
if torch.cuda.is_available():
    print('cuda present')
else:
    for fn in (lambda: SRInferencer(),
               lambda: load_inferencer('missing.pth'),
               lambda: femasr_torch.train_cli.main([], opt=OPT),
               lambda: femasr_torch.test_cli.main([], opt=OPT)):
        try:
            fn()
        except RuntimeError as e:
            assert 'CUDA' in str(e), e
        else:
            raise SystemExit('entry point fell back to the CPU')
    print('raised')
'''


def test_port_imports_with_jax_blocked_and_needs_the_card():
    proc = subprocess.run([sys.executable, '-c', _PROBE], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] in ('raised', 'cuda present')
