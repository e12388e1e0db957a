"""The trainer's learning-rate schedules and optimizer steps against the JAX
package's, on the CPU.

Schedules: `build_schedule` at steps 0-15 for MultiStepLR,
MultiStepRestartLR and CosineAnnealingRestartLR, with and without warmup.
JAX evaluates them in f32 (XLA's own f32 cos), the port in Python floats:
they agree to 1e-6 relative, not bit for bit.

Optimizer: three updates of a parameter set with frozen modules, through
the trainer's `frozen_names` + `optimizer_from_opt` with the learning rate
set from the schedule, against `_optimizer_from_opt` under optax's
multi_transform freeze mask: parameters to 1e-6, frozen ones bit-unchanged.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from femasr_torch.train import build_schedule, optimizer_from_opt
from femasr_torch.train.femasr_model import frozen_names
from femasr_tpu.train import build_schedule as jbuild_schedule
from femasr_tpu.train.femasr_model import (_frozen_mask_labels,
                                           _optimizer_from_opt)
import torch_port_util  # noqa: F401  (caps torch at 2 threads)

SCHEDULES = [
    {'type': 'MultiStepLR', 'milestones': [3, 7, 9], 'gamma': 0.1},
    {'type': 'MultiStepRestartLR', 'milestones': [2, 6, 12], 'gamma': 0.3,
     'restarts': [0, 8], 'restart_weights': [1, 0.5]},
    {'type': 'CosineAnnealingRestartLR', 'periods': [5, 7],
     'restart_weights': [1, 0.5], 'eta_min': 1e-7},
]


@pytest.mark.parametrize('warmup', [-1, 4])
@pytest.mark.parametrize('sched', SCHEDULES, ids=lambda s: s['type'])
def test_schedules_match_jax(sched, warmup):
    port = build_schedule(dict(sched), 2e-4, warmup)
    ref = jbuild_schedule(dict(sched), 2e-4, warmup)
    got = [port(s) for s in range(16)]
    want = [float(ref(s)) for s in range(16)]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)
    assert len(set(np.round(got, 12))) > 2     # the schedule moves


SHAPES = {'multiscale_encoder.in_conv.weight': (4, 3),
          'multiscale_encoder.in_conv.bias': (4,),
          'decoder_group.0.block.1.weight': (5, 2),
          'quantize_group.0.embedding.weight': (6, 2),
          'before_quant_group.0.weight': (3, 3)}
KEYWORDS = ['quantize', 'decoder']


def _flax_path(name):
    return tuple(name.split('.'))


@pytest.mark.parametrize('optim', [
    {'type': 'Adam', 'lr': 1e-2, 'betas': [0.9, 0.99], 'weight_decay': 0},
    {'type': 'Adam', 'lr': 1e-2, 'betas': [0.9, 0.99], 'weight_decay': 0.1},
    {'type': 'AdamW', 'lr': 1e-2, 'betas': [0.8, 0.95], 'weight_decay': 0.1},
    {'type': 'SGD', 'lr': 1e-2, 'momentum': 0.9, 'nesterov': True},
], ids=lambda o: f'{o["type"]}-{o.get("weight_decay", 0)}')
def test_optimizer_steps_with_frozen_modules_match_optax(optim):
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    sched_opt = {'type': 'MultiStepLR', 'milestones': [1], 'gamma': 0.5}

    # JAX: the trainer's optimizer under the freeze mask
    tree = jax_tree(init)
    labels = _frozen_mask_labels(tree, KEYWORDS)
    tx = optax.multi_transform(
        {'train': _optimizer_from_opt(optim, jbuild_schedule(
            dict(sched_opt), optim['lr'])),
         'freeze': optax.set_to_zero()}, labels)
    state = tx.init(tree)

    # the port: named parameters, frozen ones left out of the optimizer
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    frozen = frozen_names(params, KEYWORDS)
    assert frozen == {'decoder_group.0.block.1.weight',
                      'quantize_group.0.embedding.weight'}
    opt = optimizer_from_opt(optim, [p for k, p in params.items()
                                     if k not in frozen])
    sched = build_schedule(dict(sched_opt), optim['lr'])

    for step, g in enumerate(grads):
        gtree = jax_tree(g)
        updates, state = tx.update(gtree, state, tree)
        tree = optax.apply_updates(tree, updates)
        for k, p in params.items():
            p.grad = None if k in frozen else torch.from_numpy(g[k].copy())
        for group in opt.param_groups:
            group['lr'] = sched(step)
        opt.step()
        for k, p in params.items():
            node = tree
            for part in _flax_path(k):
                node = node[part]
            if k in frozen:
                np.testing.assert_array_equal(p.detach().numpy(), init[k])
                np.testing.assert_array_equal(np.asarray(node), init[k])
            else:
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(node), rtol=1e-6,
                                           atol=1e-7)
                assert not np.array_equal(p.detach().numpy(), init[k])


def jax_tree(flat):
    tree = {}
    for k, v in flat.items():
        node = tree
        for p in _flax_path(k)[:-1]:
            node = node.setdefault(p, {})
        node[_flax_path(k)[-1]] = jnp.asarray(v)
    return tree
