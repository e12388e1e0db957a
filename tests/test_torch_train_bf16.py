"""bf16 training (network_g.dtype / network_d.dtype: bfloat16) on the CPU:
the port's LQ-stage generator step against jax.value_and_grad of the JAX
FeMaSRNet built with dtype=bfloat16 (tests/test_torch_train_bf16_hq.py
holds the HQ stage and the discriminator to the same rules).

The JAX side searches in f32 (vq_index_f32: true, what the port always
does), runs its decoder's upsample + conv as the materialized upsample and
conv that the port runs (FEMASR_UPCONV=plain, not the folded 4x4 kernel,
whose bf16 taps round their sums), and is compiled with
`xla_allow_excess_precision` off, so that it rounds to bf16 where its
source does (under a plain jit XLA on the CPU keeps some bf16 values in
f32). What still differs by design is the Swin attention: the port's
trainee takes the B2 kernel's plain version (f32 logits, p rounded to
bf16), JAX's XLA attention keeps its logits in bf16.

What is held, and what was measured here:
- the layers of the trainee compute in bf16 (their inputs are bf16);
- the prior's indices equal JAX's bf16 prior's;
- the trainee's indices equal JAX's own search's except near-ties (>= 90%
  equal, each other one within NEAR_TIE of the distance; measured 63 of
  64 equal, gap 8.8e-5); JAX then decodes the port's indices, so that
  one flipped code does not move the comparison of the gradients;
- the loss within LOSS_RTOL (measured 4e-4);
- each weight's gradient (conv, linear, codebook) within WEIGHT_REL_L2
  relative L2 (measured: median 0.099, worst 0.184) and the whole gradient
  within ALL_REL_L2 (measured 0.097). bf16 rounds a 2.6% difference into
  the output of this random-init net between two roundings of the
  attention (JAX's own bf16 output is 7% from its f32 one), and the L1
  loss's sign turns it into gradient differences of ~10%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from femasr_torch.models import FeMaSRNet, init_weights
from femasr_torch.models.convert import from_flax
from femasr_torch.train import FeMaSRModel
from femasr_tpu import losses as jl
from femasr_tpu.models.convert import (convert_femasr_checkpoint,
                                       load_torch_checkpoint)
from femasr_tpu.models.femasr_arch import FeMaSRNet as JFeMaSRNet
from femasr_tpu.ops import quantize as jq
from test_torch_train_grad_lq import lq_options
from torch_port_util import nchw

SMALL = [[32, 16, 32]]
BF16 = {'dtype': 'bfloat16', 'vq_index_f32': True}
LOSS_RTOL = 1e-2
WEIGHT_REL_L2 = 0.25
ALL_REL_L2 = 0.15
NEAR_TIE = 1e-3


def strict(f, *args):
    """f(*args) compiled with XLA's excess precision off (at the CPU
    backend's optimization level 0, as torch_port_util.jit_quick: the
    same HLO, so the same rounding points, compiled faster)."""
    return jax.jit(f).lower(*args).compile(compiler_options={
        'xla_allow_excess_precision': False,
        'xla_backend_optimization_level': 0,
        'xla_llvm_disable_expensive_passes': True})(*args)


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def bf16_options(opt):
    opt['network_g'].update(BF16)
    opt['network_d']['dtype'] = 'bfloat16'
    return opt


def record_layer_inputs(net):
    """Hooks that collect the input dtype of every conv and linear."""
    seen = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].dtype))
        for m in net.modules()
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    return seen, hooks


def check_grads(net, want, weight_tol: float = WEIGHT_REL_L2,
                all_tol: float = ALL_REL_L2) -> dict:
    """Every gradient of `net` is f32; the weights' (conv, linear, codebook)
    each within `weight_tol` of JAX's, the whole gradient within `all_tol`
    (relative L2). The 1-D tensors (biases, norm scales and offsets) and the
    relative-position tables have no bound of their own: JAX on the CPU
    sums their bf16 cotangents in bf16 (a 2x32x32 conv bias gradient comes
    out -0.0625 where the sum is -0.1402; PyTorch sums in f32: -0.1406)."""
    errs, got, ref = {}, [], []
    for name, p in net.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert g.dtype == torch.float32, name
        got.append(g.numpy().ravel())
        ref.append(want[name].numpy().ravel())
        if p.dim() > 1 and 'relative_position' not in name:
            errs[name] = rel_l2(got[-1], ref[-1])
    worst = max(errs, key=errs.get)
    assert errs[worst] <= weight_tol, (worst, errs[worst])
    total = rel_l2(np.concatenate(got), np.concatenate(ref))
    assert total <= all_tol, total
    return errs


def forced_search(monkeypatch, forced, captured):
    """JAX's codebook search returns the port's indices `forced` (so both
    sides decode the same codes); its own indices go to `captured`."""
    own_search = jq.nearest_code_indices

    def search(z_flat, codebook, **kw):
        own = own_search(z_flat, codebook, **kw)
        jax.debug.callback(lambda a: captured.append(np.asarray(a)), own)
        return jnp.asarray(forced.reshape(-1), jnp.int32)
    monkeypatch.setattr(jq, 'nearest_code_indices', search)


def near_tie_agreement(z, cb, a, b) -> tuple:
    """(share of equal indices, worst relative distance gap of the others)
    for the (N, C) tokens z against the codebook cb, in float64."""
    a = torch.from_numpy(np.array(a)).reshape(-1).long()
    b = torch.from_numpy(np.array(b)).reshape(-1).long()
    diff = (a != b).nonzero().flatten()
    zd, cd = z[diff].double(), cb.double()
    d_a = (zd - cd[a[diff]]).square().sum(1)
    d_b = (zd - cd[b[diff]]).square().sum(1)
    gap = ((d_a - d_b).abs() / d_b).max().item() if len(diff) else 0.0
    return 1 - len(diff) / len(a), gap


def test_lq_stage_bf16_generator_gradients_match_jax(tmp_path, monkeypatch):
    hq = FeMaSRNet(SMALL, LQ_stage=False)
    init_weights(hq, torch.Generator().manual_seed(1))
    hq_pth = str(tmp_path / 'hq.pth')
    torch.save({'params': hq.state_dict()}, hq_pth)
    model = FeMaSRModel(bf16_options(lq_options(tmp_path, hq_pth)))
    assert model.dtype == torch.bfloat16
    rng = np.random.default_rng(0)
    lq = rng.random((1, 16, 16, 3), dtype=np.float32)
    gt = rng.random((1, 64, 64, 3), dtype=np.float32)
    seen, hooks = record_layer_inputs(model.net_g)
    tokens = []
    hooks.append(model.net_g.quantize_group[0].register_forward_hook(
        lambda mod, args, out: tokens.append(args[0].detach())))
    model.opt_g.zero_grad()
    total, ld, _, idx, gt_idx = model.g_backward(nchw(lq), nchw(gt))
    for h in hooks:
        h.remove()
    # every layer of the trainee computes in bf16 (an f32 forward cast at
    # the end would not)
    assert len(seen) > 100 and set(seen) == {torch.bfloat16}
    assert model.gt_rec.dtype == torch.bfloat16

    # the prior's indices: JAX's bf16 prior with the f32 search
    monkeypatch.setenv('FEMASR_UPCONV', 'plain')
    jhq = JFeMaSRNet(codebook_params=SMALL, LQ_stage=False,
                     dtype=jnp.bfloat16, vq_index_f32=True)
    hq_params = convert_femasr_checkpoint(
        load_torch_checkpoint(hq_pth), codebook_params=SMALL,
        LQ_stage=False)
    gt_b = jnp.asarray(gt).astype(jnp.bfloat16)
    prior_idx = strict(lambda p, x: jhq.apply({'params': p}, x)[3][0],
                       hq_params, gt_b)
    np.testing.assert_array_equal(gt_idx[0].numpy(), np.asarray(prior_idx))

    sd = {k: v.detach().numpy() for k, v in model.net_g.state_dict().items()}
    params = convert_femasr_checkpoint(sd, codebook_params=SMALL,
                                       LQ_stage=True, scale_factor=4)
    jnet = JFeMaSRNet(codebook_params=SMALL, LQ_stage=True, scale_factor=4,
                      dtype=jnp.bfloat16, vq_index_f32=True)
    gt_j = [jnp.asarray(gt_idx[0].numpy())]
    lq_b = jnp.asarray(lq).astype(jnp.bfloat16)

    def loss_fn(p):
        out, l_cb, _, _ = jnet.apply({'params': p}, lq_b, gt_indices=gt_j,
                                     train=True)
        return l_cb + jl.L1Loss()(out.astype(jnp.float32), jnp.asarray(gt))

    own = []
    forced_search(monkeypatch, idx.numpy(), own)
    loss_j, grads_j = strict(jax.value_and_grad(loss_fn), params)
    jax.effects_barrier()
    z = tokens[0].float().permute(0, 2, 3, 1).reshape(-1, SMALL[0][2])
    agree, gap = near_tie_agreement(
        z, model.net_g.quantize_group[0].embedding.weight.detach(), idx,
        own[0])
    assert agree >= 0.9 and gap <= NEAR_TIE, (agree, gap)
    np.testing.assert_allclose(float(total), float(loss_j), rtol=LOSS_RTOL)
    want = from_flax(grads_j, SMALL, LQ_stage=True, scale_factor=4)
    assert len(want) == len(list(model.net_g.parameters())) > 300
    check_grads(model.net_g, want)
