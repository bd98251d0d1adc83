"""The port's LR schedules and optimizers against the JAX package's optax
chains (``vfs_tpu/core/optimizer/builder.py``).

Schedules: every policy at a list of update counts; the port computes in
float64, optax in float32 (cosines near their zero lose relative digits),
so rtol 1e-6 plus 2e-7 of the base rate absolute. Optimizers: three updates of
SGD (momentum, nesterov, coupled decay), Adam (decay after the Adam
scaling) and AdamW, with and without a global-norm clip that binds, on
the same parameters and gradients; fp32 rtol 1e-6 / atol 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vfs_tpu.core.optimizer.builder import \
    build_lr_schedule as jax_build_lr_schedule
from vfs_tpu.core.optimizer.builder import \
    build_optimizer as jax_build_optimizer
from vfs_tpu_torch.core.optimizer import build_lr_schedule, build_optimizer

torch.set_num_threads(1)

STEPS = [0, 1, 2, 3, 4, 5, 7, 9, 10, 12, 19, 20, 25]
TOTAL, PER_EPOCH = 20, 4
POLICIES = [
    None,
    dict(policy='CosineAnnealing', min_lr=0, by_epoch=False),
    dict(policy='CosineAnnealing', min_lr=1e-3),
    dict(policy='cosine', min_lr=0, by_epoch=False, warmup='linear',
         warmup_iters=3, warmup_ratio=0.1),
    dict(policy='CosineAnnealing', min_lr=0, warmup='linear',
         warmup_iters=1, warmup_ratio=0.01),
    dict(policy='step', step=[2, 4], gamma=0.1),
    dict(policy='step', step=7, gamma=0.5, by_epoch=False),
    dict(policy='fixed'),
    dict(policy='exp', gamma=0.9),
    dict(policy='exp', gamma=0.97, by_epoch=False),
    dict(policy='tin', min_lr=0, warmup='linear', warmup_iters=5,
         warmup_ratio=0.1, by_epoch=False),
    dict(policy='tin', min_lr=1e-4, warmup='constant', warmup_iters=2,
         warmup_ratio=0.2),
    dict(policy='tin', min_lr=0, warmup='exp', warmup_iters=3,
         warmup_ratio=0.1, by_epoch=False),
    dict(policy='tin', min_lr=0),
]


@pytest.mark.parametrize('lr_config', POLICIES,
                         ids=lambda c: 'none' if c is None else
                         f"{c['policy']}-{c.get('warmup')}-"
                         f"{c.get('by_epoch', True)}")
def test_lr_schedule_matches_optax(lr_config):
    ref = jax_build_lr_schedule(lr_config, 0.05, TOTAL, PER_EPOCH)
    sched = build_lr_schedule(lr_config, 0.05, TOTAL, PER_EPOCH)
    for step in STEPS:
        expect = float(np.asarray(ref(jnp.asarray(step)))) if callable(ref) \
            else float(ref)
        np.testing.assert_allclose(sched(step), expect, rtol=1e-6,
                                   atol=2e-7 * 0.05, err_msg=f'step {step}')


def test_unknown_policy_and_optimizer_raise():
    with pytest.raises(KeyError):
        build_lr_schedule(dict(policy='poly'), 0.1, 10)
    with pytest.raises(KeyError):
        build_optimizer([torch.zeros(1, requires_grad=True)],
                        dict(type='RMSprop', lr=0.1))


OPTIMIZERS = [
    dict(type='SGD', lr=0.05, momentum=0.9, weight_decay=1e-4),
    dict(type='SGD', lr=0.05, momentum=0.9, nesterov=True,
         weight_decay=1e-3),
    dict(type='SGD', lr=0.1),
    dict(type='Adam', lr=1e-3, weight_decay=1e-2, betas=(0.8, 0.99),
         eps=1e-6),
    dict(type='Adam', lr=1e-3),
    dict(type='AdamW', lr=1e-3, weight_decay=0.05),
]


def _trees(seed):
    rs = np.random.RandomState(seed)
    params = {'a': rs.randn(4, 3).astype(np.float32),
              'b': rs.randn(5).astype(np.float32)}
    grads = [{k: (rs.randn(*v.shape) * 3).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    return params, grads


@pytest.mark.parametrize('grad_clip', [None, 2.0])
@pytest.mark.parametrize('opt_cfg', OPTIMIZERS,
                         ids=lambda c: f"{c['type']}-{len(c)}")
def test_optimizer_updates_match_optax(opt_cfg, grad_clip):
    lr_cfg = dict(policy='CosineAnnealing', min_lr=0, by_epoch=False)
    params, grads = _trees(0)
    tx, _ = jax_build_optimizer(opt_cfg, lr_cfg, 10, 5, grad_clip)
    state = tx.init(params)
    ref = params
    for g in grads:
        updates, state = tx.update(g, state, ref)
        ref = optax.apply_updates(ref, updates)
    tensors = {k: torch.tensor(v, requires_grad=True)
               for k, v in params.items()}
    opt, _ = build_optimizer(tensors.values(), opt_cfg, lr_cfg, 10, 5,
                             grad_clip)
    for g in grads:
        for k, t in tensors.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    assert opt.count == 3
    for k in params:
        np.testing.assert_allclose(tensors[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=1e-6, atol=1e-7)


def test_adam_decay_is_not_torch_adams():
    """The JAX chain adds ``wd * p`` after the Adam scaling: one step of
    torch.optim.Adam(weight_decay=...) gives another result; one of
    torch.optim.AdamW (decay ``lr * wd * p``) the same."""
    params, grads = _trees(1)
    cfg = dict(type='Adam', lr=1e-2, weight_decay=0.1)
    tensors = {k: torch.tensor(v, requires_grad=True)
               for k, v in params.items()}
    opt, _ = build_optimizer(tensors.values(), cfg)
    twins = {k: torch.tensor(v, requires_grad=True)
             for k, v in params.items()}
    adam = torch.optim.Adam(twins.values(), lr=1e-2, weight_decay=0.1)
    decoupled = {k: torch.tensor(v, requires_grad=True)
                 for k, v in params.items()}
    adamw = torch.optim.AdamW(decoupled.values(), lr=1e-2, weight_decay=0.1)
    for group in (tensors, twins, decoupled):
        for k, t in group.items():
            t.grad = torch.from_numpy(grads[0][k])
    opt.step()
    adam.step()
    adamw.step()
    for k in params:
        assert not torch.allclose(tensors[k], twins[k], rtol=1e-4)
        torch.testing.assert_close(tensors[k], decoupled[k], rtol=1e-6,
                                   atol=1e-7)


def test_optimizer_state_dict_round_trip_and_missing_grads():
    """A restored optimizer continues as the original; a parameter
    without a gradient takes a zero gradient (decay still applies)."""
    params, grads = _trees(2)
    cfg = dict(type='SGD', lr=0.05, momentum=0.9, weight_decay=0.1)
    runs = []
    for restore in (False, True):
        tensors = {k: torch.tensor(v, requires_grad=True)
                   for k, v in params.items()}
        opt, _ = build_optimizer(tensors.values(), cfg)
        tensors['a'].grad = torch.from_numpy(grads[0]['a'])
        opt.step()
        if restore:
            saved = opt.state_dict()
            opt, _ = build_optimizer(tensors.values(), cfg)
            opt.load_state_dict(saved)
        opt.zero_grad()
        assert all(t.grad is None for t in tensors.values())
        for k, t in tensors.items():
            t.grad = torch.from_numpy(grads[1][k])
        opt.step()
        runs.append(tensors)
    for k in params:
        assert torch.equal(runs[0][k], runs[1][k])
    b0 = params['b'] * (1 - 0.05 * 0.1)  # the first step: decay alone
    assert not np.allclose(b0, params['b'])
    frozen = torch.zeros(3, requires_grad=False)
    opt, _ = build_optimizer([frozen, runs[0]['a']], cfg)
    assert len(opt.params) == 1
