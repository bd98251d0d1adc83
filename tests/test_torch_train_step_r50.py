"""The port's SimSiam train step on the r50 pretraining config's model
against the JAX package's, with the JAX weights carried over by
``flax_simsiam_to_torch``.

Model: configs/r50_nc_sgd_cos_100e_r5_1xNx2_k400.py's tracker (ResNet-50
of Bottlenecks, ``out_indices=(3,)``, ``zero_init_residual`` on each
block's ``bn3``, ``intra_video=False``) with a narrow head (2048 -> 32 ->
32 projection, 32 -> 16 -> 32 predictor), BatchNorm scales and shifts
randomised as ``test_torch_train_step.randomize_bn_params`` does. Input:
the config's sampling, 2 clips of ``clip_len`` 1 a sample, of smooth
64x64 frames (``test_torch_train_step.train_batch``), 16 samples.

Why 16 samples of 64x64 and not the r18 test's 2 of 32x32: with one frame
a clip each view is a BatchNorm batch of B rows (the r18 test's views
hold 8). The head's BatchNorm1d over 2 rows gives +-1 whatever its
input, so the backbone's exact gradient is made of the eps terms alone,
and at 32x32 layer4's BatchNorm also sees 1x1 maps: there two fp32 steps
cannot be compared at all. At 16 samples of 64x64 the forward is well
conditioned (the fp32 loss and running statistics hold at the fp32
tolerances below), but the gradients are not: through 16 Bottlenecks
whose ``bn3`` scales the randomisation sets near 1, a rounding anywhere
moves them by more than the r18 test's 2e-4 in either package. So, at
the tolerances of ``test_torch_train_step.py``'s docstring: the fp32
step-0 loss at rtol 1e-5 and the running statistics at 2e-4 relative L2
plus 1e-6; the step-0 loss, every gradient and running statistic, and
the step-1 update of the r50 config's optimizer in float64 (both
packages, the JAX backbone built with ``dtype=float64``) at 1e-9. The
card's fp32 gradients are held against the CPU's on the card
(``chip_smoke.card_vs_cpu_kinks``).

One module-scoped fixture compiles the JAX side once: an fp32 forward, a
float64 value-and-gradient and a float64 train step.
"""

import os.path as osp
import runpy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.apis.train import TrainState as JaxTrainState
from vfs_tpu.apis.train import make_train_step as jax_make_train_step
from vfs_tpu.core.optimizer.builder import \
    build_optimizer as jax_build_optimizer
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.models.trackers.sim_siam_tracker import \
    parse_losses as jax_parse_losses
from vfs_tpu_torch.apis.train import make_train_step
from vfs_tpu_torch.checkpoint import flax_simsiam_to_torch
from vfs_tpu_torch.core.optimizer import build_optimizer
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.models.trackers import parse_losses

from test_torch_train_step import (ATOL, RTOL, assert_tree_close,
                                   jax_variables, load_jax_weights,
                                   to_torch_tree, to_torch_tree64,
                                   train_batch)

torch.set_num_threads(1)

CONFIG = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                  'configs', 'r50_nc_sgd_cos_100e_r5_1xNx2_k400.py')
_CFG = runpy.run_path(CONFIG)
MODEL_CFG = dict(_CFG['model'], img_head=dict(
    _CFG['model']['img_head'], projection_mid_channels=32,
    projection_out_channels=32, predictor_mid_channels=16,
    predictor_out_channels=32))
TRAIN_CFG = dict(_CFG['train_cfg'])
OPT_CFG, LR_CFG = dict(_CFG['optimizer']), dict(_CFG['lr_config'])
TOTAL_ITERS, ITERS_PER_EPOCH = 10, 5
B, HW, TOL64 = 16, 64, 1e-9


def _batch(seed):
    return train_batch(seed, b=B, t=1, hw=HW)


@pytest.fixture(scope='module')
def jax_run():
    assert MODEL_CFG['backbone']['depth'] == 50
    assert MODEL_CFG['backbone']['zero_init_residual']
    assert not TRAIN_CFG['intra_video']
    model = jax_build_model(MODEL_CFG, train_cfg=TRAIN_CFG)
    x = _batch(1)
    init = model.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    params, stats = jax_variables(model, x)

    def forward(p, s, imgs, m):
        out, mut = m.apply({'params': p, 'batch_stats': s}, imgs,
                           train=True, mutable=['batch_stats'])
        return jax_parse_losses(out)[0], mut['batch_stats']

    loss, new_stats = jax.jit(lambda p, s, i: forward(p, s, i, model))(
        params, stats, jnp.asarray(x))
    tx, _ = jax_build_optimizer(OPT_CFG, LR_CFG, TOTAL_ITERS,
                                ITERS_PER_EPOCH)
    with jax.enable_x64(True):
        cfg64 = dict(MODEL_CFG, backbone=dict(MODEL_CFG['backbone'],
                                              dtype=jnp.float64))
        model64 = jax_build_model(cfg64, train_cfg=TRAIN_CFG)
        p64, s64 = jax.tree.map(lambda a: np.asarray(a, np.float64),
                                (params, stats))
        x64 = jnp.asarray(x, jnp.float64)
        (loss64, new_s64), g64 = jax.jit(jax.value_and_grad(
            lambda p: forward(p, s64, x64, model64), has_aux=True))(p64)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=p64,
                              batch_stats=s64, opt_state=tx.init(p64))
        state, lv = jax.jit(jax_make_train_step(model64, tx))(state, x64)
        f64 = dict(start=(p64, s64), loss=float(loss64),
                   grads=jax.tree.map(np.asarray, g64),
                   new_stats=jax.tree.map(np.asarray, new_s64),
                   step_loss=float(lv['loss']),
                   state=jax.tree.map(np.asarray, state))
    return dict(init=jax.tree.map(np.asarray, init), params=params,
                stats=stats, x=x, loss=float(loss),
                new_stats=to_torch_tree(params, new_stats), f64=f64)


def _port64(jax_run):
    p64, s64 = jax_run['f64']['start']
    return load_jax_weights(build_model(MODEL_CFG, train_cfg=TRAIN_CFG),
                            p64, s64).double().train()


def _assert_close64(port_sd, ref_sd, names, what):
    for name in names:
        a, b = port_sd[name].double(), ref_sd[name].double()
        err = float(torch.linalg.norm(a - b))
        assert err <= TOL64 * float(torch.linalg.norm(b)) + 1e-12, \
            (what, name, err, float(torch.linalg.norm(b)))


def test_r50_init_zeroes_each_bottleneck_bn3_as_jax(jax_run):
    """``zero_init_residual``: the port's seeded init zeroes the scale of
    the last BatchNorm of each of the 16 Bottlenecks, the same parameters
    the JAX package's init zeroes, and those alone."""
    port = build_model(MODEL_CFG, train_cfg=TRAIN_CFG)
    port.init_weights(torch.Generator().manual_seed(0))
    zero = {n for n, p in port.named_parameters()
            if n.endswith('.weight') and not bool(p.any())}
    jax_sd = flax_simsiam_to_torch(jax_run['init']['params'],
                                   jax_run['init']['batch_stats'])
    jax_zero = {n for n in zero | set(jax_sd) if n.endswith('.weight')
                and n in dict(port.named_parameters())
                and not bool(jax_sd[n].any())}
    assert len(zero) == 16
    assert all('.bn3.' in n for n in zero)
    assert zero == jax_zero


def test_r50_step0_loss_and_running_stats_match_jax(jax_run):
    """fp32: the step-0 loss (rtol 1e-5) and every running statistic
    after one train-mode forward (2e-4 relative L2), updated once a view
    with flax's biased variance and momentum."""
    model = load_jax_weights(build_model(MODEL_CFG, train_cfg=TRAIN_CFG),
                             jax_run['params'], jax_run['stats']).train()
    with torch.no_grad():
        total, _ = parse_losses(model(torch.from_numpy(jax_run['x'])))
    np.testing.assert_allclose(float(total), jax_run['loss'], rtol=1e-5)
    names = [k for k in jax_run['new_stats'] if 'running' in k]
    assert len(names) == 2 * (53 + 4)  # r50's 53 BNs + the head's 4
    assert RTOL == 2e-4 and ATOL == 1e-6
    assert_tree_close(model.state_dict(), jax_run['new_stats'],
                      'running stat', names=names)
    assert int(model.state_dict()['backbone.bn1.num_batches_tracked']) == 2


def test_r50_step0_every_gradient_matches_jax_in_float64(jax_run):
    """float64: the step-0 loss, every gradient and every running
    statistic equal the JAX package's to 1e-9."""
    ref = jax_run['f64']
    model = _port64(jax_run)
    total, _ = parse_losses(model(torch.from_numpy(
        jax_run['x'].astype(np.float64))))
    total.backward()
    np.testing.assert_allclose(float(total.detach()), ref['loss'],
                               rtol=TOL64)
    grads = {n: p.grad for n, p in model.named_parameters()}
    jax_grads = to_torch_tree64(ref['grads'], ref['start'][1])
    assert set(grads) <= set(jax_grads)
    assert all(g is not None for g in grads.values())
    _assert_close64(grads, jax_grads, grads, 'gradient')
    new_stats = to_torch_tree64(ref['start'][0], ref['new_stats'])
    _assert_close64(model.state_dict(), new_stats,
                    [k for k in new_stats if 'running' in k], 'running stat')


def test_r50_step1_update_matches_jax_in_float64(jax_run):
    """One step of the r50 config's optimizer (SGD, lr 0.05, momentum
    0.9, decay 1e-4, cosine schedule) through ``make_train_step`` in
    float64: the loss, each parameter's update and the running
    statistics equal the JAX step's to 1e-9."""
    ref = jax_run['f64']
    model = _port64(jax_run)
    optimizer, _ = build_optimizer(model.parameters(), OPT_CFG, LR_CFG,
                                   TOTAL_ITERS, ITERS_PER_EPOCH)
    loss = float(make_train_step(model, optimizer)(
        jax_run['x'].astype(np.float64))['loss'])
    np.testing.assert_allclose(loss, ref['step_loss'], rtol=TOL64)
    start = to_torch_tree64(*ref['start'])
    state = ref['state']
    after = to_torch_tree64(state.params, state.batch_stats)
    sd = model.state_dict()
    params = [n for n, _ in model.named_parameters()]
    _assert_close64({n: sd[n] - start[n] for n in params},
                    {n: after[n] - start[n] for n in params}, params,
                    'step-1 update')
    _assert_close64(sd, after, [k for k in after if 'running' in k],
                    'step-1 running stat')
