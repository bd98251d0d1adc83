"""The port's SimSiam losses, heads, flax-semantics BatchNorm and tracker
against the JAX package's, with the JAX weights carried over by
``flax_head_to_torch`` / ``flax_simsiam_to_torch``.

Tolerances (fp32; the packages sum in other orders): losses, BatchNorm
outputs and running statistics rtol 1e-5 / atol 1e-6; the heads' (z, p),
which train-mode BatchNorm scales to unit variance, rtol 1e-5 / atol
1e-5. The tracker runs ResNet-18 on the frames of
``test_torch_train_step.smooth_frames`` (see that file for why): its
per-frame losses at rtol 5e-5, their means and total at rtol 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.models.heads.sim_siam_head import \
    DenseSimSiamHead as JaxDenseHead
from vfs_tpu.models.heads.sim_siam_head import SimSiamHead as JaxHead
from vfs_tpu.models.losses.sim_loss import CosineSimLoss as JaxCosine
from vfs_tpu.models.losses.sim_loss import DotSimLoss as JaxDot
from vfs_tpu.models.trackers.sim_siam_tracker import \
    parse_losses as jax_parse_losses
from vfs_tpu_torch.checkpoint import flax_head_to_torch
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.models.common import BatchNorm1d, BatchNorm2d
from vfs_tpu_torch.models.heads import DenseSimSiamHead, SimSiamHead
from vfs_tpu_torch.models.losses import CosineSimLoss, DotSimLoss
from vfs_tpu_torch.models.trackers import parse_losses

from test_torch_train_step import (MODEL_CFG, jax_variables,
                                   port_model, randomize_bn_params,
                                   train_batch)

torch.set_num_threads(1)

HEAD_KW = dict(in_channels=24, num_projection_fcs=3,
               projection_mid_channels=20, projection_out_channels=16,
               num_predictor_fcs=2, predictor_mid_channels=8,
               predictor_out_channels=16)


def _close(a, b, rtol=1e-5, atol=1e-6):
    a = a.detach().numpy() if torch.is_tensor(a) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


@pytest.mark.parametrize('negative', [False, True])
@pytest.mark.parametrize('mode', ['pooled', 'pairwise', 'masked'])
def test_cosine_sim_loss_matches_jax(mode, negative):
    rs = np.random.RandomState(0)
    shape = (3, 16) if mode == 'pooled' else (3, 4, 5, 16)
    p, z = rs.randn(*shape), rs.randn(*shape)
    kw = dict(negative=negative, pairwise=mode != 'pooled', loss_weight=.7)
    mask = (rs.rand(3, 20, 20) > .5).astype(np.float32) \
        if mode == 'masked' else None
    ref = JaxCosine(**kw)(jnp.asarray(p, jnp.float32),
                          jnp.asarray(z, jnp.float32),
                          None if mask is None else jnp.asarray(mask))
    out = CosineSimLoss(**kw)(torch.tensor(p, dtype=torch.float32),
                              torch.tensor(z, dtype=torch.float32),
                              None if mask is None else torch.tensor(mask))
    assert out.shape == (3,)
    _close(out, ref)


def test_dot_sim_loss_matches_jax_and_mask_needs_pairwise():
    rs = np.random.RandomState(1)
    p, z = rs.randn(2, 3, 3, 8), rs.randn(2, 3, 3, 8)
    ref = JaxDot(loss_weight=2.)(jnp.asarray(p, jnp.float32),
                                 jnp.asarray(z, jnp.float32))
    _close(DotSimLoss(loss_weight=2.)(torch.tensor(p, dtype=torch.float32),
                                      torch.tensor(z, dtype=torch.float32)),
           ref)
    with pytest.raises(ValueError, match='pairwise'):
        CosineSimLoss()(torch.zeros(2, 4), torch.zeros(2, 4),
                        torch.ones(2, 1, 1))


def _randomize_stats(tree, rng):
    if 'mean' in tree:
        return dict(mean=(rng.randn(*tree['mean'].shape) * .1).astype(
            np.float32), var=(rng.rand(*tree['var'].shape) + .5).astype(
            np.float32))
    return {k: _randomize_stats(v, rng) for k, v in tree.items()}


def _head_pair(jax_cls, torch_cls, kw, x):
    """A JAX head with randomised BatchNorm parameters and statistics,
    and the port's head with the same weights."""
    head = jax_cls(**kw)
    v = head.init(jax.random.PRNGKey(0), jnp.asarray(x), train=True)
    rng = np.random.RandomState(3)
    params = randomize_bn_params(v['params'], rng)
    stats = _randomize_stats(v['batch_stats'], rng)
    port = torch_cls(**kw)
    missing, unexpected = port.load_state_dict(
        flax_head_to_torch(params, stats), strict=False)
    assert not unexpected
    assert all(k.endswith('num_batches_tracked') for k in missing)
    return head, params, stats, port


@pytest.mark.parametrize('train', [True, False])
@pytest.mark.parametrize('num_convs', [0, 2])
def test_sim_siam_head_matches_jax(train, num_convs):
    """(z, p) and the updated running statistics, in train and eval mode;
    with two convs (conv, BN, ReLU, conv) before the pool too."""
    kw = dict(HEAD_KW, num_convs=num_convs, conv_mid_channels=12,
              conv_out_channles=24)
    x = np.maximum(np.random.RandomState(2).randn(32, 3, 3, 24), 0).astype(
        np.float32)
    head, params, stats, port = _head_pair(JaxHead, SimSiamHead, kw, x)
    (z, p), mut = head.apply({'params': params, 'batch_stats': stats},
                             jnp.asarray(x), train=train,
                             mutable=['batch_stats'])
    port.train(train)
    with torch.no_grad():
        pz, pp = port(torch.from_numpy(x))
    _close(pz, z, atol=1e-5)
    _close(pp, p, atol=1e-5)
    new = flax_head_to_torch(params, jax.tree.map(np.asarray,
                                                  mut['batch_stats']))
    sd = port.state_dict()
    for k, v in new.items():
        if 'running' in k:
            _close(sd[k], v.numpy())


def test_dense_sim_siam_head_matches_jax():
    kw = dict(in_channels=12, num_projection_convs=2,
              projection_mid_channels=10, projection_out_channels=8,
              num_predictor_convs=2, predictor_mid_channels=6,
              predictor_out_channels=8, kernel_size=3)
    rs = np.random.RandomState(4)
    x = rs.randn(4, 5, 6, 12).astype(np.float32)
    head, params, stats, port = _head_pair(JaxDenseHead, DenseSimSiamHead,
                                           kw, x)
    (z, p), _ = head.apply({'params': params, 'batch_stats': stats},
                           jnp.asarray(x), train=True,
                           mutable=['batch_stats'])
    port.train()
    pz, pp = port(torch.from_numpy(x))
    _close(pz, z, atol=1e-5)
    _close(pp, p, atol=1e-5)
    mask = (rs.rand(4, 30, 30) > .3).astype(np.float32)
    ref = head.apply({'params': params, 'batch_stats': stats}, p, z, p, z,
                     jnp.asarray(mask), jnp.asarray(mask), method='loss')
    out = port.loss(pp, pz, pp, pz, torch.from_numpy(mask),
                    torch.from_numpy(mask))
    _close(out['loss_feat'], ref['loss_feat'])


def test_batch_norm_follows_flax_not_torch():
    """The running variance takes flax's biased batch variance with
    momentum 0.9; torch's BatchNorm (unbiased, N/(N-1) larger at N=8)
    fails the same check."""
    import flax.linen as fnn
    x = np.random.RandomState(5).randn(8, 6).astype(np.float32) * 3 + 1
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, mut = bn.apply(v, jnp.asarray(x), mutable=['batch_stats'])
    ref_var = np.asarray(mut['batch_stats']['var'])
    port = BatchNorm1d(6).train()
    plain = nn.BatchNorm1d(6).train()
    with torch.no_grad():
        out = port(torch.from_numpy(x))
        plain(torch.from_numpy(x))
    _close(out, y)
    _close(port.running_var, ref_var)
    _close(port.running_mean, mut['batch_stats']['mean'])
    with pytest.raises(AssertionError):
        _close(plain.running_var, ref_var)
    np.testing.assert_allclose((plain.running_var - 0.9).numpy(),
                               (port.running_var - 0.9).numpy() * 8 / 7,
                               rtol=1e-5)
    # 2-d on a channels_last view (the ResNet's layout), then eval mode on
    # the running statistics
    x4 = np.random.RandomState(6).randn(3, 4, 5, 6).astype(np.float32)
    y4, mut4 = bn.apply(v, jnp.asarray(x4), mutable=['batch_stats'])
    bn2 = BatchNorm2d(6).train()
    with torch.no_grad():
        out4 = bn2(torch.from_numpy(x4).permute(0, 3, 1, 2))
    _close(out4.permute(0, 2, 3, 1), y4)
    _close(bn2.running_var, mut4['batch_stats']['var'])
    bn2.eval()
    with torch.no_grad():
        ev = bn2(torch.from_numpy(x4).permute(0, 3, 1, 2))
    ref_ev = (x4 - bn2.running_mean.numpy()) / np.sqrt(
        bn2.running_var.numpy() + 1e-5)
    _close(ev.permute(0, 2, 3, 1), ref_ev)


def test_batch_norm_bf16_input_matches_flax_bf16():
    """A bf16 input (the backbone under autocast) against flax's
    ``BatchNorm(dtype=bfloat16)``: statistics in fp32, output in bf16, and
    the input's gradient the bf16 sum of the statistics' part and the
    normalisation's part, each rounded to bf16 apart, as flax's two casts
    give it. Measured: output 4.6e-5, input gradient 1.2e-4 relative L2
    (99.96% bit-equal); one cast for both parts gives 2.9e-3, and a
    normalisation in bf16 more, so both fail at 1e-3."""
    import flax.linen as fnn
    rs = np.random.RandomState(7)
    x = jnp.asarray(rs.randn(8, 8, 8, 64).astype(np.float32)).astype(
        jnp.bfloat16)
    ct = jnp.asarray(rs.randn(8, 8, 8, 64).astype(np.float32)).astype(
        jnp.bfloat16)
    params = {'scale': jnp.asarray(1 + .1 * rs.randn(64), jnp.float32),
              'bias': jnp.asarray(.1 * rs.randn(64), jnp.float32)}
    stats = {'mean': jnp.zeros(64), 'var': jnp.ones(64)}

    def flax_bn(p, xx):
        return fnn.BatchNorm(use_running_average=False, momentum=0.9,
                             epsilon=1e-5, dtype=jnp.bfloat16).apply(
            {'params': p, 'batch_stats': stats}, xx,
            mutable=['batch_stats'])

    (y, mut), vjp = jax.vjp(flax_bn, params, x)
    gp, gx = vjp((ct, jax.tree.map(jnp.zeros_like, mut)))
    bn = BatchNorm2d(64).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(np.array(params['scale'])))
        bn.bias.copy_(torch.from_numpy(np.array(params['bias'])))

    def nchw(a):
        return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16).permute(0, 3, 1, 2)

    xt = nchw(x).requires_grad_()
    out = bn(xt)
    assert out.dtype == torch.bfloat16 and y.dtype == jnp.bfloat16
    assert bn.running_var.dtype == torch.float32
    out.backward(nchw(ct))

    def rel(a, b):
        a = a.detach().float().permute(0, 2, 3, 1).numpy() \
            if torch.is_tensor(a) else np.asarray(a, np.float32)
        b = np.asarray(b.astype(jnp.float32))
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(out, y) < 1e-3
    assert rel(xt.grad, gx) < 1e-3
    _close(bn.running_var, mut['batch_stats']['var'], rtol=1e-4, atol=1e-6)
    _close(bn.weight.grad, gp['scale'], rtol=1e-4, atol=1e-4)
    _close(bn.bias.grad, gp['bias'], rtol=1e-4, atol=1e-4)


@pytest.fixture(scope='module')
def tracker_weights():
    model = jax_build_model(MODEL_CFG, train_cfg=dict(intra_video=True))
    x = train_batch(1, b=2, t=3)
    params, stats = jax_variables(model, x)
    return params, stats, x


@pytest.mark.parametrize('intra_video', [True, False])
def test_tracker_loss_dict_and_parse_losses_match_jax(tracker_weights,
                                                      intra_video):
    params, stats, x = tracker_weights
    model = jax_build_model(MODEL_CFG,
                            train_cfg=dict(intra_video=intra_video))
    out, _ = jax.jit(lambda p, s, i: model.apply(
        {'params': p, 'batch_stats': s}, i, train=True,
        mutable=['batch_stats']))(params, stats, jnp.asarray(x))
    total_ref, log_ref = jax_parse_losses(out)
    port = port_model(params, stats,
                      train_cfg=dict(intra_video=intra_video))
    with torch.no_grad():
        losses = port(torch.from_numpy(x))
    expect = {f'img_head.{i}.loss_feat' for i in
              range(3 if intra_video else 1)}
    assert set(losses) == set(out) == expect
    for k in losses:
        assert losses[k].shape == (6,)  # per frame of the B*T
        _close(losses[k], out[k], rtol=5e-5)
    total, log_vars = parse_losses(losses)
    assert set(log_vars) == set(log_ref)
    _close(total, total_ref, rtol=2e-5)
    for k in log_vars:
        _close(log_vars[k], log_ref[k], rtol=2e-5)


def test_build_model_builds_trackers_heads_and_losses():
    head = build_model(dict(type='SimSiamHead', **HEAD_KW))
    assert isinstance(head, SimSiamHead)
    assert isinstance(build_model(dict(type='CosineSimLoss')), CosineSimLoss)
    assert type(build_model(MODEL_CFG)).__name__ == 'SimSiamBaseTracker'
    with pytest.raises(KeyError, match='registered'):
        build_model(dict(type='NoSuchThing'))
    with pytest.raises(ValueError, match=r'\(B, 2, T, H, W, C\)'):
        build_model(MODEL_CFG)(torch.zeros(1, 3, 2, 8, 8, 3))
