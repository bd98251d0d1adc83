"""The port's recognition losses, metrics, heads and recognizers against
the JAX package's (``vfs_tpu/models/{losses/regression,heads/
recognition_heads,recognizers}.py``, ``vfs_tpu/core/evaluation``), with
the JAX weights carried over by ``flax_recognizer_to_torch``.

The JAX variables take their shapes from ``jax.eval_shape`` of the
module's init (no compile) and their values from a seeded numpy draw:
kernels at a 1 / fan_in variance, BatchNorm scales in [0.5, 1.5),
shifts and running means ~0.1, running variances in [0.5, 1.5), so that
every layer is exercised away from its initial identity. Forward
tolerance (fp32): rtol 1e-4, atol 1e-5; the packages sum convolutions in
other orders (~1e-6 relative at these depths). Inputs: 32x32 frames,
2-4 segments or frames, narrow heads.

The helpers here (``jax_variables``, ``jax_apply``, ``port_model``,
``close``) serve the other ``test_torch_recognition_*`` files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.core.evaluation import accuracy as jax_accuracy
from vfs_tpu.core.evaluation.proposal import \
    get_weighted_score as jax_weighted_score
from vfs_tpu.models import build_head as jax_build_head
from vfs_tpu.models import build_loss as jax_build_loss
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu_torch.checkpoint import flax_recognizer_to_torch
from vfs_tpu_torch.core.evaluation import accuracy
from vfs_tpu_torch.models import (build_head, build_loss, build_model,
                                  build_recognizer)
from vfs_tpu_torch.models.heads import dropout, head_loss

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5


def jax_variables(module, *args, seed=0, dtype=np.float32, **kwargs):
    """{'params', 'batch_stats'} of ``module`` as numpy trees: the shapes
    of its init, the values of a seeded draw (module docstring)."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = str(path[-1].key), leaf.shape
        if name == 'kernel':
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ('scale', 'var'):
            a = rng.rand(*shape) + 0.5
        else:  # bias, mean
            a = rng.randn(*shape) * 0.1
        return a.astype(dtype)

    out = jax.tree_util.tree_map_with_path(fill, shapes)
    return dict(params=out['params'], batch_stats=out.get('batch_stats', {}))


def jax_apply(module, variables, *args, **kwargs):
    """``module.apply`` compiled whole (much faster on the CPU than op by
    op); ``kwargs`` are static."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kwargs))(
        variables, *args)


def load_port(model, variables):
    """Load JAX variables into a port model; every key but the BatchNorm
    counters must be there."""
    missing, unexpected = model.load_state_dict(flax_recognizer_to_torch(
        variables['params'], variables['batch_stats']), strict=False)
    assert not unexpected, unexpected
    assert all(k.endswith('num_batches_tracked') for k in missing), missing
    return model


def port_model(cfg, variables, build=build_model, **kwargs):
    return load_port(build(dict(cfg), **kwargs), variables)


def close(port, ref, rtol=RTOL, atol=ATOL, what=''):
    port = port.detach().numpy() if torch.is_tensor(port) else port
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=what)


def frames(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ------------------------------------------------------------------ losses

LOSSES = [
    ('CrossEntropyLoss', dict(loss_weight=0.5), 'hard'),
    ('CrossEntropyLoss', {}, 'soft'),
    ('BCELossWithLogits', {}, 'multi'),
    ('NLLLoss', dict(loss_weight=2.0), 'hard'),
    ('MSELoss', {}, 'dense'),
    ('L1Loss', {}, 'dense'),
    ('SmoothL1Loss', dict(beta=0.5), 'dense'),
]


@pytest.mark.parametrize('name,kwargs,labels', LOSSES,
                         ids=[f'{n}-{k}' for n, _, k in LOSSES])
def test_loss_matches_jax(name, kwargs, labels):
    rng = np.random.RandomState(3)
    score = rng.randn(6, 5).astype(np.float32)
    if labels == 'hard':
        target = rng.randint(0, 5, 6)
    elif labels == 'soft':
        target = rng.dirichlet(np.ones(5), 6).astype(np.float32)
    elif labels == 'multi':
        target = (rng.rand(6, 5) > 0.5).astype(np.float32)
    else:
        target = rng.randn(6, 5).astype(np.float32)
    cfg = dict(type=name, **kwargs)
    ours = build_loss(cfg)(torch.from_numpy(score), torch.from_numpy(target))
    ref = jax_build_loss(cfg)(jnp.asarray(score), jnp.asarray(target))
    close(ours, ref, 1e-6, 1e-7)


# ----------------------------------------------------------------- metrics

def _scores_labels(seed=0, n=40, k=7):
    rng = np.random.RandomState(seed)
    scores = rng.randn(n, k).astype(np.float32)
    labels = rng.randint(0, k, n)
    return scores, labels


@pytest.mark.parametrize('normalize', [None, 'true', 'pred', 'all'])
def test_confusion_matrix_matches_jax(normalize):
    rng = np.random.RandomState(1)
    pred, real = rng.randint(0, 5, 50), rng.randint(1, 6, 50)
    np.testing.assert_array_equal(
        accuracy.confusion_matrix(pred, real, normalize),
        jax_accuracy.confusion_matrix(pred, real, normalize))
    with pytest.raises(ValueError):
        accuracy.confusion_matrix(pred, real, 'rows')
    with pytest.raises(TypeError):
        accuracy.confusion_matrix(pred.astype(np.float32), real)


def test_recognition_metrics_match_jax():
    scores, labels = _scores_labels()
    assert accuracy.top_k_accuracy(scores, labels, (1, 3, 5)) == \
        jax_accuracy.top_k_accuracy(scores, labels, (1, 3, 5))
    assert accuracy.mean_class_accuracy(scores, labels) == \
        jax_accuracy.mean_class_accuracy(scores, labels)
    rng = np.random.RandomState(2)
    onehot = list((rng.rand(40, 7) > 0.6).astype(np.float32))
    assert accuracy.mean_average_precision(list(scores), onehot) == \
        jax_accuracy.mean_average_precision(list(scores), onehot)
    for ours, ref in zip(
            accuracy.binary_precision_recall_curve(scores[:, 0], onehot[0]
                                                   .repeat(6)[:40] > 0),
            jax_accuracy.binary_precision_recall_curve(
                scores[:, 0], onehot[0].repeat(6)[:40] > 0)):
        np.testing.assert_array_equal(ours, ref)
    lists = [list(scores), list(scores[::-1])]
    np.testing.assert_array_equal(
        np.array(accuracy.get_weighted_score(lists, [0.3, 0.7])),
        np.array(jax_weighted_score(lists, [0.3, 0.7])))


# ------------------------------------------------------------------- heads

HEADS = {
    'tsn': (dict(type='TSNHead', num_classes=6, in_channels=16,
                 dropout_ratio=0.0), (6, 16, 3, 3), dict(num_segs=3)),
    'i3d': (dict(type='I3DHead', num_classes=6, in_channels=16,
                 dropout_ratio=0.0), (2, 16, 2, 3, 3), {}),
    'tsm': (dict(type='TSMHead', num_classes=6, in_channels=16,
                 num_segments=3, dropout_ratio=0.0), (6, 16, 3, 3),
            dict(num_segs=3)),
    'tsm_temporal_pool': (dict(type='TSMHead', num_classes=6,
                               in_channels=16, num_segments=4,
                               temporal_pool=True, dropout_ratio=0.0),
                          (4, 16, 3, 3), dict(num_segs=2)),
    'slowfast': (dict(type='SlowFastHead', num_classes=6, in_channels=24,
                      dropout_ratio=0.0), ((2, 16, 1, 3, 3),
                                           (2, 8, 4, 3, 3)), {}),
}


def _to_nhwc(x):
    return np.moveaxis(x, 1, -1)


@pytest.mark.parametrize('name', list(HEADS))
def test_head_forward_and_loss_match_jax(name):
    """Each head on NCHW / NCTHW maps against the JAX head on the same
    maps channels-last; SlowFast's fc sees [fast, slow]."""
    cfg, shape, kw = HEADS[name]
    if name == 'slowfast':
        x = (frames(*shape[0], seed=1), frames(*shape[1], seed=2))
        jx = tuple(jnp.asarray(_to_nhwc(a)) for a in x)
        tx = tuple(torch.from_numpy(a) for a in x)
    else:
        x = frames(*shape, seed=1)
        jx, tx = jnp.asarray(_to_nhwc(x)), torch.from_numpy(x)
    jhead = jax_build_head(dict(cfg))
    jargs = (jx, kw['num_segs']) if kw else (jx,)
    variables = jax_variables(jhead, *jargs, train=False)
    ref = jhead.apply({'params': variables['params']}, *jargs, train=False)
    head = port_model(cfg, variables, build_head).eval()
    out = head(tx, kw['num_segs']) if kw else head(tx)
    close(out, ref)
    labels = np.array([1, 4])
    loss = head.loss(out, torch.from_numpy(labels))['loss_cls']
    ref_loss = jhead.apply({'params': variables['params']}, ref,
                           jnp.asarray(labels), method='loss')['loss_cls']
    close(loss, ref_loss)


@pytest.mark.parametrize('labels,multi_class,eps', [
    ('hard', False, 0.0), ('soft', False, 0.0), ('multi', True, 0.1),
    ('multi', True, 0.0)], ids=['hard', 'soft', 'multi_smooth', 'multi'])
def test_head_loss_branches_match_jax(labels, multi_class, eps):
    from vfs_tpu.models.heads.recognition_heads import \
        head_loss as jax_head_loss
    rng = np.random.RandomState(4)
    score = rng.randn(5, 4).astype(np.float32)
    target = rng.randint(0, 4, 5) if labels == 'hard' else \
        rng.dirichlet(np.ones(4), 5).astype(np.float32) if labels == 'soft' \
        else (rng.rand(5, 4) > 0.5).astype(np.float32)
    loss_cfg = dict(type='BCELossWithLogits') if multi_class else \
        dict(type='CrossEntropyLoss')
    ours = head_loss(build_loss(loss_cfg), torch.from_numpy(score),
                     torch.from_numpy(target), 4, eps, multi_class)
    ref = jax_head_loss(jax_build_loss(loss_cfg), jnp.asarray(score),
                        jnp.asarray(target), 4, eps, multi_class)
    close(ours['loss_cls'], ref['loss_cls'], 1e-6, 1e-7)


def test_dropout_rate_scale_and_seeding():
    """flax's rule: zeros with probability p, the rest scaled by 1 / (1 -
    p); equal generator seeds draw equal masks, other seeds others; the
    head drops only in training mode."""
    x = torch.ones(200, 500)
    gen = torch.Generator().manual_seed(7)
    y = dropout(x, 0.3, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    again = dropout(x, 0.3, torch.Generator().manual_seed(7))
    other = dropout(x, 0.3, torch.Generator().manual_seed(8))
    assert torch.equal(y, again) and not torch.equal(y, other)
    head = build_head(dict(type='I3DHead', num_classes=3, in_channels=8,
                           dropout_ratio=0.5))
    feats = torch.ones(4, 8, 1, 1, 1)
    head.eval()
    assert torch.equal(head(feats), head(feats))
    head.train()
    a = head(feats, generator=torch.Generator().manual_seed(1))
    b = head(feats, generator=torch.Generator().manual_seed(1))
    c = head(feats, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_head_init_draws_normal_init_std():
    """``fc_cls`` takes normal(init_std) and a zero bias: 0.01 for TSN,
    I3D and SlowFast, 0.001 for TSM."""
    for cfg, std in ((dict(type='TSNHead'), 0.01),
                     (dict(type='TSMHead'), 0.001),
                     (dict(type='I3DHead'), 0.01),
                     (dict(type='SlowFastHead'), 0.01)):
        head = build_head(dict(cfg, num_classes=400, in_channels=256))
        with torch.no_grad():
            head.flax_init(torch.Generator().manual_seed(0))
        w = head.fc_cls.weight
        assert abs(w.std().item() - std) < 0.03 * std
        assert abs(w.mean().item()) < 0.03 * std
        assert not head.fc_cls.bias.any()


# ------------------------------------------------------------- recognizers

RECOGNIZERS = {
    'tsn_resnet': (dict(type='Recognizer2D',
                        backbone=dict(type='ResNet', depth=18),
                        cls_head=dict(type='TSNHead', num_classes=5,
                                      in_channels=512, dropout_ratio=0.0)),
                   (2, 3, 32, 32, 3)),
    'tsm': (dict(type='Recognizer2D',
                 backbone=dict(type='ResNetTSM', depth=18, num_segments=3),
                 cls_head=dict(type='TSMHead', num_classes=5,
                               in_channels=512, num_segments=3,
                               dropout_ratio=0.0)),
            (2, 3, 32, 32, 3)),
    'i3d': (dict(type='Recognizer3D',
                 backbone=dict(type='ResNet3d', depth=18,
                               base_channels=16),
                 cls_head=dict(type='I3DHead', num_classes=5,
                               in_channels=128, dropout_ratio=0.0)),
            (1, 2, 8, 32, 32, 3)),
}


@pytest.mark.parametrize('average_clips', [None, 'score', 'prob'])
@pytest.mark.parametrize('name', list(RECOGNIZERS))
def test_recognizer_scores_match_jax(name, average_clips):
    """``return_loss=False`` on channels-last clips, with each
    ``average_clips`` mode of ``test_cfg``."""
    cfg, shape = RECOGNIZERS[name]
    test_cfg = dict(average_clips=average_clips)
    jmodel = jax_build_model(cfg, test_cfg=test_cfg)
    x = frames(*shape, seed=5)
    variables = jax_variables(jmodel, x, train=False, return_loss=False)
    ref = jax_apply(jmodel, variables, jnp.asarray(x), train=False,
                    return_loss=False)
    model = port_model(cfg, variables, test_cfg=test_cfg).eval()
    with torch.no_grad():
        out = model(torch.from_numpy(x), return_loss=False)
    close(out, ref)


def test_average_clip_rejects_unknown_mode():
    model = build_recognizer(RECOGNIZERS['tsm'][0],
                             test_cfg=dict(average_clips='vote'))
    with pytest.raises(ValueError, match='vote'):
        model.average_clip(torch.zeros(2, 5))


@pytest.mark.parametrize('name', ['tsm'])
def test_recognizer_train_loss_and_running_stats_match_jax(name):
    """A train-mode forward with labels: the loss dict and every running
    statistic after flax's update, in fp32. (Both recognizers' train steps
    are held in float64 in ``test_torch_recognition_train.py``: in fp32
    the 3-D net's last BatchNorms see two values a channel, where ``E[x^2]
    - E[x]^2`` leaves ~1e-4 of rounding in the loss.)"""
    cfg, shape = RECOGNIZERS[name]
    jmodel = jax_build_model(cfg)
    x = frames(*shape, seed=6)
    rows = shape[0] * (shape[1] if name == 'i3d' else 1)  # clip scores
    labels = np.array([3, 1, 4, 0])[:rows]
    variables = jax_variables(jmodel, x, jnp.asarray(labels), train=True)
    losses, mutated = jax_apply(jmodel, variables, jnp.asarray(x),
                                jnp.asarray(labels), train=True,
                                mutable=['batch_stats'])
    model = port_model(cfg, variables).train()
    ours = model(torch.from_numpy(x), torch.from_numpy(labels))
    close(ours['loss_cls'], losses['loss_cls'])
    ref_sd = flax_recognizer_to_torch(variables['params'],
                                      mutated['batch_stats'])
    sd = model.state_dict()
    for k in (k for k in ref_sd if 'running' in k):
        close(sd[k], ref_sd[k].numpy(), what=k)


def test_build_model_dispatches_recognizers():
    model = build_model(RECOGNIZERS['tsm'][0], test_cfg=dict(
        average_clips='prob'))
    assert type(model).__name__ == 'Recognizer2D'
    assert model.test_cfg == dict(average_clips='prob')
    # a type no registry holds raises; BMN, unregistered before slice 13
    # ported the localizers, now builds through LOCALIZERS
    with pytest.raises(KeyError):
        build_model(dict(type='NoSuchModel'))
    bmn = build_model(dict(type='BMN', temporal_dim=5, boundary_ratio=0.5,
                           num_samples=2, num_samples_per_bin=1,
                           feat_dim=8, soft_nms_alpha=0.4,
                           soft_nms_low_threshold=0.5,
                           soft_nms_high_threshold=0.9,
                           post_process_top_k=10, hidden_dim_1d=8,
                           hidden_dim_2d=4, hidden_dim_3d=8),
                      test_cfg=dict(average_clips='prob'))
    assert type(bmn).__name__ == 'BMN'
    assert bmn.test_cfg == dict(average_clips='prob')
