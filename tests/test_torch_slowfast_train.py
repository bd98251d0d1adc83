"""SlowFast training in the port against the benchmark's plain reference
(``portbench/reference/slowfast.py``), and the reference against the JAX
package's SlowFast (``vfs_tpu/models/backbones/resnet3d_variants.py``),
at a small size on the CPU: SlowFast-R50 at base channels 16 / 2, 2 clips
of 16 frames of 32x32, ten classes.

- The port's ``Recognizer3D`` over ``ResNet3dSlowFast`` through
  ``make_train_step`` (labels, the head's dropout at p 0.5 on the step's
  draws, SGD with momentum and decay, the recipe's warm-up, the gradient
  clipped at max norm 1) against the reference on the same seeded
  weights (the port's init, BatchNorm perturbed) in float64: the first
  step's loss, every leaf's first gradient after the clip, the losses of
  three updates and every parameter and running statistic after them,
  within 1e-9. The clip is engaged in every step. (In fp32 the two part
  by up to ~1e-3 in the later losses: the first update's rounding,
  carried by the stems' large gradients at this size.)
- The reference's forward against the JAX package's, on the JAX
  variables carried by ``flax_recognizer_to_torch``: training mode (batch
  statistics, the loss, every running statistic after flax's update) in
  float64 within 1e-9, eval mode in fp32 within rtol 1e-4 / atol 1e-5
  (convolutions summed in other orders).
- The recipe's ``lr_config`` (cosine, linear warm-up by epoch): the
  port's schedule gives mmcv's rate (the reference's ``lr_at``) through
  the first epoch.
- One step inside ``utils.trace.recording()``: the spans around each
  pathway's stem and stages, the laterals, the head and the clip, and
  the concatenations' bytes.
"""

import functools
import json
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vfs_tpu.models.backbones.resnet3d as jax_resnet3d
import vfs_tpu.models.backbones.resnet3d_variants as jax_variants
from portbench.reference import slowfast
from portbench.reference.device_aug import step_seed as ref_step_seed
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu_torch.apis.train import DROPOUT_STREAM, make_train_step
from vfs_tpu_torch.checkpoint import flax_recognizer_to_torch
from vfs_tpu_torch.core.optimizer import build_lr_schedule, build_optimizer
from vfs_tpu_torch.models import build_model
from vfs_tpu_torch.ops.device_aug import step_seed
from vfs_tpu_torch.utils import trace

from test_torch_recognition import close, frames, jax_apply, jax_variables

torch.set_num_threads(1)

SLOW = dict(type='resnet3d', depth=50, pretrained=None, lateral=True,
            base_channels=16, conv1_kernel=(1, 7, 7), dilations=(1, 1, 1, 1),
            conv1_stride_t=1, pool1_stride_t=1, inflate=(0, 0, 1, 1),
            norm_eval=False)
FAST = dict(type='resnet3d', depth=50, pretrained=None, lateral=False,
            base_channels=2, conv1_kernel=(5, 7, 7), conv1_stride_t=1,
            pool1_stride_t=1, norm_eval=False)


def model_cfg(dropout=0.5):
    return dict(type='Recognizer3D', backbone=dict(
        type='ResNet3dSlowFast', pretrained=None, resample_rate=8,
        speed_ratio=8, channel_ratio=8, slow_pathway=SLOW,
        fast_pathway=FAST), cls_head=dict(
        type='SlowFastHead', in_channels=16 * 32 + 2 * 32, num_classes=10,
        spatial_type='avg', dropout_ratio=dropout))


def plain(cfg):
    """The dict as a JSON configuration holds it (lists for tuples)."""
    return json.loads(json.dumps(cfg))


SHAPE = (2, 1, 16, 32, 32, 3)
LABELS = ([3, 7], [0, 9], [5, 5])
OPT = dict(type='SGD', lr=0.1, momentum=0.9, weight_decay=1e-4)
LR = dict(policy='CosineAnnealing', min_lr=0, warmup='linear',
          warmup_by_epoch=True, warmup_iters=34)
EPOCHS, ITERS = 256, 3757
MAX_NORM = 1.0
SEED = 2**31 + 7


def seeded_state(seed):
    """The port's init from a seeded generator, then BatchNorm scales
    1 + 0.1 N(0, 1) and shifts 0.1 N(0, 1) (the benchmark's rule)."""
    model = build_model(model_cfg())
    generator = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        model.init_weights(generator)
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                     generator=generator))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape,
                                               generator=generator))
    return {k: v.double() if v.is_floating_point() else v
            for k, v in model.state_dict().items()}


def batches():
    return [torch.from_numpy(frames(*SHAPE, seed=20 + i).astype(np.float64))
            for i in range(3)]


def port_steps(state):
    model = build_model(model_cfg()).double()
    model.load_state_dict(state)
    model.train()
    optimizer, _ = build_optimizer(model.parameters(), OPT, LR,
                                   EPOCHS * ITERS, ITERS, MAX_NORM)
    step = make_train_step(model, optimizer, seed=SEED)
    losses, first = [], None
    for i, x in enumerate(batches()):
        losses.append(float(step(x, labels=torch.tensor(LABELS[i]))['loss']))
        if i == 0:
            first = {n: m[0] - OPT['weight_decay'] * state[n]
                     for (n, _), m in zip(model.named_parameters(),
                                          optimizer.moments)}
    return losses, first, model.state_dict()


def reference_steps(state):
    model = slowfast.SlowFast(plain(model_cfg())).double()
    model.load_state_dict(state)
    keeps = []
    for count in range(3):
        g = torch.Generator().manual_seed(
            ref_step_seed(SEED, 0, count, slowfast.DROPOUT_STREAM))
        keeps.append(slowfast.dropout_keep((SHAPE[0], 576), 0.5, g))
    out = slowfast.sgd_steps(
        model, batches(), [torch.tensor(x) for x in LABELS], keeps, OPT,
        MAX_NORM, lambda c: slowfast.lr_at(c, OPT['lr'], LR, ITERS, EPOCHS))
    return out, model.state_dict()


@pytest.fixture(scope='module')
def both():
    state = seeded_state(5)
    return state, port_steps(state), reference_steps(state)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b)) \
        / (float(torch.linalg.vector_norm(b)) + 1e-300)


def test_reference_draws_the_programs_dropout_stream():
    assert slowfast.DROPOUT_STREAM == DROPOUT_STREAM
    for args in ((SEED, 0, 2, DROPOUT_STREAM), (3, 1, 0)):
        assert ref_step_seed(*args) == step_seed(*args)


def test_first_loss_and_gradients_match_the_reference(both):
    state, (losses, first, _), (ref, _) = both
    assert losses[0] == pytest.approx(float(ref['losses'][0]), rel=1e-12)
    assert set(first) == set(ref['first_grads'])
    for name, g in first.items():
        assert _rel(g, ref['first_grads'][name]) < 1e-9, name


def test_three_clipped_updates_match_the_reference(both):
    state, (losses, _, after), (ref, ref_after) = both
    assert all(n > MAX_NORM for n in ref['total_norms'])
    np.testing.assert_allclose(losses, [float(x) for x in ref['losses']],
                               rtol=1e-9)
    for name, v in ref_after.items():
        if v.is_floating_point():
            change = after[name] - state[name]
            ref_change = v - state[name]
            assert float(torch.linalg.vector_norm(change - ref_change)) \
                <= 1e-9 * float(torch.linalg.vector_norm(ref_change)) \
                + 1e-12, name


def _jax_f64(monkeypatch):
    """The JAX SlowFast computing in float64: its ``ConvBN3d`` and
    ``Bottleneck3d`` (fp32 by default, with no dtype argument on the
    backbone) given ``dtype=float64``."""
    monkeypatch.setattr(jax_variants, 'ConvBN3d', functools.partial(
        jax_resnet3d.ConvBN3d, dtype=jnp.float64))
    class Bottleneck3d(jax_resnet3d.Bottleneck3d):
        dtype: Any = jnp.float64

    settings = dict(jax_variants.ARCH_SETTINGS_3D)
    settings[50] = (Bottleneck3d, settings[50][1])
    monkeypatch.setattr(jax_variants, 'ARCH_SETTINGS_3D', settings)


def test_reference_train_forward_matches_jax_in_float64(monkeypatch):
    """Batch statistics: the loss and every running statistic after
    flax's update, the JAX variables loaded into the reference."""
    cfg = model_cfg(dropout=0.0)
    x = frames(*SHAPE, seed=3).astype(np.float64)
    labels = np.array([3, 7])
    with jax.enable_x64(True):
        _jax_f64(monkeypatch)
        jmodel = jax_build_model(cfg)
        variables = jax_variables(jmodel, x, jnp.asarray(labels),
                                  train=True, dtype=np.float64)
        losses, mutated = jax_apply(jmodel, variables, jnp.asarray(x),
                                    jnp.asarray(labels), train=True,
                                    mutable=['batch_stats'])
        losses = jax.tree.map(np.asarray, losses)
        mutated = jax.tree.map(np.asarray, mutated)
    ref = slowfast.SlowFast(plain(cfg)).double()
    missing, unexpected = ref.load_state_dict(flax_recognizer_to_torch(
        variables['params'], variables['batch_stats']), strict=False)
    assert not unexpected
    assert all(k.endswith('num_batches_tracked') for k in missing), missing
    ref.train()
    with torch.no_grad():
        loss = slowfast.cross_entropy(ref(torch.from_numpy(x)),
                                      torch.from_numpy(labels))
    assert float(loss) == pytest.approx(float(losses['loss_cls']),
                                        rel=1e-9)
    after = flax_recognizer_to_torch(variables['params'],
                                     mutated['batch_stats'])
    sd = ref.state_dict()
    for k in (k for k in after if 'running' in k):
        assert _rel(sd[k], after[k].double()) < 1e-9, k


def test_reference_eval_forward_matches_jax():
    cfg = model_cfg(dropout=0.0)
    jmodel = jax_build_model(cfg)
    x = frames(*SHAPE, seed=4)
    variables = jax_variables(jmodel, x, train=False, return_loss=False)
    scores = jax_apply(jmodel, variables, jnp.asarray(x), train=False,
                       return_loss=False)
    ref = slowfast.SlowFast(plain(cfg))
    ref.load_state_dict(flax_recognizer_to_torch(
        variables['params'], variables['batch_stats']), strict=False)
    ref.eval()
    with torch.no_grad():
        close(ref(torch.from_numpy(x)), scores)


@pytest.mark.parametrize('count', [0, 1, 2, 1000, ITERS - 1])
def test_recipe_schedule_is_mmcvs_in_the_first_epoch(count):
    """Linear warm-up by epoch from 0.1 of the rate over 34 epochs of
    updates; through the first epoch mmcv's cosine by epoch is the base
    rate, so the port's schedule (optax's warm-up joined to a cosine by
    update) gives the same rate."""
    schedule = build_lr_schedule(LR, OPT['lr'], EPOCHS * ITERS, ITERS)
    assert schedule(count) == pytest.approx(
        slowfast.lr_at(count, OPT['lr'], LR, ITERS, EPOCHS), rel=1e-12)
    assert schedule(count) == pytest.approx(
        OPT['lr'] * (0.1 + 0.9 * count / (34 * ITERS)), rel=1e-12)


def test_one_step_records_the_slowfast_spans_and_counter():
    state = {k: v.float() if v.is_floating_point() else v
             for k, v in seeded_state(6).items()}
    model = build_model(model_cfg())
    model.load_state_dict(state)
    model.train()
    optimizer, _ = build_optimizer(model.parameters(), OPT, LR,
                                   EPOCHS * ITERS, ITERS, MAX_NORM)
    widths = []
    slow = model.backbone.slow_path
    hooks = [getattr(slow, f'layer{i + 1}').register_forward_pre_hook(
        lambda m, inp: widths.append(inp[0].numel())) for i in range(4)]
    step = make_train_step(model, optimizer, seed=1)
    x = torch.from_numpy(frames(*SHAPE, seed=9))
    with trace.recording() as rec:
        step(x, labels=torch.tensor([1, 2]))
    for h in hooks:
        h.remove()
    names = [s.name for s in rec.spans]
    assert names.count('slowfast.slow') == 5
    assert names.count('slowfast.fast') == 5
    assert names.count('slowfast.lateral') == 4
    assert names.count('recognizer.head') == 1
    assert names.count('optimizer.clip') == 1
    # each stage's input is a concatenation's output, in fp32
    assert rec.counts['slowfast.concat_bytes'] == 4 * sum(widths)
    by_id = {s.id: s for s in rec.spans}
    for s in rec.spans:
        if s.name.startswith('slowfast.'):
            assert by_id[s.parent].name == 'train.forward'
        if s.name == 'optimizer.clip':
            assert by_id[s.parent].name == 'train.optimizer'
