"""The bf16 eval configuration of the JAX package's bench (bench.py:63-72,
114-124) in vfs_tpu_torch against vfs_tpu on the CPU:
``pallas_precision='bfloat16'`` (bf16 features on the Pallas paths), a
bf16 backbone, yuv420 transport.

- Rows 1, 2 and 3's plain bf16 paths against the TPU kernels in Pallas
  interpret mode with bf16 features, as tests/test_ops/test_pallas_video.py
  and test_pallas_kernel.py run them. Both sum exact bf16 x bf16 products
  in fp32, in other orders: row 1's sources equal on every valid entry and
  scores to rtol 1e-5 / atol 1e-6 (measured 9.5e-7); logits of the
  propagation (rows 1, 2 and the scan of row 3) and of row 3 alone to
  rtol 1e-4 / atol 1e-5 (measured 2.4e-7 and 1.8e-7), argmax equal
  everywhere.
- ``tiled`` and ``dense`` ignore the knob, as in the JAX package: equal
  to their fp32 results bit for bit and to the JAX tiled tier's within
  rtol 1e-4 / atol 1e-5 (measured 4.8e-7); the Pallas paths do not.
- The bf16 backbone's eval features (``VanillaTracker._extract_feats``,
  inside the exact fp32 mode) against the JAX package's bf16-dtyped
  ResNet: relative L2 under half the gap between the JAX bf16 and fp32
  features (measured 2.5e-3 against a gap of 7.4e-3; the fp32 backbones
  8.5e-7 apart), so the autocast takes effect. The JAX tracker's jitted
  extraction is not the reference here: under jit XLA may skip bf16
  roundings between fused operations (its bf16 features read 6.4e-3 from
  fp32 and 8.2e-3 from the port's).
- ``forward_test`` in the full bench configuration (P = 20, top-10,
  neighbor 24, batch_step 20, bf16 backbone and features, yuv420) at
  64x96 against the JAX tracker on the same weights: masks equal on
  >= 0.99 of pixels (measured 0.99927: the two bf16 backbones round
  apart, as above).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.ops import propagation as jax_prop
from vfs_tpu.ops.affinity import l2_normalize as jax_l2_normalize
from vfs_tpu.ops.pallas_attention import (pad_for_pallas,
                                          pallas_local_topk_attend)
from vfs_tpu_torch.ops import NEG_INF
from vfs_tpu_torch.ops import propagation as torch_prop
from vfs_tpu_torch.ops.local_attention import local_topk_attend
from vfs_tpu_torch.ops.video_affinity import video_topk_affinity

from test_torch_local_attention_modes import _valid_keys
from test_torch_resnet import jax_resnet_variables
from test_torch_video_affinity import _jax_affinity

torch.set_num_threads(1)

COMMON = dict(precede_frames=4, topk=4, temperature=0.07, neighbor_range=6,
              pallas_tile=(4, 4))


def _inputs(seed, t_total=8, h=6, w=7, c=16, k=3):
    rng = np.random.RandomState(seed)
    feats = rng.randn(t_total, h, w, c).astype(np.float32)
    seg_first = np.eye(k, dtype=np.float32)[rng.randint(0, k, (h, w))]
    return feats, seg_first


def _port(feats, seg_first, **kw):
    return torch_prop.propagate_video(
        torch.from_numpy(feats), torch.from_numpy(seg_first), None,
        torch_prop.PropagationConfig(**dict(COMMON, **kw))).numpy()


def _jax(feats, seg_first, **kw):
    return np.asarray(jax_prop.propagate_video(
        jnp.asarray(feats), jnp.asarray(seg_first), None,
        jax_prop.PropagationConfig(**dict(COMMON, pallas_interpret=True,
                                          **kw))))


def test_row1_bf16_lists_match_tpu_kernel():
    """Row 1's plain version on bf16 features against video_topk_affinity2
    run on the same bf16 features in interpret mode: the exact top-k of
    the same scores."""
    rng = np.random.RandomState(3)
    feats = rng.randn(9, 6, 7, 16).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    bf16 = torch.from_numpy(feats).to(torch.bfloat16)
    out_s, out_i = video_topk_affinity(bf16, 3, 0.07, 5, 4)
    ref_s, ref_i = _jax_affinity(jnp.asarray(feats).astype(jnp.bfloat16),
                                 3, 5, 4)
    out_s, out_i = out_s.numpy()[1:], out_i.numpy()[1:]
    ref_s, ref_i = ref_s[1:], ref_i[1:]
    np.testing.assert_allclose(out_s, ref_s, rtol=1e-5, atol=1e-6)
    valid = ref_s > NEG_INF / 2
    assert valid.all()
    np.testing.assert_array_equal(out_i[valid], ref_i[valid])
    # the bf16 lists are not the fp32 lists: the cast took effect
    fp32_s, _ = video_topk_affinity(torch.from_numpy(feats), 3, 0.07, 5, 4)
    assert not np.array_equal(fp32_s.numpy()[1:], out_s)


@pytest.mark.parametrize('backend,engine', [
    ('pallas_video', 'v2'), ('pallas_video', 'v1'), ('pallas', 'v2')],
    ids=['row1_v2', 'row2_v1', 'row3_scan'])
def test_bf16_propagation_matches_pallas_interpret(backend, engine):
    """``propagate_video`` with ``pallas_precision='bfloat16'`` on the
    Pallas paths: the JAX package's kernels in interpret mode with bf16
    features (v2 and v1 whole-video engines, the per-step scan whose bank
    ring is bf16) against the port's plain versions."""
    feats, seg_first = _inputs(7)
    kw = dict(backend=backend, video_engine=engine,
              video_extract='perframe', pallas_precision='bfloat16')
    ref = _jax(feats, seg_first, **kw)
    out = _port(feats, seg_first, **kw)
    assert (np.argmax(ref, -1) == np.argmax(out, -1)).mean() == 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    fp32 = _port(feats, seg_first, **dict(kw, pallas_precision='float32'))
    assert not np.array_equal(fp32, out)


def test_row3_bf16_matches_pallas_kernel():
    """Row 3 on a bf16 query and bank against pallas_local_topk_attend(...,
    matmul_precision='bfloat16', interpret=True), as
    tests/test_ops/test_pallas_kernel.py:94 runs it."""
    rng = np.random.RandomState(2)
    h, w, f, c, k, topk = 12, 14, 5, 16, 3, 4
    radius, tile = 3, (4, 8)
    query = jax_l2_normalize(jnp.asarray(rng.randn(h, w, c), jnp.float32),
                             -1)
    bank_f = jax_l2_normalize(
        jnp.asarray(rng.randn(f, h, w, c), jnp.float32), -1)
    bank_v = rng.rand(f, h, w, k).astype(np.float32)
    valid = np.array([1, 1, 0, 1, 1], np.int32)
    ref = np.asarray(pallas_local_topk_attend(
        pad_for_pallas(query, h, w, radius, tile),
        pad_for_pallas(bank_f, h, w, radius, tile), jnp.asarray(bank_v),
        jnp.asarray(valid), radius=radius, temperature=0.07, topk=topk,
        h=h, w=w, tile=tile, interpret=True, matmul_precision='bfloat16'))
    out, scores, _ = local_topk_attend(
        torch.from_numpy(np.array(query)).to(torch.bfloat16),
        torch.from_numpy(np.array(bank_f)).to(torch.bfloat16),
        torch.from_numpy(bank_v), torch.from_numpy(valid), float(radius),
        0.07, topk)
    assert scores.dtype == torch.float32
    assert (ref.argmax(-1) == out.numpy().argmax(-1)).mean() == 1.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('backend', ['tiled', 'dense'])
def test_tiled_and_dense_ignore_the_knob(backend):
    """The cast exists only on the two Pallas paths, in both packages."""
    feats, seg_first = _inputs(11)
    out = _port(feats, seg_first, backend=backend,
                pallas_precision='bfloat16')
    np.testing.assert_array_equal(out, _port(feats, seg_first,
                                             backend=backend))
    ref = _jax(feats, seg_first, backend='tiled',
               pallas_precision='bfloat16')
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_unknown_precision_raises_on_pallas_paths():
    """An unknown feature type raises; the scan's bf16 scores, refused
    before slice 10 ported them, run with bf16 features and match the JAX
    package's interpret-mode scan (every query keeps >= k valid keys:
    frame 0's slot alone holds >= 9 in-map keys of a corner's circle of
    radius 3, against top-4; tests/test_torch_local_attention_modes.py
    covers the modes in full)."""
    feats, seg_first = _inputs(1)
    with pytest.raises(ValueError, match='pallas_precision'):
        _port(feats, seg_first, backend='pallas_video',
              pallas_precision='float16')
    assert (_valid_keys(6, 7, 3, [1]) >= COMMON['topk']).all()
    kw = dict(backend='pallas', pallas_scores='bfloat16',
              pallas_precision='bfloat16')
    out, ref = _port(feats, seg_first, **kw), _jax(feats, seg_first, **kw)
    assert (ref.argmax(-1) == out.argmax(-1)).mean() == 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


MEAN = np.array([123.675, 116.28, 103.53], np.float32)
STD = np.array([58.395, 57.12, 57.375], np.float32)


def _trackers(test_cfg, seed, hw, dtype):
    from vfs_tpu.models import build_model as jax_build_model
    from vfs_tpu_torch.checkpoint import flax_resnet_to_torch
    from vfs_tpu_torch.models import build_model
    _, variables = jax_resnet_variables(18, (1, 2, 1, 1), (2,), seed=seed,
                                        hw=hw)
    model_cfg = dict(type='VanillaTracker', backbone=dict(
        type='ResNet', depth=18, out_indices=(3,), dtype=dtype))
    jax_tracker = jax_build_model(model_cfg, test_cfg=dict(test_cfg))
    jax_tracker.variables = variables
    port = build_model(model_cfg, test_cfg=dict(test_cfg))
    port.load_weights(flax_resnet_to_torch(variables['params'],
                                           variables['batch_stats']))
    return jax_tracker, port


def test_bf16_backbone_eval_features_match_jax():
    """The port's bf16 eval features (``_extract_feats``: uint8 frames
    normalised on the device, the backbone under bf16 autocast inside the
    exact fp32 mode, fp32 at the seam) against the JAX package's
    bf16-dtyped ResNet on the same weights and normalised frames."""
    from vfs_tpu.models.backbones import ResNet as JaxResNet
    test_cfg = dict(strides=(1, 2, 1, 1), out_indices=(2,), batch_step=2)
    rng = np.random.RandomState(0)
    imgs = rng.randint(0, 255, (4, 48, 64, 3)).astype(np.uint8)
    x = jnp.asarray((imgs.astype(np.float32) - MEAN) / STD)
    feats = {}
    for dtype in ('float32', 'bfloat16'):
        _, port = _trackers(test_cfg, 6, (48, 64), dtype)
        _, variables = jax_resnet_variables(18, (1, 2, 1, 1), (2,), seed=6,
                                            hw=(48, 64))
        ref = JaxResNet(depth=18, strides=(1, 2, 1, 1), out_indices=(2,),
                        dtype=jnp.dtype(dtype)).apply(variables, x,
                                                      train=False)
        out = port._extract_feats(torch.from_numpy(imgs), 2,
                                  torch.from_numpy(MEAN),
                                  torch.from_numpy(STD))[0]
        assert out.dtype == torch.float32
        assert ref.dtype == jnp.dtype(dtype)
        feats[dtype] = (out.numpy(), np.asarray(ref, np.float32))
    gap = _rel(feats['bfloat16'][1], feats['float32'][1])
    assert _rel(*feats['float32']) < 1e-4  # the fp32 backbones agree
    assert _rel(*feats['bfloat16']) < gap / 2, (_rel(*feats['bfloat16']),
                                                gap)
    assert gap > 1e-3


def test_forward_test_bench_config_matches_jax(monkeypatch):
    """``forward_test`` in bench.py's r18 configuration at 64x96, 6
    frames: yuv420 transport, bf16 backbone, bf16 features through the
    v2 engine, P = 20, top-10, neighbor 24, batch_step 20. The JAX
    tracker's config builder does not read ``pallas_interpret``, so the
    test wraps it to run the TPU kernel in interpret mode on the CPU."""
    from vfs_tpu.models.trackers import vanilla_tracker as jax_vt
    make = jax_vt.make_propagation_config

    def interpreted(*args, **kwargs):
        cfg, mask = make(*args, **kwargs)
        return cfg._replace(pallas_interpret=True), mask

    monkeypatch.setattr(jax_vt, 'make_propagation_config', interpreted)
    test_cfg = dict(precede_frames=20, topk=10, temperature=0.07,
                    strides=(1, 2, 1, 1), out_indices=(2,),
                    neighbor_range=24, with_first=True,
                    with_first_neighbor=True, batch_step=20,
                    pallas_precision='bfloat16', input_format='yuv420',
                    backend='pallas_video')
    jax_tracker, port = _trackers(test_cfg, 8, (64, 96), 'bfloat16')
    from test_torch_tracker import make_video
    imgs, labels = make_video(num_frames=6, seed=3)
    meta = [dict(original_shape=(64, 96),
                 img_norm_cfg=dict(mean=MEAN, std=STD))]
    ref = jax_tracker.forward_test(imgs, labels[0], meta)[0]
    out = port.forward_test(imgs, labels[0], meta, device='cpu')[0]
    assert out.shape == ref.shape == (6, 64, 96) and out.dtype == np.uint8
    np.testing.assert_array_equal(out[0], labels[0])
    assert (out == ref).mean() >= 0.99, (out == ref).mean()
