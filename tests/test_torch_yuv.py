"""vfs_tpu_torch.ops.yuv against vfs_tpu.ops.yuv on the CPU, the seven
cases of tests/test_ops/test_yuv.py: the host pack (cv2 and its numpy
fallback), the unpack (cv2's inverse, the round-trip bound, odd sizes),
the plane layout, and the tracker's yuv420 transport.

Tolerances. The pack is the same code on the same numpy inputs: equal
bytes. The unpack is the JAX package's arithmetic in torch (constants
multiplied as the JAX package writes them): held to 1e-4 on the [0, 255]
scale, measured 0.0 (the same fp32 operations in the same order). The
tracker: the port's yuv420 masks equal the JAX package's pixel for pixel
on the same weights, and agree with the port's own RGB masks on > 0.94 of
pixels (the JAX test's floor; chroma rounding flips boundary pixels)."""

import builtins

import numpy as np
import pytest
import torch

from vfs_tpu.ops import yuv as jax_yuv
from vfs_tpu_torch.ops import yuv

torch.set_num_threads(1)


def _smooth_rgb(t, h, w, seed=0):
    """tests/test_ops/test_yuv.py's smooth colour fields."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    frames = []
    for i in range(t):
        chans = []
        for _ in range(3):
            fy, fx, ph = rng.uniform(0.5, 2.0, 3)
            chans.append(
                127 + 90 * np.sin(2 * np.pi * (fy * yy / h + fx * xx / w)
                                  + ph + 0.1 * i)
                + 30 * np.cos(2 * np.pi * (fx * yy / h - fy * xx / w)))
        frames.append(np.stack(chans, -1))
    return np.clip(np.stack(frames), 0, 255).astype(np.uint8)


def _unpack(packed, h, w, convention='studio'):
    """Both unpacks of the same planes: (port, JAX) as float32 numpy."""
    out = yuv.yuv420_to_rgb(torch.from_numpy(packed), h, w, convention)
    ref = jax_yuv.yuv420_to_rgb(packed, h, w, convention)
    assert out.dtype == torch.float32
    return out.numpy(), np.asarray(ref)


def test_pack_matches_cv2():
    cv2 = pytest.importorskip('cv2')
    imgs = _smooth_rgb(2, 48, 64)
    packed = yuv.rgb_to_yuv420(imgs)
    ref = np.stack([
        cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420).reshape(-1) for f in imgs])
    assert packed.shape == ref.shape
    assert np.array_equal(packed, ref)
    assert np.array_equal(packed, jax_yuv.rgb_to_yuv420(imgs))


def test_numpy_fallback_matches_cv2(monkeypatch):
    pytest.importorskip('cv2')
    imgs = _smooth_rgb(1, 32, 40, seed=3)
    ref = yuv.rgb_to_yuv420(imgs).astype(np.int16)
    real_import = builtins.__import__

    def no_cv2(name, *a, **k):
        if name == 'cv2':
            raise ImportError('forced')
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, '__import__', no_cv2)
    fallback = yuv.rgb_to_yuv420(imgs)
    # cv2 is fixed point; the float fallback may differ by one step
    assert np.abs(fallback.astype(np.int16) - ref).max() <= 1
    assert np.array_equal(fallback, jax_yuv.rgb_to_yuv420(imgs))


@pytest.mark.parametrize('convention', ['studio', 'jpeg'])
def test_unpack_matches_cv2_inverse(convention):
    """The unpack is cv2's YUV2RGB_I420 (nearest chroma, studio-swing
    inverse) within cv2's fixed-point rounding, and the JAX package's
    unpack (both conventions) within 1e-4."""
    cv2 = pytest.importorskip('cv2')
    imgs = _smooth_rgb(2, 48, 64, seed=1)
    packed = yuv.rgb_to_yuv420(imgs)
    rec, ref = _unpack(packed, 48, 64, convention)
    np.testing.assert_allclose(rec, ref, rtol=0, atol=1e-4)
    if convention == 'studio':
        for i in range(2):
            cv = cv2.cvtColor(packed[i].reshape(-1, 64),
                              cv2.COLOR_YUV2RGB_I420).astype(np.float32)
            assert np.abs(rec[i] - cv).max() <= 1.0


def test_roundtrip_error_bounded():
    imgs = _smooth_rgb(2, 48, 64, seed=1)
    packed = yuv.rgb_to_yuv420(imgs)
    rec, ref = _unpack(packed, 48, 64)
    assert rec.shape == (2, 48, 64, 3)
    np.testing.assert_allclose(rec, ref, rtol=0, atol=1e-4)
    err = np.abs(rec - imgs.astype(np.float32))
    assert err.mean() < 8.0, err.mean()
    assert err[:, ::2, ::2].mean() < 1.0


def test_odd_sizes_padded():
    imgs = _smooth_rgb(1, 48, 64, seed=2)[:, :47, :63]
    packed = yuv.rgb_to_yuv420(imgs)
    he, we, n = yuv.yuv420_shape(47, 63)
    assert (he, we, n) == jax_yuv.yuv420_shape(47, 63)
    assert (he, we) == (48, 64) and packed.shape == (1, n)
    rec, ref = _unpack(packed, 47, 63)
    assert rec.shape == (1, 47, 63, 3)
    np.testing.assert_allclose(rec, ref, rtol=0, atol=1e-4)
    err = np.abs(rec - imgs.astype(np.float32))
    assert err.mean() < 8.0, err.mean()
    assert err[:, ::2, ::2].mean() < 1.0


def test_planes_to_flat_layout():
    imgs = _smooth_rgb(1, 32, 40)
    packed = yuv.rgb_to_yuv420(imgs)
    hw = 32 * 40
    y = packed[:, :hw].reshape(1, 32, 40)
    u = packed[:, hw:hw + hw // 4].reshape(1, 16, 20)
    v = packed[:, hw + hw // 4:].reshape(1, 16, 20)
    assert np.array_equal(yuv.yuv420_planes_to_flat(y, u, v), packed)
    assert np.array_equal(jax_yuv.yuv420_planes_to_flat(y, u, v), packed)
    frames = yuv.Yuv420Frames(packed, (32, 40))
    assert frames.hw == (32, 40) and frames.convention == 'studio'
    assert frames[:1].hw == (32, 40)  # views keep the geometry


def test_tracker_yuv_transport_agrees_with_rgb():
    """End to end on shared weights: the port's yuv420 masks equal the
    JAX package's, ship 1.5 bytes a pixel, and agree with the port's RGB
    masks almost everywhere."""
    from test_torch_resnet import jax_resnet_variables
    from vfs_tpu.models import build_model as jax_build_model
    from vfs_tpu_torch.checkpoint import flax_resnet_to_torch
    from vfs_tpu_torch.models import build_model

    test_cfg = dict(precede_frames=3, topk=3, temperature=0.07,
                    strides=(1, 2, 1, 1), out_indices=(2,),
                    neighbor_range=8, with_first=True,
                    with_first_neighbor=True, batch_step=4)
    model_cfg = dict(type='VanillaTracker',
                     backbone=dict(type='ResNet', depth=18, out_indices=(3,)))
    _, variables = jax_resnet_variables(18, (1, 2, 1, 1), (2,), seed=5,
                                        hw=(48, 64))
    jax_tracker = jax_build_model(model_cfg, test_cfg=dict(
        test_cfg, input_format='yuv420'))
    jax_tracker.variables = variables
    port = build_model(model_cfg, test_cfg=dict(test_cfg))
    port.load_weights(flax_resnet_to_torch(variables['params'],
                                           variables['batch_stats']))

    imgs = _smooth_rgb(4, 48, 64, seed=5)
    seg = np.zeros((48, 64), np.uint8)
    seg[10:30, 20:44] = 1
    meta = [dict(original_shape=(48, 64),
                 img_norm_cfg=dict(mean=np.array([123.675, 116.28, 103.53],
                                                 np.float32),
                                   std=np.array([58.395, 57.12, 57.375],
                                                np.float32)))]
    rgb_preds = port.forward_test(imgs, seg, meta, device='cpu')[0]

    port.test_cfg['input_format'] = 'yuv420'
    handle = port.preload(imgs, device='cpu')
    assert handle.hw == (48, 64) and handle.convention == 'studio'
    assert handle.frames.dtype == torch.uint8
    assert handle.frames.numel() * 2 == imgs.size  # 1.5 bytes a pixel
    yuv_preds = port.forward_test(handle, seg, meta, device='cpu')[0]
    ref = jax_tracker.forward_test(imgs, seg, meta)[0]
    np.testing.assert_array_equal(yuv_preds, ref)
    # numpy frames under input_format='yuv420' take the same path
    np.testing.assert_array_equal(
        port.forward_test(imgs, seg, meta, device='cpu')[0], yuv_preds)
    agreement = float((rgb_preds == yuv_preds).mean())
    assert agreement > 0.94, agreement
