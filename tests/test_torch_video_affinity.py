"""vfs_tpu_torch phase 1 (masked top-k video affinity) and propagation
against the JAX package on the CPU.

The port's plain ``video_topk_affinity_reference`` is held against
``vfs_tpu``'s TPU kernel ``video_topk_affinity2`` run in Pallas interpret
mode, its outputs decoded to (T, h, w, k) scores and flat sources with the
formulas of ``vfs_tpu/ops/propagation.py:453-486``. Sources must be equal;
scores agree to rtol 1e-5 / atol 1e-6 (the two sum the dot products in
different orders). Cases follow ``tests/test_ops/test_pallas_video.py``:
tile remainders, T > P ring wraparound, P = 1, T = 2, bank splits, and
duplicated frames for the tie order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.ops import propagation as jax_prop
from vfs_tpu.ops.pallas_affinity_video import (pad_for_video_kernel,
                                               video_kernel_geometry,
                                               video_topk_affinity2)
from vfs_tpu_torch.ops import NEG_INF, propagation as torch_prop
from vfs_tpu_torch.ops import spatial_neighbor
from vfs_tpu_torch.ops.video_affinity import (video_topk_affinity,
                                              video_topk_affinity_reference)

from test_torch_local_attention_modes import _valid_keys

torch.set_num_threads(1)


def _normalized_feats(rng, t_total, h, w, c):
    f = rng.randn(t_total, h, w, c).astype(np.float32)
    return f / np.linalg.norm(f, axis=-1, keepdims=True)


def _jax_affinity(feats, radius, topk, p, tile=(4, 4), qpair=2,
                  compact=True, splits=1):
    """The TPU kernel in interpret mode, decoded to (T, h, w, k) scores and
    flat sources f*h*w + ky*w + kx."""
    t_total, h, w, _ = feats.shape
    g = video_kernel_geometry(h, w, radius, tile)
    nth, ntw, th, tw, tws, r = (g['nth'], g['ntw'], g['th'], g['tw'],
                                g['tws'], g['r'])
    cap = g['cap_c'] if compact else g['kb_cap']
    feats_pad = pad_for_video_kernel(jnp.asarray(feats), h, w, radius, tile)
    top_s, top_i = video_topk_affinity2(
        feats_pad, radius=float(radius), temperature=0.07, topk=topk,
        precede_frames=p, h=h, w=w, tile=tile, interpret=True,
        bank_splits=splits, qpair=qpair, compact=compact)
    top_s = np.swapaxes(np.asarray(top_s), 3, 4)  # (nth, ntw, T, q_n, k)
    top_i = np.swapaxes(np.asarray(top_i), 3, 4)
    j, pos = top_i // cap, top_i % cap
    a, b = pos // tws, pos % tws
    if compact:
        a = a + (np.arange(th * tw) // tw).reshape(1, 1, 1, -1, 1)
    oy = (np.arange(nth) * th).reshape(nth, 1, 1, 1, 1)
    ox = (np.arange(ntw) * tw).reshape(1, ntw, 1, 1, 1)
    ky = np.clip(oy + a - r, 0, h - 1)
    kx = np.clip(ox + b - r, 0, w - 1)
    t_idx = np.arange(t_total).reshape(1, 1, t_total, 1, 1)
    f_src = np.where(j == 0, 0, t_idx - 1 - np.mod(t_idx - 1 - (j - 1), p))
    f_src = np.clip(f_src, 0, t_total - 1)

    def to_thwk(x):
        x = np.moveaxis(x, 2, 0).reshape(t_total, nth, ntw, th, tw, topk)
        x = np.moveaxis(x, 3, 2).reshape(t_total, nth * th, ntw * tw, topk)
        return x[:, :h, :w]

    return to_thwk(top_s), to_thwk(f_src * (h * w) + ky * w + kx)


def _check_affinity(feats, radius, topk, p, **jax_kw):
    ref_s, ref_i = _jax_affinity(feats, radius, topk, p, **jax_kw)
    out_s, out_i = video_topk_affinity_reference(
        torch.from_numpy(feats), radius, 0.07, topk, p)
    out_s, out_i = out_s.numpy()[1:], out_i.numpy()[1:]
    ref_s, ref_i = ref_s[1:], ref_i[1:]
    np.testing.assert_allclose(out_s, ref_s, rtol=1e-5, atol=1e-6)
    valid = ref_s > NEG_INF / 2
    np.testing.assert_array_equal(out_i[valid], ref_i[valid])
    return out_s, out_i, valid


@pytest.mark.parametrize('t_total,h,w,nr,p,tile,topk,qpair,compact,splits', [
    (9, 6, 7, 6, 4, (4, 4), 5, 2, True, 1),    # tile remainder both dims
    (12, 8, 8, 6, 4, (4, 4), 3, 2, True, 1),   # wraparound + duplication
    (6, 5, 9, 8, 3, (4, 8), 4, 2, True, 1),    # wide tile, bigger radius
    (12, 8, 9, 6, 1, (4, 4), 5, 2, True, 1),   # P = 1
    (2, 5, 6, 6, 4, (4, 4), 3, 1, True, 1),    # T = 2
    (10, 8, 9, 6, 5, (4, 4), 5, 2, False, 2),  # bank splits, ragged
])
def test_affinity_matches_tpu_kernel(t_total, h, w, nr, p, tile, topk, qpair,
                                     compact, splits):
    rng = np.random.RandomState(t_total * 31 + h)
    feats = _normalized_feats(rng, t_total, h, w, 8)
    _, _, valid = _check_affinity(feats, nr // 2, topk, p, tile=tile,
                                  qpair=qpair, compact=compact,
                                  splits=splits)
    assert valid.all()  # every query has >= topk keys at these sizes


@pytest.mark.parametrize('qpair,splits', [(1, 1), (2, 1), (2, 2)])
def test_affinity_tie_order(qpair, splits):
    """Duplicated frames give bit-identical scores at distinct bank
    positions: the order must be (bank position j, ky, kx) exactly."""
    rng = np.random.RandomState(17)
    feats = _normalized_feats(rng, 10, 8, 9, 8)
    feats[3] = feats[1]
    feats[7] = feats[5]
    out_s, out_i, valid = _check_affinity(feats, 3, 5, 4, qpair=qpair,
                                          splits=splits)
    assert valid.all()
    # the duplicates really tie: some query holds both copies of a key
    frame, cell = out_i // (8 * 9), out_i % (8 * 9)
    dup = (frame[..., :, None] == 1) & (frame[..., None, :] == 3) & (
        cell[..., :, None] == cell[..., None, :])
    assert dup.any()


def test_affinity_filler_entries():
    """With fewer than k valid keys the rest are filler: score NEG_INF (as
    in the TPU kernel), source the query's own cell in frame 0."""
    rng = np.random.RandomState(3)
    feats = _normalized_feats(rng, 4, 2, 3, 8)
    out_s, out_i, valid = _check_affinity(feats, 2, 12, 2)
    assert (~valid).any()
    np.testing.assert_array_equal(out_s[~valid], np.float32(NEG_INF))
    own = np.broadcast_to(np.arange(6).reshape(1, 2, 3, 1), out_i.shape)
    np.testing.assert_array_equal(out_i[~valid], own[~valid])


def test_affinity_dispatch_cpu_is_reference():
    rng = np.random.RandomState(5)
    feats = torch.from_numpy(_normalized_feats(rng, 6, 5, 6, 8))
    a = video_topk_affinity(feats, 3.0, 0.07, 4, 3)
    b = video_topk_affinity_reference(feats, 3.0, 0.07, 4, 3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert a[0].dtype == torch.float32 and a[1].dtype == torch.int64
    assert a[0].shape == (6, 5, 6, 4)


def _propagation_inputs(seed, t_total, h, w, c, k):
    rng = np.random.RandomState(seed)
    feats = rng.randn(t_total, h, w, c).astype(np.float32)
    seg_first = np.eye(k, dtype=np.float32)[rng.randint(0, k, (h, w))]
    return feats, seg_first


@pytest.mark.parametrize('jax_backend', ['pallas_video', 'tiled'])
@pytest.mark.parametrize('t_total,h,w,nr,p,topk', [
    (9, 6, 7, 6, 4, 5),     # tile remainder
    (12, 8, 8, 6, 4, 3),    # wraparound: T > P + duplication
    (12, 8, 9, 6, 1, 5),    # P = 1
])
def test_propagate_video_matches_jax(t_total, h, w, nr, p, topk,
                                     jax_backend):
    feats, seg_first = _propagation_inputs(0, t_total, h, w, 8, 3)
    common = dict(precede_frames=p, topk=topk, temperature=0.07,
                  neighbor_range=nr)
    ref = np.asarray(jax_prop.propagate_video(
        jnp.asarray(feats), jnp.asarray(seg_first), None,
        jax_prop.PropagationConfig(backend=jax_backend,
                                   pallas_interpret=True, **common)))
    out = torch_prop.propagate_video(
        torch.from_numpy(feats), torch.from_numpy(seg_first), None,
        torch_prop.PropagationConfig(backend='pallas_video', **common))
    out = out.numpy()
    assert out.shape == ref.shape
    assert (np.argmax(ref, -1) == np.argmax(out, -1)).mean() == 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_propagate_video_tie_frames_match_jax():
    feats, seg_first = _propagation_inputs(17, 10, 8, 9, 8, 3)
    feats[3] = feats[1]
    feats[7] = feats[5]
    common = dict(precede_frames=4, topk=5, temperature=0.07,
                  neighbor_range=6)
    ref = np.asarray(jax_prop.propagate_video(
        jnp.asarray(feats), jnp.asarray(seg_first), None,
        jax_prop.PropagationConfig(backend='tiled', **common)))
    out = torch_prop.propagate_video(
        torch.from_numpy(feats), torch.from_numpy(seg_first), None,
        torch_prop.PropagationConfig(backend='tiled', **common)).numpy()
    assert (np.argmax(ref, -1) == np.argmax(out, -1)).mean() == 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)


def test_propagate_video_short_videos():
    feats, seg_first = _propagation_inputs(1, 1, 4, 5, 8, 2)
    cfg = torch_prop.PropagationConfig(neighbor_range=6)
    out = torch_prop.propagate_video(torch.from_numpy(feats),
                                     torch.from_numpy(seg_first), None, cfg)
    assert out.shape == (1, 4, 5, 2)
    assert torch.equal(out[0], torch.from_numpy(seg_first))


@pytest.mark.parametrize('kw', [
    dict(backend='pallas', pallas_extract='packed'),
    dict(backend='pallas', pallas_scores='bfloat16'), dict(backend='dense'),
    dict(with_first=False),
    dict(pallas_precision='bfloat16'), dict(neighbor_range=None),
    dict(with_first_neighbor=False)])
def test_propagate_video_later_slices_raise(kw):
    """The modes once left for later slices now run and match the JAX
    package. The dense tier's cases (``backend='dense'``,
    ``with_first=False``, ``neighbor_range=None``,
    ``with_first_neighbor=False``; ``tests/test_torch_dense.py`` covers
    them in full); ``pallas_precision='bfloat16'`` since slice 8, here on
    the default ``tiled`` backend, which ignores it in both packages
    (``tests/test_torch_bf16_eval.py`` covers the Pallas paths); the
    scan's ``pallas_extract='packed'`` and ``pallas_scores='bfloat16'``
    since slice 10, against the JAX package's interpret-mode scan (every
    query keeps >= k valid keys: from t = 1 frame 0 stands in two live
    slots, each with >= 9 in-map keys of a corner's circle, against
    top-10; ``tests/test_torch_local_attention_modes.py`` covers them in
    full)."""
    feats, seg_first = _propagation_inputs(2, 4, 4, 5, 8, 2)
    cfg = torch_prop.PropagationConfig(**{'neighbor_range': 6, **kw})
    args = (torch.from_numpy(feats), torch.from_numpy(seg_first))
    if 'pallas_extract' in kw or 'pallas_scores' in kw:
        assert (_valid_keys(4, 5, 3, [1, 1]) >= cfg.topk).all()
        ref = jax_prop.propagate_video(
            jnp.asarray(feats), jnp.asarray(seg_first), None,
            jax_prop.PropagationConfig(**dict(cfg._asdict(),
                                              pallas_interpret=True,
                                              pallas_tile=(4, 8))))
        out = torch_prop.propagate_video(*args, None, cfg)
        assert (np.argmax(np.asarray(ref), -1)
                == np.argmax(out.numpy(), -1)).mean() == 1.0
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5)
        return
    use_local = cfg.neighbor_range is not None and cfg.with_first_neighbor
    mask = None if cfg.neighbor_range is None or use_local else \
        spatial_neighbor(4, 5, cfg.neighbor_range)
    jax_cfg = jax_prop.PropagationConfig(**dict(cfg._asdict(),
                                                backend='tiled'))
    ref = jax_prop.propagate_video(
        jnp.asarray(feats), jnp.asarray(seg_first),
        None if mask is None else jnp.asarray(mask.numpy()), jax_cfg)
    out = torch_prop.propagate_video(*args, mask, cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_propagation_config_fields_match_jax():
    assert (torch_prop.PropagationConfig._fields
            == jax_prop.PropagationConfig._fields)
    assert (tuple(torch_prop.PropagationConfig())
            == tuple(jax_prop.PropagationConfig()))
