"""The scan kernel's inexact modes in vfs_tpu_torch against the JAX package
on the CPU: ``scores='bfloat16'`` (``scores_dtype``) and
``extract='packed'`` (``extract_mode``) of ``local_topk_attend``.

The port's plain ``local_topk_attend_reference`` in each mode is held
against ``vfs_tpu``'s TPU kernel ``pallas_local_topk_attend`` run in
Pallas interpret mode with the same ``extract_mode`` / ``scores_dtype`` /
``matmul_precision`` on ``pad_for_pallas`` layouts: the seeded cases of
``tests/test_ops/test_pallas_kernel.py:64-155``, odd maps, invalid slots,
K = 4 and 16, bf16 features in each mode, two TPU tiles (JAX's result
does not depend on the tile) and tie-heavy banks (duplicated frames, and
keys within one quantisation step of each other).

Tolerance: logits at rtol 1e-4 / atol 1e-5, the packed test's own. The
two packages sum each dot product in different orders (about 1e-6 apart),
so a score within that distance of a bf16 rounding midpoint or of a
packed quantisation boundary may take the other key, and change a
selection. Such a cell is allowed only where the test shows it
(``_near_boundary``): a key of the query's window lies within
``FLIP_EPS`` of a boundary and at the margin of the k-th key. Every other
cell is held to the tolerance.

The parity cases keep every query at >= k valid keys (asserted): there
JAX's packed mode never picks a masked key. Below that it weighs masked
keys at coordinates clipped in its tile layout, a quirk of the reference
(ROADMAP Queue 3) that the port does not copy: it keeps its filler.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.ops import propagation as jax_prop
from vfs_tpu.ops.affinity import l2_normalize as jax_l2_normalize
from vfs_tpu.ops.pallas_attention import (PACKED_SCALE as JAX_SCALE,
                                          pad_for_pallas,
                                          pallas_local_topk_attend)
from vfs_tpu_torch.ops import NEG_INF, propagation as torch_prop
from vfs_tpu_torch.ops.local_attention import (local_topk_attend,
                                               local_topk_attend_cuda,
                                               local_topk_attend_reference,
                                               score_key)
from vfs_tpu_torch.ops.video_affinity import circle_offsets

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
# how near a rounding boundary a score must lie for two summation orders
# to round it apart (they differ by about 1e-6 at |s| <= 14.3)
FLIP_EPS = 4e-6
MODES = [dict(scores='bfloat16'), dict(extract='packed')]


def _inputs(seed, h, w, f=5, c=16, k=3):
    """The seeded inputs of tests/test_ops/test_pallas_kernel.py."""
    rng = np.random.RandomState(seed)
    query = np.array(jax_l2_normalize(
        jnp.asarray(rng.randn(h, w, c), jnp.float32), -1))
    bank = np.array(jax_l2_normalize(
        jnp.asarray(rng.randn(f, h, w, c), jnp.float32), -1))
    vals = rng.rand(f, h, w, k).astype(np.float32)
    return query, bank, vals


def _valid_keys(h, w, radius, valid):
    """Valid keys of each query: in-map circle keys times valid slots."""
    _, dy, dx = circle_offsets(float(radius))
    ky = np.arange(h)[:, None, None] + dy.numpy()
    kx = np.arange(w)[None, :, None] + dx.numpy()
    inb = ((ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)).sum(-1)
    return inb * int(np.sum(valid))


def _port(query, bank, vals, valid, radius, topk, bf16=False, **mode):
    q, b = torch.from_numpy(query), torch.from_numpy(bank)
    if bf16:
        q, b = q.to(torch.bfloat16), b.to(torch.bfloat16)
    out = local_topk_attend_reference(
        q, b, torch.from_numpy(vals), torch.from_numpy(np.asarray(valid)),
        float(radius), 0.07, topk, **mode)
    return tuple(o.numpy() for o in out)


def _jax(query, bank, vals, valid, radius, topk, tile, bf16=False,
         scores='float32', extract='mask'):
    h, w = query.shape[:2]
    return np.asarray(pallas_local_topk_attend(
        pad_for_pallas(jnp.asarray(query), h, w, radius, tile),
        pad_for_pallas(jnp.asarray(bank), h, w, radius, tile),
        jnp.asarray(vals), jnp.asarray(valid, jnp.int32), radius=radius,
        temperature=0.07, topk=topk, h=h, w=w, tile=tile, interpret=True,
        extract_mode=extract, scores_dtype=scores,
        matmul_precision='bfloat16' if bf16 else 'float32'))


def _boundary_distance(s, scores='float32', extract='mask'):
    """Distance of fp32 scores ``s`` (numpy) from the nearest boundary at
    which the mode's key rounds to another value."""
    s = s.astype(np.float64)
    if extract == 'packed':
        x = np.clip(s, -15, 15) * float(np.float32(JAX_SCALE))
        return np.abs(x - np.floor(x) - 0.5) / float(np.float32(JAX_SCALE))
    # bf16: the midpoints beside the nearest bf16 value (8 significant
    # bits; below a power of two the step halves)
    near = torch.from_numpy(s.astype(np.float32)).to(torch.bfloat16)
    near = near.to(torch.float64).numpy()
    ulp = np.ldexp(1.0, np.frexp(near)[1] - 8)
    mids = near[None] + np.stack([-ulp / 2, ulp / 2, -ulp / 4])
    return np.abs(mids - s[None]).min(0)


def _near_boundary(query, bank, valid, radius, topk, **mode):
    """(h, w) bool: the query's selection may round apart between two
    summation orders. Its exact (fp64) scores over the valid window keys
    are keyed as the mode keys them; a key within FLIP_EPS of a rounding
    boundary may take either neighbouring key, and that changes the
    selection or its softmax only at the margin: for packed, a key within
    one quantisation step of the k-th key; for bf16 scores, a key at or
    above one bf16 step below the k-th key (rounded values enter the
    softmax)."""
    h, w, c = query.shape
    _, dy, dx = circle_offsets(float(radius))
    ky = np.arange(h)[:, None, None] + dy.numpy()
    kx = np.arange(w)[None, :, None] + dx.numpy()
    inb = (ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)
    kyc, kxc = ky.clip(0, h - 1), kx.clip(0, w - 1)
    scores, ok = [], []
    for f in np.flatnonzero(valid):
        keys = bank[f][kyc, kxc].astype(np.float64)           # (h, w, n, C)
        s = np.einsum('hwc,hwnc->hwn', query.astype(np.float64), keys)
        scores.append(s * np.float64(np.float32(1 / 0.07)))
        ok.append(inb)
    s, ok = np.concatenate(scores, -1), np.concatenate(ok, -1)
    ambiguous = (_boundary_distance(s, **mode) < FLIP_EPS) & ok
    kth = np.sort(np.where(ok, s, -np.inf), -1)[..., -topk][..., None]
    if mode.get('extract') == 'packed':
        margin = 1.5 / float(np.float32(JAX_SCALE))
        at_margin = np.abs(s - kth) <= margin
    else:
        at_margin = s >= kth - np.abs(kth) * 2.0 ** -7
    return (ambiguous & at_margin).any(-1)


def _assert_parity(out, ref, query, bank, valid, radius, topk, bf16=False,
                   **mode):
    """Logits within the tolerance, except at cells the rounding-flip rule
    explains; returns the number of such cells."""
    bad = ~np.isclose(out, ref, rtol=RTOL, atol=ATOL).all(-1)
    if bad.any():
        q, b = query, bank
        if bf16:
            q = torch.from_numpy(q).to(torch.bfloat16).float().numpy()
            b = torch.from_numpy(b).to(torch.bfloat16).float().numpy()
        near = _near_boundary(q, b, valid, radius, topk, **mode)
        assert near[bad].all(), np.argwhere(bad & ~near)
    np.testing.assert_allclose(out[~bad], ref[~bad], rtol=RTOL, atol=ATOL)
    return int(bad.sum())


CASES = [
    # (seed, h, w, f, c, k, radius, tile, topk, valid)
    (1, 12, 14, 5, 16, 3, 3, (4, 8), 4, (1, 1, 1, 1, 1)),  # bf16 scores
    (2, 12, 14, 5, 16, 3, 3, (4, 8), 4, (1, 1, 1, 1, 1)),  # bf16 matmul
    (7, 12, 14, 5, 16, 3, 3, (4, 8), 4, (1, 1, 1, 0, 0)),  # packed
    (7, 10, 11, 5, 16, 3, 4, (8, 8), 3, (1, 1, 1, 0, 0)),  # packed, odd
    (9, 9, 13, 5, 16, 16, 3, (4, 8), 10, (1, 0, 1, 0, 1)),  # holes, K=16
    (4, 7, 5, 5, 8, 4, 4, (8, 8), 8, (0, 1, 1, 1, 1)),    # slot 0 off, K=4
]


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('mode', MODES, ids=['scores_bf16', 'packed'])
@pytest.mark.parametrize('case', CASES, ids=[f'c{i}' for i in
                                             range(len(CASES))])
def test_modes_match_tpu_kernel(case, mode, bf16):
    seed, h, w, f, c, k, radius, tile, topk, valid = case
    assert (_valid_keys(h, w, radius, valid) >= topk).all()
    query, bank, vals = _inputs(seed, h, w, f=f, c=c, k=k)
    out, scores, src = _port(query, bank, vals, valid, radius, topk, bf16,
                             **mode)
    ref = _jax(query, bank, vals, valid, radius, topk, tile, bf16, **mode)
    assert out.shape == ref.shape == (h, w, k)
    _assert_parity(out, ref, query, bank, valid, radius, topk, bf16, **mode)
    assert (scores > NEG_INF / 2).all()  # >= k valid keys: no filler
    assert np.isin(src // (h * w), np.flatnonzero(valid)).all()


@pytest.mark.parametrize('mode', MODES, ids=['scores_bf16', 'packed'])
def test_modes_do_not_depend_on_the_tile(mode):
    """Two TPU tiles give JAX one result, which the port's equals."""
    query, bank, vals = _inputs(11, 11, 13, f=4, c=16, k=4)
    valid = (1, 1, 0, 1)
    outs = [_jax(query, bank, vals, valid, 4, 6, tile, **mode)
            for tile in ((4, 8), (8, 16))]
    np.testing.assert_array_equal(outs[0], outs[1])
    out = _port(query, bank, vals, valid, 4, 6, **mode)[0]
    _assert_parity(out, outs[0], query, bank, valid, 4, 6, **mode)


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('mode', MODES, ids=['scores_bf16', 'packed'])
def test_modes_tie_heavy(mode, bf16):
    """Duplicated frames score alike at distinct slots, and keys nudged by
    far less than a quantisation step share a key: both sort by the
    lowest (slot, ky, kx), as the TPU kernel's flat index does."""
    h, w, radius, topk = 9, 10, 3, 8
    query, bank, vals = _inputs(13, h, w, f=5, c=16, k=4)
    bank[2] = bank[0]
    bank[4] = bank[1]
    rng = np.random.RandomState(14)
    nudged = bank[3] + 1e-5 * rng.randn(*bank[3].shape).astype(np.float32)
    bank[3] = nudged / np.linalg.norm(nudged, axis=-1, keepdims=True)
    bank[3, ::2] = bank[0, ::2]
    valid = (1, 1, 1, 1, 1)
    out, scores, src = _port(query, bank, vals, valid, radius, topk, bf16,
                             **mode)
    ref = _jax(query, bank, vals, valid, radius, topk, (4, 8), bf16, **mode)
    _assert_parity(out, ref, query, bank, valid, radius, topk, bf16,
                   **mode)
    # along each list the key descends and equal keys take ascending
    # sources: the (slot, ky, kx) order (packed returns exact scores,
    # picked by their key)
    key = score_key(torch.from_numpy(scores), mode.get('scores', 'float32'),
                    mode.get('extract', 'mask')).numpy()
    k0, k1 = key[..., :-1], key[..., 1:]
    ties = k0 == k1
    assert ties.any()
    assert (src[..., :-1][ties] < src[..., 1:][ties]).all()
    slot, cell = src // (h * w), src % (h * w)
    assert ((slot[..., :-1] == 0) & (slot[..., 1:] == 2)
            & (cell[..., :-1] == cell[..., 1:])).any()


def test_packed_returns_exact_scores_of_its_picks():
    """Packed re-scores its picks: where it picks what the exact mode
    picks, its scores are the exact scores."""
    query, bank, vals = _inputs(3, 8, 9, f=4, c=16, k=3)
    valid = (1, 1, 0, 1)
    exact = _port(query, bank, vals, valid, 3, 5)
    packed = _port(query, bank, vals, valid, 3, 5, extract='packed')
    same = (np.sort(exact[2], -1) == np.sort(packed[2], -1)).all(-1)
    assert same.mean() > 0.9
    order = np.argsort(packed[2], -1)
    np.testing.assert_allclose(
        np.take_along_axis(packed[1], order, -1)[same],
        np.take_along_axis(exact[1], np.argsort(exact[2], -1), -1)[same],
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(packed[0][same], exact[0][same], rtol=1e-5,
                               atol=1e-6)


def test_bf16_scores_are_rounded():
    query, bank, vals = _inputs(5, 6, 7, f=3, c=8, k=2)
    scores = _port(query, bank, vals, (1, 1, 1), 3, 4,
                   scores='bfloat16')[1]
    assert np.array_equal(
        scores, torch.from_numpy(scores).to(torch.bfloat16).float().numpy())


def test_packed_key_matches_jax_quantisation():
    """The port's key equals JAX's int quantisation on scores at and
    around the clip and half-step points."""
    s = np.concatenate([np.linspace(-16, 16, 4001, dtype=np.float32),
                        ((np.arange(-40, 40) + 0.5) / np.float32(JAX_SCALE)
                         ).astype(np.float32)])
    ref = np.asarray(jnp.round(jnp.clip(jnp.asarray(s), -15.0, 15.0)
                               * JAX_SCALE).astype(jnp.int32))
    key = score_key(torch.from_numpy(s), 'float32', 'packed').numpy()
    np.testing.assert_array_equal(key, ref.astype(np.float32))


@pytest.mark.parametrize('kw,match', [
    (dict(scores='bfloat16', extract='packed'), 'packed'),
    (dict(extract='sweep'), 'extract'),
    (dict(scores='float16'), 'scores'),
])
def test_bad_modes_raise(kw, match):
    query, bank, vals = _inputs(6, 4, 5, f=2, c=8, k=2)
    args = [torch.from_numpy(a) for a in (query, bank, vals)]
    valid = torch.tensor([True, True])
    with pytest.raises(ValueError, match=match):
        local_topk_attend(*args, valid, 3.0, 0.07, 4, **kw)
    with pytest.raises(ValueError, match=match):
        local_topk_attend_cuda(*args, valid, 3.0, 0.07, 4, **kw)
    assert local_topk_attend_cuda.launches == 0
    # JAX refuses the same modes
    with pytest.raises(ValueError):
        _jax(query, bank, vals, (1, 1), 3, 4, (4, 8),
             **{k: v for k, v in kw.items()})


def test_descent_is_exact():
    query, bank, vals = _inputs(8, 6, 7, f=3, c=8, k=2)
    a = _port(query, bank, vals, (1, 1, 1), 3, 4)
    b = _port(query, bank, vals, (1, 1, 1), 3, 4, extract='descent')
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _propagation_inputs(seed, t_total, h, w, c, k):
    rng = np.random.RandomState(seed)
    feats = rng.randn(t_total, h, w, c).astype(np.float32)
    seg_first = np.eye(k, dtype=np.float32)[rng.randint(0, k, (h, w))]
    return feats, seg_first


@pytest.mark.parametrize('precision', ['float32', 'bfloat16'])
@pytest.mark.parametrize('mode', [dict(pallas_scores='bfloat16'),
                                  dict(pallas_extract='packed')],
                         ids=['scores_bf16', 'packed'])
@pytest.mark.parametrize('t_total,h,w,nr,p,topk,dup', [
    (7, 6, 7, 6, 4, 5, False),    # ring wraps: T >= P + 2
    (8, 6, 6, 6, 2, 3, True),     # duplicated frames: ties
])
def test_scan_modes_match_jax(t_total, h, w, nr, p, topk, dup, mode,
                              precision):
    """propagate_video(backend='pallas') in each mode against JAX's
    interpret-mode scan. Frame 0 is always valid and its in-map circle
    holds >= k keys, so every step keeps >= k valid keys."""
    assert (_valid_keys(h, w, nr // 2, [1]) >= topk).all()
    feats, seg_first = _propagation_inputs(t_total + h, t_total, h, w, 8, 3)
    if dup:
        feats[3] = feats[1]
        feats[6] = feats[4]
    common = dict(precede_frames=p, topk=topk, temperature=0.07,
                  neighbor_range=nr, pallas_precision=precision, **mode)
    ref = np.asarray(jax_prop.propagate_video(
        jnp.asarray(feats), jnp.asarray(seg_first), None,
        jax_prop.PropagationConfig(backend='pallas', pallas_interpret=True,
                                   pallas_tile=(4, 8), **common)))
    out = torch_prop.propagate_video(
        torch.from_numpy(feats), torch.from_numpy(seg_first), None,
        torch_prop.PropagationConfig(backend='pallas', **common)).numpy()
    assert out.shape == ref.shape == (t_total, h, w, 3)
    assert (np.argmax(ref, -1) == np.argmax(out, -1)).mean() == 1.0
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)
