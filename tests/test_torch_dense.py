"""The port's dense tier against the JAX package's on the same numpy
inputs: ``compute_affinity``, ``propagate``, ``propagate_temporal``,
``grid_mask`` (``ops/affinity.py``), ``masked_attention_efficient`` and
``local_square_attention`` (``ops/attention.py``), ``attend_one_frame``
and ``propagate_video`` on the paths the dense scan serves: the non-local
masked path (``neighbor_range`` None, or ``with_first_neighbor=False``),
``with_first=False``, ``with_norm=False`` and ``backend='dense'``
(mirroring ``tests/test_ops/test_attention.py`` and
``tests/test_ops/test_local_tiled.py``).

Tolerances, as those files hold the JAX package: rtol 1e-4, atol 1e-5
(the products sum in another order). The tie cases duplicate key frames
or positions, so equal scores are bit-identical in both packages and
the values they select differ: a wrong tie order moves the output by
far more than the tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.ops import affinity as jax_aff
from vfs_tpu.ops import attention as jax_att
from vfs_tpu.ops import propagation as jax_prop
from vfs_tpu_torch.ops import affinity as aff
from vfs_tpu_torch.ops import attention as att
from vfs_tpu_torch.ops import propagation as prop

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize('scores,k', [
    ([[1., 3, 3, 2, 3, 0], [5, 5, 5, 5, 5, 5]], 2),
    ([[1., 3, 3, 2, 3, 0], [0, -1, 0, -1, 0, -1]], 4),
    ([[-1e30, -1e30, 2., -1e30]], 3)], ids=['tie', 'tie_k4', 'masked'])
def test_topk_first_index_breaks_ties_as_jax(scores, k):
    import jax
    vals, idx = aff.topk_first_index(_t(scores).float(), k)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(scores, jnp.float32), k)
    order = np.argsort(np.asarray(ref_idx), axis=-1)
    np.testing.assert_array_equal(
        idx.numpy(), np.take_along_axis(np.asarray(ref_idx), order, -1))
    np.testing.assert_array_equal(
        vals.numpy(), np.take_along_axis(np.asarray(ref_vals), order, -1))


@pytest.mark.parametrize('softmax_axis,with_mask', [
    (None, False), (1, False), (2, True), (1, True)])
def test_compute_affinity_matches_jax(softmax_axis, with_mask):
    rs = np.random.RandomState(2)
    src = rs.randn(2, 4, 5, 8).astype(np.float32)
    dst = rs.randn(2, 3, 4, 8).astype(np.float32)
    mask = None
    if with_mask:
        mask = rs.rand(2, 20, 12) > 0.4
        mask[0, :, 0] = False  # a fully masked column: NaN -> 0
    ref = jax_aff.compute_affinity(
        jnp.asarray(src), jnp.asarray(dst), temperature=0.5,
        softmax_axis=softmax_axis,
        mask=None if mask is None else jnp.asarray(mask))
    out = aff.compute_affinity(_t(src), _t(dst), temperature=0.5,
                               softmax_axis=softmax_axis,
                               mask=None if mask is None else _t(mask))
    assert out.shape == (2, 20, 12)
    _close(out, ref)


@pytest.mark.parametrize('topk', [None, 3])
def test_propagate_and_propagate_temporal_match_jax(topk):
    rs = np.random.RandomState(3)
    img = rs.randn(2, 4, 4, 3).astype(np.float32)
    affinity = rs.rand(2, 16, 16).astype(np.float32)
    _close(aff.propagate(_t(img), _t(affinity), topk=topk),
           jax_aff.propagate(jnp.asarray(img), jnp.asarray(affinity),
                             topk=topk))
    imgs = rs.randn(2, 3, 4, 4, 3).astype(np.float32)
    affs = rs.rand(2, 3, 16, 16).astype(np.float32)
    _close(aff.propagate_temporal(_t(imgs), _t(affs), topk=topk),
           jax_aff.propagate_temporal(jnp.asarray(imgs), jnp.asarray(affs),
                                      topk=topk))


def test_grid_mask_matches_jax():
    rs = np.random.RandomState(4)
    g1 = rs.rand(2, 4, 5, 2).astype(np.float32) * 40
    g2 = rs.rand(2, 3, 6, 2).astype(np.float32) * 40
    out = aff.grid_mask(_t(g1), _t(g2), radius=0.4)
    ref = jax_aff.grid_mask(jnp.asarray(g1), jnp.asarray(g2), radius=0.4)
    assert out.shape == (2, 20, 18) and out.any() and not out.all()
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize('topk,mask_on,non_mask_len,step,mode', [
    (None, False, 0, None, 'softmax'),
    (5, False, 0, None, 'softmax'),
    (5, True, 0, 16, 'softmax'),
    (5, True, 1, 16, 'softmax'),
    (10, True, 0, 7, 'softmax'),   # step not dividing the query count
    (None, True, 2, 30, 'cosine'),
    (4, False, 0, None, 'cosine'),
    (4, True, 1, 9, 'cosine'),
])
def test_masked_attention_matches_jax(topk, mask_on, non_mask_len, step,
                                      mode):
    rs = np.random.RandomState(0)
    n, t, h, w, c, cv = 2, 3, 8, 9, 16, 4
    q = rs.randn(n, h, w, c).astype(np.float32)
    k = rs.randn(n, t, h, w, c).astype(np.float32)
    v = rs.randn(n, t, h, w, cv).astype(np.float32)
    mask = aff.spatial_neighbor(h, w, 6) if mask_on else None
    # cosine weights are unnormalised squares of the scores: at tau 0.07
    # they reach ~200 and the sums cancel, so the cosine cases take tau 1,
    # as test_attention.py's cosine case does
    kw = dict(temperature=0.07 if mode == 'softmax' else 1.0, topk=topk,
              step=step,
              non_mask_len=non_mask_len, mode=mode)
    ref = jax_att.masked_attention_efficient(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask.numpy()), **kw)
    out = att.masked_attention_efficient(_t(q), _t(k), _t(v), mask, **kw)
    assert out.shape == (n, h, w, cv)
    _close(out, ref)


def test_masked_attention_ties_match_jax():
    """Key frames 0 and 2 equal, frame 1 a copy of frame 0 with one
    position's vector repeated: every score of frame 0 recurs later, and
    the values differ, so only the (frame, position) tie order matches."""
    rs = np.random.RandomState(5)
    h, w, c = 5, 6, 8
    base = rs.randn(1, h, w, c).astype(np.float32)
    k = np.stack([base, base, base], 1)
    k[0, 1, 2, 3] = k[0, 1, 0, 0]
    v = rs.randn(1, 3, h, w, 4).astype(np.float32)
    q = base + 0.01 * rs.randn(1, h, w, c).astype(np.float32)
    for topk in (1, 3, 4):
        ref = jax_att.masked_attention_efficient(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
            temperature=0.07, topk=topk)
        out = att.masked_attention_efficient(_t(q), _t(k), _t(v), None,
                                             temperature=0.07, topk=topk)
        _close(out, ref)


@pytest.mark.parametrize('kernel,topk,batch_as_context', [
    (3, None, False), (5, 4, False), (3, 3, True), ((3, 5), 6, False)])
def test_local_square_attention_matches_jax(kernel, topk, batch_as_context):
    rs = np.random.RandomState(6)
    q = rs.randn(2, 6, 7, 8).astype(np.float32)
    k = rs.randn(2, 6, 7, 8).astype(np.float32)
    v = rs.randn(2, 6, 7, 3).astype(np.float32)
    kw = dict(temperature=0.5, topk=topk, batch_as_context=batch_as_context)
    ref = jax_att.local_square_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), kernel, **kw)
    out = att.local_square_attention(_t(q), _t(k), _t(v), kernel, **kw)
    assert out.shape == (2, 6, 7, 3)
    _close(out, ref)


@pytest.mark.parametrize('masked,chunk', [
    ((True,) * 5, 32), ((False, True, True, True, True), 17),
    ((True,) * 5, 1000)], ids=['masked', 'first_exempt', 'one_chunk'])
def test_attend_one_frame_matches_jax(masked, chunk):
    rs = np.random.RandomState(0)
    f, h, w, c, k = 5, 9, 10, 16, 3
    query = rs.randn(h, w, c).astype(np.float32)
    bank_f = rs.randn(f, h, w, c).astype(np.float32)
    bank_v = rs.rand(f, h, w, k).astype(np.float32)
    valid = np.array([True, True, True, False, False])
    mask = aff.spatial_neighbor(h, w, 6)
    cfg = dict(topk=4, temperature=0.07, with_norm=True, query_chunk=chunk)
    ref = jax_prop.attend_one_frame(
        jnp.asarray(query), jnp.asarray(bank_f), jnp.asarray(bank_v),
        jnp.asarray(valid), jnp.asarray(masked), jnp.asarray(mask.numpy()),
        jax_prop.PropagationConfig(**cfg))
    out = prop.attend_one_frame(_t(query), _t(bank_f), _t(bank_v),
                                _t(valid), _t(np.array(masked)), mask,
                                prop.PropagationConfig(**cfg))
    _close(out, ref)


def _video(seed, t, h, w, c=16, k=3, repeat=False):
    rs = np.random.RandomState(seed)
    feats = rs.randn(t, h, w, c).astype(np.float32)
    if repeat:  # frames repeat: equal scores across bank slots
        feats[2::2] = feats[0]
        feats[3::2] = feats[1]
    seg = np.eye(k, dtype=np.float32)[rs.randint(0, k, (h, w))]
    return feats, seg


# the formerly refused paths, each against the JAX package
PATHS = {
    'no_mask': dict(neighbor_range=None),
    'first_neighbor_exempt': dict(neighbor_range=6,
                                  with_first_neighbor=False),
    'no_first_local': dict(neighbor_range=6, with_first=False),
    'no_first_no_mask': dict(neighbor_range=None, with_first=False),
    'no_norm': dict(neighbor_range=6, with_norm=False),
    'dense_backend_local': dict(neighbor_range=6, backend='dense'),
    'dense_backend_no_mask': dict(neighbor_range=None, backend='dense'),
}


@pytest.mark.parametrize('repeat', [False, True], ids=['random', 'ties'])
@pytest.mark.parametrize('path', list(PATHS))
def test_propagate_video_matches_jax(path, repeat):
    """T = 9 > P + 1 (ring wraparound); the ``ties`` video repeats its
    first two frames, so frame 0's scores recur in later slots. The mask
    is the one ``VanillaTracker`` passes: the circle where the local
    engine does not apply, else None."""
    kw = PATHS[path]
    feats, seg = _video(1, 9, 7, 8, repeat=repeat)
    cfg = prop.PropagationConfig(precede_frames=4, topk=5, temperature=0.07,
                                 query_chunk=20, **kw)
    use_local = (cfg.neighbor_range is not None and cfg.with_first_neighbor
                 and cfg.with_norm)
    mask = None
    if cfg.neighbor_range is not None and not use_local:
        mask = aff.spatial_neighbor(7, 8, cfg.neighbor_range)
    # the JAX package's CPU backend is 'tiled'; 'dense' is the same path
    ref = jax_prop.propagate_video(
        jnp.asarray(feats), jnp.asarray(seg),
        None if mask is None else jnp.asarray(mask.numpy()),
        jax_prop.PropagationConfig(**dict(cfg._asdict(), backend='tiled')))
    out = prop.propagate_video(_t(feats), _t(seg), mask, cfg)
    assert out.shape == (9, 7, 8, 3)
    _close(out, ref)


def test_propagate_video_local_equals_dense():
    """The local engine and the dense scan with the circle mask give the
    same logits (``test_local_tiled.py``'s check, on the port)."""
    feats, seg = _video(1, 8, 12, 14)
    nr = 6
    dense_cfg = prop.PropagationConfig(precede_frames=4, topk=5,
                                       temperature=0.07, query_chunk=32)
    dense = prop.propagate_video(_t(feats), _t(seg),
                                 aff.spatial_neighbor(12, 14, nr),
                                 dense_cfg)
    local = prop.propagate_video(_t(feats), _t(seg), None,
                                 dense_cfg._replace(neighbor_range=nr))
    _close(local, dense.numpy())


def test_unknown_backend_raises():
    feats, seg = _video(3, 3, 4, 4)
    with pytest.raises(ValueError, match='backend'):
        prop.propagate_video(_t(feats), _t(seg), None,
                             prop.PropagationConfig(neighbor_range=4,
                                                    backend='xla'))
