"""vfs_tpu_torch per-step masked top-k attention and the scan-tier
propagation (``backend='pallas'``) against the JAX package on the CPU.

The port's plain ``local_topk_attend_reference`` is held against
``vfs_tpu``'s TPU kernel ``pallas_local_topk_attend`` run in Pallas
interpret mode (inputs laid out by ``pad_for_pallas``) and against its XLA
twin ``local_masked_topk_attend``, on the seeded inputs of
``tests/test_ops/test_pallas_kernel.py`` plus cases for invalid slots,
duplicated frames (ties), filler entries and tile-indivisible maps.
Logits agree within rtol 1e-4 / atol 1e-5 (the packages sum the dot
products and the weighted sums in different orders).

The scan path is held against JAX ``propagate_video(backend='pallas',
pallas_interpret=True)`` itself (the interpret-mode scan compiles in a few
seconds here) at T >= P + 2, so the ring wraps, and against the port's own
decoupled path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.ops import propagation as jax_prop
from vfs_tpu.ops.affinity import l2_normalize as jax_l2_normalize
from vfs_tpu.ops.local_attention_tiled import local_masked_topk_attend
from vfs_tpu.ops.pallas_attention import (pad_for_pallas,
                                          pallas_local_topk_attend)
from vfs_tpu_torch.ops import NEG_INF, propagation as torch_prop
from vfs_tpu_torch.ops.local_attention import (local_topk_attend,
                                               local_topk_attend_reference)

torch.set_num_threads(1)


def _inputs(seed, h, w, f=5, c=16, k=3):
    """The seeded inputs of tests/test_ops/test_pallas_kernel.py."""
    rng = np.random.RandomState(seed)
    query = np.array(jax_l2_normalize(
        jnp.asarray(rng.randn(h, w, c), jnp.float32), -1))
    bank = np.array(jax_l2_normalize(
        jnp.asarray(rng.randn(f, h, w, c), jnp.float32), -1))
    vals = rng.rand(f, h, w, k).astype(np.float32)
    return query, bank, vals


def _port(query, bank, vals, valid, radius, topk):
    out = local_topk_attend_reference(
        torch.from_numpy(query), torch.from_numpy(bank),
        torch.from_numpy(vals), torch.from_numpy(np.asarray(valid)),
        float(radius), 0.07, topk)
    return tuple(o.numpy() for o in out)


def _jax_pallas(query, bank, vals, valid, radius, topk, tile):
    h, w = query.shape[:2]
    return np.asarray(pallas_local_topk_attend(
        pad_for_pallas(jnp.asarray(query), h, w, radius, tile),
        pad_for_pallas(jnp.asarray(bank), h, w, radius, tile),
        jnp.asarray(vals), jnp.asarray(valid, jnp.int32), radius=radius,
        temperature=0.07, topk=topk, h=h, w=w, tile=tile, interpret=True))


def _jax_tiled(query, bank, vals, valid, radius, topk):
    return np.asarray(local_masked_topk_attend(
        jnp.asarray(query), jnp.asarray(bank), jnp.asarray(vals),
        jnp.asarray(valid, bool), radius=radius, temperature=0.07,
        topk=topk, tile=(4, 4)))


def _assert_sources_in_tie_order(scores, src):
    """Along each list, scores descend and equal scores take ascending
    sources: the (slot, ky, kx) tie order."""
    s0, s1 = scores[..., :-1], scores[..., 1:]
    assert (s0 >= s1).all()
    ties = s0 == s1
    assert (src[..., :-1][ties] < src[..., 1:][ties]).all()


@pytest.mark.parametrize('h,w,nr,tile,topk,k,valid', [
    (12, 14, 6, (4, 8), 4, 3, [1, 1, 1, 0, 0]),
    (10, 11, 8, (8, 8), 3, 3, [1, 1, 1, 0, 0]),  # tile-indivisible both dims
    (9, 13, 6, (4, 8), 10, 16, [1, 0, 1, 0, 1]),  # holes, K = 16
    (7, 5, 8, (8, 8), 8, 4, [0, 1, 1, 1, 1]),    # slot 0 invalid, K = 4
])
def test_local_attend_matches_tpu_kernel(h, w, nr, tile, topk, k, valid):
    query, bank, vals = _inputs(0, h, w, k=k)
    radius = nr // 2
    out, scores, src = _port(query, bank, vals, valid, radius, topk)
    ref = _jax_pallas(query, bank, vals, valid, radius, topk, tile)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        out, _jax_tiled(query, bank, vals, valid, radius, topk),
        rtol=1e-4, atol=1e-5)
    assert out.shape == (h, w, k) and scores.shape == src.shape == (h, w,
                                                                    topk)
    slots = src // (h * w)
    assert np.isin(slots, np.flatnonzero(valid)).all()
    _assert_sources_in_tie_order(scores, src)


def test_local_attend_tie_order():
    """Duplicated bank frames score bit for bit alike at distinct slots:
    the lower slot comes first, and the logits match the TPU kernel's."""
    h, w, radius, topk = 12, 14, 3, 4
    query, bank, vals = _inputs(3, h, w, f=4)
    bank[3] = bank[0]
    bank[2] = bank[1]
    valid = [1, 1, 1, 1]
    out, scores, src = _port(query, bank, vals, valid, radius, topk)
    np.testing.assert_allclose(
        out, _jax_pallas(query, bank, vals, valid, radius, topk, (4, 8)),
        rtol=1e-4, atol=1e-5)
    _assert_sources_in_tie_order(scores, src)
    # some selected key of slot 1 is followed at once by its copy in slot 2
    slot, cell = src // (h * w), src % (h * w)
    assert ((slot[..., :-1] == 1) & (slot[..., 1:] == 2)
            & (cell[..., :-1] == cell[..., 1:])).any()


def test_local_attend_filler_entries():
    """With fewer than k valid keys the rest are filler: score NEG_INF,
    source the query's own cell in slot 0, softmax weight 0."""
    h, w, radius, topk = 2, 3, 2, 12
    query, bank, vals = _inputs(5, h, w, f=3, k=4)
    valid = [1, 0, 1]
    out, scores, src = _port(query, bank, vals, valid, radius, topk)
    filler = scores <= NEG_INF / 2
    assert filler.any() and not filler[..., 0].any()
    np.testing.assert_array_equal(scores[filler], np.float32(NEG_INF))
    own = np.broadcast_to(np.arange(h * w).reshape(h, w, 1), src.shape)
    np.testing.assert_array_equal(src[filler], own[filler])
    np.testing.assert_allclose(
        out, _jax_pallas(query, bank, vals, valid, radius, topk, (8, 8)),
        rtol=1e-4, atol=1e-5)


def test_local_attend_dispatch_cpu_is_reference():
    query, bank, vals = _inputs(6, 5, 6, f=3)
    args = [torch.from_numpy(a) for a in (query, bank, vals)]
    valid = torch.tensor([True, True, False])
    a = local_topk_attend(*args, valid, 3.0, 0.07, 4)
    b = local_topk_attend_reference(*args, valid, 3.0, 0.07, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].dtype == a[1].dtype == torch.float32
    assert a[2].dtype == torch.int64


def _propagation_inputs(seed, t_total, h, w, c, k):
    rng = np.random.RandomState(seed)
    feats = rng.randn(t_total, h, w, c).astype(np.float32)
    seg_first = np.eye(k, dtype=np.float32)[rng.randint(0, k, (h, w))]
    return feats, seg_first


@pytest.mark.parametrize('t_total,h,w,nr,p,topk,dup', [
    (7, 6, 7, 6, 4, 5, False),    # ring wraps: T >= P + 2
    (8, 5, 9, 8, 3, 4, False),    # tile-indivisible, bigger radius
    (8, 6, 6, 6, 2, 3, True),     # duplicated frames: ties
])
def test_scan_propagation_matches_jax(t_total, h, w, nr, p, topk, dup):
    feats, seg_first = _propagation_inputs(t_total + h, t_total, h, w, 8, 3)
    if dup:
        feats[3] = feats[1]
        feats[6] = feats[4]
    common = dict(precede_frames=p, topk=topk, temperature=0.07,
                  neighbor_range=nr)
    ref = np.asarray(jax_prop.propagate_video(
        jnp.asarray(feats), jnp.asarray(seg_first), None,
        jax_prop.PropagationConfig(backend='pallas', pallas_interpret=True,
                                   pallas_tile=(4, 8), **common)))
    out = torch_prop.propagate_video(
        torch.from_numpy(feats), torch.from_numpy(seg_first), None,
        torch_prop.PropagationConfig(backend='pallas', **common)).numpy()
    assert out.shape == ref.shape == (t_total, h, w, 3)
    assert (np.argmax(ref, -1) == np.argmax(out, -1)).mean() == 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    decoupled = torch_prop.propagate_video(
        torch.from_numpy(feats), torch.from_numpy(seg_first), None,
        torch_prop.PropagationConfig(backend='pallas_video', **common))
    np.testing.assert_allclose(out, decoupled.numpy(), rtol=1e-5, atol=1e-6)
