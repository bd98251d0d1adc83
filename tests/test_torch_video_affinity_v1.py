"""vfs_tpu_torch's v1 engine (``video_engine='v1'``) against the JAX
package's v1 whole-video kernel on the CPU.

The port's ``propagate_video(backend='pallas_video', video_engine='v1')``
(on the CPU: the plain ``video_topk_affinity_reference``) is held against
JAX's ``propagate_video(backend='pallas_video', pallas_interpret=True,
video_engine='v1')``, which runs ``video_topk_affinity`` (v1) in Pallas
interpret mode. The cases follow ``tests/test_ops/test_pallas_video.py``:
its shapes, the extraction and tau-early-exit matrix on temporally smooth
features, bank splits 2 and 3 with ring wrap-around, and duplicated
frames for the tie order. Logits agree within rtol 1e-4 / atol 1e-5, the
tolerance of the JAX package's own tests, and argmax everywhere. Both
packages raise ``ValueError`` on the same invalid options.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.ops import propagation as jax_prop
from vfs_tpu_torch.ops import propagation as torch_prop
from vfs_tpu_torch.ops.video_affinity import video_topk_affinity_reference
from vfs_tpu_torch.ops.video_affinity_v1 import (video_topk_affinity_v1,
                                                 video_topk_affinity_v1_cuda)

torch.set_num_threads(1)


def _inputs(seed, t_total, h, w, c, k, smooth=False):
    """Random features (or, with ``smooth``, a base map plus a cumulative
    drift: temporally coherent features, where the tau exit triggers) and
    one-hot first-frame labels, made with numpy."""
    rng = np.random.RandomState(seed)
    if smooth:
        base = rng.randn(h, w, c)
        drift = rng.randn(t_total, h, w, c) * 0.1
        feats = (base[None] + np.cumsum(drift, 0)).astype(np.float32)
    else:
        feats = rng.randn(t_total, h, w, c).astype(np.float32)
    seg_first = np.eye(k, dtype=np.float32)[rng.randint(0, k, (h, w))]
    return feats, seg_first


def _configs(nr, p, topk, tile=(4, 4), **video_kw):
    common = dict(precede_frames=p, topk=topk, temperature=0.07,
                  neighbor_range=nr, backend='pallas_video',
                  video_engine='v1', **video_kw)
    return (jax_prop.PropagationConfig(pallas_interpret=True,
                                       pallas_tile=tile, **common),
            torch_prop.PropagationConfig(**common))


def _check(feats, seg_first, nr, p, topk, tile=(4, 4), **video_kw):
    jax_cfg, torch_cfg = _configs(nr, p, topk, tile, **video_kw)
    ref = np.asarray(jax_prop.propagate_video(
        jnp.asarray(feats), jnp.asarray(seg_first), None, jax_cfg))
    out = torch_prop.propagate_video(torch.from_numpy(feats),
                                     torch.from_numpy(seg_first), None,
                                     torch_cfg).numpy()
    assert out.shape == ref.shape
    assert (np.argmax(ref, -1) == np.argmax(out, -1)).mean() == 1.0
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
    return out


@pytest.mark.parametrize('t_total,h,w,nr,p,tile,topk', [
    (9, 6, 7, 6, 4, (4, 4), 5),      # tile remainder both dims
    (12, 8, 8, 6, 4, (4, 4), 3),     # wraparound: T > P + duplication
    (6, 5, 9, 8, 3, (4, 8), 4),      # wide tile, bigger radius
])
def test_v1_matches_jax(t_total, h, w, nr, p, tile, topk):
    feats, seg_first = _inputs(0, t_total, h, w, 8, 3)
    _check(feats, seg_first, nr, p, topk, tile)


@pytest.mark.parametrize('extract,early_exit', [
    ('sweep', True), ('perframe', True), ('perframe', False)])
def test_v1_extract_modes_match_jax(extract, early_exit):
    """Both extractions, with and without the tau exit, on temporally
    smooth features."""
    feats, seg_first = _inputs(3, 10, 8, 9, 8, 4, smooth=True)
    _check(feats, seg_first, 6, 4, 5, video_extract=extract,
           video_early_exit=early_exit)


@pytest.mark.parametrize('splits,t_total,p', [
    (2, 12, 4),   # wraparound + cross-split frame-0 duplication
    (2, 6, 4),    # split 2 has no valid frames for small t
    (3, 10, 5),   # ragged split sizes
])
def test_v1_bank_splits_match_jax(splits, t_total, p):
    """JAX merges the splits' lists by a 2-key sort; the port has no
    splits, and the logits are the same."""
    feats, seg_first = _inputs(11, t_total, 8, 9, 8, 3)
    _check(feats, seg_first, 6, p, 5, video_bank_splits=splits)


@pytest.mark.parametrize('extract', ['sweep', 'perframe'])
def test_v1_tie_frames_match_jax(extract):
    """Duplicated frames give bit-identical scores at distinct bank
    positions; the lists keep the (j, ky, kx) order."""
    feats, seg_first = _inputs(17, 10, 8, 9, 8, 3)
    feats[3] = feats[1]
    feats[7] = feats[5]
    _check(feats, seg_first, 6, 4, 5, video_extract=extract)


@pytest.mark.parametrize('kw', [
    dict(video_extract='bogus'),
    dict(video_extract='perframe', video_bank_splits=2)])
def test_v1_invalid_options_raise_like_jax(kw):
    feats, seg_first = _inputs(2, 4, 5, 6, 8, 2)
    jax_cfg, torch_cfg = _configs(6, 2, 3, **kw)
    with pytest.raises(ValueError):
        jax_prop.propagate_video(jnp.asarray(feats), jnp.asarray(seg_first),
                                 None, jax_cfg)
    with pytest.raises(ValueError):
        torch_prop.propagate_video(torch.from_numpy(feats),
                                   torch.from_numpy(seg_first), None,
                                   torch_cfg)


def test_v1_options_reach_only_the_v1_engine():
    """``video_engine='v2'`` and ``backend='tiled'`` never read the v1
    options, in either package: an invalid ``video_extract`` passes."""
    feats, seg_first = _inputs(4, 5, 5, 6, 8, 2)
    for backend, engine in (('pallas_video', 'v2'), ('tiled', 'v1')):
        out = torch_prop.propagate_video(
            torch.from_numpy(feats), torch.from_numpy(seg_first), None,
            torch_prop.PropagationConfig(
                neighbor_range=6, precede_frames=2, topk=3, backend=backend,
                video_engine=engine, video_extract='bogus'))
        assert out.shape == (5, 5, 6, 2)


def test_v1_dispatch_cpu_is_reference():
    rng = np.random.RandomState(5)
    f = rng.randn(6, 5, 6, 8).astype(np.float32)
    feats = torch.from_numpy(f / np.linalg.norm(f, axis=-1, keepdims=True))
    for extract in ('sweep', 'perframe'):
        a = video_topk_affinity_v1(feats, 3.0, 0.07, 4, 3, extract=extract)
        b = video_topk_affinity_reference(feats, 3.0, 0.07, 4, 3)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_v1_kernel_wrapper_checks_options_first():
    """The CUDA wrapper raises the JAX package's ``ValueError`` before it
    looks at the tensor or builds anything."""
    feats = torch.zeros(3, 4, 5, 8)
    with pytest.raises(ValueError, match="'sweep' or 'perframe'"):
        video_topk_affinity_v1_cuda(feats, 3.0, 0.07, 4, 2, extract='x')
    with pytest.raises(ValueError, match='CUDA tensor'):
        video_topk_affinity_v1_cuda(feats, 3.0, 0.07, 4, 2)
    assert video_topk_affinity_v1_cuda.launches == 0
