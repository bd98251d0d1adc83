"""Every radius and top-k that the JAX package takes, in vfs_tpu_torch on
the CPU: window offsets past 31 (``neighbor_range`` 66 and 70) and top-k
past 32 (33 and 40), where the CUDA wrappers launch the wide kernel
(``csrc/window_topk_wide.cu``) instead of the core.

On the CPU the wrappers take the plain versions, so these tests hold the
port's functions at those sizes against the JAX package's, run as its own
tests run them: ``propagate_video`` with ``backend`` ``'tiled'``,
``'pallas_video'`` (v2 and v1) and ``'pallas'`` (each of row 3's modes,
JAX in Pallas interpret mode), ``local_masked_topk_attend`` and the scan
kernel's modes one step at a time. Tolerances: logits within atol 1e-5 for
the exact modes (the two packages sum each dot product in different
orders, ~1e-6 apart); the inexact modes under
``test_torch_local_attention_modes.py``'s rule (rtol 1e-4 / atol 1e-5, a
cell excused only where ``_near_boundary`` shows a key at a rounding
boundary at the k-th key's margin). The packed scan refuses what JAX's
refuses. Last, the wrappers choose the wide kernel for each row and each
kind of limit before anything is built (``_build.load`` records the name).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.ops import propagation as jax_prop
from vfs_tpu.ops.local_attention_tiled import \
    local_masked_topk_attend as jax_local_masked_topk_attend
from vfs_tpu_torch.ops import (NEG_INF, local_masked_topk_attend,
                               propagation as torch_prop)
from vfs_tpu_torch.ops import _build, local_attention, local_attention_v2
from vfs_tpu_torch.ops import video_affinity, video_affinity_v1
from vfs_tpu_torch.ops.window_geometry import (KMAX, MAX_OFFSET, circle_band,
                                               core_takes, wide_plan,
                                               window_offset)

from vfs_tpu_torch.ops import l2_normalize, local_topk_attend_reference

from test_torch_local_attention_modes import (MODES, RTOL, ATOL,
                                              _assert_parity, _inputs, _jax,
                                              _near_boundary, _port,
                                              _valid_keys)

torch.set_num_threads(1)

# (neighbor_range, topk): r = 32 and 34 past the core's 31; top-33 and
# top-40 past its 32
WIDE = [(66, 10), (70, 10), (24, 33), (24, 40)]
# a 4 x 40 map: the window spans its height, and the circle's edge in dx
# (|dx| = r = 32 and 34, 11 at top-k 33 and 40) lies inside its width
T, H, W, C, K, P = 5, 4, 40, 8, 3, 2
BACKENDS = [
    ('tiled', dict(backend='tiled')),
    ('pallas_video', dict(backend='pallas_video')),
    ('pallas_video_v1', dict(backend='pallas_video', video_engine='v1')),
    ('pallas', dict(backend='pallas')),
    ('pallas_packed', dict(backend='pallas', pallas_extract='packed')),
    ('pallas_scores_bf16', dict(backend='pallas', pallas_scores='bfloat16')),
]


def _video(seed):
    rng = np.random.RandomState(seed)
    feats = rng.randn(T, H, W, C).astype(np.float32)
    seg_first = np.eye(K, dtype=np.float32)[rng.randint(0, K, (H, W))]
    return feats, seg_first


def test_sizes_take_the_wide_path():
    """The sizes here lie past the core's limits; their windows span the
    map's height and end inside its width."""
    for nr, topk in WIDE:
        radius = nr // 2
        assert not core_takes(radius, topk)
        assert window_offset(radius) > MAX_OFFSET or topk > KMAX
        plan = wide_plan(radius, topk)
        assert len(plan.band) == plan.r + 1 and plan.band[0] == plan.r
        assert plan.r >= H and 2 * plan.r + 1 < 2 * W
    assert core_takes(12, 10) and core_takes(32, 32)
    assert not core_takes(32.5, 10) and not core_takes(12, 33)


@pytest.mark.parametrize('name,backend', BACKENDS, ids=[b[0] for b in BACKENDS])
@pytest.mark.parametrize('nr,topk', WIDE)
def test_propagate_video_matches_jax(nr, topk, name, backend):
    """The port's propagate_video against vfs_tpu's (Pallas kernels in
    interpret mode) at r > 31 and top-k > 32 on every local backend and
    row 3 mode: the exact modes within atol 1e-5; the inexact ones at the
    modes test's rtol 1e-4 / atol 1e-5 with equal argmax."""
    feats, seg_first = _video(nr + topk)
    common = dict(precede_frames=P, topk=topk, temperature=0.07,
                  neighbor_range=nr, **backend)
    ref = np.asarray(jax_prop.propagate_video(
        jnp.asarray(feats), jnp.asarray(seg_first), None,
        jax_prop.PropagationConfig(pallas_interpret=True, **common)))
    out = torch_prop.propagate_video(
        torch.from_numpy(feats), torch.from_numpy(seg_first), None,
        torch_prop.PropagationConfig(**common)).numpy()
    assert out.shape == ref.shape == (T, H, W, K)
    mode = INEXACT.get(name)
    if mode is None:
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
        return
    bad = ~np.isclose(out, ref, rtol=RTOL, atol=ATOL).all(-1)
    if bad.any():
        excused = _excused(feats, nr // 2, topk, mode)
        assert excused[bad].all(), np.argwhere(bad & ~excused)
    np.testing.assert_allclose(out[~bad], ref[~bad], rtol=RTOL, atol=ATOL)


INEXACT = {'pallas_packed': dict(extract='packed'),
           'pallas_scores_bf16': dict(scores='bfloat16')}


def _excused(feats, radius, topk, mode):
    """(T, H, W) bool: the cells of the scan whose logits may differ
    between two summation orders under the modes test's rule: at step t
    a cell whose selection ``_near_boundary`` shows at a rounding boundary,
    or one that selects a key whose slot holds an excused cell's logits.
    The bank follows the scan's layout (``_propagate_video_scan``): slot 0
    frame 0, slot ``1 + j`` the latest frame ``f < t`` with ``f % P ==
    j`` (frame 0 for j = 0 first), valid iff ``j < t``."""
    feats = l2_normalize(torch.from_numpy(feats), dim=-1)
    excused = np.zeros((T, H, W), bool)
    for t in range(1, T):
        frames = [0] + [max(f for f in range(t) if f % P == j) if j < t
                        else 0 for j in range(P)]
        valid = [1] + [int(j < t) for j in range(P)]
        bank = feats[frames].numpy()
        near = _near_boundary(feats[t].numpy(), bank, valid, radius, topk,
                              **mode)
        src = local_topk_attend_reference(
            feats[t], torch.from_numpy(bank), torch.zeros(P + 1, H, W, 1),
            torch.tensor(valid), float(radius), 0.07, topk, **mode)[2]
        slot, cell = src.numpy() // (H * W), src.numpy() % (H * W)
        reads = excused[np.asarray(frames)[slot]].reshape(-1, H * W)
        taint = np.take_along_axis(reads, cell.reshape(-1, 1), 1)
        excused[t] = near | taint.reshape(H, W, topk).any(-1)
    return excused


@pytest.mark.parametrize('nr,topk', WIDE)
def test_local_masked_topk_attend_matches_jax(nr, topk):
    """The port's local_masked_topk_attend (row 3's function) against the
    JAX op of the same name, on a bank with an invalid slot."""
    radius = nr // 2
    query, bank, vals = _inputs(nr + topk, H, W, f=4, c=16, k=K)
    valid = np.array([1, 0, 1, 1], bool)
    assert (_valid_keys(H, W, radius, valid) >= topk).all()
    ref = np.asarray(jax_local_masked_topk_attend(
        jnp.asarray(query), jnp.asarray(bank), jnp.asarray(vals),
        jnp.asarray(valid), float(radius), 0.07, topk))
    out = local_masked_topk_attend(
        torch.from_numpy(query), torch.from_numpy(bank),
        torch.from_numpy(vals), torch.from_numpy(valid), float(radius), 0.07,
        topk).numpy()
    assert out.shape == ref.shape == (H, W, K)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_local_masked_topk_attend_fillers_and_tile():
    """Fewer valid keys than k: fillers of weight 0 in both packages; the
    tile is a TPU layout key with no effect."""
    query, bank, vals = _inputs(3, 2, 3, f=2, c=8, k=2)
    valid = np.array([1, 1], bool)
    assert (_valid_keys(2, 3, 33, valid) < 40).all()
    ref = np.asarray(jax_local_masked_topk_attend(
        jnp.asarray(query), jnp.asarray(bank), jnp.asarray(vals),
        jnp.asarray(valid), 33.0, 0.07, 20))
    args = [torch.from_numpy(a) for a in (query, bank, vals, valid)]
    out = local_masked_topk_attend(*args, 33.0, 0.07, 20).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        local_masked_topk_attend(*args, 33.0, 0.07, 40, tile=(4, 8)),
        local_masked_topk_attend(*args, 33.0, 0.07, 40))


@pytest.mark.parametrize('bf16', [False, True])
@pytest.mark.parametrize('mode', MODES, ids=['scores_bf16', 'packed'])
@pytest.mark.parametrize('nr,topk', WIDE)
def test_scan_modes_match_tpu_kernel(nr, topk, mode, bf16):
    """Row 3's inexact modes one step at a time against the TPU kernel in
    interpret mode at the wide sizes, under the modes test's rule
    (``_assert_parity``)."""
    radius = nr // 2
    query, bank, vals = _inputs(nr * topk, H, W, f=3, c=16, k=K)
    valid = (1, 1, 1)
    assert (_valid_keys(H, W, radius, valid) >= topk).all()
    out, scores, _ = _port(query, bank, vals, valid, radius, topk, bf16,
                           **mode)
    ref = _jax(query, bank, vals, valid, radius, topk, (4, 8), bf16, **mode)
    _assert_parity(out, ref, query, bank, valid, radius, topk, bf16, **mode)
    assert (scores > NEG_INF / 2).all()


@pytest.mark.parametrize('nr,p,refuses', [(66, 8, False), (66, 20, True),
                                          (70, 20, True), (24, 20, False)])
def test_packed_scan_refuses_where_jax_refuses(nr, p, refuses):
    """``pallas_extract='packed'`` packs a 16-bit key index in the JAX
    package and raises past 65536 keys a TPU tile (P + 1 key blocks of the
    8 x 8 tile's window); the port raises exactly there."""
    feats, seg_first = _video(nr + p)
    feats, seg_first = feats[:3, :3, :5], seg_first[:3, :5]
    common = dict(precede_frames=p, topk=4, temperature=0.07,
                  neighbor_range=nr, backend='pallas',
                  pallas_extract='packed')
    jax_cfg = jax_prop.PropagationConfig(pallas_interpret=True, **common)
    cfg = torch_prop.PropagationConfig(**common)
    assert (torch_prop.packed_keys(cfg) > 65536) == refuses
    args = (torch.from_numpy(feats), torch.from_numpy(seg_first), None, cfg)
    if refuses:
        with pytest.raises(ValueError, match='packed'):
            jax_prop.propagate_video(jnp.asarray(feats),
                                     jnp.asarray(seg_first), None, jax_cfg)
        with pytest.raises(ValueError, match='packed'):
            torch_prop.propagate_video(*args)
        # the exact scan takes the same size
        torch_prop.propagate_video(*args[:3], cfg._replace(
            pallas_extract='mask'))
    else:
        ref = np.asarray(jax_prop.propagate_video(
            jnp.asarray(feats), jnp.asarray(seg_first), None, jax_cfg))
        out = torch_prop.propagate_video(*args).numpy()
        np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


class Built(Exception):
    """Raised by the recording ``_build.load``: nothing launches."""


@pytest.fixture
def built(monkeypatch):
    """Record which library each wrapper asks ``_build.load`` for, with
    the device checks waived so that CPU tensors reach it."""
    names = []

    def load(name):
        names.append(name)
        raise Built(name)

    monkeypatch.setattr(_build, 'load', load)
    for module, check in ((video_affinity, 'check_features'),
                          (video_affinity_v1, 'check_features'),
                          (local_attention, 'check_operands'),
                          (local_attention_v2, 'check_operands')):
        monkeypatch.setattr(module, check, lambda *a, **k: None)
    return names


def _call(row, radius, topk, **mode):
    h, w, c = 4, 5, 8
    feats = torch.zeros(3, h, w, c)
    step = (torch.zeros(h, w, c), torch.zeros(2, h, w, c),
            torch.zeros(2, h, w, 4), torch.ones(2, dtype=torch.int32))
    if row == 1:
        video_affinity.video_topk_affinity_cuda(feats, radius, 0.07, topk, 2)
    elif row == 2:
        video_affinity_v1.video_topk_affinity_v1_cuda(
            feats, radius, 0.07, topk, 2, extract='perframe')
    elif row == 3:
        local_attention.local_topk_attend_cuda(*step, radius, 0.07, topk,
                                               **mode)
    else:
        local_attention_v2.local_topk_attend_v2_cuda(*step, radius, 0.07,
                                                     topk)


CORE_LIBRARY = {1: 'video_topk_affinity', 2: 'video_topk_affinity_v1',
                3: 'local_topk_attend', 4: 'local_topk_attend_v2'}


@pytest.mark.parametrize('kind', ['radius', 'topk', 'both', 'core'])
@pytest.mark.parametrize('row', [1, 2, 3, 4])
def test_wrappers_choose_the_wide_kernel_before_any_build(built, kind, row):
    """r > 31 or topk > 32 (or both) take the wide kernel, core sizes
    (r = 31, top-32) the row's own, decided before anything is built."""
    radius, topk = dict(radius=(MAX_OFFSET + 2.0, 10), topk=(5.0, KMAX + 1),
                        both=(40.0, 48), core=(MAX_OFFSET + 1.0, KMAX))[kind]
    with pytest.raises(Built):
        _call(row, radius, topk)
    want = CORE_LIBRARY[row] if kind == 'core' else 'window_topk_wide'
    assert built == [want]


@pytest.mark.parametrize('mode', [{}, dict(scores='bfloat16'),
                                  dict(extract='packed')],
                         ids=['exact', 'scores_bf16', 'packed'])
def test_scan_modes_take_the_wide_kernel(built, mode):
    with pytest.raises(Built):
        _call(3, 40.0, 10, **mode)
    assert built == ['window_topk_wide']


def test_wide_entry_names():
    """The wide kernel's C entries mirror the core's, mode by mode."""
    names = {local_attention.wide_entry_name(s, e, d)
             for s, e in (('float32', 'mask'), ('bfloat16', 'mask'),
                          ('float32', 'packed'))
             for d in (torch.float32, torch.bfloat16)}
    assert names == {f'vfs_local_topk_wide{m}{f}'
                     for m in ('', '_scores_bf16', '_packed')
                     for f in ('', '_bf16')}


def test_band_is_exact_past_the_core():
    """The wide plan's band is the circle's at r past 31 (the brute-force
    float test of ``circle_offsets``)."""
    for radius in (33.0, 35.0, 40.0):
        band = circle_band(radius)
        r = window_offset(radius)
        r2 = np.float32(radius * radius)
        for dy in range(r + 1):
            inside = [dx for dx in range(-r, r + 1)
                      if np.float32(dy * dy + dx * dx) < r2]
            assert inside == list(range(-band[dy], band[dy] + 1))
