"""Row 1's tensor-core path on the CPU: its margin, its selection and its
wrapper.

``csrc/video_topk_tc.cu`` scores every window pair on TF32 tensor cores
(a pre-score), keeps each query's top 32 pre-scores, and re-scores with
the exact fmaf chain only the keys that its margin cannot rule out; its
lists must equal the FFMA core's bit for bit. The card alone runs the
kernel. Here:

- the host's margin (``window_geometry.prescore_margin``) bounds the gap
  between an emulated pre-score (TF32 operands truncated on their low 13
  bits, as the kernel clears them and as the tensor cores read fp32, 1x
  and split 3x, sums of 8 exact products rounded to fp32 to nearest or
  toward zero, 128 channels at a time) and the fp32 fmaf chain, and both
  against float64, on random and adversarial vectors;
- a plain emulation of the kernel's selection (pre-score, top-32 list,
  the margin's candidates, the per-query overflow pass, the exact
  re-rank) gives ``video_topk_affinity_reference``'s scores and sources
  exactly, for pre-scores anywhere within the margin, on the cases of
  ``test_torch_video_affinity.py`` and on near ties (repeated frames,
  constant regions, keys an ulp apart);
- the wrapper sends fp32 launches of ``C >= TC_MIN_CHANNELS`` to the
  tensor-core entry with the plan, the margin and a workspace of
  ``tc_workspace_ints`` words, and its counters reach a trace recording.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from vfs_tpu_torch.ops import _build, video_affinity
from vfs_tpu_torch.ops.affinity import NEG_INF
from vfs_tpu_torch.ops.video_affinity import (bank_frame, circle_offsets,
                                              video_topk_affinity_reference)
from vfs_tpu_torch.ops.window_geometry import (TC_FLUSH_CHANNELS,
                                               TC_MIN_CHANNELS, UNIT,
                                               norm_grow, prescore_margin,
                                               tc_takes, tc_workspace_ints,
                                               window_plan)
from vfs_tpu_torch.utils import trace

torch.set_num_threads(1)

INV_TAU = float(np.float32(1 / 0.07))
LIST = 32


# --- emulation ---------------------------------------------------------


def tf32(x: np.ndarray) -> np.ndarray:
    """fp32 values with their low 13 mantissa bits cleared: the kernel's
    hi parts, and what the tensor cores read of any fp32 value."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xffffe000)).view(np.float32)


def split(x: np.ndarray):
    hi = tf32(x)
    return hi, tf32((x - hi).astype(np.float32))


def round32(x: np.ndarray, toward_zero: bool) -> np.ndarray:
    r = x.astype(np.float32)
    if toward_zero:
        over = np.abs(r.astype(np.float64)) > np.abs(x)
        r = np.where(over, np.nextafter(r, np.float32(0)), r)
    return r


def prescores(q: np.ndarray, k: np.ndarray, splits: int,
              toward_zero: bool = False) -> np.ndarray:
    """The kernel's pre-scores of every (row of q, row of k), times
    inv_tau: TF32 parts, three (or one) products a channel, sums of 8
    exact products onto an fp32 accumulator rounded to nearest (or toward
    zero), a fresh accumulator every 128 channels, the partial sums added
    in fp32, then scaled in fp32."""
    qh, ql = split(q)
    kh, kl = split(k)
    terms = ([(ql, kh), (qh, kl), (qh, kh)] if splits == 3
             else [(qh, kh)])
    c = q.shape[1]
    total = None
    for c0 in range(0, c, TC_FLUSH_CHANNELS):
        acc = np.zeros((q.shape[0], k.shape[0]), np.float32)
        for k0 in range(c0, min(c, c0 + TC_FLUSH_CHANNELS), 8):
            for a, b in terms:
                blk = (a[:, k0:k0 + 8].astype(np.float64)
                       @ b[:, k0:k0 + 8].astype(np.float64).T)
                acc = round32(acc.astype(np.float64) + blk, toward_zero)
        total = acc if total is None else (total + acc).astype(np.float32)
    return (total * np.float32(INV_TAU)).astype(np.float32)


def chain_scores(q: np.ndarray, k: np.ndarray) -> np.ndarray:
    """The fmaf chain of each pair (row i of q with row i of k) over
    channels 0..C-1 from 0, times inv_tau, in fp32."""
    a = np.zeros(q.shape[0], np.float32)
    for i in range(q.shape[1]):
        a = (q[:, i].astype(np.float64) * k[:, i].astype(np.float64)
             + a.astype(np.float64)).astype(np.float32)
    return (a * np.float32(INV_TAU)).astype(np.float32)


def unit(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def pairs(kind: str, c: int, n: int = 48):
    """``n`` (q, k) pairs of C channels of one adversarial kind."""
    rng = np.random.RandomState(c + len(kind))
    q = unit(rng.randn(n, c))
    k = unit(rng.randn(n, c))
    if kind == 'equal':            # every channel the same: score 1
        q = np.full((n, c), 1 / np.sqrt(c), np.float32)
        k = q.copy()
    elif kind == 'onehot':         # one channel, first or last
        q = np.zeros((n, c), np.float32)
        k = np.zeros((n, c), np.float32)
        q[:, 0] = 1
        k[: n // 2, 0] = 1
        k[n // 2:, c - 1] = 1
    elif kind == 'self':           # q = k: the accumulators reach 1
        k = q.copy()
    elif kind == 'front':          # the norm in the first 8 channels
        q[:, 8:] *= 1e-3
        q = unit(q)
        k = q.copy()
    elif kind == 'cancel':         # +-1/sqrt(C) against 1/sqrt(C)
        q = np.full((n, c), 1 / np.sqrt(c), np.float32)
        q[:, 1::2] *= -1
        k = np.abs(q)
    elif kind == 'norm_ulps':      # norms 1 + a few ulp
        q = (q * np.float32(1 + 3 * UNIT)).astype(np.float32)
        k = (k * np.float32(1 + 3 * UNIT)).astype(np.float32)
    return q, k


# --- (a) the margin ----------------------------------------------------


@pytest.mark.parametrize('c', [16, 256, 1024])
@pytest.mark.parametrize('kind', ['random', 'equal', 'onehot', 'self',
                                  'front', 'cancel', 'norm_ulps'])
@pytest.mark.parametrize('splits', [3, 1])
def test_margin_bounds_prescore_and_chain(c, kind, splits):
    """|pre-score - chain|, and each against float64 truth, stay within
    the margin, for accumulators rounded to nearest and toward zero."""
    q, k = pairs(kind, c)
    coef, absolute = prescore_margin(c, INV_TAU, splits)
    n2 = max(float((q.astype(np.float64) ** 2).sum(1).max()),
             float((k.astype(np.float64) ** 2).sum(1).max()))
    m = coef * n2 + absolute
    truth = (q.astype(np.float64) * k.astype(np.float64)).sum(1) * INV_TAU
    s = chain_scores(q, k).astype(np.float64)
    assert np.abs(s - truth).max() <= m
    for toward_zero in (False, True):
        p = np.diagonal(prescores(q, k, splits, toward_zero)).astype(
            np.float64)
        assert np.abs(p - s).max() <= m
        assert np.abs(p - truth).max() <= m


def test_margin_terms():
    """The split margin is close to the chain's own bound (gamma_C,
    times inv_tau) at the eval's width, the 1x one is 10x wider, and it
    grows with C; bad arguments raise."""
    chain = 1024 * UNIT * INV_TAU
    coef3, absolute = prescore_margin(1024, INV_TAU, 3)
    coef1, _ = prescore_margin(1024, INV_TAU, 1)
    assert chain < coef3 < 1.5 * chain
    assert coef1 > 10 * coef3
    assert 0 < absolute < 1e-30
    assert prescore_margin(256, INV_TAU)[0] < coef3
    assert np.float32(coef3) == coef3  # an fp32 value, rounded up
    with pytest.raises(ValueError):
        prescore_margin(1024, INV_TAU, 2)
    with pytest.raises(ValueError):
        prescore_margin(0, INV_TAU)
    assert norm_grow(1024) >= 1 / (1 - 1024 * UNIT) ** 2


def test_norm_grow_bounds_the_computed_norm():
    """The kernel's largest squared norm, summed in fp32 in any order and
    multiplied by ``norm_grow``, is at least the exact one."""
    rng = np.random.RandomState(0)
    for c in (16, 1024):
        x = unit(rng.randn(64, c)) * np.float32(1 + 2 * UNIT)
        exact = (x.astype(np.float64) ** 2).sum(1)
        for order in (np.arange(c), np.arange(c)[::-1]):
            a = np.zeros(64, np.float32)
            for i in order:
                a = (a + x[:, i] * x[:, i]).astype(np.float32)
            assert (a.astype(np.float64) * norm_grow(c) >= exact).all()


# --- (b) the selection --------------------------------------------------


def window(feats: torch.Tensor, radius: float, topk: int, p: int, t: int):
    """Query frame t's window as the reference builds it: each query's
    scores (fp32, -inf where invalid) and sources over the bank positions
    j = 0..P in (j, dy, dx) order, which is the order key's order."""
    t_total, h, w, c = feats.shape
    hw = h * w
    _, dy, dx = circle_offsets(radius)
    ky = torch.arange(h).view(h, 1, 1) + dy
    kx = torch.arange(w).view(1, w, 1) + dx
    inb = ((ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)).reshape(hw, -1)
    key_pos = (ky.clamp(0, h - 1) * w + kx.clamp(0, w - 1)).reshape(hw, -1)
    inv_tau = torch.tensor(1 / 0.07, dtype=torch.float32)
    q = feats[t].reshape(hw, c)
    cand, src, valid = [], [], []
    for j in range(p + 1):
        f = bank_frame(t, j, p)
        if f is None:
            cand.append(torch.full(key_pos.shape, -np.inf))
            src.append(key_pos)
            valid.append(torch.zeros_like(inb))
            continue
        s = (q @ feats[f].reshape(hw, c).T) * inv_tau
        cand.append(torch.where(inb, s.gather(1, key_pos),
                                torch.tensor(-np.inf)))
        src.append(f * hw + key_pos)
        valid.append(inb)
    return (torch.cat(cand, 1).numpy(), torch.cat(src, 1).numpy(),
            torch.cat(valid, 1).numpy())


def select(s, p, valid, topk, m, list_size):
    """The kernel's selection for one query: keys (columns, in order-key
    order) with exact scores s and pre-scores p. Returns the chosen
    columns (best first) and whether the list overflowed."""
    cols = np.nonzero(valid)[0]
    lst = cols[np.lexsort((cols, -p[cols]))][:list_size]
    theta = p[lst[topk - 1]] if len(lst) >= topk else -np.inf
    r = lst[p[lst] >= theta - 2 * m]
    r = r[np.lexsort((r, -s[r]))]
    kappa = s[r[topk - 1]] if len(r) >= topk else -np.inf
    overflow = len(cols) >= list_size and p[lst[-1]] >= kappa - m
    if overflow:
        r = cols[p[cols] >= kappa - m]
        r = r[np.lexsort((r, -s[r]))]
    return r[:topk], overflow


def emulate(feats, radius, topk, p, m, list_size, prescore):
    """Row 1 by the kernel's selection: ``prescore(t, s, valid)`` gives
    each query's pre-scores. Returns scores, sources and the overflowed
    queries."""
    t_total, h, w, _ = feats.shape
    scores = np.zeros((t_total, h * w, topk), np.float32)
    src = np.zeros((t_total, h * w, topk), np.int64)
    overflowed = 0
    for t in range(1, t_total):
        s, s_src, valid = window(feats, radius, topk, p, t)
        pre = prescore(t, s, valid)
        for q in range(h * w):
            chosen, over = select(s[q], pre[q], valid[q], topk, m,
                                  list_size)
            overflowed += over
            scores[t, q] = NEG_INF
            src[t, q] = q
            scores[t, q, :len(chosen)] = s[q, chosen]
            src[t, q, :len(chosen)] = s_src[q, chosen]
    return (scores.reshape(t_total, h, w, topk),
            src.reshape(t_total, h, w, topk), overflowed)


def feats_case(kind, t_total, h, w, c, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(t_total, h, w, c)
    if kind == 'dup':             # two frames repeated
        x[3 % t_total] = x[1]
        x[7 % t_total] = x[5 % t_total]
    elif kind == 'static':        # a static background: every frame alike
        x[1:] = x[0]
    elif kind == 'flat':          # a constant region in every frame
        x[:, 1:4, 2:6] = x[0, 0, 0]
    feats = unit(x)
    if kind == 'ulp':             # frames an ulp apart in one channel
        for t in range(2, t_total):
            feats[t] = feats[1]
            feats[t, ..., t % c] = np.nextafter(
                feats[1, ..., t % c], np.float32(np.inf) if t % 2
                else np.float32(-np.inf))
    return torch.from_numpy(np.ascontiguousarray(feats))


# (kind, T, h, w, C, radius, P, topk): test_torch_video_affinity.py's
# shapes, then near ties
CASES = [('random', 9, 6, 7, 8, 3.0, 4, 5),
         ('random', 12, 8, 8, 8, 3.0, 4, 3),
         ('random', 6, 5, 9, 8, 4.0, 3, 4),
         ('random', 12, 8, 9, 8, 3.0, 1, 5),
         ('random', 2, 5, 6, 8, 3.0, 4, 3),
         ('random', 4, 2, 3, 8, 2.0, 2, 12),   # fillers
         ('dup', 10, 8, 9, 8, 3.0, 4, 5),
         ('static', 8, 6, 7, 8, 3.0, 5, 10),
         ('flat', 7, 6, 8, 8, 3.0, 3, 10),
         ('ulp', 8, 5, 7, 8, 3.0, 5, 10)]


@pytest.mark.parametrize('case', CASES, ids=[
    f'{c[0]}-T{c[1]}-{c[2]}x{c[3]}-k{c[7]}' for c in CASES])
@pytest.mark.parametrize('m,list_size', [(1e-3, LIST), (0.05, LIST),
                                         (0.5, 12)])
def test_selection_matches_reference(case, m, list_size):
    """Pre-scores anywhere within m of the exact scores (random, and at
    +-m) give the reference's scores and sources exactly."""
    kind, t_total, h, w, c, radius, p, topk = case
    feats = feats_case(kind, t_total, h, w, c, t_total * 31 + h)
    rng = np.random.RandomState(7)

    def prescore(t, s, valid):
        d = rng.uniform(-m, m, s.shape)
        d[rng.rand(*s.shape) < 0.3] = m * rng.choice([-1, 1])
        return np.where(valid, s.astype(np.float64) + d, -np.inf)

    list_size = max(list_size, topk)
    scores, src, _ = emulate(feats, radius, topk, p, m, list_size, prescore)
    ref_s, ref_i = video_topk_affinity_reference(feats, radius, 0.07, topk, p)
    np.testing.assert_array_equal(scores[1:], ref_s[1:].numpy())
    np.testing.assert_array_equal(src[1:], ref_i[1:].numpy())


@pytest.mark.parametrize('kind', ['static', 'flat', 'ulp'])
def test_near_ties_overflow_and_stay_exact(kind):
    """Near ties fill a short list within the margin: the overflow pass
    runs, and the lists still equal the reference's."""
    feats = feats_case(kind, 8, 6, 7, 8, 3)

    def prescore(t, s, valid):
        return np.where(valid, s.astype(np.float64), -np.inf)

    scores, src, overflowed = emulate(feats, 3.0, 10, 5, 0.01, 10, prescore)
    ref_s, ref_i = video_topk_affinity_reference(feats, 3.0, 0.07, 10, 5)
    assert overflowed > 0
    np.testing.assert_array_equal(scores[1:], ref_s[1:].numpy())
    np.testing.assert_array_equal(src[1:], ref_i[1:].numpy())


@pytest.mark.parametrize('case', [CASES[0], CASES[7], CASES[8], CASES[9]],
                         ids=['random', 'static', 'flat', 'ulp'])
@pytest.mark.parametrize('splits', [3, 1])
def test_selection_with_tf32_prescores(case, splits):
    """The emulated TF32 pre-scores with the host's margin: the reference's
    lists exactly."""
    kind, t_total, h, w, c, radius, p, topk = case
    c = 64
    feats = feats_case(kind, t_total, h, w, c, 5)
    coef, absolute = prescore_margin(c, INV_TAU, splits)
    n2 = float((feats.double() ** 2).sum(-1).max())
    m = coef * n2 + absolute
    hw = h * w
    f = feats.numpy()
    _, dy, dx = circle_offsets(radius)

    def prescore(t, s, valid):
        out = []
        for j in range(p + 1):
            fj = bank_frame(t, j, p)
            dense = prescores(f[t].reshape(hw, c),
                              f[fj if fj is not None else 0].reshape(hw, c),
                              splits)
            ky = np.clip(np.arange(h)[:, None, None] + dy.numpy(), 0, h - 1)
            kx = np.clip(np.arange(w)[None, :, None] + dx.numpy(), 0, w - 1)
            pos = (ky * w + kx).reshape(hw, -1)
            out.append(np.take_along_axis(dense, pos, 1))
        return np.where(valid, np.concatenate(out, 1).astype(np.float64),
                        -np.inf)

    scores, src, _ = emulate(feats, radius, topk, p, m, LIST, prescore)
    ref_s, ref_i = video_topk_affinity_reference(feats, radius, 0.07, topk, p)
    np.testing.assert_array_equal(scores[1:], ref_s[1:].numpy())
    np.testing.assert_array_equal(src[1:], ref_i[1:].numpy())


# --- the wrapper --------------------------------------------------------


class Recorded:
    """A stand-in library: each entry records its arguments and returns 0;
    the tensor-core entry writes (3, 5) to its counters when given any."""

    def __init__(self, name):
        self.name = name
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith('vfs_'):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            if name == 'vfs_video_topk_tc' and args[4] is not None:
                (ctypes.c_int64 * 2).from_address(args[4])[:] = [3, 5]
            return 0

        setattr(self, name, entry)
        return entry


@pytest.fixture
def libs(monkeypatch):
    """The row-1 wrapper on CPU tensors, with recording libraries."""
    made = {}

    def load(name):
        return made.setdefault(name, Recorded(name))

    monkeypatch.setattr(_build, 'load', load)
    monkeypatch.setattr(video_affinity, 'check_features',
                        lambda *a, **k: None)
    monkeypatch.setattr(video_affinity, '_sm_count', lambda index: 4)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch.cuda, 'current_device', lambda: 0)
    fn = video_affinity.video_topk_affinity_cuda
    for counter in ('launches', 'tc_launches', 'bf16_launches'):
        monkeypatch.setattr(fn, counter, getattr(fn, counter))
    monkeypatch.setattr(video_affinity, '_pending', [])
    return made


@pytest.mark.parametrize('c,dtype,entry', [
    (1024, torch.float32, 'vfs_video_topk_tc'),
    (TC_MIN_CHANNELS, torch.float32, 'vfs_video_topk_tc'),
    (256, torch.float32, 'vfs_video_topk_affinity'),
    (1024, torch.bfloat16, 'vfs_video_topk_affinity_bf16')])
def test_wrapper_routes_by_width_and_type(libs, c, dtype, entry):
    """fp32 features of C >= TC_MIN_CHANNELS take the tensor-core entry;
    narrower or bf16 features the core; both count as row 1's launches."""
    t_total, h, w, p, radius, topk = 5, 4, 6, 3, 18.0, 10
    fn = video_affinity.video_topk_affinity_cuda
    before = (fn.launches, fn.tc_launches)
    video_affinity.video_topk_affinity_cuda(
        torch.zeros(t_total, h, w, c, dtype=dtype), radius, 0.07, topk, p)
    calls = [call for lib in libs.values() for call in lib.calls]
    [(name, args)] = calls
    assert name == entry
    tc = entry == 'vfs_video_topk_tc'
    assert tc == tc_takes(c, dtype)
    assert (fn.launches, fn.tc_launches) == (before[0] + 1, before[1] + tc)
    if tc:
        plan = window_plan(radius, topk)
        assert args[4] is None  # no counters outside a recording
        assert args[5:10] == (t_total, h, w, c, plan.r)
        assert list(args[10]) == list(plan.band)
        assert args[11] == pytest.approx(1 / 0.07)
        assert args[12:14] == (topk, p)
        coef, absolute = prescore_margin(c, float(np.float32(1 / 0.07)))
        assert args[14:17] == (coef, absolute, norm_grow(c))
        assert args[17] == 4
        assert tc_workspace_ints(t_total, h, w, p, plan.r, 4) == (
            8 + (t_total - 1) * h * w + (t_total - 1) * 1 * 1
            + 4 * 64 * (p + 1) * (2 * plan.r + 1) ** 2)


def test_counters_reach_a_recording(libs):
    """Inside a recording the entry gets a counter array, and
    ``flush_counts`` adds it to the recording's counts; outside, nothing
    is pending."""
    feats = torch.zeros(3, 4, 6, 1024)
    video_affinity.video_topk_affinity_cuda(feats, 18.0, 0.07, 10, 2)
    assert video_affinity._pending == []
    with trace.recording() as rec:
        video_affinity.video_topk_affinity_cuda(feats, 18.0, 0.07, 10, 2)
        video_affinity.video_topk_affinity_cuda(feats, 18.0, 0.07, 10, 2)
        video_affinity.flush_counts()
    assert rec.counts == {'row1.rescored_pairs': 6,
                          'row1.overflow_queries': 10}
    assert video_affinity._pending == []
