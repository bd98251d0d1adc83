"""The wide kernel's plan (``window_geometry.WidePlan``) in pure Python, and
the four wrappers' calls of the wide kernel's C entries through a recording
library, on the CPU.

The plan fixes what ``csrc/window_topk_wide.cu`` is given past the core's
limits: the passes a block covers at once, the key rows it stages
together, its shared memory, and the scratch of the running and the
per-slot lists. These tests hold the shared memory within an H100 block's
232,448 bytes for every r, top-k, channel count, feature type and map
width a caller may bring, and check that the wrappers allocate exactly the
plan's scratch and pass the plan's arguments.
"""

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from vfs_tpu_torch.ops import (_build, local_attention, local_attention_v2,
                               video_affinity, video_affinity_v1,
                               window_geometry)
from vfs_tpu_torch.ops.window_geometry import (CELL_BYTES, KMAX,
                                               MAX_PASS_GROUP, PASS_DX,
                                               SMEM_LIMIT, TILE_H, TILE_W,
                                               WidePlan, circle_band,
                                               wide_plan)

torch.set_num_threads(1)

QUERIES = TILE_H * TILE_W


def _plans(rs, topks):
    """Plans for each r and top-k (the band, which the block's shape does
    not read, as a placeholder of r + 1 ints)."""
    for r in rs:
        band = tuple(range(r, -1, -1))
        for topk in topks:
            yield WidePlan(r=r, band=band, topk=topk)


def test_block_fits_every_size():
    """Every r in 0..300 and top-k in 1..512: at most 384 threads, at most
    6 passes a group and as few groups as cover the window, and shared
    memory within an H100 block's limit."""
    worst = 0
    for plan in _plans(range(301), range(1, 513)):
        pg, groups = plan.pass_group, plan.pass_groups
        assert 1 <= pg <= MAX_PASS_GROUP
        assert pg * groups >= plan.passes > MAX_PASS_GROUP * (groups - 1)
        assert plan.passes * PASS_DX >= 2 * plan.r + 1
        assert 1 <= plan.key_rows <= 4
        assert plan.threads == 64 * pg * plan.key_rows <= 384
        assert plan.key_cells == TILE_W + PASS_DX * pg
        assert plan.smem_bytes <= SMEM_LIMIT
        worst = max(worst, plan.smem_bytes)
    assert worst == 215040


@pytest.mark.parametrize('c', [8, 256, 260, 1024])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('w', [1, 37, 107, 1024])
def test_smem_and_scratch_at_every_width(c, dtype, w):
    """A staged cell is 128 bytes in either feature type (32 fp32 or 64
    bf16 channels a chunk, the chunks walked in turn) and a key row's
    window is the tile's 32 columns and the group's dx, so a block's bytes
    are the same at every C, feature type and map width; the lists'
    scratch grows with the map and the frames or slots."""
    cell = CELL_BYTES // (2 if dtype == torch.bfloat16 else 4)
    chunks = -(-c // cell)
    assert chunks * cell >= c
    h = 60
    for plan in _plans((0, 11, 31, 39, 47, 48, 150, 300),
                       (1, 10, 32, 33, 48, 512)):
        stage = (plan.key_rows * plan.key_cells + QUERIES) * CELL_BYTES
        slab = QUERIES // 2 * (PASS_DX * plan.pass_group + 4) * 4
        lists = (2 * QUERIES * plan.topk if plan.topk <= KMAX
                 else 3 * QUERIES) * 4
        assert plan.smem_bytes == 2 * stage + slab + lists <= SMEM_LIMIT
        video = plan.video_lists(24, h, w)
        if plan.topk <= KMAX:
            assert video is None and plan.shared_lists
        else:
            assert video == (23, h, w, 2, plan.topk)
        assert plan.local_lists(21, h, w) == (21, h, w, 2, plan.topk)


# (radius, pass_group, key_rows): passes(r) = ceil((2r + 1) / 16) spread
# evenly over the fewest groups of at most 6; key rows as many as keep 384
# threads
GROUPS = [(1.0, 1, 4), (8.0, 1, 4), (12.0, 2, 3), (24.0, 3, 2),
          (32.0, 4, 1), (40.0, 5, 1), (48.0, 6, 1), (49.0, 4, 1),
          (150.0, 5, 1)]


@pytest.mark.parametrize('radius,pg,nkr', GROUPS)
def test_pass_groups(radius, pg, nkr):
    plan = wide_plan(radius, 10)
    assert (plan.pass_group, plan.key_rows) == (pg, nkr)
    assert plan.threads == 64 * pg * nkr


class Recorded:
    """A stand-in for the wide kernel's library: each C entry records its
    arguments and returns 0 (success); a local entry zeroes its sources
    (h*w*topk int64 at ``src``), so that row 4's epilogue, which runs in
    PyTorch, gathers in bounds."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith('vfs_'):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            if name.startswith('vfs_local'):
                h, w, topk = args[10], args[11], args[17]
                ctypes.memset(args[6], 0, h * w * topk * 8)
            return 0

        setattr(self, name, entry)
        return entry


class NotWide(Exception):
    """Raised by the recording ``_build.load`` for a core library."""


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers' wide path on CPU tensors: ``_build.load`` returns a
    ``Recorded`` library for the wide kernel (it would build a .cu) and
    raises ``NotWide`` for any other, the device checks and the CUDA
    device and stream are waived, and ``wide_lists`` records the scratch
    it allocates."""
    lib = Recorded()
    allocated, names = [], []

    def load(name):
        names.append(name)
        if name != window_geometry.WIDE_KERNEL_NAME:
            raise NotWide(name)
        return lib

    def lists(shape, device):
        out = window_geometry.wide_lists(shape, device)
        allocated.append((shape, out))
        return out

    monkeypatch.setattr(_build, 'load', load)
    for module, check in ((video_affinity, 'check_features'),
                          (video_affinity_v1, 'check_features'),
                          (local_attention, 'check_operands'),
                          (local_attention_v2, 'check_operands')):
        monkeypatch.setattr(module, check, lambda *a, **k: None)
    for module in (video_affinity, local_attention):
        monkeypatch.setattr(module, 'wide_lists', lists)
    monkeypatch.setattr(torch.cuda, 'device',
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda: types.SimpleNamespace(cuda_stream=0))
    # the wrappers' launch counters count these recorded launches too:
    # they go back to their values when the test ends, so that a later
    # test in the process finds no launch it did not make
    for fn in (video_affinity.video_topk_affinity_cuda,
               video_affinity.video_topk_affinity_wide_cuda,
               video_affinity_v1.video_topk_affinity_v1_cuda,
               local_attention.local_topk_attend_cuda,
               local_attention.local_topk_attend_wide_cuda,
               local_attention_v2.local_topk_attend_v2_cuda):
        for counter in ('launches', 'wide_launches'):
            if hasattr(fn, counter):
                monkeypatch.setattr(fn, counter, getattr(fn, counter))
    return lib, allocated, names


def _ptr(t):
    return None if t is None else t.data_ptr()


@pytest.mark.parametrize('radius,topk', [(40.0, 10), (12.0, 48),
                                         (33.0, 33), (150.0, 5)])
@pytest.mark.parametrize('row', [1, 2])
def test_video_wrappers_pass_the_plan(recorded, row, radius, topk):
    """Rows 1w/2w: the C entry gets the plan's r, top-k, pass group and
    key rows beside T, the map, C and P, and the list scratch the plan
    asks for (none while the lists fit shared memory)."""
    lib, allocated, _ = recorded
    t_total, h, w, c, p = 5, 4, 6, 8, 3
    feats = torch.zeros(t_total, h, w, c)
    if row == 1:
        video_affinity.video_topk_affinity_cuda(feats, radius, 0.07, topk, p)
        assert video_affinity.video_topk_affinity_cuda.wide_launches
    else:
        video_affinity_v1.video_topk_affinity_v1_cuda(
            feats, radius, 0.07, topk, p, extract='perframe')
    plan = wide_plan(radius, topk)
    [(shape, (list_s, list_o))] = allocated
    assert shape == plan.video_lists(t_total, h, w)
    if list_s is not None:
        assert list_s.shape == list_o.shape == shape
        assert (list_s.dtype, list_o.dtype) == (torch.float32, torch.int32)
    [(name, args)] = lib.calls
    assert name == 'vfs_video_topk_wide'
    assert args[3:5] == (_ptr(list_s), _ptr(list_o))
    assert args[5:10] == (t_total, h, w, c, plan.r)
    assert args[11] == pytest.approx(1 / 0.07)
    assert args[12:16] == (topk, p, plan.pass_group, plan.key_rows)


# (row, mode, C entry): row 3 in each mode, row 4 (selection only)
LOCAL_CALLS = [(3, {}, 'vfs_local_topk_wide'),
               (3, dict(scores='bfloat16'), 'vfs_local_topk_wide_scores_bf16'),
               (3, dict(extract='packed'), 'vfs_local_topk_wide_packed'),
               (4, {}, 'vfs_local_topk_wide')]


@pytest.mark.parametrize('row,mode,entry', LOCAL_CALLS,
                         ids=['row3', 'row3_scores_bf16', 'row3_packed',
                              'row4'])
@pytest.mark.parametrize('radius,topk', [(40.0, 10), (12.0, 48)])
def test_local_wrappers_pass_the_plan(recorded, row, mode, entry, radius,
                                      topk):
    """Rows 3w/4w: the mode's C entry gets the plan's arguments and the
    (F, h, w, 2, topk) list scratch of the slot split; row 4 passes no
    values and no logits (no epilogue)."""
    lib, allocated, _ = recorded
    h, w, c, k, f = 4, 6, 8, 3, 3
    step = (torch.zeros(h, w, c), torch.zeros(f, h, w, c),
            torch.zeros(f, h, w, k), torch.ones(f, dtype=torch.int32))
    if row == 3:
        out = local_attention.local_topk_attend_cuda(*step, radius, 0.07,
                                                     topk, **mode)
        assert out[0].shape == (h, w, k)
    else:
        local_attention_v2.local_topk_attend_v2_cuda(*step, radius, 0.07,
                                                     topk)
    plan = wide_plan(radius, topk)
    [(shape, (list_s, list_o))] = allocated
    assert shape == plan.local_lists(f, h, w) == (f, h, w, 2, topk)
    [(name, args)] = lib.calls
    assert name == entry
    assert (args[2] is None) == (args[4] is None) == (row == 4)
    assert args[7:9] == (list_s.data_ptr(), list_o.data_ptr())
    assert args[9:15] == (f, h, w, c, k, plan.r)
    assert args[16] == pytest.approx(1 / 0.07)
    assert args[17:20] == (topk, plan.pass_group, plan.key_rows)


@pytest.mark.parametrize('row', [1, 2, 3, 4])
def test_core_sizes_keep_the_core(recorded, row):
    """Within the core's limits (r = 31, top-32) each wrapper asks for its
    own library and never reaches the wide entries."""
    lib, allocated, names = recorded
    h, w, c = 4, 5, 8
    step = (torch.zeros(h, w, c), torch.zeros(2, h, w, c),
            torch.zeros(2, h, w, 4), torch.ones(2, dtype=torch.int32))
    with pytest.raises(NotWide):
        if row == 1:
            video_affinity.video_topk_affinity_cuda(
                torch.zeros(3, h, w, c), 32.0, 0.07, KMAX, 2)
        elif row == 2:
            video_affinity_v1.video_topk_affinity_v1_cuda(
                torch.zeros(3, h, w, c), 32.0, 0.07, KMAX, 2)
        elif row == 3:
            local_attention.local_topk_attend_cuda(*step, 32.0, 0.07, KMAX)
        else:
            local_attention_v2.local_topk_attend_v2_cuda(*step, 32.0, 0.07,
                                                         KMAX)
    assert lib.calls == [] and allocated == []
    assert names and window_geometry.WIDE_KERNEL_NAME not in names


def test_band_never_widens():
    """The kernel takes a key row's widest band over a row range from the
    nearest row: the band must not widen with |dy|."""
    for r in range(0, 301, 7):
        band = np.array(circle_band(r + 0.5))
        assert (np.diff(band) <= 0).all() and band[0] == r
