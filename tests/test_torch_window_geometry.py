"""Host-side geometry of the windowed top-k kernels (rows 1 to 4): the
circle band, the launch plan and the pass rule, on the CPU."""

import numpy as np
import pytest
import torch

from vfs_tpu_torch.ops import _build
from vfs_tpu_torch.ops.local_attention import local_topk_attend_cuda
from vfs_tpu_torch.ops.local_attention_v2 import local_topk_attend_v2_cuda
from vfs_tpu_torch.ops.video_affinity import (circle_offsets,
                                              video_topk_affinity_cuda)
from vfs_tpu_torch.ops.video_affinity_v1 import video_topk_affinity_v1_cuda
from vfs_tpu_torch.ops.window_geometry import (KMAX, MAX_OFFSET, PASS_DX,
                                               circle_band, core_takes,
                                               pair_counts, pass_starts,
                                               plan_args, window_plan)

torch.set_num_threads(1)

RADII = [3.0, 5.0, 12.0, 18.0, 18.5, 32.0]


@pytest.mark.parametrize('radius', RADII)
def test_band_equals_circle_offsets(radius):
    """|dx| <= band[|dy|] selects exactly circle_offsets' offsets, in its
    row-major order (3.0 and 5.0 have offsets exactly on the circle)."""
    r, dy, dx = circle_offsets(radius)
    band = circle_band(radius)
    assert len(band) == r + 1
    d = np.arange(-r, r + 1)
    want = [(a, b) for a in d for b in d if abs(b) <= band[abs(a)]]
    assert want == list(zip(dy.tolist(), dx.tolist()))


@pytest.mark.parametrize('radius', RADII)
def test_passes_cover_each_row_band(radius):
    """For every key row and group of 4 query rows, the passes that run
    cover every valid dx of every row of the group, and a pass that runs
    holds at least one valid dx."""
    plan = window_plan(radius, 10)
    r, band = plan.r, plan.band
    assert plan.passes * PASS_DX >= 2 * r + 1
    for top in range(-r - 4, r + 1):  # dy of the group's first row
        dys = [top + m for m in range(4) if abs(top + m) <= r]
        e = max((band[abs(dy)] for dy in dys), default=-1)
        starts = pass_starts(plan, e)
        covered = {s + i for s in starts for i in range(PASS_DX)}
        for dy in dys:
            assert set(range(-band[abs(dy)], band[abs(dy)] + 1)) <= covered
        for s in starts:
            assert any(-e <= s + i <= e for i in range(PASS_DX))
            assert (s + plan.r) % 4 == 0  # a swizzle group of 4 cells
        assert len(starts) <= plan.passes


@pytest.mark.parametrize('radius', RADII + [16.0, 24.0])
@pytest.mark.parametrize('topk', [1, 10, 32])
def test_plan_fits_the_card(radius, topk):
    """The plan is one the CUDA core takes (its check_band): r fits the
    core's 32-entry band table, the band starts at r and never widens, and
    the C interface gets r and the band as given. The core derives the
    launch (passes, threads, shared memory) from r; chip_smoke.py launches
    it at its largest, r = 31 and top-32. The plan is cached: the scan
    tier asks for it once per step."""
    plan = window_plan(radius, topk)
    assert 0 <= plan.r <= MAX_OFFSET and len(plan.band) == plan.r + 1
    assert plan.band[0] == plan.r
    assert all(0 <= b <= a for a, b in zip(plan.band, plan.band[1:]))
    assert ((plan.passes - 1) * PASS_DX < 2 * plan.r + 1
            <= plan.passes * PASS_DX)
    r, band = plan_args(plan)
    assert r == plan.r and list(band) == list(plan.band)
    assert window_plan(radius, topk) is plan


@pytest.mark.parametrize('h,w,radius', [(3, 5, 3.0), (13, 45, 5.0),
                                        (10, 37, 12.0), (9, 40, 18.0)])
def test_pair_counts(h, w, radius):
    """Pairs needed: the circle's offsets that land in the map, counted
    by brute force; pairs computed: whole passes, at least as many."""
    _, dy, dx = circle_offsets(radius)
    ys, xs = np.arange(h)[:, None, None], np.arange(w)[None, :, None]
    ky, kx = ys + dy.numpy(), xs + dx.numpy()
    want = int(((ky >= 0) & (ky < h) & (kx >= 0) & (kx < w)).sum())
    needed, computed = pair_counts(h, w, radius)
    assert needed == want
    assert computed >= needed and computed % (4 * 32 * PASS_DX) == 0


def _no_build(name):
    raise AssertionError(f'{name} was built before the arguments were '
                         'checked')


@pytest.mark.parametrize('kind', ['radius', 'topk'])
@pytest.mark.parametrize('row', [1, 2, 3, 4])
def test_wrappers_reject_before_launch(monkeypatch, kind, row):
    """What no kernel takes, a radius <= 0 (r < 0) or a topk < 1, raises
    ValueError before any build or launch, whatever device the tensors
    are on. r > 31 and topk > 32, which the core does not take, are no
    longer refused: the wide kernel takes them
    (``tests/test_torch_wide_window.py`` shows the wrappers choose it)."""
    monkeypatch.setattr(_build, 'load', _no_build)
    radius, topk = (0.0, 10) if kind == 'radius' else (5.0, 0)
    assert not core_takes(radius, topk)
    assert core_takes(MAX_OFFSET + 1.0, KMAX)
    h, w, c = 4, 5, 8
    feats = torch.zeros(3, h, w, c)
    step = (torch.zeros(h, w, c), torch.zeros(2, h, w, c),
            torch.zeros(2, h, w, 4), torch.ones(2, dtype=torch.int32))
    with pytest.raises(ValueError, match=kind):
        if row == 1:
            video_topk_affinity_cuda(feats, radius, 0.07, topk, 2)
        elif row == 2:
            video_topk_affinity_v1_cuda(feats, radius, 0.07, topk, 2,
                                        extract='perframe')
        elif row == 3:
            local_topk_attend_cuda(*step, radius, 0.07, topk)
        else:
            local_topk_attend_v2_cuda(*step, radius, 0.07, topk)


@pytest.mark.parametrize('radius', [31.9, 32.0])
def test_largest_radius_is_planned(radius):
    assert window_plan(radius, 32).r == MAX_OFFSET
