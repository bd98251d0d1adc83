"""The frozen operation counts and the table of peaks."""

import itertools

import numpy as np
import pytest

from portbench.harness import card, flops
from portbench.reference import simsiam
from test_spec import bench
from portbench.harness import spec


def test_r18_step_is_2_727_tflop():
    cfg = spec.find_cell(bench(), 'pretrain_r18').config
    model = simsiam.SimSiam(cfg['model'], True)
    step = flops.train_flops(model, (224, 224), 32 * 2 * 4)
    assert round(step / 1e12, 3) == 2.727


def test_row1_count_by_hand():
    t_total, h, w, c, radius, topk, p = 6, 5, 7, 8, 2.5, 3, 2
    pairs = 0
    for t in range(1, t_total):
        # frame 0 and the p frames before t, distinct
        frames = {0} | set(range(max(0, t - p), t))
        for (y, x, ky, kx) in itertools.product(range(h), range(w),
                                                 range(h), range(w)):
            if (ky - y) ** 2 + (kx - x) ** 2 < radius ** 2:
                pairs += len(frames)
    work = flops.row1_work(t_total, h, w, c, radius, topk, p)
    assert work['flops'] == 2 * c * pairs
    assert work['bytes'] == 4 * t_total * h * w * c \
        + 12 * (t_total - 1) * h * w * topk


def test_roofline_takes_the_larger_bound():
    assert flops.roofline_seconds(dict(flops=2e12, bytes=1e9), 1e12,
                                  1e12) == 2.0
    assert flops.roofline_seconds(dict(flops=1e9, bytes=3e12), 1e12,
                                  1e12) == 3.0


def test_peaks_refuse_an_unknown_card():
    assert card.peaks('NVIDIA H100 80GB HBM3').fp32_flops == 67e12
    assert card.peaks('NVIDIA H100 PCIe').fp32_flops == 51e12
    with pytest.raises(card.UnknownCard):
        card.peaks('NVIDIA A100-SXM4-80GB')


def test_window_pairs_match_offsets():
    dy, dx = flops.circle_offsets(18.0)
    assert len(dy) == int(np.sum((np.arange(-17, 18)[:, None] ** 2
                                  + np.arange(-17, 18)[None] ** 2)
                                 < 18 ** 2))
