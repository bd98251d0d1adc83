"""On the card, at each cell's own size: each control (the reference in
TF32 in the program's place; for the eval also with only row 1's scores
in TF32) fails a compared number, and the program's own readings pass.
The limits were set from these readings over many seeds
(``control.py``); this keeps one seed of each. Skips without a CUDA
device."""

import pytest

from portbench.harness import spec
from test_spec import bench

CELLS = ('davis_r50_all_blocks', 'pretrain_r18', 'pretrain_r18_deviceaug')
CONTROLS = tuple((c, 'control') for c in CELLS) + (
    ('davis_r50_all_blocks', 'control_row1'),)
SEED = 4_000_000_019


@pytest.mark.card
@pytest.mark.parametrize('cell,control', CONTROLS)
def test_control_fails(card, cell, control):
    c = spec.find_cell(bench(), cell)
    checks, _ = spec.driver(c.config).readings(c, SEED, card, control)
    assert not all(x.ok for x in checks), checks


@pytest.mark.card
@pytest.mark.parametrize('cell', CELLS)
def test_program_passes(card, cell):
    c = spec.find_cell(bench(), cell)
    checks, _ = spec.driver(c.config).readings(c, SEED, card, 'program')
    assert all(x.ok for x in checks), checks
