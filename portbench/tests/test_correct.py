"""What decides ``correct``: the plain reference agrees with the program
at tiny sizes on the CPU, and a run whose timed path is broken comes out
not correct, once for each fault a cell can have (one card: no exchange
between chips to leave out)."""

import numpy as np
import pytest
import torch

from helpers import run_cell
from portbench.harness import spec

TRAIN_CELLS = ('tiny_train', 'tiny_train_u8')


@pytest.mark.parametrize('cell', ('tiny_davis',) + TRAIN_CELLS)
def test_reference_agrees_with_the_program(tiny_bench, cell):
    rc, line = run_cell(tiny_bench, cell, seed=2**31 + 5)
    assert rc == 0 and line['correct'], line


@pytest.mark.parametrize('cell', TRAIN_CELLS)
def test_program_readings_within_limits(tiny_bench, cell):
    b = spec.load_json(spec.bench_file(tiny_bench))
    c = spec.find_cell(b, cell, tiny_bench)
    checks, _ = spec.driver(c.config, tiny_bench).readings(c, 23, 'cpu',
                                                           'program')
    assert all(x.ok for x in checks), checks


def _state_unchanged(step, model, optimizer):
    optimizer.step = lambda: None
    return step


def _half_batch(step, model, optimizer):
    def half(imgs, orig_hw=None, labels=None):
        n = imgs.shape[0] // 2
        return step(imgs[:n], None if orig_hw is None else orig_hw[:n])
    return half


@pytest.mark.parametrize('cell', TRAIN_CELLS)
@pytest.mark.parametrize('fault', (_state_unchanged, _half_batch),
                         ids=('state_unchanged', 'half_batch'))
def test_train_fault_is_not_correct(tiny_bench, cell, fault):
    rc, line = run_cell(tiny_bench, cell, tamper=fault)
    assert rc == 0 and line['correct'] is False, line['checks']


def _altered_answer(model):
    produce = model.forward_test

    def altered(*args, **kwargs):
        out = produce(*args, **kwargs)
        for r in out:
            r[:, 1:, :8, :8] = (np.asarray(r[:, 1:, :8, :8]) + 1) % 3
        return out
    model.forward_test = altered


def test_eval_altered_answer_is_not_correct(tiny_bench):
    rc, line = run_cell(tiny_bench, 'tiny_davis', tamper=_altered_answer)
    assert rc == 0 and line['correct'] is False, line['checks']


def test_reference_loss_matches_the_programs_model():
    """The reference SimSiam and the program's model give one loss on the
    same weights and batch (train-mode BatchNorm, intra-video pairs)."""
    from portbench.harness import weights
    from portbench.reference import simsiam
    from vfs_tpu_torch.models import build_model
    from vfs_tpu_torch.models.trackers.sim_siam_tracker import parse_losses
    from test_spec import bench
    cfg = spec.find_cell(bench(), 'pretrain_r18').config
    ref = simsiam.SimSiam(cfg['model'], True)
    state = weights.seeded_state(ref, cfg['weights'], 3, 'cpu')
    ref.load_state_dict(state)
    prog = build_model(dict(cfg['model']), train_cfg=dict(cfg['train_cfg']))
    prog.load_state_dict(state)
    ref.train()
    prog.train()
    x = torch.randn(2, 2, 3, 64, 64, 3, generator=torch.Generator()
                    .manual_seed(0))
    total, _ = parse_losses(prog(x))
    assert torch.allclose(ref(x), total, rtol=1e-6, atol=1e-6)


def test_eval_row1_in_bf16_is_not_correct(tiny_bench, monkeypatch):
    """Row 1 scoring bf16-rounded features, the rest of the run as it is:
    the scores' check fails where the features' and the masks' pass."""
    from vfs_tpu_torch.ops import propagation as program_propagation
    topk = program_propagation.video_topk_affinity

    def lowered(feats, *args, **kwargs):
        return topk(feats.to(torch.bfloat16).float(), *args, **kwargs)
    monkeypatch.setattr(program_propagation, 'video_topk_affinity', lowered)
    rc, line = run_cell(tiny_bench, 'tiny_davis')
    assert rc == 0 and line['correct'] is False, line['checks']
    assert line['checks']['feature_gap']['value'] \
        <= line['checks']['feature_gap']['limit']
    assert line['checks']['topk_score_gap']['value'] \
        > line['checks']['topk_score_gap']['limit']
