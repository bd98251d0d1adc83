"""The port's learning loop (``vfs_tpu_torch/tools/learning_loop.py``)
against ``tools/learning_loop.py``: the synthetic world's files equal the
JAX tool's byte for byte for seed 0; ``eval_jf`` and ``eval_retrieval``
of both packages agree on one fabricated torchvision-layout ``.pth``; and
the pretrain -> ``.pth`` -> eval circle runs for one epoch on the CPU, as
``tests/test_learning_loop.py`` runs the JAX tool.

Tolerances: the two backbones sum their convolutions in other orders
(features within ~1e-5), so a near tie at the k-th place may move one
propagated pixel: J&F within 1e-3. Retrieval takes an argmax of cosine
similarities over ~350 cells: a near tie may flip one of ~1000 matches,
so within 2e-3. (Measured: J&F and retrieval equal on two fabricated
weight sets.)
"""

import filecmp
import os
import os.path as osp
import sys

import numpy as np
import pytest
import torch

from vfs_tpu_torch.tools import learning_loop as port_loop

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..',
                            'tools'))
import learning_loop as jax_loop  # noqa: E402  (tools/ is not a package)

torch.set_num_threads(1)

SMALL_WORLD = dict(n_train=3, n_val=2, train_frames=8, val_frames=6)


def _tree(root):
    out = []
    for d, _, files in os.walk(root):
        out += [osp.relpath(osp.join(d, f), root) for f in files]
    return sorted(out)


def test_synthetic_world_matches_jax_byte_for_byte(tmp_path):
    roots = [str(tmp_path / 'port'), str(tmp_path / 'jax')]
    outs = [port_loop.make_synthetic_world(roots[0], seed=0),
            jax_loop.make_synthetic_world(roots[1], seed=0)]
    assert [osp.relpath(p, r) for p in outs[0] for r in roots[:1]] == \
        [osp.relpath(p, r) for p in outs[1] for r in roots[1:]]
    files = _tree(roots[0])
    assert files == _tree(roots[1])
    assert len(files) == 2 + 24 * 16 + 12 * 12 * 2
    match, mismatch, errors = filecmp.cmpfiles(roots[0], roots[1], files,
                                               shallow=False)
    assert not mismatch and not errors and len(match) == len(files)


@pytest.fixture(scope='module')
def small_world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('ll_world'))
    return root, port_loop.make_synthetic_world(root, seed=0, **SMALL_WORLD)


def test_eval_jf_and_retrieval_match_jax(small_world, tmp_path):
    """One fabricated torchvision-layout r18 (seeded random weights with
    randomised BatchNorm statistics) through both packages' eval."""
    root, (_, val_ann, img_root, ann_root) = small_world
    model = port_loop.build_tracker(seed=3)
    rs = np.random.RandomState(3)
    sd = {k: v.clone() for k, v in model.backbone.state_dict().items()
          if not k.endswith('num_batches_tracked')}
    for k, v in sd.items():
        if k.endswith('running_mean'):
            sd[k] = torch.as_tensor(rs.randn(*v.shape) * 0.1,
                                    dtype=torch.float32)
        elif k.endswith('running_var'):
            sd[k] = torch.as_tensor(rs.uniform(0.5, 2.0, v.shape),
                                    dtype=torch.float32)
    pth = str(tmp_path / 'fabricated_tv.pth')
    torch.save(sd, pth)

    port = port_loop.build_tracker(pth)
    ref = jax_loop.build_tracker(pth)
    jf = port_loop.eval_jf(port, root, val_ann, img_root, ann_root, 'cpu')
    jax_jf = jax_loop.eval_jf(ref, root, val_ann, img_root, ann_root)
    assert 0.0 <= jf <= 1.0
    assert jf == pytest.approx(jax_jf, abs=1e-3)
    retr = port_loop.eval_retrieval(port, img_root, ann_root, 'cpu')
    jax_retr = jax_loop.eval_retrieval(ref, img_root, ann_root)
    assert 0.0 < retr <= 1.0
    assert retr == pytest.approx(jax_retr, abs=2e-3)


def test_learning_loop_plumbing(small_world, tmp_path):
    """Pretrain one epoch on the CPU (one step of 8 samples at 64x64
    crops), write the ``.pth``, load it into the eval tracker, score."""
    root, (train_ann, val_ann, img_root, ann_root) = small_world
    pth = port_loop.pretrain(str(tmp_path / 'work'), train_ann,
                             total_epochs=1, repeat=3, batch=8, seed=0,
                             device='cpu')
    sd = torch.load(pth, map_location='cpu', weights_only=True)
    assert 'conv1.weight' in sd and 'layer4.1.bn2.running_var' in sd
    assert not any(k.endswith('num_batches_tracked') for k in sd)
    random_sd = port_loop.build_tracker(seed=0).backbone.state_dict()
    assert not torch.equal(sd['conv1.weight'], random_sd['conv1.weight'])
    model = port_loop.build_tracker(pth)
    assert torch.equal(model.backbone.state_dict()['conv1.weight'],
                       sd['conv1.weight'])
    jf = port_loop.eval_jf(model, root, val_ann, img_root, ann_root, 'cpu')
    retr = port_loop.eval_retrieval(model, img_root, ann_root, 'cpu')
    assert np.isfinite(jf) and 0.0 <= jf <= 1.0
    assert 0.0 <= retr <= 1.0
