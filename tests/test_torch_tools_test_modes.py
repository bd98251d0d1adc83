"""``python -m vfs_tpu_torch.tools.test --device cpu`` with the scan
kernel's inexact modes (``--options test_cfg.pallas_extract=packed``,
``test_cfg.pallas_scores=bfloat16``) against the JAX package's eval chain
on the mini-DAVIS fixture.

The fixture, config and weights are ``test_torch_tools_test``'s
(``backend='pallas'``, ``precede_frames=3``, top-10, 64x96 frames). The
JAX side runs the chain ``tools/test.py`` runs with ``backend='pallas'``
and the same option; its tracker does not map ``pallas_interpret`` from
``test_cfg``, so the test wraps its ``make_propagation_config`` to set it
and the TPU kernel runs in Pallas interpret mode, as the JAX package's
own tests run it on the CPU. Every query keeps >= k valid keys: frame 0's
slot alone holds >= 61 in-map keys (neighbor_range 24, the smallest
corner circle on the 8x12 feature map) against top-10.

Masks must be equal and J&F equal to 4 decimals, unless the
rounding-flip rule of ``test_torch_local_attention_modes`` explains a
difference: then both packages propagate the port's own features, and
the first frame whose logits differ must differ only at cells whose
selection lies at a rounding boundary (``_near_boundary``); the masks
must be equal before that frame. With the fixture's seed-0 weights the
packed run meets one such cell (video 1, frame 6: one mask pixel, J&F
0.6545 against 0.6550); bf16 scores none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfs_tpu.apis import single_process_test as jax_single_process_test
from vfs_tpu.datasets import build_dataset as jax_build_dataset
from vfs_tpu.models import build_model as jax_build_model
from vfs_tpu.models.trackers import vanilla_tracker as jax_tracker
from vfs_tpu.ops import propagation as jax_prop
from vfs_tpu.utils import Config as JaxConfig
from vfs_tpu_torch.models.trackers import vanilla_tracker as torch_tracker
from vfs_tpu_torch.tools import test as tools_test

from test_torch_local_attention_modes import _near_boundary, _valid_keys
from test_torch_tools_test import eval_setup  # noqa: F401  (fixture)

torch.set_num_threads(1)


def _jax_eval(config, ckpt, option, monkeypatch):
    make = jax_tracker.make_propagation_config

    def interpret(test_cfg, h, w):
        cfg, mask = make(test_cfg, h, w)
        return cfg._replace(pallas_interpret=True), mask

    monkeypatch.setattr(jax_tracker, 'make_propagation_config', interpret)
    cfg = JaxConfig.fromfile(config)
    cfg.merge_from_dict({'test_cfg.backend': 'pallas', **option})
    dataset = jax_build_dataset(cfg.data.test, dict(test_mode=True))
    model_cfg = dict(type='VanillaTracker', backbone=dict(cfg.model.backbone))
    model_cfg['backbone']['pretrained'] = ckpt
    model = jax_build_model(model_cfg, test_cfg=cfg.test_cfg)
    model.init_weights()
    results = jax_single_process_test(model, dataset, progress=False,
                                      prefetch=False)
    return results, dataset.evaluate(results, metrics=['davis'])


def _first_flip(feats, seg_first, cfg, out, mode):
    """The first frame at which JAX's scan, run on the port's features,
    gives other logits than the port's ``out``; asserts that the rule
    explains each of its cells. None where every frame agrees."""
    ref = np.asarray(jax_prop.propagate_video(
        jnp.asarray(feats.numpy()), jnp.asarray(seg_first.numpy()), None,
        jax_prop.PropagationConfig(**dict(cfg._asdict(),
                                          pallas_interpret=True))))
    bad = ~np.isclose(out.numpy(), ref, rtol=1e-4, atol=1e-5).all(-1)
    if not bad.any():
        return None
    t = int(np.argwhere(bad)[0, 0])
    f = torch.nn.functional.normalize(feats, dim=-1).numpy()
    live = [0] + list(range(max(1, t - cfg.precede_frames), t))
    near = _near_boundary(f[t], f[live], [1] * len(live),
                          cfg.neighbor_range // 2, cfg.topk, **mode)
    assert near[bad[t]].all(), np.argwhere(bad[t] & ~near)
    return t


@pytest.mark.parametrize('key,value', [('pallas_extract', 'packed'),
                                       ('pallas_scores', 'bfloat16')])
def test_tools_test_mode_matches_jax_chain(eval_setup, key,  # noqa: F811
                                           value, monkeypatch):
    config, ckpt, tmp = eval_setup
    assert (_valid_keys(8, 12, 12, [1]) >= 10).all()
    runs = []
    propagate = torch_tracker.propagate_video

    def record(feats, seg_first, mask, cfg):
        out = propagate(feats, seg_first, mask, cfg)
        runs.append((feats, seg_first, cfg, out))
        return out

    monkeypatch.setattr(torch_tracker, 'propagate_video', record)
    out_npz = str(tmp / f'{key}.npz')
    got = tools_test.main([config, ckpt, '--eval', 'davis', '--device',
                           'cpu', '--out', out_npz, '--options',
                           'test_cfg.topk=10', f'test_cfg.{key}={value}'])
    ref_results, ref = _jax_eval(config, ckpt, {f'test_cfg.{key}': value},
                                 monkeypatch)
    with np.load(out_npz) as saved:
        masks = [saved[k] for k in sorted(saved.files,
                                          key=lambda n: int(n[4:]))]
    assert len(masks) == len(ref_results) == len(runs) == 2
    mode = {'pallas_extract': 'extract', 'pallas_scores': 'scores'}[key]
    flips = 0
    for a, b, run in zip(masks, ref_results, runs):
        b = np.asarray(b)
        assert a.shape == (8, 64, 96) and a.dtype == np.uint8
        if np.array_equal(a, b):
            continue
        t = _first_flip(*run, {mode: value})
        assert t is not None, 'masks differ, logits on one input do not'
        np.testing.assert_array_equal(a[:t], b[:t])
        flips += 1
    assert set(got) == set(ref)
    if not flips:
        for name in ref:
            assert round(got[name], 4) == round(ref[name], 4), name
