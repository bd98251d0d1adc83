"""The port's SiamFC tracker, OTB harness and CLI
(``projects/siamfc/siamfc_tpu_torch``, ``train_siamfc_torch.py``) against
the JAX package's (``siamfc_tpu``) with the same weights, carried by
``flax_siamfc_to_torch``.

Shapes are small: ``exemplar_sz`` 32 and ``instance_sz`` 64 (the default
config's 120 / 255 runs on the card only) on ``test_siamfc.py``'s OTB
fixtures, the moving square and three sequences of 12, 9 and 7 frames, in
one 120x160 dataset. Boxes must agree within 0.01 px, with device crops
on and off, sequentially, batched and over two CPU workers.
"""

import os.path as osp
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, osp.join(osp.dirname(__file__), '../projects/siamfc'))
sys.path.insert(0, osp.dirname(__file__))

import siamfc_tpu as J  # noqa: E402
import siamfc_tpu_torch as P  # noqa: E402
from test_models.test_siamfc import (make_otb_fixture,  # noqa: E402
                                     make_otb_multi_fixture)
from test_torch_siamfc import (jax_tracker, jax_variables,  # noqa: E402
                               make_got10k, port_tracker, small_cfg)

import train_siamfc_torch  # noqa: E402

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIG = osp.join(ROOT, 'configs', 'r18_nc_sgd_cos_100e_r2_1xNx8_k400.py')
ATOL = 0.01


@pytest.fixture(scope='module')
def otb(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('otb'))
    make_otb_fixture(root)
    make_otb_multi_fixture(root)
    return root


def seqs_of(root):
    exp = J.ExperimentOTB(root)
    return [J.otb._load_otb_seq(d) for d in exp.seq_dirs]


@pytest.fixture(scope='module')
def runs(otb, tmp_path_factory):
    """The JAX and the port tracker with the same seeded weights, each
    run sequentially through its ``ExperimentOTB`` with device crops on
    and off: {(package, device_crops): {seq name: boxes}}."""
    cfg = small_cfg()
    v = jax_variables(cfg, 2)
    trackers = dict(jax=(jax_tracker(dict(cfg), v), J.ExperimentOTB),
                    port=(port_tracker(dict(cfg), v), P.ExperimentOTB))
    out = {}
    for name, (tracker, exp_cls) in trackers.items():
        for dev in (True, False):
            tracker.cfg['device_crops'] = dev
            work = tmp_path_factory.mktemp(f'{name}{int(dev)}')
            exp = exp_cls(otb, result_dir=str(work / 'res'),
                          report_dir=str(work / 'rep'))
            res = exp.run(tracker)
            out[name, dev] = {k: b for k, (b, _) in res.items()}
            if dev:
                out[name, 'report'] = exp.report(res)
        tracker.cfg['device_crops'] = True
    out['cfg'], out['variables'] = cfg, v
    out['port'] = trackers['port'][0]
    return out


@pytest.mark.parametrize('device_crops', [True, False])
def test_boxes_match_jax(runs, device_crops):
    jax_boxes, port_boxes = runs['jax', device_crops], runs['port',
                                                             device_crops]
    assert sorted(port_boxes) == ['Seq0', 'Seq1', 'Seq2', 'Square']
    for name, boxes in jax_boxes.items():
        assert port_boxes[name].shape == boxes.shape
        assert np.isfinite(port_boxes[name]).all()
        np.testing.assert_allclose(port_boxes[name], boxes, atol=ATOL,
                                   rtol=0, err_msg=name)


def test_device_crops_match_host_crops(runs):
    """The two crop modes of the port agree on this fixture as the JAX
    package's do (bit-equal crops on downscale; peaks equal)."""
    for name, boxes in runs['port', False].items():
        np.testing.assert_allclose(runs['port', True][name], boxes,
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize('device_crops', [True, False])
def test_track_batch_matches_sequential(runs, otb, device_crops):
    """Three sequences a call over four (longest first; the last chunk
    holds one) give the sequential boxes, in the input order."""
    tracker = runs['port']
    tracker.cfg['device_crops'] = device_crops
    try:
        seqs = seqs_of(otb)
        results = tracker.track_batch([(f, a[0]) for f, a in seqs],
                                      batch_size=3)
    finally:
        tracker.cfg['device_crops'] = True
    names = J.ExperimentOTB(otb).seq_names
    for name, (boxes, times) in zip(names, results):
        assert times.shape == (len(boxes),)
        np.testing.assert_allclose(boxes, runs['port', device_crops][name],
                                   atol=ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize('batch_size', [None, 2])
def test_experiment_over_two_workers_matches_single(runs, otb, tmp_path,
                                                    batch_size):
    """``run(devices=['cpu', 'cpu'])``: a clone and a thread a device,
    sequential (``batch_size`` None) or two ``track_batch`` streams of 2;
    the boxes equal the single sequential run's, results are written and
    the report reads them."""
    exp = P.ExperimentOTB(otb, result_dir=str(tmp_path / 'res'),
                          report_dir=str(tmp_path / 'rep'))
    got = exp.run(runs['port'], devices=['cpu', 'cpu'],
                  batch_size=batch_size)
    assert sorted(got) == sorted(runs['port', True])
    for name, (boxes, _) in got.items():
        np.testing.assert_allclose(boxes, runs['port', True][name],
                                   atol=ATOL, rtol=0, err_msg=name)
    assert osp.isfile(tmp_path / 'res' / 'Seq1.txt')
    assert exp.report(got)['precision_score'] == pytest.approx(
        runs['port', 'report']['precision_score'])


def test_init_weights_independent_of_the_layout():
    """The seeded draw is the same whatever layout the parameters had
    (on CUDA the backbone sits channels_last), and a tracker's weights are
    the same whether its backbone came from the draw or from a ``.pth``
    of it."""
    cfg = small_cfg()
    plain = P.TrackerSiamFC(cfg, device='cpu')
    plain.init_weights(generator=torch.Generator().manual_seed(5))
    nhwc = P.TrackerSiamFC(cfg, device='cpu')
    nhwc.net.to(memory_format=torch.channels_last)
    nhwc.init_weights(generator=torch.Generator().manual_seed(5))
    for (name, a), b in zip(plain.net.state_dict().items(),
                            nhwc.net.state_dict().values()):
        assert torch.equal(a, b), name
    w = plain.net.backbone.layer4[0].conv1.weight
    assert not torch.equal(w, P.TrackerSiamFC(cfg, device='cpu').net
                           .backbone.layer4[0].conv1.weight)


def test_clone_shares_weights_on_its_device(runs):
    tracker = runs['port']
    twin = tracker.clone('cpu')
    assert twin.net is tracker.net and twin.device == torch.device('cpu')
    assert not hasattr(twin, '_state')


def test_cli_on_cpu_matches_jax(runs, otb, tmp_path, capsys):
    """``train_siamfc_torch.py --device cpu`` with a checkpoint of the JAX
    weights writes ``performance.json`` with the precision and success
    the JAX package's OTB sequence (tracker, ``ExperimentOTB.run``,
    ``report``: what ``train_siamfc.py`` runs) gives on the same fixture
    and weights."""
    from vfs_tpu_torch.checkpoint import save_checkpoint
    ckpt = save_checkpoint(str(tmp_path / 'ckpt'), 3, dict(
        model=P.flax_siamfc_to_torch(runs['variables'])))
    work = tmp_path / 'work'
    report = train_siamfc_torch.main([
        CONFIG, '--checkpoint', ckpt, '--otb-root', otb, '--work-dir',
        str(work), '--device', 'cpu', '--track-batch', '2',
        '--options', 'exemplar_sz=32', 'instance_sz=64'])
    want = runs['jax', 'report']
    assert osp.isfile(work / 'reports' / 'performance.json')
    for key in ('precision_score', 'success_score'):
        assert report[key] == pytest.approx(want[key], abs=1e-12), key
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"precision: {want['precision_score']:.4f} "
                           f"success: {want['success_score']:.4f} speed: ")


def test_cli_linear_probe_trains_the_head_only(tmp_path, monkeypatch):
    """``--pretrained`` + ``--got10k-root``: two epochs of one step on a
    GOT-10k-layout set (batch 2, one loader thread); every loss finite,
    ``epoch_1`` and ``epoch_2`` written, the backbone still the
    ``.pth``'s, the head moved; ``--checkpoint epoch_2`` restores it."""
    from vfs_tpu_torch.checkpoint import restore_checkpoint
    from vfs_tpu_torch.models.backbones import ResNet
    make_got10k(str(tmp_path / 'got'))
    cfg = small_cfg()
    backbone = ResNet(**{k: v for k, v in cfg['model']['backbone'].items()
                         if k != 'type'})
    backbone.init_weights(torch.Generator().manual_seed(3))
    pth = str(tmp_path / 'r18.pth')
    torch.save(backbone.state_dict(), pth)
    losses = []
    step = P.TrackerSiamFC.probe_step

    def record(self, *args):
        losses.append(float(step(self, *args)))
        return losses[-1]
    monkeypatch.setattr(P.TrackerSiamFC, 'probe_step', record)
    work = tmp_path / 'work'
    argv = [CONFIG, '--pretrained', pth, '--got10k-root',
            str(tmp_path / 'got'), '--otb-root', str(tmp_path / 'none'),
            '--work-dir', str(work), '--device', 'cpu', '--options',
            'exemplar_sz=32', 'instance_sz=64', 'batch_size=2',
            'num_workers=1', 'epoch_num=2']
    assert train_siamfc_torch.main(argv) is None
    assert len(losses) == 2 and np.isfinite(losses).all()
    ckpt = restore_checkpoint(str(work / 'checkpoints' / 'epoch_2'))
    assert osp.isfile(work / 'checkpoints' / 'epoch_1')
    assert ckpt['epoch'] == 2 and ckpt['step'] == 2
    init = P.TrackerSiamFC(ckpt_cfg(argv), device='cpu')
    init.init_weights(pretrained=pth)
    for name, value in init.net.state_dict().items():
        same = torch.equal(ckpt['model'][name], value)
        assert same == (not name.startswith('head.')), name
    i = argv.index('--pretrained')
    argv[i:i + 2] = ['--checkpoint', str(work / 'checkpoints' / 'epoch_2')]
    restored = train_siamfc_torch.build_tracker(
        train_siamfc_torch.parse_args(argv))
    for name, value in restored.net.state_dict().items():
        assert torch.equal(ckpt['model'][name], value), name


def ckpt_cfg(argv):
    return train_siamfc_torch.build_cfg(train_siamfc_torch.parse_args(argv))


def test_cli_config_depth_and_options():
    """The VFS config's depth decides the head width: r50 takes 2048
    channels and out_scale 1e-5; ``--options`` override the defaults."""
    r50 = osp.join(ROOT, 'configs', 'r50_nc_sgd_cos_100e_r5_1xNx2_k400.py')
    cfg = train_siamfc_torch.build_cfg(train_siamfc_torch.parse_args(
        [r50, '--options', 'scale_num=5', 'device_crops=False']))
    assert cfg['model']['backbone']['depth'] == 50
    assert (cfg['out_channels'], cfg['out_scale']) == (2048, 1e-5)
    assert cfg['scale_num'] == 5 and cfg['device_crops'] is False
    cfg18 = train_siamfc_torch.build_cfg(train_siamfc_torch.parse_args(
        [CONFIG]))
    assert (cfg18['out_channels'], cfg18['out_scale']) == (512, 0.001)
    assert P.default_cfg['out_channels'] == 512


def test_jax_weights_round_trip_into_the_net():
    """Every key of the port's ``Net`` comes from the JAX tree, kernels in
    OIHW; BatchNorm counters aside."""
    cfg = small_cfg()
    v = jax_variables(cfg, 4)
    sd = P.flax_siamfc_to_torch(jax.device_get(v))
    own = P.TrackerSiamFC(cfg, device='cpu').net.state_dict()
    assert sorted(k for k in own if not k.endswith('num_batches_tracked')) \
        == sorted(sd)
    np.testing.assert_array_equal(
        sd['head.z_conv0.weight'].numpy(),
        np.transpose(v['head']['params']['z_conv0']['kernel'], (3, 2, 0, 1)))
    np.testing.assert_array_equal(
        sd['backbone.layer2.0.downsample.0.weight'].numpy(),
        np.transpose(v['backbone']['params']['layer2_0']['downsample'][
            'conv']['kernel'], (3, 2, 0, 1)))
