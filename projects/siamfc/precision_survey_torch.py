#!/usr/bin/env python
"""Precision@20 of the port's SiamFC tracker with seeded random weights on
bench.py's tracking fixture (chip_smoke.make_track_fixture: 4 sequences x
50 frames at 360x640, seed 7), one JSON line per set of weights.

    python3 projects/siamfc/precision_survey_torch.py [--seeds 6]
        [--weights NAME=STATE.pt ...] [--device cuda:0]

Each seed draws the r18 ``default_cfg`` tracker twice: with
``TrackerSiamFC.init_weights`` (the JAX package's initialisers by
distribution) and with the port ResNet's own ``init_weights`` for the
backbone (Kaiming normal, fan out) and the same head. ``--weights`` adds
state dicts of ``siamfc_tpu_torch.Net``, e.g. the JAX package's seed-0
draw, exported where JAX is installed:

    python -c "import sys, jax, jax.numpy as jnp, torch;
      sys.path[:0] = ['.', 'projects/siamfc'];
      import siamfc_tpu as J, siamfc_tpu_torch as P;
      t = J.TrackerSiamFC(dict(J.default_cfg));
      v = jax.jit(t.net.init)(jax.random.PRNGKey(0),
          jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 64, 64, 3)));
      torch.save(P.flax_siamfc_to_torch(jax.device_get(v)), 'jax0.pt')"

(flax draws parameters from their shapes alone, so a small input gives
the same weights as the tracker's 120 / 255 crops.) Every run tracks
through ``ExperimentOTB.run(batch_size=2)``, the smoke's ``dev_batch2``.
"""

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(os.path.dirname(HERE)), HERE]


def parse_args():
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--seeds', type=int, default=6)
    p.add_argument('--weights', nargs='*', default=[],
                   help='NAME=PATH of a Net state dict')
    p.add_argument('--device', default=None)
    return p.parse_args()


def main():
    args = parse_args()
    import numpy as np
    import torch
    from siamfc_tpu_torch import (ExperimentOTB, TrackerSiamFC, default_cfg,
                                  eval_metrics)
    from siamfc_tpu_torch.otb import _load_otb_seq

    from chip_smoke import make_track_fixture

    def tracker(seed, backbone_init):
        t = TrackerSiamFC(dict(default_cfg), device=args.device)
        t.init_weights(generator=torch.Generator().manual_seed(seed))
        if backbone_init == 'resnet':
            # the same head, the backbone by the port ResNet's initialiser
            net = t.net.cpu().to(memory_format=torch.contiguous_format)
            net.backbone.init_weights(torch.Generator().manual_seed(seed))
            t.net = t._place(net, t.device)
        return t

    variants = [(f'{init}_seed{s}', lambda s=s, init=init: tracker(s, init))
                for s in range(args.seeds) for init in ('flax', 'resnet')]
    for spec in args.weights:
        name, path = spec.split('=', 1)

        def loaded(path=path):
            t = TrackerSiamFC(dict(default_cfg), device=args.device)
            t.net.load_state_dict(torch.load(path, map_location='cpu'))
            return t
        variants.append((name, loaded))
    with tempfile.TemporaryDirectory() as root:
        make_track_fixture(root, 4, 50, (360, 640))
        exp = ExperimentOTB(root, result_dir=os.path.join(root, 'res'),
                            report_dir=os.path.join(root, 'rep'))
        seqs = [_load_otb_seq(d) for d in exp.seq_dirs]
        for name, make in variants:
            res = exp.run(make(), batch_size=2)
            prec = [float(eval_metrics(res[n][0], anno)[1][20])
                    for n, (_, anno) in zip(exp.seq_names, seqs)]
            print(json.dumps(dict(weights=name, precision_20=float(
                np.mean(prec)), per_sequence=prec)), flush=True)


if __name__ == '__main__':
    main()
