#!/usr/bin/env python3
"""Split the r18 pretraining loader's time on this host.

    python3 loader_probe.py [--workers 16 8] [--batches 16] [--samples 8]

Writes ``chip_smoke.py``'s synthetic Kinetics-layout clips (32 MJPG clips
of 16 256x340 frames) under ``build/``, builds the train set of
configs/r18_nc_sgd_cos_100e_r2_1xNx8_k400.py on them (``RepeatDataset``
times raised to ``--batches`` batches of the config's 32 samples an
epoch) and prints one JSON line for each of:

- ``in_process``: ms a sample of the train pipeline in this process, over
  ``--samples`` samples after one; ms to pickle and to unpickle one batch
  of distinct samples, which a process worker sends back whole;
- ``pipe``: MB/s of that many bytes sent from a child process through a
  ``multiprocessing`` pipe, the channel through which a process pool
  returns its results;
- ``pool``: samples/s of the config's loader over a warm epoch (epoch 0
  starts the worker processes, epoch 1 is timed), once for each
  ``--workers`` count.

Needs no card; run it on the host whose loader rate is in question.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import pickle
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def _send(conn, nbytes):
    """Child: allocate ``nbytes``, say ready, then send them."""
    payload = bytes(nbytes)
    conn.send_bytes(b'ready')
    conn.send_bytes(payload)
    conn.close()


def pipe_mb_per_s(nbytes):
    ctx = multiprocessing.get_context('spawn')
    recv, send = ctx.Pipe(duplex=False)
    child = ctx.Process(target=_send, args=(send, nbytes))
    child.start()
    recv.recv_bytes()
    t0 = time.time()
    got = len(recv.recv_bytes())
    seconds = time.time() - t0
    child.join()
    return got / seconds / 1e6


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--workers', type=int, nargs='+', default=[16, 8])
    parser.add_argument('--batches', type=int, default=16)
    parser.add_argument('--samples', type=int, default=8)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import chip_smoke
    from vfs_tpu_torch.datasets import build_dataloader, build_dataset
    from vfs_tpu_torch.utils import Config

    cfg = Config.fromfile(chip_smoke.CONFIG).to_dict()
    batch_size = cfg['data']['videos_per_gpu']
    os.makedirs(os.path.join(ROOT, 'build'), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, 'build')) as root:
        ann = chip_smoke.write_k400(root)
        train = cfg['data']['train']
        dataset = build_dataset(dict(
            train, times=args.batches * batch_size // chip_smoke.K400_CLIPS,
            dataset=dict(train['dataset'], ann_file=ann, data_prefix=root)))

        dataset[0]
        t0 = time.time()
        samples = [dataset[i] for i in range(1, args.samples + 1)]
        sample_ms = (time.time() - t0) * 1e3 / args.samples
        batch = [samples[i % len(samples)] for i in range(batch_size)]
        batch = [{k: v.copy() if hasattr(v, 'copy') else v
                  for k, v in s.items()} for s in batch]
        t0 = time.time()
        blob = pickle.dumps(batch, protocol=pickle.HIGHEST_PROTOCOL)
        pickle_ms = (time.time() - t0) * 1e3
        t0 = time.time()
        pickle.loads(blob)
        unpickle_ms = (time.time() - t0) * 1e3
        print(json.dumps(dict(
            probe='in_process', cpus=os.cpu_count(), ms_per_sample=sample_ms,
            batch_mb=len(blob) / 1e6, pickle_ms=pickle_ms,
            unpickle_ms=unpickle_ms)), flush=True)
        print(json.dumps(dict(probe='pipe', mb=len(blob) / 1e6,
                              mb_per_s=pipe_mb_per_s(len(blob)))),
              flush=True)

        for workers in args.workers:
            loader = build_dataloader(dataset, batch_size, workers,
                                      shuffle=True, drop_last=True, seed=0)
            try:
                t0 = time.time()
                for _ in loader:
                    pass
                warm_s = time.time() - t0
                loader.set_epoch(1)
                t0 = time.time()
                n = sum(len(b['imgs']) for b in loader)
                sps = n / (time.time() - t0)
            finally:
                loader.close()
            print(json.dumps(dict(probe='pool', workers=workers,
                                  batches=len(loader), warm_epoch_s=warm_s,
                                  samples_per_s=sps)), flush=True)


if __name__ == '__main__':
    main()
