"""Dataset and loader builders (counterpart of
``vfs_tpu/datasets/builder.py``; reference: mmaction/datasets/builder.py).

The loader is a host-side prefetcher producing fixed-shape numpy batches.
Decode and augmentation are GIL-bound Python and cv2 work, so with
``worker_type='process'`` (the default from 4 workers on a host with 4
cores) batches are built in a persistent spawn-based process pool; threads
remain for small worker counts and unpicklable datasets. The index stream
is the JAX package's: a permutation seeded ``seed + epoch``, padded by
wrapping to a multiple of the shard count, shard ``i`` taking every
``num_shards``-th index from ``i``; process workers seed ``np.random`` and
``random`` with ``seed + worker ordinal``, and hand that seed to the
dataset's ``seed_worker`` where it has one.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from ..utils import build_from_cfg
from .registry import DATASETS


def build_dataset(cfg, default_args=None):
    return build_from_cfg(cfg, DATASETS, default_args)


# --------------------------------------------------------------------------
# process-pool worker plumbing (module-level so 'spawn' can import it)
# --------------------------------------------------------------------------

_WORKER_DATASET = None


def _proc_init(dataset, seed, ordinal_counter):
    """Worker bootstrap: install the dataset and derive a per-worker seed
    (reference datasets/builder.py:111-117 worker_init_fn: deterministic
    ``seed + worker_id``). The worker ordinal comes from a shared
    multiprocessing counter passed through initargs, so seeds are stable
    across runs with a fixed config seed — unlike a PID, which changes
    every launch."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    import random
    with ordinal_counter.get_lock():
        worker_id = ordinal_counter.value
        ordinal_counter.value += 1
    worker_seed = (int(seed) + worker_id) % (2 ** 31)
    np.random.seed(worker_seed)
    # several transforms draw from the stdlib RNG too (RandomResizedCrop
    # offsets, MultiScaleCrop choices — reference worker_init_fn seeds
    # both streams)
    random.seed(worker_seed)
    # a dataset that draws from a state of its own takes the seed too
    seed_worker = getattr(dataset, 'seed_worker', None)
    if seed_worker is not None:
        seed_worker(worker_seed)


def _proc_fetch(indices):
    samples = [_WORKER_DATASET[int(j)] for j in indices]
    return collate(samples)


def collate(samples):
    """Stack numpy fields; ragged arrays and non-arrays stay lists
    (reference mmcv collate semantics minus DataContainer)."""
    batch = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            if len({v.shape for v in vals}) == 1:
                batch[key] = np.stack(vals)
            else:
                batch[key] = vals
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals
    return batch


class EpochSampler:
    """Deterministic per-epoch shuffling with optional multi-process
    sharding + pad-to-divisible (reference
    datasets/samplers/distributed_sampler.py:5-33)."""

    def __init__(self, dataset_len: int, shuffle: bool = True, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0):
        self.dataset_len = dataset_len
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.num_samples = -(-dataset_len // num_shards)
        self.total_size = self.num_samples * num_shards

    def indices(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            order = rng.permutation(self.dataset_len)
        else:
            order = np.arange(self.dataset_len)
        # pad to divisible by wrapping (reference :26-28)
        pad = self.total_size - len(order)
        if pad > 0:
            order = np.concatenate([order, order[:pad]])
        return order[self.shard_index:self.total_size:self.num_shards]


class DataLoader:
    """Threaded batching loader.

    Collates samples by stacking numpy arrays; non-array fields become
    lists. ``drop_last`` mirrors the reference train loader.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, drop_last: bool = False,
                 seed: int = 0, num_shards: int = 1, shard_index: int = 0,
                 prefetch: int = 4, worker_type: str = 'auto'):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.sampler = EpochSampler(len(dataset), shuffle, seed, num_shards,
                                    shard_index)
        self.prefetch = prefetch
        self.epoch = 0
        if worker_type not in ('auto', 'thread', 'process'):
            raise ValueError(f'bad worker_type {worker_type!r}')
        if worker_type == 'auto':
            # decode+augment is GIL-bound: threads stop scaling past ~2
            # (measured: 16 threads = 4.3 samples/s vs 5.6 single-thread).
            # Processes only pay off with real cores behind them.
            import os
            worker_type = 'process' if (
                self.num_workers >= 4 and (os.cpu_count() or 1) >= 4) \
                else 'thread'
        self.worker_type = worker_type
        self._pool = None

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _get_pool(self):
        """Persistent spawn pool (fork after CUDA init is unsafe); workers
        hold a dataset copy via the initializer. Falls back to threads if
        the dataset cannot be pickled."""
        if self._pool is None:
            import concurrent.futures
            import multiprocessing
            import pickle
            try:
                pickle.dumps(self.dataset)
            except Exception:
                self.worker_type = 'thread'
                return None
            ctx = multiprocessing.get_context('spawn')
            counter = ctx.Value('i', 0)  # stable worker ordinals
            self._pool = concurrent.futures.ProcessPoolExecutor(
                max_workers=self.num_workers, mp_context=ctx,
                initializer=_proc_init,
                initargs=(self.dataset, self.sampler.seed, counter))
        return self._pool

    def close(self):
        """Stop the worker processes (queued batches are cancelled; the
        call returns when the workers have exited)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __len__(self):
        n = self.sampler.num_samples
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _collate(self, samples):
        return collate(samples)

    def _iter_process(self, pool, batches) -> Iterator[dict]:
        """Ordered streaming through the process pool with a bounded
        in-flight window (workers + prefetch)."""
        from collections import deque
        inflight: 'deque' = deque()
        window = self.num_workers + self.prefetch
        nbatch = len(batches)
        submitted = 0
        try:
            while submitted < min(window, nbatch):
                inflight.append(pool.submit(_proc_fetch,
                                            batches[submitted].tolist()))
                submitted += 1
            while inflight:
                fut = inflight.popleft()
                batch = fut.result()  # propagates worker exceptions
                if submitted < nbatch:
                    inflight.append(pool.submit(
                        _proc_fetch, batches[submitted].tolist()))
                    submitted += 1
                yield batch
        finally:
            # abandoned iterator (generator close): stop queued decodes
            # instead of letting up to window batches keep burning the
            # host's cores in the background
            for fut in inflight:
                fut.cancel()

    def __iter__(self) -> Iterator[dict]:
        indices = self.sampler.indices(self.epoch)
        nbatch = len(self)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nbatch)]
        if self.worker_type == 'process':
            pool = self._get_pool()
            if pool is not None:
                yield from self._iter_process(pool, batches)
                return
        yield from self._iter_thread(batches)

    def _iter_thread(self, batches) -> Iterator[dict]:
        """Threaded decode with a BOUNDED in-flight window: workers block
        once ``prefetch + num_workers`` undelivered batches exist (an
        unbounded backlog would decode the whole epoch into host memory
        when the consumer is slower than decode), and stop promptly when
        the consumer abandons the iterator (generator close)."""
        import time
        nbatch = len(batches)
        idx_q: 'queue.Queue' = queue.Queue()
        for i, b in enumerate(batches):
            idx_q.put((i, b))
        results = {}
        lock = threading.Lock()
        errors = []
        stop = threading.Event()
        slots = threading.Semaphore(self.prefetch + self.num_workers)

        def worker():
            while not stop.is_set():
                if not slots.acquire(timeout=0.1):
                    continue  # window full; re-check stop
                try:
                    i, b = idx_q.get_nowait()
                except queue.Empty:
                    slots.release()
                    return
                try:
                    samples = [self.dataset[int(j)] for j in b]
                    collated = self._collate(samples)
                except Exception as exc:  # propagate to the iterator
                    slots.release()
                    with lock:
                        errors.append(exc)
                    return
                with lock:
                    results[i] = collated

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        served = 0
        try:
            while served < nbatch:
                with lock:
                    if errors:
                        raise errors[0]
                    batch = results.pop(served, None)
                if batch is not None:
                    served += 1
                    slots.release()
                    yield batch
                elif not any(t.is_alive() for t in threads):
                    with lock:
                        if errors:
                            raise errors[0]
                        if served not in results:
                            raise RuntimeError(
                                'DataLoader workers exited without '
                                f'producing batch {served}')
                else:
                    time.sleep(0.002)
        finally:
            stop.set()


def build_dataloader(dataset, videos_per_gpu: int, workers_per_gpu: int,
                     shuffle: bool = True, drop_last: bool = False,
                     seed: Optional[int] = None, num_shards: int = 1,
                     shard_index: int = 0, worker_type: str = 'auto',
                     **kwargs) -> DataLoader:
    return DataLoader(dataset, batch_size=videos_per_gpu,
                      shuffle=shuffle, num_workers=workers_per_gpu,
                      drop_last=drop_last, seed=seed or 0,
                      num_shards=num_shards, shard_index=shard_index,
                      worker_type=worker_type)
