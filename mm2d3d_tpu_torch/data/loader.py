"""Host-side data loading (port of `mm2d3d_tpu/data/loader.py`): worker
pools, per-sample seeds, batch assembly, the source/target pairing and a
background prefetch thread.

Per-sample augmentations draw from `np.random.RandomState(seed)` with the
seed derived from (loader seed, epoch, cycle, index), as in the JAX
package, so a run's batches do not depend on which worker made a sample and
equal the JAX loader's bit for bit.  Workers return numpy samples; `collate`
runs in the consuming process, and only that process touches the device.
Under data parallelism each rank's loader takes its shard of every global
batch (`num_shards`, `shard_id`), as each process's does in JAX.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from multiprocessing import get_context
from typing import Iterator, Optional

import numpy as np

from ..train.batch import PointBatch
from .base import collate

_WORKER_DATASET = None


def _worker_init(dataset):
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_get(args):
    index, seed = args
    return _WORKER_DATASET.__getitem__(index, rng=np.random.RandomState(seed))


def _drain(pending, seconds: float = 60.0) -> None:
    """Wait out the results still in flight (at most `seconds` in total): a
    worker blocked on a full result pipe holds the pool's shutdown."""
    deadline = time.monotonic() + seconds
    while pending:
        try:
            pending.popleft().get(timeout=max(0.1, deadline - time.monotonic()))
        except Exception:
            pass  # a worker's error or a timeout still unclogs the pipe


class Loader:
    """Iterates a dataset as PointBatches of CPU tensors; one epoch per
    __iter__ call.

    `batch_size` is the per-process batch.  With `num_shards` > 1 (one
    process per device), every process samples the same global order (same
    seed) and takes its `shard_id` slice of each global batch of
    `batch_size * num_shards` scans.  A train loader (`drop_last`) drops
    the whole global tail, so every shard has as many batches (the
    collectives need that); a sharded eval loader pads the global tail
    whatever `pad_last` says, so every scan is evaluated exactly once.

    `pad_last` pads a partial tail batch to the full `batch_size` with
    fully-masked filler samples (zero metric and loss contribution), so
    every batch has one static shape.  `full_scale` (the model's) turns on
    the host-side Morton sort of each sample's points (`data.base.collate`);
    None leaves the points in scan order."""

    def __init__(self, dataset, batch_size: int, n_points: int,
                 shuffle: bool = False, drop_last: bool = False, seed: int = 0,
                 num_workers: int = 0, num_shards: int = 1, shard_id: int = 0,
                 full_scale: Optional[int] = None, pad_last: bool = False):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} outside [0, {num_shards})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.n_points = n_points
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = num_workers
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.full_scale = full_scale
        self.pad_last = pad_last
        self.epoch = 0
        # within-epoch restart counter of `max_size_cycle`: folded into the
        # per-sample seed, so the shorter loader draws fresh augmentations
        # on every cycle; reset by set_epoch
        self.cycle = 0
        self._pool = None
        self._inflight = None  # results of an abandoned epoch, drained later

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        self.cycle = 0

    def set_cycle(self, cycle: int):
        self.cycle = cycle

    def __len__(self) -> int:
        """Global batches of one epoch: the batches of every shard."""
        n = len(self.dataset)
        g = self.batch_size * self.num_shards
        if self.drop_last:
            return n // g
        return (n + g - 1) // g

    def _sample_seed(self, index: int) -> int:
        return (
            self.seed * 1_000_003 + self.epoch * 97
            + self.cycle * 15_485_863 + index
        ) % (2**31 - 1)

    def _pool_handle(self):
        if self.num_workers > 0 and self._pool is None:
            # forkserver, as in the JAX package: the workers fork from a
            # fresh server process, with no copy of this process's threads
            # or device state.  The server imports the dataset's module (and
            # so torch) once, for every pool of the run; a spawned worker
            # would import it anew, seconds each.  As with spawn, a script
            # that builds loaders keeps its top-level work behind a
            # `__main__` guard
            ctx = get_context("forkserver")
            ctx.set_forkserver_preload([type(self.dataset).__module__])
            self._pool = ctx.Pool(self.num_workers, initializer=_worker_init,
                                  initargs=(self.dataset,))
        return self._pool

    def _batches(self):
        """[(indices, number of trailing filler entries)] of this shard's
        batches in one epoch."""
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        g = self.batch_size * self.num_shards
        lo = self.shard_id * self.batch_size
        out = []
        for i in range(0, n, g):
            b = order[i + lo:i + lo + self.batch_size]
            if i + g > n:  # the partial global tail
                if self.drop_last:
                    continue
                if self.pad_last or self.num_shards > 1:
                    # the filler repeats the tail's first scan, marked
                    # `_pad_tail_`: no point of it counts
                    n_pad = self.batch_size - len(b)
                    out.append((np.concatenate(
                        [b, np.full(n_pad, order[i], order.dtype)]), n_pad))
                    continue
            if len(b):
                out.append((b, 0))
        return out

    def _finish(self, samples, n_pad: int) -> PointBatch:
        if n_pad:
            samples = list(samples)
            samples[len(samples) - n_pad:] = [
                {**s, "_pad_tail_": True} for s in samples[len(samples) - n_pad:]]
        return collate(samples, self.n_points, full_scale=self.full_scale)

    def __iter__(self) -> Iterator[PointBatch]:
        batches = self._batches()
        pool = self._pool_handle()
        if pool is None:
            for idxs, n_pad in batches:
                yield self._finish([
                    self.dataset.__getitem__(
                        int(i), rng=np.random.RandomState(self._sample_seed(int(i))))
                    for i in idxs], n_pad)
            return
        # an epoch abandoned midway (limit_train_batches, an exception)
        # leaves its window of results in flight: drain them first
        if self._inflight:
            _drain(self._inflight)
        args = iter((int(i), self._sample_seed(int(i)))
                    for b, _ in batches for i in b)
        # a bounded window of submitted samples: an epoch-sized backlog can
        # fill the pool's task pipe and deadlock its shutdown when the
        # consumer stops early
        window = max(2 * self.batch_size, 4 * self.num_workers)
        pending: deque = deque()
        self._inflight = pending

        def refill():
            while len(pending) < window:
                a = next(args, None)
                if a is None:
                    return
                pending.append(pool.apply_async(_worker_get, (a,)))

        refill()
        for idxs, n_pad in batches:
            samples = []
            for _ in idxs:
                samples.append(pending.popleft().get())
                refill()
            yield self._finish(samples, n_pad)
        self._inflight = None

    def iterate(self, num_iterations: int) -> Iterator[PointBatch]:
        """Yield exactly `num_iterations` batches, cycling epochs with
        reshuffling (the reference's IterationBasedBatchSampler,
        lib/utils/sampler.py)."""
        produced = 0
        while produced < num_iterations:
            for batch in self:
                yield batch
                produced += 1
                if produced >= num_iterations:
                    return
            self.set_epoch(self.epoch + 1)

    def close(self):
        """Drain the results in flight, then close the pool; a worker still
        wedged after 30 s is terminated (with the pipe drained, terminate no
        longer risks the pool's feeder-thread deadlock)."""
        if self._pool is None:
            return
        if self._inflight:
            _drain(self._inflight)
        self._inflight = None
        self._pool.close()
        joiner = threading.Thread(target=self._pool.join, daemon=True)
        joiner.start()
        joiner.join(timeout=30)
        if joiner.is_alive():
            self._pool.terminate()
            joiner.join(timeout=30)
        self._pool = None


def prefetched(gen, depth: int = 2):
    """Run a generator in a background thread, `depth` items ahead.

    The trainer overlaps host work (loader collate and the pinned,
    non-blocking host-to-device copies) with device compute this way.
    Exceptions in the generator propagate to the consumer."""
    import queue

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err = []
    stop = threading.Event()

    def fill():
        try:
            for x in gen:
                while not stop.is_set():
                    try:
                        q.put(x, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # handed to the consuming thread
            err.append(e)
        finally:
            while True:
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    if stop.is_set():
                        break  # the consumer is gone

    t = threading.Thread(target=fill, daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is sentinel:
                t.join()
                if err:
                    raise err[0]
                return
            yield x
    finally:
        # the consumer stopped early (limit_train_batches, an exception):
        # release the fill thread and wait for it, so it touches no loader
        # after this (a loader it restarted would start a new worker pool)
        stop.set()
        t.join()


_TOPOLOGY_THREADS = 3  # the JAX package's pool
_TOPOLOGY_DEPTH = 4  # pairs in flight


def prefetch_topology_pairs(pairs, full_scale: int, num_levels: int,
                            slot_profile: str = "default"):
    """(src, trg) batch pairs -> (src, trg, topo_src, topo_trg): both
    domains' topologies built on the CPU (`data.host_topology`, under the
    task's `slot_profile`) in a pool of 3 threads, 4 pairs ahead; the C++
    calls release the GIL.  Closing the generator waits for the pairs in
    flight."""
    from concurrent.futures import ThreadPoolExecutor

    from .host_topology import topology_for_batch

    def job(pair):
        return (*pair, *(topology_for_batch(b, full_scale, num_levels,
                                            slot_profile=slot_profile)
                         for b in pair))

    it = iter(pairs)
    with ThreadPoolExecutor(max_workers=_TOPOLOGY_THREADS) as pool:
        pending = deque(pool.submit(job, p)
                        for p in itertools.islice(it, _TOPOLOGY_DEPTH))
        while pending:
            done = pending.popleft()
            for p in itertools.islice(it, 1):
                pending.append(pool.submit(job, p))
            yield done.result()


def stop_worker_server() -> None:
    """Stop the forkserver and resource-tracker processes that worker pools
    start, and wait for both to exit; the next pool starts them anew.  Call
    it once every Loader is closed: left alone, both end only after this
    process has ended."""
    import gc
    from multiprocessing import forkserver, resource_tracker

    gc.collect()  # the closed pools' semaphores leave the tracker first
    forkserver._forkserver._stop()  # holds a copy of the tracker's pipe
    resource_tracker._resource_tracker._stop()


def max_size_cycle(source: Loader, target: Loader):
    """Pair source and target batches, cycling the shorter loader
    (Lightning's multiple_trainloader_mode="max_size_cycle"); each restart
    of a loader within the epoch bumps its cycle counter, so the repeated
    domain draws fresh augmentations."""
    n = max(len(source), len(target))

    def cycled(loader):
        for c in itertools.count():
            if hasattr(loader, "set_cycle"):
                loader.set_cycle(c)
            yield from loader

    src_it, trg_it = cycled(source), cycled(target)
    for _ in range(n):
        yield next(src_it), next(trg_it)
