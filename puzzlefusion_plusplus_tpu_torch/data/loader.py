"""Host-side batch loader (numpy).

A copy of ``Loader``, ``prefetch_batches`` and ``collate_stack`` from
``puzzlefusion_plusplus_tpu/data/loader.py``, kept so that the port imports nothing from the
JAX package. Batches are stacked dicts of numpy arrays; the same seed serves the same batches
in the same order as the JAX package.

Data-parallel training iterates the same global batches on every rank and keeps each rank's
rows (``parallel/mesh.py::shard_batch``): the augmentations come from one rng drawn across a
batch's items in order, so a rank that built only its own rows would draw other ones than
one process does. ``process_index``/``process_count`` deal out whole batches instead.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator

import numpy as np

from puzzlefusion_plusplus_tpu_torch.utils import profiling


class Loader:
    def __init__(
        self,
        dataset,  # __len__ + get(i, rng) -> dict[str, np.ndarray]
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        collate: Callable[[list[dict]], dict] | None = None,
        order: Any | None = None,  # custom serving order (e.g. part-count-sorted bucketing)
        bucket_key: Any | None = None,  # per-sample group id; batches never cross groups
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        self.collate = collate or collate_stack
        self.order = None if order is None else np.asarray(order, np.int64)
        self.bucket_key = None if bucket_key is None else np.asarray(bucket_key, np.int64)

    def __len__(self) -> int:
        order = np.arange(len(self.dataset)) if self.order is None else self.order
        count = len(self._global_batches(order))
        if self.process_count > 1:
            count //= self.process_count
        return count

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = np.arange(n) if self.order is None else self.order
        rng = np.random.default_rng((self.seed, self.epoch))
        if self.shuffle:
            order = order[rng.permutation(len(order))]
        batches = self._global_batches(order, rng)
        if self.process_count > 1:
            per_host = len(batches) // self.process_count
            batches = batches[self.process_index :: self.process_count][:per_host]
        self.epoch += 1
        for idx in batches:
            items = [self.dataset.get(int(i), rng) for i in idx]
            yield self.collate(items)

    def _global_batches(self, order: np.ndarray, rng=None) -> list[np.ndarray]:
        """Split an index order into batches; with ``bucket_key`` batches form WITHIN each
        bucket and the batch list is shuffled when an rng is given."""
        batches = []
        if self.bucket_key is None:
            for start in range(0, len(order), self.batch_size):
                idx = order[start : start + self.batch_size]
                if self.drop_last and len(idx) < self.batch_size:
                    break
                batches.append(idx)
            return batches
        for key in np.unique(self.bucket_key[order]):
            members = order[self.bucket_key[order] == key]
            for start in range(0, len(members), self.batch_size):
                idx = members[start : start + self.batch_size]
                if self.drop_last and len(idx) < self.batch_size:
                    break
                batches.append(idx)
        if self.shuffle and rng is not None:
            batches = [batches[i] for i in rng.permutation(len(batches))]
        return batches


def prefetch_batches(iterable, depth: int = 2) -> Iterator[Any]:
    """Drive ``iterable`` from one daemon thread, at most ``depth`` items ahead of the
    consumer, so that the host builds the next batch while the card runs the step. One
    producer keeps the loader's rng call order, so batches come out bit for bit as plain
    iteration gives them. The producer touches numpy only, never CUDA. Its exceptions
    re-raise at the consumer; a consumer that leaves early (``max_steps``) stops it.
    Spans: ``pfpp.loader.build`` on the producer a batch built, ``pfpp.loader.wait`` on the
    consumer a batch handed out; the producer records only where the consumer's thread ran
    a profiler when the generator started."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()
    err: list[BaseException] = []
    profiled = profiling.profiling_on()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            items = iter(iterable)
            while True:
                with profiling.span("pfpp.loader.build", on=profiled) as sp:
                    item = next(items, sentinel)
                    if item is sentinel:
                        sp.discard()
                if item is sentinel or not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 - re-raised at the consumer
            err.append(e)
        finally:
            # the sentinel must reach the consumer even when the queue is full at the end
            # (a slow consumer), or it waits in q.get() forever
            put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            with profiling.span("pfpp.loader.wait") as sp:
                item = q.get()
                if item is sentinel:
                    sp.discard()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()


def collate_stack(items: list[dict[str, Any]]) -> dict[str, np.ndarray]:
    out = {}
    for k in items[0]:
        v0 = items[0][k]
        if isinstance(v0, (np.ndarray, np.generic, int, float, bool)):
            out[k] = np.stack([np.asarray(it[k]) for it in items], axis=0)
        else:  # strings & misc stay as lists (e.g. mesh_file_path)
            out[k] = [it[k] for it in items]
    return out
