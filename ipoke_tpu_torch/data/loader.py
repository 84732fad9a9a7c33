"""Host-side batching with thread-pool prefetch, and the copy to the card
(the port's counterpart of ``ipoke_tpu/data/loader.py``).

``DataLoader`` gives the JAX package's batches in its order: the sampler's
indices in groups of ``batch_size``, each group loaded by ``num_threads``
threads (``pool.map`` keeps the order) and stacked, ``prefetch`` batches
ahead of the consumer.  With ``num_threads=0`` the producer thread loads the
examples itself, one after another, and gives the same batches as one
worker (JAX's loader calls ``ThreadPoolExecutor(0)`` there, which raises in
its producer thread and leaves the consumer waiting for ever).  A consumer
that stops early stops the producer.

``device_prefetch`` is JAX's ``device_prefetch`` for torch: each batch is
copied into pinned host memory and then to the card on a side stream with
``non_blocking=True``, ``size`` batches ahead, so the copy overlaps the
step; the consumer's stream waits on that batch's copy only.
"""
from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator

import numpy as np
import torch


def collate(samples):
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    def __init__(self, dataset, sampler, batch_size: int, drop_last: bool = True,
                 prefetch: int = 2, num_threads: int = 4):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_threads = num_threads

    def _batches(self) -> Iterator[list]:
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler) // self.batch_size
        if not self.drop_last and len(self.sampler) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop, done = threading.Event(), object()

        def put(item):
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            pool = ThreadPoolExecutor(self.num_threads) if self.num_threads > 0 else None
            load = (lambda idx: list(pool.map(self.dataset.__getitem__, idx))) if pool else \
                (lambda idx: [self.dataset[i] for i in idx])
            try:
                for batch_idx in self._batches():
                    if not put(collate(load(batch_idx))):
                        return
                put(done)
            except BaseException as e:   # surfaced in the consumer
                put(e)
            finally:
                if pool is not None:
                    pool.shutdown(wait=True)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()


def to_device(batch, device, keys=None, pin: bool = False):
    """The numpy batch's ``keys`` (all by default) as tensors on ``device``;
    ``pin``: through pinned host memory with a non-blocking copy."""
    out = {}
    for k in keys or batch:
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        out[k] = t.pin_memory().to(device, non_blocking=True) if pin else t.to(device)
    return out


def device_prefetch(batches: Iterable, device, keys=None, size: int = 2, mesh=None):
    """The batches of ``batches`` as tensors on ``device``, ``size`` copies
    ahead; on a CUDA device through pinned memory on a side stream.  With a
    ``mesh`` (``parallel/mesh``), each global batch's rows of this rank over
    ``data`` (``shard_batch``) are all it copies."""
    device = torch.device(device)
    it = iter(batches)
    if mesh is not None:
        from ipoke_tpu_torch.parallel.mesh import shard_batch

        it = (shard_batch(mesh, b) for b in it)
    buf = deque()
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def put():
        try:
            batch = next(it)
        except StopIteration:
            return
        if stream is None:
            buf.append((to_device(batch, device, keys), None))
            return
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            out = to_device(batch, device, keys, pin=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        buf.append((out, ev))

    for _ in range(size):
        put()
    while buf:
        out, ev = buf.popleft()
        if ev is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(ev)
            for t in out.values():
                t.record_stream(current)
        put()
        yield out
