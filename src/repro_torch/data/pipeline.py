"""Prefetching host->device batch stream — the port of
``repro/data/pipeline.py::ShardedStream``.

A background thread keeps ``prefetch`` batches in flight so device steps
never wait on host data (compute/ingest overlap).  Placement is either
``.to(device)`` of every tensor of a batch, or, with ``sharding=``, each
tensor put under a ``distribution.sharding.Sharding`` as the reference
``device_put``s each leaf under a ``NamedSharding``: every rank is given
the whole global batch and keeps its block of it, a DTensor on the mesh's
device (``sharding.place``; no collective).  ``batch_sharding(mesh,
batch_axes)`` shards the leading (batch) dim over the named mesh axes.
With neither the batch passes through as it is.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import torch

from repro_torch.distribution import sharding as sharding_mod


def _map(fn, batch):
    if isinstance(batch, torch.Tensor):
        return fn(batch)
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, v) for v in batch)
    return batch


def batch_sharding(mesh, batch_axes=("data",)) -> sharding_mod.Sharding:
    """Shard the leading (batch) dim over the given mesh axes."""
    return sharding_mod.to_shardings(sharding_mod.Spec(tuple(batch_axes)),
                                     mesh)


class ShardedStream:
    """Wraps a host batch iterator with device placement + prefetch; an
    error of the iterator is raised on the consumer side."""

    def __init__(self, it: Iterator, device=None, prefetch: int = 2,
                 sharding: Optional[sharding_mod.Sharding] = None):
        if device is not None and sharding is not None:
            raise ValueError("ShardedStream places a batch on a device or "
                             "under a sharding, not both")
        self._it = it
        if sharding is not None:
            self._place = lambda t: sharding_mod.place(t, sharding)
        elif device is not None:
            device = torch.device(device)
            self._place = lambda t: t.to(device)
        else:
            self._place = None
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._it:
                self._q.put(batch if self._place is None
                            else _map(self._place, batch))
        except BaseException as e:      # surfaced on the consumer side
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
