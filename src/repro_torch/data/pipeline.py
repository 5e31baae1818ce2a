"""Prefetching host->device batch stream — the port of
``repro/data/pipeline.py::ShardedStream``.

A background thread keeps ``prefetch`` batches in flight so device steps
never wait on host data (compute/ingest overlap).  Placement is
``.to(device)`` of every tensor of a batch, where the reference
``device_put``s each leaf under a ``NamedSharding``; with no device the
batch passes through as it is.  The reference's ``batch_sharding`` shards
over a JAX mesh and waits for the port of ``distribution/sharding.py``.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import torch


def _place(batch, device: torch.device):
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    if isinstance(batch, dict):
        return {k: _place(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_place(v, device) for v in batch)
    return batch


class ShardedStream:
    """Wraps a host batch iterator with device placement + prefetch; an
    error of the iterator is raised on the consumer side."""

    def __init__(self, it: Iterator, device=None, prefetch: int = 2):
        self._it = it
        self._device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._done = object()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._it:
                self._q.put(batch if self._device is None
                            else _place(batch, self._device))
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
