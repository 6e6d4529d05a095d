"""Sharded host data pipeline.

Counterpart of ``repro/data/pipeline.py``. Hands each rank its rows of
every global batch and prefetches ``prefetch`` batches on a background
thread, so host data generation overlaps device work. Where the reference
``device_put``s a batch onto a ``NamedSharding`` over the mesh, a rank
here keeps only its own rows (its ``P(data_axes)`` shard, in the
reference's order), as tensors on its device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import torch

from repro_torch.distributed.mesh import data_axes, data_shard, device_of, mesh_shape


class ShardedLoader:
    """Iterate ``it``'s dict batches as this rank's shards.

    With a mesh, an array whose first dimension divides by the size of the
    FIRST data axis (the reference's test, kept as it is) is split by rows
    over all the data axes (``"pod"``, ``"data"``: those the mesh has) and
    the rank keeps its block of ceil(rows / shards) rows; any other array
    is replicated whole. Arrays become tensors on the rank's device;
    other values pass through. Without a mesh the batches pass unchanged.
    An error raised by ``it`` reaches the consumer.
    """

    def __init__(self, it: Iterator[dict], mesh=None, prefetch: int = 2):
        self._it = it
        self._mesh = mesh
        if mesh is not None:
            axes = data_axes(mesh)
            if not axes:
                raise ValueError(f"the mesh has no data axis ('pod' or 'data'): "
                                 f"{tuple(mesh_shape(mesh))}")
            self._first = mesh_shape(mesh)[axes[0]]
            self._index, self._shards = data_shard(mesh, axes)
            self._device = device_of(mesh)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _shard(self, batch: dict) -> dict:
        if self._mesh is None:
            return batch
        out = {}
        for k, v in batch.items():
            if not hasattr(v, "ndim"):
                out[k] = v
                continue
            t = torch.as_tensor(v)
            if t.ndim >= 1 and t.shape[0] % max(1, self._first) == 0:
                rows = -(-t.shape[0] // self._shards)
                t = t[self._index * rows:(self._index + 1) * rows]
            out[k] = t.to(self._device)
        return out

    def _work(self):
        try:
            for batch in self._it:
                if self._stop.is_set():
                    return
                self._q.put(self._shard(batch))
        except Exception as e:  # surface generator errors to the consumer
            self._q.put(e)
        self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        if isinstance(item, Exception):
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
