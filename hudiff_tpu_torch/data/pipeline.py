# Copied from hudiff_tpu/data/pipeline.py (prefetch); device_feed is the port's.
"""Host->device feeding: background prefetch, pinned memory, non-blocking
copies.

A daemon thread keeps a small queue of ready numpy batches (in pinned
host memory when the target is a card) while the device computes;
``device_feed`` copies each with ``non_blocking=True`` onto the device, so
the copy overlaps the work already queued there.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterable, Iterator

import numpy as np
import torch


def prefetch(it: Iterable, size: int = 2) -> Iterator:
    """Run ``it`` in a daemon thread, buffering up to ``size`` items.

    A producer-side exception is re-raised in the consumer (silently ending
    the stream would truncate an epoch and look like clean exhaustion)."""
    q: queue.Queue = queue.Queue(maxsize=size)
    _END = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - relay to consumer
            q.put((_END, e))
            return
        q.put((_END, None))

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _END:
            if item[1] is not None:
                raise item[1]
            return
        yield item


def device_feed(batches: Iterable[Dict[str, np.ndarray]],
                device) -> Iterator[Dict[str, torch.Tensor]]:
    """Prefetched iterator of device-resident batches (int arrays become
    int64 tensors, the model's embedding indices; float arrays, such as
    the fine-tune's AHo one-hots, float32)."""
    device = torch.device(device)
    pin = device.type == 'cuda'

    def tensor(v):
        v = np.asarray(v)
        return torch.from_numpy(v.astype(np.float32 if v.dtype.kind == 'f' else np.int64))

    def host(batch):
        out = {k: tensor(v) for k, v in batch.items()}
        return {k: v.pin_memory() for k, v in out.items()} if pin else out

    for batch in prefetch(host(b) for b in batches):
        yield {k: v.to(device, non_blocking=True) for k, v in batch.items()}
