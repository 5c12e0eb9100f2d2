"""Host → card prefetching (the counterpart of ``udp_pose_tpu/data/
prefetch.py``'s ``device_prefetch``).

A background thread takes each host batch, copies its arrays into pinned
host memory and uploads them with ``non_blocking=True`` on a side
stream, one batch ahead of the consumer, so the train step does not wait
for the host-to-card copy.  The consumer's stream waits on an event
recorded after the upload, and each uploaded tensor is marked as used by
that stream (``record_stream``) so that its memory is not reused while
the step still reads it.  An error in the thread (a worker's, or the
upload's) is raised in the consumer.  On the CPU, which must be asked
for, the batches pass through unchanged.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from ..utils.platform import resolve_device

_END = object()


def device_prefetch(host_iter: Iterator, device="cuda", keys=None):
    """Yield the dict batches of ``host_iter`` with their numpy arrays and
    CPU tensors (those named in ``keys``, or all when None) as tensors on
    ``device``; other entries (meta lists) pass through."""
    device = resolve_device(device)
    if device.type == "cpu":
        yield from host_iter
        return
    stream = torch.cuda.Stream(device)
    ready: "queue.Queue" = queue.Queue(maxsize=1)
    stop = threading.Event()
    err = []

    def put(item):
        while not stop.is_set():
            try:
                ready.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def upload():
        try:
            with torch.cuda.stream(stream):
                for batch in host_iter:
                    if stop.is_set():
                        break
                    out = {}
                    for k, v in batch.items():
                        if keys is None or k in keys:
                            if isinstance(v, np.ndarray):
                                v = torch.from_numpy(v)
                            if torch.is_tensor(v) and v.device.type == "cpu":
                                v = v.pin_memory().to(device,
                                                      non_blocking=True)
                        out[k] = v
                    done = torch.cuda.Event()
                    done.record(stream)
                    put((out, done))
        except BaseException as e:          # raised in the consumer
            err.append(e)
        finally:
            put(_END)

    thread = threading.Thread(target=upload, name="device_prefetch",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = ready.get()
            if item is _END:
                if err:
                    raise err[0]
                return
            out, done = item
            current = torch.cuda.current_stream(device)
            current.wait_event(done)
            for v in out.values():
                if torch.is_tensor(v) and v.device == current.device:
                    v.record_stream(current)
            yield out
    finally:
        stop.set()
        thread.join(timeout=60)
