"""Device-side input prefetch (counterpart of
paddle_tpu/distributed/prefetcher.py): N-buffered host-to-device staging of
the next batches while the current step runs.

``DevicePrefetcher`` holds a deque of ``depth`` batches whose copies to the
device have been issued but not consumed. On a CUDA device every host
tensor is pinned (``pin_memory``) and copied with ``non_blocking=True`` on a
side stream, so the copies of the next batches overlap the current step's
kernels; an event recorded after a batch's copies travels with it. When a
batch is handed out, the consumer's current stream waits on that event, and
every copied tensor records that stream with the caching allocator
(``record_stream``): its memory, allocated on the side stream, is not
reused before the step that reads it has run. Tensors already on the
target device pass through untouched (``skipped_puts``). Per-batch issue
wall time and the queue depth at consumption ride along for StepTelemetry.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Iterable, Iterator

import torch

__all__ = ["DevicePrefetcher"]


class DevicePrefetcher:
    """Issues the copies of the next ``depth`` batches ahead of use.

    device: the target device (the engine's). depth: how many batches may be
    in flight (2 = classic double buffer).

    Stats (read after/while iterating): ``batches``, ``puts``,
    ``skipped_puts``, ``h2d_ms_total``, and per-batch ``last_h2d_ms`` /
    ``last_depth`` (queue occupancy when the batch was handed out, i.e. how
    much look-ahead the consumer actually had).
    """

    def __init__(self, device, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.depth = depth
        self.batches = 0
        self.puts = 0
        self.skipped_puts = 0
        self.h2d_ms_total = 0.0
        self.last_h2d_ms = 0.0
        self.last_depth = 0
        self._stream = None

    def place(self, arrays):
        """Issue the copies of one batch (tensors or arrays; those already
        on the device are skipped). Returns (tensors on the device, the
        tensors copied, the event after the copies or None, issue wall ms):
        the copies run in the background; the wall time is the host-side
        issue cost."""
        cuda = self.device.type == "cuda"
        if cuda and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        t0 = time.perf_counter()
        out, copied = [], []
        ctx = torch.cuda.stream(self._stream) if cuda else contextlib.nullcontext()
        with ctx:
            for a in arrays:
                t = torch.as_tensor(a)
                if t.device == self.device:
                    self.skipped_puts += 1
                    out.append(t)
                    continue
                self.puts += 1
                if cuda and t.device.type == "cpu" and not t.is_pinned():
                    t = t.pin_memory()
                t = t.to(self.device, non_blocking=cuda)
                out.append(t)
                copied.append(t)
            event = None
            if cuda and copied:
                event = torch.cuda.Event()
                event.record(self._stream)
        ms = (time.perf_counter() - t0) * 1000.0
        self.h2d_ms_total += ms
        return tuple(out), copied, event, ms

    def _hand_over(self, copied, event):
        """The consumer's stream waits for the batch's copies; the copied
        tensors' memory is recorded as in use on that stream."""
        if event is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        for t in copied:
            t.record_stream(cur)

    def iterate(self, batches: Iterable) -> Iterator[tuple]:
        """Yield device-placed batches, keeping up to ``depth`` in flight.

        ``batches`` yields sequences of tensors or arrays. The copies of
        batch i+1..i+depth are issued before batch i is handed to the
        consumer, so they overlap the consumer's device work."""
        it = iter(batches)
        buf = collections.deque()
        exhausted = False
        while True:
            while not exhausted and len(buf) < self.depth:
                try:
                    nxt = next(it)
                except StopIteration:
                    exhausted = True
                    break
                buf.append(self.place(tuple(nxt)))
            if not buf:
                return
            placed, copied, event, ms = buf.popleft()
            self._hand_over(copied, event)
            self.batches += 1
            self.last_h2d_ms = ms
            self.last_depth = len(buf) + 1  # this batch + still-in-flight
            yield placed

    def __call__(self, batches: Iterable) -> Iterator[tuple]:
        return self.iterate(batches)
