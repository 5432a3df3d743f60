"""Runtime counters (counterpart of paddle_tpu/core/monitor.py's
``StatValue`` / ``StatRegistry`` / ``stat``): named integer counters with a
high-water mark, such as the ``grad_comm.*`` byte counters; and the card's
memory (``device_memory_stats``, ``live_buffer_stats``) from the caching
allocator, which StepTelemetry records."""
from __future__ import annotations

import threading
from typing import Dict, List


class StatValue:
    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._max = 0
        self._lock = threading.Lock()

    def increase(self, n: int = 1) -> int:
        with self._lock:
            self._v += n
            self._max = max(self._max, self._v)
            return self._v

    def decrease(self, n: int = 1) -> int:
        with self._lock:
            self._v -= n
            return self._v

    def set(self, v: int) -> None:
        with self._lock:
            self._v = v
            self._max = max(self._max, v)

    def get(self) -> int:
        return self._v

    def peak(self) -> int:
        return self._max


class StatRegistry:
    def __init__(self):
        self._stats: Dict[str, StatValue] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> StatValue:
        with self._lock:
            if name not in self._stats:
                self._stats[name] = StatValue(name)
            return self._stats[name]

    def names(self) -> List[str]:
        return sorted(self._stats)

    def report(self) -> Dict[str, Dict[str, int]]:
        return {n: {"value": s.get(), "peak": s.peak()}
                for n, s in self._stats.items()}


_registry = StatRegistry()


def stat(name: str) -> StatValue:
    """The counter ``name``, registered at first use."""
    return _registry.get(name)


def registry() -> StatRegistry:
    return _registry


def _cuda_device(device):
    """``device`` as a CUDA device, the current card for None; None when it
    is not a CUDA device or there is no card."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            return None
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    return device if device.type == "cuda" else None


def device_memory_stats(device=None) -> Dict[str, int]:
    """The caching allocator's memory stats of a CUDA device (the current
    card by default), under the reference's PJRT keys: ``bytes_in_use`` and
    ``peak_bytes_in_use`` (allocated bytes now and since the last
    ``torch.cuda.reset_peak_memory_stats``), ``bytes_limit`` (the card's
    total memory) and ``largest_alloc_size`` (the largest block allocated
    now: the caching allocator keeps no all-time figure). ``{}`` on the CPU."""
    import torch

    dev = _cuda_device(device)
    if dev is None:
        return {}
    stats = torch.cuda.memory_stats(dev)
    _free, total = torch.cuda.mem_get_info(dev)
    largest = 0
    for seg in torch.cuda.memory_snapshot():
        if seg.get("device") != dev.index:
            continue
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                largest = max(largest, int(blk["size"]))
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
            "largest_alloc_size": largest}


def live_buffer_stats(device=None) -> Dict[str, int]:
    """Count and bytes of the caching allocator's live allocations on a CUDA
    device (the current card by default); ``{}`` on the CPU, which has no
    such census."""
    import torch

    dev = _cuda_device(device)
    if dev is None:
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"count": int(stats.get("allocation.all.current", 0)),
            "bytes": int(stats.get("allocated_bytes.all.current", 0))}
