"""Runtime counters (counterpart of paddle_tpu/core/monitor.py's
``StatValue`` / ``StatRegistry`` / ``stat``): named integer counters with a
high-water mark, such as the ``grad_comm.*`` byte counters."""
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
