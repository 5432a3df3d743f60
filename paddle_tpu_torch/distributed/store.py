"""TCPStore and FileStore: the key-value stores of the membership protocol
and of fleet federation (counterpart of paddle_tpu/distributed/store.py).

Reference: paddle/fluid/distributed/store/tcp_store.h:91 (C++ TCPStore with
set/get/wait/add). The JAX package serves it from a C++ backend
(core/native/tcp_store.cc) through ctypes, with a pure-Python socket server
behind it; the port has only the pure-Python server (_py_store.py), which
speaks the same semantics. Rank 0 hosts the server; every rank (including 0)
is a client — the reference's master-socket topology (tcp_utils.cc).
Process-group rendezvous of ``torch.distributed`` does not use this store.
"""
from __future__ import annotations

import os
import random
import time
from typing import List, Optional

from ..core import monitor as _monitor

_DEFAULT_TIMEOUT = 900.0  # seconds, matches the reference's default store timeout
RETRIES = _monitor.stat("store.retries")
LEASE_EXPIRIES = _monitor.stat("store.lease_expiries")
GC_KEYS = _monitor.stat("store.gc_keys")


class _StoreOps:
    """Shared high-level helpers over the primitive set/get/add/wait/
    delete_key/list_keys surface — mixed into TCPStore AND FileStore so the
    elastic membership coordinator runs identically on either backend.

    Generation scoping: a live mesh reformation (distributed/membership.py)
    bumps a world generation; every coordination key a generation touches
    (barrier rounds, member leases, join/leave announcements) lives under a
    ``gen<N>`` namespace so a re-formed world can never trip over counters
    or done-flags a dead generation left behind. ``gc_generation`` sweeps a
    retired generation's keys (counted in ``store.gc_keys``).
    """

    def barrier(self, name: str, world_size: Optional[int] = None,
                timeout: Optional[float] = None,
                generation: Optional[int] = None) -> None:
        """All ranks arrive, then all ranks proceed. Reusable: the round is
        derived from the arrival counter, so the same name synchronizes every
        call (reference uses add+wait loops the same way). ``generation``
        namespaces the round keys per world generation — barrier("resume",
        generation=3) can never consume an arrival generation 2 banked."""
        n = world_size or self.world_size
        ns = (f"__barrier__/gen{int(generation)}/{name}"
              if generation is not None else f"__barrier__/{name}")
        arrived = self.add(f"{ns}/count", 1)
        round_idx = (arrived - 1) // n
        done_key = f"{ns}/round{round_idx}/done"
        if arrived == (round_idx + 1) * n:
            self.set(done_key, b"1")
        self.wait([done_key], timeout)

    def gc_generation(self, generation: int) -> int:
        """Delete every key a retired world generation owned (membership
        leases, join/leave announcements, barrier rounds, fleet metric
        snapshots). Returns the number of keys removed; each removal
        counts in ``store.gc_keys``."""
        removed = 0
        for prefix in (f"__elastic__/gen{int(generation)}/",
                       f"__barrier__/gen{int(generation)}/",
                       f"__fleet__/gen{int(generation)}/"):
            for key in self.list_keys(prefix):
                if self.delete_key(key):
                    removed += 1
        if removed:
            GC_KEYS.increase(removed)
        return removed


def _connect_with_retry(connect, host, port, timeout,
                        max_attempts: Optional[int] = None,
                        base_delay: float = 0.05, max_delay: float = 2.0):
    """Bounded retry with exponential backoff + full jitter around a store
    connect. A rank that races its master (the normal elastic-restart case)
    sees ECONNREFUSED on the first attempts; previously that failed the job
    hard. `connect(per_attempt_timeout)` returns a client or None/raises
    OSError; retries are bounded by the store timeout (the rendezvous
    contract) and optionally by PADDLE_TPU_STORE_CONNECT_ATTEMPTS. Jitter
    decorrelates a pod of ranks hammering a just-restarted master. Every
    retry counts in `store.retries`."""
    if max_attempts is None:
        max_attempts = int(os.environ.get(
            "PADDLE_TPU_STORE_CONNECT_ATTEMPTS", "0") or 0) or None
    deadline = time.monotonic() + timeout
    delay = base_delay
    attempt = 0
    last_exc = None
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        attempt += 1
        try:
            client = connect(min(remaining, 5.0))
            if client:
                return client
            last_exc = None
        except OSError as e:  # includes TimeoutError / ConnectionRefused
            last_exc = e
        if max_attempts is not None and attempt >= max_attempts:
            break
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            break
        RETRIES.increase()
        time.sleep(min(delay, max_delay, remaining)
                   * (0.5 + random.random() * 0.5))
        delay *= 2
    raise TimeoutError(
        f"TCPStore: cannot connect to {host}:{port} after {attempt} "
        f"attempt(s) within {timeout}s"
        + (f" (last error: {last_exc!r})" if last_exc is not None else ""))


class TCPStore(_StoreOps):
    """paddle.distributed.TCPStore parity: TCPStore(host, port, is_master,
    world_size, timeout), over the pure-Python server."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = _DEFAULT_TIMEOUT):
        from . import _py_store

        self.host = host
        self.is_master = is_master
        self.world_size = world_size
        self.timeout = timeout
        self._py_server = None
        if is_master:
            self._py_server = _py_store.PyStoreServer(port)
            port = self._py_server.port
        self.port = port
        self._client = _connect_with_retry(
            lambda t: _py_store.PyStoreClient(host, port, t),
            host, port, timeout)

    # ---- API (reference tcp_store.h: set/get/wait/add) ----
    def set(self, key: str, value) -> None:
        data = value if isinstance(value, bytes) else str(value).encode()
        self._client.set(key, data)

    def get(self, key: str, wait: bool = True) -> bytes:
        return self._client.get(key, wait,
                                timeout=self.timeout if wait else 0.0)

    def add(self, key: str, amount: int = 1) -> int:
        return self._client.add(key, amount)

    def wait(self, keys, timeout: Optional[float] = None) -> None:
        if isinstance(keys, str):
            keys = [keys]
        tmo = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + tmo
        for key in keys:
            self._client.wait(key, max(0.0, deadline - time.monotonic()))

    def num_keys(self) -> int:
        return self._client.num_keys()

    def delete_key(self, key: str) -> bool:
        return self._client.delete(key)

    def list_keys(self, prefix: str = "") -> List[str]:
        """Keys with the given prefix, sorted (used by the elastic membership
        registry; the reference's C++ server returns them in key order)."""
        return sorted(self._client.list_prefix(prefix))

    def __del__(self):
        try:
            if getattr(self, "_py_server", None) is not None:
                self._py_server.stop()
                self._py_server = None
        except Exception:
            pass


class FileStore(_StoreOps):
    """Single-host fallback store over a shared directory (reference has a
    libuv-free file store for tests). Full TCPStore API parity — bounded
    ``wait``/``get`` timeouts, ``delete_key``/``list_keys``/``num_keys``,
    the generation-scoped ``barrier``/``gc_generation`` helpers — so the
    elastic membership coordinator runs on either backend, and multi-agent
    tests can rendezvous through a tmpdir instead of a socket."""

    def __init__(self, path: str, world_size: int = 1,
                 timeout: float = _DEFAULT_TIMEOUT):
        self.path = path
        self.world_size = world_size
        self.timeout = timeout
        os.makedirs(path, exist_ok=True)

    _LOCK = ".lock"

    def _p(self, key: str) -> str:
        return os.path.join(self.path, key.replace("/", "%2F"))

    def set(self, key: str, value) -> None:
        data = value if isinstance(value, bytes) else str(value).encode()
        tmp = self._p(key) + f".tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._p(key))

    def get(self, key: str, wait: bool = True,
            timeout: Optional[float] = None) -> bytes:
        tmo = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + tmo
        while True:
            try:
                with open(self._p(key), "rb") as f:
                    return f.read()
            except FileNotFoundError:
                if not wait:
                    raise KeyError(key) from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"FileStore.get({key!r}): not set within {tmo}s"
                    ) from None
                time.sleep(0.02)

    def add(self, key: str, amount: int = 1) -> int:
        import fcntl

        lockp = os.path.join(self.path, self._LOCK)
        with open(lockp, "w") as lf:
            fcntl.flock(lf, fcntl.LOCK_EX)
            try:
                cur = int(self.get(key, wait=False))
            except KeyError:
                cur = 0
            new = cur + amount
            self.set(key, str(new))
            return new

    def wait(self, keys, timeout: Optional[float] = None) -> None:
        """Block until every key exists; raises TimeoutError past the bound
        (the store timeout by default) instead of wedging the caller — the
        same contract as TCPStore.wait."""
        if isinstance(keys, str):
            keys = [keys]
        tmo = self.timeout if timeout is None else timeout
        deadline = time.monotonic() + tmo
        for k in keys:
            self.get(k, wait=True,
                     timeout=max(0.0, deadline - time.monotonic()))

    def delete_key(self, key: str) -> bool:
        try:
            os.remove(self._p(key))
            return True
        except FileNotFoundError:
            return False

    def list_keys(self, prefix: str = "") -> List[str]:
        """Keys with the given prefix (used by the elastic membership
        registry). Internal lock/tmp files are invisible by construction."""
        out = []
        try:
            names = os.listdir(self.path)
        except OSError:
            return out
        for name in names:
            if name == self._LOCK or ".tmp." in name:
                continue
            key = name.replace("%2F", "/")
            if key.startswith(prefix):
                out.append(key)
        return sorted(out)

    def num_keys(self) -> int:
        return len(self.list_keys())
