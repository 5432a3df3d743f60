"""Pure-Python TCP store (counterpart of paddle_tpu/distributed/_py_store.py;
the same semantics as the reference's core/native/tcp_store.cc).

The port's only TCPStore server. Wire protocol is private to this
pair (server+client always come from the same implementation on a host because
rank 0 hosts the server) so it can stay simple: pickled request/response frames.
"""
from __future__ import annotations

import pickle
import socket
import socketserver
import struct
import threading
import time
from typing import Dict, List


def _send_frame(sock, obj) -> None:
    data = pickle.dumps(obj)
    sock.sendall(struct.pack(">I", len(data)) + data)


def _recv_frame(sock):
    hdr = b""
    while len(hdr) < 4:
        chunk = sock.recv(4 - len(hdr))
        if not chunk:
            raise ConnectionError("store connection closed")
        hdr += chunk
    (n,) = struct.unpack(">I", hdr)
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            raise ConnectionError("store connection closed")
        data += chunk
    return pickle.loads(data)


class PyStoreServer:
    def __init__(self, port: int = 0):
        self._data: Dict[str, bytes] = {}
        self._cond = threading.Condition()
        outer = self

        class Handler(socketserver.BaseRequestHandler):
            def handle(self):
                while True:
                    try:
                        req = _recv_frame(self.request)
                    except (ConnectionError, EOFError):
                        return
                    _send_frame(self.request, outer._handle(req))

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self._server = Server(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    def _handle(self, req):
        op = req["op"]
        key = req.get("key", "")
        with self._cond:
            if op == "set":
                self._data[key] = req["value"]
                self._cond.notify_all()
                return {"status": 0}
            if op == "get":
                if req.get("wait", True):
                    deadline = time.monotonic() + req.get("timeout", 900.0)
                    while key not in self._data:
                        if not self._cond.wait(min(1.0, deadline - time.monotonic())):
                            if time.monotonic() >= deadline:
                                return {"status": -1}
                if key not in self._data:
                    return {"status": -1}
                return {"status": 0, "value": self._data[key]}
            if op == "add":
                cur = int(self._data.get(key, b"0"))
                new = cur + req["delta"]
                self._data[key] = str(new).encode()
                self._cond.notify_all()
                return {"status": 0, "value": new}
            if op == "wait":
                deadline = time.monotonic() + req.get("timeout", 900.0)
                while key not in self._data:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(min(1.0, remaining)):
                        if time.monotonic() >= deadline:
                            return {"status": -1}
                return {"status": 0}
            if op == "num_keys":
                return {"status": 0, "value": len(self._data)}
            if op == "delete":
                return {"status": 0, "value": int(self._data.pop(key, None)
                                                  is not None)}
            if op == "list_prefix":
                return {"status": 0,
                        "value": [k for k in self._data if k.startswith(key)]}
        return {"status": -22}

    def stop(self):
        self._server.shutdown()
        self._server.server_close()


class PyStoreClient:
    def __init__(self, host: str, port: int, timeout: float):
        self._lock = threading.Lock()
        deadline = time.monotonic() + timeout
        while True:
            try:
                self._sock = socket.create_connection((host, port), timeout=5.0)
                self._sock.settimeout(None)
                self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"cannot connect to store {host}:{port}")
                time.sleep(0.05)

    def _call(self, **req):
        with self._lock:
            _send_frame(self._sock, req)
            return _recv_frame(self._sock)

    def set(self, key: str, value: bytes) -> None:
        self._call(op="set", key=key, value=value)

    def get(self, key: str, wait: bool = True, timeout: float = 900.0) -> bytes:
        resp = self._call(op="get", key=key, wait=wait, timeout=timeout)
        if resp["status"] != 0:
            if wait:
                raise TimeoutError(f"get({key!r}) timed out after {timeout}s")
            raise KeyError(key)
        return resp["value"]

    def add(self, key: str, delta: int) -> int:
        return self._call(op="add", key=key, delta=delta)["value"]

    def wait(self, key: str, timeout: float) -> None:
        resp = self._call(op="wait", key=key, timeout=timeout)
        if resp["status"] != 0:
            raise TimeoutError(f"wait({key!r}) timed out")

    def num_keys(self) -> int:
        return self._call(op="num_keys")["value"]

    def delete(self, key: str) -> bool:
        return bool(self._call(op="delete", key=key)["value"])

    def list_prefix(self, prefix: str) -> List[str]:
        return self._call(op="list_prefix", key=prefix)["value"]
