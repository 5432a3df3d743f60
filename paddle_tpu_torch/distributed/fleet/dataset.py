"""Fleet datasets: InMemoryDataset and QueueDataset over the port's native
``data_feed`` library (counterpart of paddle_tpu/distributed/fleet/dataset.py).

Reference: python/paddle/distributed/fleet/dataset/dataset.py (InMemoryDataset
:init/_init_distributed_settings/load_into_memory/global_shuffle, QueueDataset)
backed by the C++ MultiSlotDataset/InMemoryDataFeed (data_set.h:47,
data_feed.h:966). Same split here: core/native/data_feed.cc (the JAX
package's source byte for byte) parses the MultiSlot files on host threads,
holds the records, shuffles them from a seed and emits CSR batches; this
module is the configuration and iteration surface. The records stay on the
host: the trainer moves each batch to its device.

Batches are dicts by slot name: a sparse (uint64 id) slot as ``(values,
offsets)`` numpy arrays, a dense float slot whose rows all have one width
as a ``[batch, dim]`` float32 array (ragged float slots as ``(values,
offsets)`` too). The same files, slots, batch size and shuffle seed give the
JAX package's batches exactly.
"""
from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_U64P = ctypes.POINTER(ctypes.c_uint64)
_F32P = ctypes.POINTER(ctypes.c_float)
_I64P = ctypes.POINTER(ctypes.c_longlong)


class _NativeFeed:
    """One handle of the native feed (raises when it cannot be built)."""

    def __init__(self, types: str):
        from ...core.native import load_library

        lib = load_library("data_feed")
        lib.df_create.restype = ctypes.c_int
        lib.df_create.argtypes = [ctypes.c_int, ctypes.c_char_p]
        lib.df_load.restype = ctypes.c_longlong
        lib.df_load.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.df_size.restype = ctypes.c_longlong
        lib.df_size.argtypes = [ctypes.c_int]
        lib.df_shuffle.argtypes = [ctypes.c_int, ctypes.c_longlong]
        lib.df_begin.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.df_next.restype = ctypes.c_longlong
        lib.df_next.argtypes = [ctypes.c_int]
        lib.df_slot_vals.restype = ctypes.c_longlong
        lib.df_slot_vals.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.df_slot_copy_u.argtypes = [ctypes.c_int, ctypes.c_int, _U64P, _I64P]
        lib.df_slot_copy_f.argtypes = [ctypes.c_int, ctypes.c_int, _F32P, _I64P]
        lib.df_destroy.argtypes = [ctypes.c_int]
        self._lib = lib
        self._h = lib.df_create(len(types), types.encode())
        if self._h < 0:
            self._h = None
            raise RuntimeError("df_create failed (slot/type mismatch)")

    def load(self, files: Sequence[str], nthreads: int) -> int:
        return self._lib.df_load(self._h, ",".join(files).encode(), nthreads)

    def size(self) -> int:
        return self._lib.df_size(self._h)

    def shuffle(self, seed: int):
        self._lib.df_shuffle(self._h, seed)

    def batches(self, batch_size: int, slots: List[Tuple[str, str]]):
        """Yield every batch of the records held, in their current order."""
        self._lib.df_begin(self._h, batch_size)
        while True:
            rows = self._lib.df_next(self._h)
            if rows <= 0:
                return
            out: Dict[str, object] = {}
            for i, (name, typ) in enumerate(slots):
                vals, offs = self._slot(i, typ, rows)
                widths = np.diff(offs)
                if typ == "f" and len(widths) and (widths == widths[0]).all():
                    out[name] = vals.reshape(rows, -1)
                else:
                    out[name] = (vals, offs)
            yield out

    def _slot(self, idx: int, typ: str, rows: int):
        n = self._lib.df_slot_vals(self._h, idx)
        offs = np.zeros(rows + 1, np.int64)
        offs_p = offs.ctypes.data_as(_I64P)
        if typ == "u":
            vals = np.zeros(max(n, 1), np.uint64)
            self._lib.df_slot_copy_u(self._h, idx, vals.ctypes.data_as(_U64P), offs_p)
        else:
            vals = np.zeros(max(n, 1), np.float32)
            self._lib.df_slot_copy_f(self._h, idx, vals.ctypes.data_as(_F32P), offs_p)
        return vals[:n], offs

    def destroy(self):
        if self._h is not None:
            self._lib.df_destroy(self._h)
            self._h = None


class DatasetBase:
    """Configuration shared by the two datasets (reference DatasetBase.init:
    batch_size, thread_num, use_var, pipe_command ...)."""

    def __init__(self):
        self._batch_size = 1
        self._thread_num = 1
        self._slots: List[Tuple[str, str]] = []  # (name, 'u' | 'f')
        self._filelist: List[str] = []
        self._feed: Optional[_NativeFeed] = None

    def init(self, batch_size=1, thread_num=1, use_var=None, fs_name="",
             fs_ugi="", pipe_command="cat", download_cmd="cat",
             input_type=0, **kwargs):
        self._batch_size = batch_size
        self._thread_num = thread_num
        if use_var:
            self.set_use_var(use_var)
        return self

    @staticmethod
    def _var_slot(v):
        """(name, kind) pairs, dicts, or tensors (an integer dtype is sparse)."""
        if isinstance(v, tuple):
            return (v[0], "u" if v[1] in ("u", "sparse", "int64") else "f")
        if isinstance(v, dict):
            return (v["name"], "u" if v.get("sparse") else "f")
        name = getattr(v, "name", str(id(v)))
        dt = str(getattr(v, "dtype", "float32"))
        return (name, "u" if "int" in dt else "f")

    def set_filelist(self, filelist: Sequence[str]):
        self._filelist = list(filelist)

    def set_batch_size(self, batch_size: int):
        self._batch_size = batch_size

    def set_thread(self, thread_num: int):
        self._thread_num = thread_num

    def set_use_var(self, use_var):
        self._slots = [self._var_slot(v) for v in use_var]

    def _types(self) -> str:
        return "".join(t for _, t in self._slots)

    def _ensure_feed(self) -> _NativeFeed:
        if self._feed is None:
            self._feed = _NativeFeed(self._types())
        return self._feed

    def __iter__(self):
        return self._ensure_feed().batches(self._batch_size, self._slots)

    def release_memory(self):
        if self._feed is not None:
            self._feed.destroy()
            self._feed = None


class InMemoryDataset(DatasetBase):
    """Load everything, shuffle, iterate (reference InMemoryDataset)."""

    def load_into_memory(self):
        if not self._filelist:
            raise ValueError("call set_filelist() first")
        n = self._ensure_feed().load(self._filelist, self._thread_num)
        if n < 0:
            raise RuntimeError("data feed load failed")
        return n

    def get_memory_data_size(self) -> int:
        return self._ensure_feed().size()

    def global_shuffle(self, fleet=None, thread_num=12, seed=None):
        """Shuffle the records held from ``seed`` (a random one when None).
        On one host: with a fleet handle the reference exchanges records
        across trainers; here each trainer shuffles its own shard (the
        launcher splits the filelist per trainer)."""
        if seed is None:
            seed = int.from_bytes(os.urandom(4), "little")
        self._ensure_feed().shuffle(seed)

    def local_shuffle(self, seed=None):
        self.global_shuffle(seed=seed)


class QueueDataset(DatasetBase):
    """Streaming iteration: each file is parsed when the iteration reaches
    it, not held resident (reference QueueDataset), by the same native
    parser."""

    def __iter__(self):
        for f in self._filelist:
            feed = _NativeFeed(self._types())
            try:
                feed.load([f], self._thread_num)
                yield from feed.batches(self._batch_size, self._slots)
            finally:
                feed.destroy()
