"""``save`` / ``load`` of the port (counterpart of paddle_tpu/framework/io.py).

A file is a pickled nested container (dict, list, tuple) whose tensors are
stored as a payload with the fields ``dtype`` (the numpy name), ``data`` (a
numpy array) and ``bf16`` (bfloat16 is stored as float32 with the flag set).
This is the JAX package's own file:

- ``save`` writes each payload under the JAX package's class path,
  ``paddle_tpu.framework.io._TensorPayload``, by name and without importing
  it, so ``paddle_tpu.load`` reads what the port saves;
- ``load`` maps that class path, and this module's, onto this module's
  ``_TensorPayload`` through ``Unpickler.find_class``, so the port reads what
  the JAX package saves. It imports nothing of the JAX package.

``load`` returns torch tensors on ``device`` (None: the card, as every entry
point of the port; pass ``device="cpu"`` for the CPU). With
``return_numpy=True`` it returns numpy arrays; a bfloat16 tensor then comes
back as float32 (numpy has no bfloat16 of its own; the JAX package returns
an ``ml_dtypes`` array there).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from ..device import resolve_device

_PROTO = 4
#: the JAX package's payload class, as a pickle names it
_JAX_PAYLOAD = ("paddle_tpu.framework.io", "_TensorPayload")


class _TensorPayload:
    """A tensor in the file: its dtype name, its data on the host, and the
    bf16 flag (the JAX package's fields)."""

    def __init__(self, tensor: torch.Tensor):
        t = tensor.detach().cpu()
        self.dtype = str(t.dtype).replace("torch.", "")
        self.bf16 = t.dtype == torch.bfloat16
        self.data = (t.float() if self.bf16 else t).numpy()

    def to_tensor(self) -> torch.Tensor:
        t = torch.from_numpy(np.array(self.data, copy=True))
        return t.to(torch.bfloat16) if self.bf16 else t


class _Pickler(pickle._Pickler):
    """The pure-Python pickler, writing ``_TensorPayload`` under the JAX
    package's class path (the C pickler imports a class's module to check
    its path, and the port never imports the JAX package)."""

    def save_global(self, obj, name=None):
        if obj is not _TensorPayload:
            return super().save_global(obj, name)
        module, qualname = _JAX_PAYLOAD
        if self.proto >= 4:
            self.save(module)
            self.save(qualname)
            self.write(pickle.STACK_GLOBAL)
        else:
            self.write(pickle.GLOBAL + f"{module}\n{qualname}\n".encode())
        self.memoize(obj)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if name == "_TensorPayload" and module in (_JAX_PAYLOAD[0], __name__):
            return _TensorPayload
        return super().find_class(module, name)


def _pack(obj):
    if isinstance(obj, torch.Tensor):
        return _TensorPayload(obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _unpack(obj, return_numpy, device):
    if isinstance(obj, _TensorPayload):
        if return_numpy:
            return np.asarray(obj.data)
        return obj.to_tensor().to(device)
    if isinstance(obj, dict):
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, device) for v in obj)
    return obj


def save(obj, path, protocol=_PROTO, **configs):
    """Write ``obj`` (tensors in nested dicts, lists and tuples) to ``path``,
    creating its directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        _Pickler(f, protocol=protocol).dump(_pack(obj))


def load(path, return_numpy=False, device=None, **configs):
    """Read a file of either package; tensors on ``device`` (module
    docstring)."""
    dev = None if return_numpy else resolve_device(device)
    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return _unpack(obj, return_numpy, dev)
