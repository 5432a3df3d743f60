"""Dtype system (counterpart of paddle_tpu/core/dtype.py).

A dtype of the port *is* a ``torch.dtype``, as one of the JAX package is an
``np.dtype``. ``convert_dtype`` takes the same string aliases as the
reference's ``_STR_ALIASES``, Python's ``float`` / ``int`` / ``bool``,
numpy dtypes and torch dtypes. The default float dtype is the package's
own (``set_default_dtype``): it is not torch's global default, which the
port leaves alone, so the models and their engines are not moved by it.
"""
from __future__ import annotations

import numpy as np
import torch

bfloat16 = torch.bfloat16
float8_e4m3fn = torch.float8_e4m3fn
float8_e5m2 = torch.float8_e5m2
float16 = torch.float16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = torch.uint16
uint32 = torch.uint32
uint64 = torch.uint64
bool_ = torch.bool
complex64 = torch.complex64
complex128 = torch.complex128

_STR_ALIASES = {
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64, "int": int64,
    "uint8": uint8, "uint16": uint16, "uint32": uint32, "uint64": uint64,
    "bool": bool_,
    "complex64": complex64, "complex128": complex128,
}

# float literals -> FP32 (set_default_dtype), int literals -> INT64
_default_float_dtype = float32


def set_default_dtype(d):
    global _default_float_dtype
    d = convert_dtype(d)
    if d not in (float16, bfloat16, float32, float64):
        raise TypeError(f"set_default_dtype only supports floating dtypes, got {d}")
    _default_float_dtype = d


def get_default_dtype():
    return _default_float_dtype


def convert_dtype(d):
    """Normalize str / torch.dtype / np.dtype / python type to a torch.dtype."""
    if d is None:
        return None
    if isinstance(d, torch.dtype):
        return d
    if isinstance(d, str):
        key = d.lower()
        if key.startswith("torch."):
            key = key[len("torch."):]
        if key not in _STR_ALIASES:
            raise TypeError(f"unsupported dtype string: {d!r}")
        return _STR_ALIASES[key]
    if d is float:
        return _default_float_dtype
    if d is int:
        return int64
    if d is bool:
        return bool_
    name = np.dtype(d).name
    if name not in _STR_ALIASES:
        raise TypeError(f"unsupported dtype: {d!r}")
    return _STR_ALIASES[name]


def is_floating(d) -> bool:
    return convert_dtype(d).is_floating_point


def is_integer(d) -> bool:
    d = convert_dtype(d)
    return not (d.is_floating_point or d.is_complex or d == bool_)


def is_complex(d) -> bool:
    return convert_dtype(d).is_complex


def is_bool(d) -> bool:
    return convert_dtype(d) == bool_


def finfo(d):
    return torch.finfo(convert_dtype(d))


def iinfo(d):
    return torch.iinfo(convert_dtype(d))
