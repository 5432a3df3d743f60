"""Carry weights from the JAX package's GPT into the port.

Input is the JAX model's state as numpy arrays::

    numpy_state = {k: np.asarray(v._data)
                   for k, v in jax_model.state_dict().items()}

Names are the same in both packages. The JAX Linear layers store their
weight ``[in, out]`` (``F.linear`` is ``a @ w + b``); ``nn.Linear`` stores
``[out, in]``, so every Linear weight is transposed. Embeddings (``wte``,
which the LM head shares, and ``wpe``) and 1-D parameters carry over as they
are. A quantized or QAT state (incubate/quantization.py; quantize the port's
model the same way before loading) carries a QuantizedLinear's int8
``._w_int8`` and a QATLinear's ``.inner.weight`` transposed too, and the
scales, biases and activation scales as they are.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_LINEAR_WEIGHTS = (".qkv_proj.weight", ".out_proj.weight", ".fc1.weight",
                   ".fc2.weight")


def _is_linear_weight(name: str) -> bool:
    leaf = "." + name
    return (name.endswith(_LINEAR_WEIGHTS) or name == "lm_head.weight"
            or leaf.endswith(("._w_int8", ".inner.weight")))


def state_from_jax(numpy_state: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    out = {}
    for name, arr in numpy_state.items():
        arr = np.asarray(arr)
        if _is_linear_weight(name):
            if arr.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D Linear weight, got "
                                 f"shape {arr.shape}")
            arr = arr.T
        out[name] = torch.from_numpy(np.array(arr, order="C", copy=True))
    return out


def load_jax_state(model: torch.nn.Module,
                   numpy_state: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Copy the JAX weights into ``model`` (every name must match) and
    return it."""
    model.load_state_dict(state_from_jax(numpy_state), strict=True)
    return model
