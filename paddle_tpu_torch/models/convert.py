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

Tensor parallelism: ``state_from_jax(numpy_state, mp_rank, mp_size)`` gives
rank ``mp_rank`` of ``mp_size`` its shards (the mp layers' layout,
distributed/meta_parallel/mp_layers.py): qkv by output, per head (the JAX
``[H, 3H]`` output is reshaped ``(3, nh, hd)``, so a rank's shard is its
heads of q, of k and of v: three strided column blocks of the JAX weight),
fc1 by output, out_proj and fc2 by input, wte and an untied lm_head by
vocab rows; everything else whole. ``gather_to_jax(shards)`` is the
inverse: the ranks' port states (in mp rank order) -> the JAX model's
numpy state, bit for bit.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

_LINEAR_WEIGHTS = (".qkv_proj.weight", ".out_proj.weight", ".fc1.weight",
                   ".fc2.weight")

# (name suffix, (dim, blocks)) in the port's layout (mp_layers.mp_slice)
_MP_SPLITS = ((".qkv_proj.weight", (0, 3)), (".qkv_proj.bias", (0, 3)),
              (".fc1.weight", (0, 1)), (".fc1.bias", (0, 1)),
              (".out_proj.weight", (1, 1)), (".fc2.weight", (1, 1)),
              (".wte.weight", (0, 1)), (".lm_head.weight", (0, 1)))


def mp_split_of(name: str):
    """(dim, blocks) of parameter ``name``'s mp split in the port's layout,
    or None for a parameter every mp rank holds whole."""
    leaf = "." + name
    for suffix, split in _MP_SPLITS:
        if leaf.endswith(suffix):
            return split
    return None


def _is_linear_weight(name: str) -> bool:
    leaf = "." + name
    return (name.endswith(_LINEAR_WEIGHTS) or name == "lm_head.weight"
            or leaf.endswith(("._w_int8", ".inner.weight")))


def state_from_jax(numpy_state: Dict[str, np.ndarray], mp_rank: int = 0,
                   mp_size: int = 1) -> Dict[str, torch.Tensor]:
    from ..distributed.meta_parallel.mp_layers import mp_slice

    out = {}
    for name, arr in numpy_state.items():
        arr = np.asarray(arr)
        if _is_linear_weight(name):
            if arr.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D Linear weight, got "
                                 f"shape {arr.shape}")
            arr = arr.T
        t = torch.from_numpy(np.array(arr, order="C", copy=True))
        if mp_size > 1:
            t = mp_slice(t, mp_split_of(name), mp_rank, mp_size).contiguous()
        out[name] = t
    return out


def gather_to_jax(shards: List[Dict[str, torch.Tensor]]) -> Dict[str, np.ndarray]:
    """The JAX model's numpy state from the mp ranks' port states (in mp
    rank order; one state at mp = 1)."""
    from ..distributed.meta_parallel.mp_layers import mp_gather

    out = {}
    for name in shards[0]:
        t = mp_gather([sd[name].detach().cpu() for sd in shards], mp_split_of(name))
        arr = t.numpy()
        out[name] = np.ascontiguousarray(arr.T if _is_linear_weight(name) else arr)
    return out


def load_jax_state(model: torch.nn.Module,
                   numpy_state: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Copy the JAX weights into ``model`` (every name must match; a model
    built over mp > 1 ranks takes its rank's shards) and return it."""
    from ..distributed.meta_parallel.mp_layers import mp_info

    size = getattr(model, "mp_size", 1)
    rank = mp_info(model.mp_group)[1] if size > 1 else 0
    model.load_state_dict(state_from_jax(numpy_state, rank, size), strict=True)
    return model
