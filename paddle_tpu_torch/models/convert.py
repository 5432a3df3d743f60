"""Carry weights from the JAX package's GPT, ERNIE / BERT, ResNet, ResNeXt
and LeNet into the port, and back.

Input is the JAX model's state as numpy arrays::

    numpy_state = {k: np.asarray(v._data)
                   for k, v in jax_model.state_dict().items()}

Names are the same in both packages. The JAX Linear layers store their
weight ``[in, out]`` (``F.linear`` is ``a @ w + b``); ``nn.Linear`` stores
``[out, in]``, so every Linear weight is transposed. Embeddings (``wte``,
which the LM head shares, and ``wpe``) and 1-D parameters carry over as they
are; so do convolution weights (``[out, in / groups, *k]`` in both
packages), batch norm's ``_mean`` and ``_variance`` buffers and ERNIE's
embeddings. The Linear weights of the other models are ERNIE's
``qkv_proj``, ``out_proj``, ``fc1``, ``fc2``, ``pooler``,
``mlm_transform``, ``nsp_head`` and an untied ``mlm_decoder``, ResNet's
``fc``, LeNet's ``fc.0`` to ``fc.2``, and the CTR models' (models/rec.py)
top-level ``mlp.<i>`` and ``out`` (their embeddings, the wide one
``[vocab, 1]`` too, carry over as they are). A quantized or QAT state (incubate/quantization.py; quantize the port's
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

Pipeline parallelism: ``GPTForPretrainingPipe``'s names are the JAX Pipe's
and so is its layout (stacked ``[S, Lp, ...]`` or ``[V, S, Lp, ...]``
stage leaves, ``[in, out]`` matrices), so nothing is transposed; with
``pp_size`` above one a rank takes its stage of every stacked leaf (dim 0,
dim 1 with ``virtual_stages`` V > 1), then its mp shards (the stacked
qkv per head along its last dim, fc1 by output, proj and fc2 by input,
wte and the untied ``lm_head_w`` by vocab). ``gather_to_jax(shards,
mp_size, virtual_stages)`` takes the ranks' states in (pp, mp) rank order.
``pipe_state_from_gpt`` / ``gpt_state_from_pipe`` map between
GPTForPretraining's state and the Pipe's (logical tensors, the port's
layouts), so one set of weights runs through both models.
"""
from __future__ import annotations

import re
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


# GPTForPretrainingPipe's stacked leaves, and their mp splits over the last
# dims (with the untied head's)
PIPE_STACKED = ("qkv_w", "qkv_b", "proj_w", "proj_b", "ln1_s", "ln1_b", "ln2_s", "ln2_b",
                "fc1_w", "fc1_b", "fc2_w", "fc2_b")
PIPE_MP_SPLITS = {"qkv_w": (-1, 3), "qkv_b": (-1, 3), "proj_w": (-2, 1),
                  "fc1_w": (-1, 1), "fc1_b": (-1, 1), "fc2_w": (-2, 1),
                  "lm_head_w": (-1, 1)}
# GPTForPretraining's block parameters -> the Pipe's stacked names
# (transposed: the [out, in] Linear weights)
_BLOCK_OF_PIPE = {"qkv_w": ("attn.qkv_proj.weight", True), "qkv_b": ("attn.qkv_proj.bias", False),
                  "proj_w": ("attn.out_proj.weight", True),
                  "proj_b": ("attn.out_proj.bias", False),
                  "ln1_s": ("ln1.weight", False), "ln1_b": ("ln1.bias", False),
                  "ln2_s": ("ln2.weight", False), "ln2_b": ("ln2.bias", False),
                  "fc1_w": ("mlp.fc1.weight", True), "fc1_b": ("mlp.fc1.bias", False),
                  "fc2_w": ("mlp.fc2.weight", True), "fc2_b": ("mlp.fc2.bias", False)}
_TOP_OF_PIPE = {"wte.weight": "gpt.wte.weight", "wpe.weight": "gpt.wpe.weight",
                "ln_f.weight": "gpt.ln_f.weight", "ln_f.bias": "gpt.ln_f.bias"}


def mp_split_of(name: str):
    """(dim, blocks) of parameter ``name``'s mp split in the port's layout,
    or None for a parameter every mp rank holds whole."""
    if name in PIPE_MP_SPLITS:
        return PIPE_MP_SPLITS[name]
    leaf = "." + name
    for suffix, split in _MP_SPLITS:
        if leaf.endswith(suffix):
            return split
    return None


def pp_split_of(name: str, virtual_stages: int = 1):
    """(dim, 1) of a stacked Pipe leaf's stage dim, or None."""
    if name in PIPE_STACKED:
        return (1 if virtual_stages > 1 else 0, 1)
    return None


# the Linear weights of ERNIE's heads, ResNet's fc, LeNet's fc.0 - fc.2 and
# the CTR models' tower (top-level names only: GPT's ``mlp.fc1`` is no match)
_OTHER_LINEAR_WEIGHTS = re.compile(
    r"(^|\.)(pooler|mlm_transform|nsp_head|mlm_decoder|fc(\.\d+)?)\.weight$"
    r"|^(mlp\.\d+|out)\.weight$")


def _is_linear_weight(name: str) -> bool:
    leaf = "." + name
    return (name.endswith(_LINEAR_WEIGHTS) or name == "lm_head.weight"
            or leaf.endswith(("._w_int8", ".inner.weight"))
            or _OTHER_LINEAR_WEIGHTS.search(name) is not None)


def state_from_jax(numpy_state: Dict[str, np.ndarray], mp_rank: int = 0,
                   mp_size: int = 1, pp_rank: int = 0, pp_size: int = 1,
                   virtual_stages: int = 1) -> Dict[str, torch.Tensor]:
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
        t = mp_slice(t, pp_split_of(name, virtual_stages), pp_rank, pp_size)
        t = mp_slice(t, mp_split_of(name), mp_rank, mp_size).contiguous()
        out[name] = t
    return out


def gather_to_jax(shards: List[Dict[str, torch.Tensor]], mp_size: int = None,
                  virtual_stages: int = 1) -> Dict[str, np.ndarray]:
    """The JAX model's numpy state from the ranks' port states, in (pp, mp)
    rank order (``mp_size`` of them a stage; all of them when None; one
    state at mp = pp = 1)."""
    from ..distributed.meta_parallel.mp_layers import mp_gather

    mp_size = mp_size or len(shards)
    stages = [shards[i:i + mp_size] for i in range(0, len(shards), mp_size)]
    out = {}
    for name in shards[0]:
        per_stage = [mp_gather([sd[name].detach().cpu() for sd in st], mp_split_of(name))
                     for st in stages]
        t = mp_gather(per_stage, pp_split_of(name, virtual_stages))
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
    pp = dict(pp_rank=getattr(model, "pp_rank", 0), pp_size=getattr(model, "pp_size", 1),
              virtual_stages=getattr(model, "num_virtual_stages", 1))
    model.load_state_dict(state_from_jax(numpy_state, rank, size, **pp), strict=True)
    return model


def layer_state_from_jax(module: torch.nn.Module,
                         numpy_state: Dict[str, np.ndarray]) -> torch.nn.Module:
    """Copy a JAX layer's state (``nn.Layer.state_dict()`` as numpy arrays)
    into the port's ``module`` built the same way, and return it. Every
    parameter that its layer made as the JAX one transposed (the flag that
    ``make_param`` sets: a ``Linear`` weight, under any name, such as a
    Transformer's ``self_attn.q_proj.weight`` or ``linear1.weight``) is
    transposed from the JAX ``[in, out]``; everything else (convolutions,
    transposed convolutions, norms, embeddings, biases, buffers, the RNN
    cells' ``[gates·H, in]`` weights) carries over as it is. A name the module lacks, a missing one, or a shape that
    does not fit raises."""
    transposed = {n for n, p in module.named_parameters(remove_duplicate=False)
                  if getattr(p, "_jax_transposed", False)}
    own = module.state_dict()
    unknown = sorted(set(numpy_state) - set(own))
    missing = sorted(set(own) - set(numpy_state))
    if unknown or missing:
        raise ValueError(f"layer_state_from_jax: names the module lacks {unknown}, names "
                         f"the state lacks {missing}")
    out = {}
    for name, arr in numpy_state.items():
        arr = np.asarray(arr)
        if name in transposed:
            if arr.ndim != 2:
                raise ValueError(f"{name}: expected a 2-D Linear weight, got {arr.shape}")
            arr = arr.T
        if tuple(arr.shape) != tuple(own[name].shape):
            raise ValueError(f"{name}: the JAX shape {arr.shape} does not fit the port's "
                             f"{tuple(own[name].shape)}")
        out[name] = torch.from_numpy(np.array(arr, order="C", copy=True))
    module.load_state_dict(out, strict=True)
    return module


def pipe_state_from_gpt(state: Dict[str, torch.Tensor], num_stages: int,
                        num_virtual_stages: int = 1) -> Dict[str, torch.Tensor]:
    """GPTForPretraining's state (logical tensors, the port's layout) as
    GPTForPretrainingPipe's logical state for ``num_stages`` x
    ``num_virtual_stages``: block l is layer l % Lp of logical stage
    l // Lp, stage v S + r at leaf [v, r] (V > 1) or [r]."""
    S, V = int(num_stages), int(num_virtual_stages)
    n_layers = 1 + max(int(k.split(".")[2]) for k in state if k.startswith("gpt.blocks."))
    lp = n_layers // (S * V)
    out = {pn: state[gn].clone() for pn, gn in _TOP_OF_PIPE.items()}
    if "lm_head.weight" in state:
        out["lm_head_w"] = state["lm_head.weight"].t().contiguous()
    for pn, (bn, transposed) in _BLOCK_OF_PIPE.items():
        layers = [state[f"gpt.blocks.{i}.{bn}"] for i in range(n_layers)]
        t = torch.stack([x.t() if transposed else x for x in layers])
        lead = (V, S, lp) if V > 1 else (S, lp)
        out[pn] = t.reshape(lead + t.shape[1:]).contiguous()
    return out


def gpt_state_from_pipe(state: Dict[str, torch.Tensor],
                        num_virtual_stages: int = 1) -> Dict[str, torch.Tensor]:
    """The inverse of ``pipe_state_from_gpt``."""
    n_lead = 3 if num_virtual_stages > 1 else 2
    out = {gn: state[pn].clone() for pn, gn in _TOP_OF_PIPE.items()}
    if "lm_head_w" in state:
        out["lm_head.weight"] = state["lm_head_w"].t().contiguous()
    for pn, (bn, transposed) in _BLOCK_OF_PIPE.items():
        t = state[pn]
        t = t.reshape((-1,) + t.shape[n_lead:])
        for i, x in enumerate(t):
            out[f"gpt.blocks.{i}.{bn}"] = (x.t() if transposed else x).contiguous()
    return out
