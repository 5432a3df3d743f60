"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module paths (``models/gpt.py``, ``serving/engine.py``,
``ops/nn_functional.py``, ``ops/fused.py``, ``amp.py``, ``optimizer/``,
``nn/clip.py``, ``distributed/engine.py``, ``distributed/fleet/utils.py``,
``observability/flops.py``, ``core/flags.py``, ``core/monitor.py``,
``distributed/{env,collective,spawn,mesh,grad_comm}.py``,
``distributed/launch/``, ``distributed/fleet/``,
``distributed/meta_parallel/``, ``framework/io.py``, ``io/``, ``reader.py``,
``vision/``, ``text/``, ``metric/``, ``hapi/`` and ``callbacks.py``) and replaces each Pallas TPU kernel with a CUDA
kernel written for Hopper (``ops/kernels/``); ``bench.py`` is the
counterpart of the repository's bench.py (``python -m
paddle_tpu_torch.bench``) and ``tools/`` holds the port's command-line
tools. It imports
``torch`` and never ``jax`` or ``paddle_tpu``.

The top level is the tensor API of ``paddle_tpu/__init__.py``: the dtype
names (``torch.dtype``s), the places and ``set_device``, ``seed`` and the
RNG state, ``grad`` / ``no_grad`` and the grad modes, and every op of
``ops/`` (creation, math, reduction, manipulation, linalg, attribute,
activation) as functions on ``torch.Tensor``; ``linalg`` is also
``paddle_tpu_torch.linalg``. ``Tensor`` is ``torch.Tensor``: no methods are
attached to it (``ops/__init__.py``).

Entry points and creation ops run on ``cuda`` unless the caller passes
``device="cpu"`` (``place=``) or calls ``set_device("cpu")``; on the CPU
every kernel wrapper takes its plain PyTorch version.
"""
import sys as _sys

import torch as _torch

from .core.dtype import (
    bfloat16, bool_, complex64, complex128, convert_dtype, finfo, float16,
    float32, float64, get_default_dtype, iinfo, int8, int16, int32, int64,
    set_default_dtype, uint8,
)
from .core.place import (
    CPUPlace, CUDAPinnedPlace, CUDAPlace, CustomPlace, IPUPlace, MLUPlace,
    NPUPlace, NPUPinnedPlace, Place, TPUPlace, XPUPlace, device_count,
    get_device, get_place, is_compiled_with_cinn, is_compiled_with_cuda,
    is_compiled_with_distribute, is_compiled_with_ipu, is_compiled_with_mlu,
    is_compiled_with_npu, is_compiled_with_rocm, is_compiled_with_tpu,
    is_compiled_with_xpu, set_device,
)
from .core.random import get_rng_state, seed, set_rng_state
from .core.flags import get_flags, set_flags
from .core.autograd import enable_grad, grad, is_grad_enabled, no_grad, set_grad_enabled
from .device import resolve_device
from .framework.io import load, save
from .ops import *  # noqa: F401,F403
from .ops import __all__ as _ops_all
from .ops import linalg
from . import autograd, amp  # noqa: F401

_sys.modules[__name__ + ".linalg"] = linalg   # importable paddle_tpu_torch.linalg

# the reference's CUDA RNG state API: every device's generator
get_cuda_rng_state = get_rng_state
set_cuda_rng_state = set_rng_state

Tensor = _torch.Tensor
dtype = _torch.dtype

# dygraph is the only mode; the static switches are kept for the API
_static_mode = False


def enable_static():
    global _static_mode
    _static_mode = True


def disable_static(place=None):
    global _static_mode
    _static_mode = False
    if place is not None:
        set_device(place)


def in_dynamic_mode():
    return not _static_mode


def is_grad_enabled_():  # legacy alias
    return is_grad_enabled()


def set_printoptions(precision=None, threshold=None, edgeitems=None, sci_mode=None,
                     linewidth=None):
    _torch.set_printoptions(precision=precision, threshold=threshold, edgeitems=edgeitems,
                            linewidth=linewidth, sci_mode=sci_mode)


def disable_signal_handler():
    """No-op: no signal handlers are installed, so there is nothing to disable."""


def tolist(x):
    return x.tolist()


def tanh_(x):
    return x.tanh_()


def squeeze_(x, axis=None, name=None):
    if axis is None:
        return x.squeeze_()
    axis = [axis] if isinstance(axis, int) else list(axis)
    return x.squeeze_(tuple(a for a in axis if x.shape[a] == 1))


def unsqueeze_(x, axis, name=None):
    from .ops.manipulation import _expand_axes

    for a in _expand_axes(x.dim(), axis):
        x.unsqueeze_(a)
    return x


def scatter_(x, index, updates, overwrite=True, name=None):
    """``scatter`` written into ``x``."""
    idx = index.reshape(-1).long()
    u = updates.to(x.dtype)
    if overwrite:
        return x.index_put_((idx,), u)
    x.index_fill_(0, idx, 0)
    return x.index_put_((idx,), u, accumulate=True)


#: loaded at first use, so ``import paddle_tpu_torch`` stays light:
#: name -> (module, attribute or None for the module itself)
_LAZY = {"DataParallel": (".distributed.meta_parallel", "DataParallel"),
         "Model": (".hapi.model", "Model"), "summary": (".hapi.summary", "summary"),
         "flops": (".hapi.dynamic_flops", "flops"), "batch": (".reader", "batch"),
         "ParamAttr": (".nn.layer", "ParamAttr"),
         "create_parameter": (".nn.layer", "create_parameter"),
         **{m: ("." + m, None) for m in ("io", "reader", "metric", "callbacks", "hapi",
                                         "vision", "nn", "optimizer", "distributed",
                                         "incubate", "jit", "regularizer", "models",
                                         "serving", "observability", "text")}}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module, attr = _LAZY[name]
    mod = importlib.import_module(module, __name__)
    return mod if attr is None else getattr(mod, attr)


bool = bool_  # paddle.bool

__all__ = ["resolve_device", "set_flags", "get_flags", "save", "load", "linalg", "autograd",
           "amp", "Tensor", "dtype", "bool", "bfloat16", "bool_", "complex64", "complex128",
           "convert_dtype", "finfo", "float16", "float32", "float64", "get_default_dtype",
           "iinfo", "int8", "int16", "int32", "int64", "set_default_dtype", "uint8",
           "CPUPlace", "CUDAPinnedPlace", "CUDAPlace", "CustomPlace", "IPUPlace", "MLUPlace",
           "NPUPlace", "NPUPinnedPlace", "Place", "TPUPlace", "XPUPlace", "device_count",
           "get_device", "get_place", "set_device", "get_rng_state", "set_rng_state", "seed",
           "get_cuda_rng_state", "set_cuda_rng_state", "enable_grad", "grad",
           "is_grad_enabled", "no_grad", "set_grad_enabled", "enable_static",
           "disable_static", "in_dynamic_mode", "set_printoptions", "disable_signal_handler",
           "tolist", "tanh_", "squeeze_", "unsqueeze_", "scatter_",
           *[n for n in globals() if n.startswith("is_compiled_with_")], *_ops_all, *_LAZY]
