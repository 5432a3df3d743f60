"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module paths (``models/gpt.py``, ``serving/engine.py``,
``ops/nn_functional.py``, ``ops/fused.py``, ``amp.py``, ``optimizer/``,
``nn/clip.py``, ``distributed/engine.py``, ``distributed/fleet/utils.py``,
``observability/flops.py``, ``core/flags.py``, ``core/monitor.py``,
``distributed/{env,collective,spawn,mesh,grad_comm}.py``,
``distributed/launch/``, ``distributed/fleet/``,
``distributed/meta_parallel/``, ``framework/io.py``, ``io/``, ``reader.py``,
``vision/``, ``metric/``, ``hapi/`` and ``callbacks.py``) and replaces each Pallas TPU kernel with a CUDA
kernel written for Hopper (``ops/kernels/``); ``bench.py`` is the
counterpart of the repository's bench.py (``python -m
paddle_tpu_torch.bench``) and ``tools/`` holds the port's command-line
tools. It imports
``torch`` and never ``jax`` or ``paddle_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
from .core.flags import get_flags, set_flags
from .device import resolve_device
from .framework.io import load, save


#: loaded at first use, so ``import paddle_tpu_torch`` stays light:
#: name -> (module, attribute or None for the module itself)
_LAZY = {"DataParallel": (".distributed.meta_parallel", "DataParallel"),
         "Model": (".hapi.model", "Model"), "summary": (".hapi.summary", "summary"),
         "flops": (".hapi.dynamic_flops", "flops"), "batch": (".reader", "batch"),
         **{m: ("." + m, None) for m in ("io", "reader", "metric", "callbacks", "hapi",
                                         "vision")}}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    module, attr = _LAZY[name]
    mod = importlib.import_module(module, __name__)
    return mod if attr is None else getattr(mod, attr)


__all__ = ["resolve_device", "set_flags", "get_flags", "save", "load", *_LAZY]
