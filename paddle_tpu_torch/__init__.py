"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module paths (``models/gpt.py``, ``serving/engine.py``,
``ops/nn_functional.py``, ``ops/fused.py``, ``amp.py``, ``optimizer/``,
``nn/clip.py``, ``distributed/engine.py``, ``distributed/fleet/utils.py``,
``observability/flops.py``, ``core/flags.py``, ``core/monitor.py``,
``distributed/{env,collective,spawn,mesh,grad_comm}.py``,
``distributed/launch/``, ``distributed/fleet/``,
``distributed/meta_parallel/`` and ``framework/io.py``) and replaces each Pallas TPU kernel with a CUDA
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


def __getattr__(name):
    # DataParallel loads the distributed package, which ``import
    # paddle_tpu_torch`` does not need
    if name == "DataParallel":
        from .distributed.meta_parallel import DataParallel

        return DataParallel
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["resolve_device", "set_flags", "get_flags", "save", "load", "DataParallel"]
