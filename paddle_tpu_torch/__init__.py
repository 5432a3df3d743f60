"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu.

The JAX package ``paddle_tpu`` is the reference; this package mirrors its
module paths (``models/gpt.py``, ``serving/engine.py``,
``ops/nn_functional.py``, ``ops/fused.py``, ``amp.py``, ``optimizer/``,
``nn/clip.py``, ``distributed/engine.py``, ``distributed/fleet/utils.py``,
``observability/flops.py``, ``core/flags.py``, ``core/monitor.py``,
``distributed/{env,collective,spawn,mesh,grad_comm}.py``,
``distributed/launch/`` and ``distributed/fleet/``) and replaces each Pallas TPU kernel with a CUDA
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

__all__ = ["resolve_device", "set_flags", "get_flags"]
