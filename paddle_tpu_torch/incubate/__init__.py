"""incubate (counterpart of paddle_tpu/incubate/): LookAhead,
ModelAverage and the int8 quantization module (``incubate.quantization``).
``minimize_bfgs`` / ``minimize_lbfgs`` are not ported yet (ROADMAP.md)."""
from . import quantization  # noqa: F401
from .optimizer import LookAhead, ModelAverage

__all__ = ["LookAhead", "ModelAverage"]
