"""incubate (counterpart of paddle_tpu/incubate/): LookAhead and
ModelAverage. ``minimize_bfgs`` / ``minimize_lbfgs`` are not ported yet
(ROADMAP.md)."""
from .optimizer import LookAhead, ModelAverage

__all__ = ["LookAhead", "ModelAverage"]
