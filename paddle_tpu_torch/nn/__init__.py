"""nn helpers of the port (counterpart of paddle_tpu/nn/): gradient clipping."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue"]
