"""nn helpers of the port (counterpart of paddle_tpu/nn/): gradient clipping."""
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue", "clip_grad_norm_"]
