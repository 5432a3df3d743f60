"""Framework helpers of the port (counterpart of paddle_tpu/framework/):
``io.save`` / ``io.load``."""
from .io import load, save

__all__ = ["save", "load"]
