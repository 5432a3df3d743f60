"""Training engines of the port (counterpart of paddle_tpu/distributed/): the
single-GPU ``TrainStepEngine``."""
from .engine import TrainStepEngine

__all__ = ["TrainStepEngine"]
