"""fleet of the port (counterpart of paddle_tpu/distributed/fleet/): recompute."""
from .utils import recompute

__all__ = ["recompute"]
