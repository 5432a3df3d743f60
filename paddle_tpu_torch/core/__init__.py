"""Runtime flags and counters of the port (counterpart of paddle_tpu/core/:
``flags.py`` and ``monitor.py``)."""
from . import flags, monitor  # noqa: F401
