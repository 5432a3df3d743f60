"""High-level API of the port (counterpart of paddle_tpu/hapi/): the
Keras-like ``Model`` (``prepare``, ``fit``, ``evaluate``, ``predict``), its
callbacks, ``summary`` and ``flops``. Reference python/paddle/hapi/."""
from .callbacks import (Callback, CallbackList, EarlyStopping, LRScheduler,  # noqa: F401
                        ModelCheckpoint, ProgBarLogger, TelemetryCallback, VisualDL,
                        config_callbacks)
from .dynamic_flops import flops
from .model import Model
from .summary import summary

__all__ = ["Model", "Callback", "CallbackList", "EarlyStopping", "LRScheduler",
           "ModelCheckpoint", "ProgBarLogger", "TelemetryCallback", "VisualDL",
           "config_callbacks", "summary", "flops"]
