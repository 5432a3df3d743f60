"""The callbacks namespace of the port (counterpart of
paddle_tpu/callbacks.py): ``hapi/callbacks.py``'s callbacks."""
from .hapi.callbacks import (  # noqa: F401
    Callback, EarlyStopping, LRScheduler, ModelCheckpoint, ProgBarLogger,
    TelemetryCallback, VisualDL,
)

__all__ = ["Callback", "EarlyStopping", "LRScheduler", "ModelCheckpoint", "ProgBarLogger",
           "TelemetryCallback", "VisualDL"]
