"""Vision of the port (counterpart of paddle_tpu/vision/): the models.
Datasets, transforms and vision ops are not ported (ROADMAP.md)."""
from . import models  # noqa: F401
