"""``python -m paddle_tpu_torch.distributed.launch``: see ``main.py``."""
from .main import launch  # noqa: F401
