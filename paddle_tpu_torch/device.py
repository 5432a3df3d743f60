"""Device choice for the port's entry points (counterpart of paddle_tpu/device/).

The port runs on the card. A caller that wants the CPU asks for it by name,
or once for all with ``set_device("cpu")``; nothing falls back to the CPU
silently.
"""
from __future__ import annotations

import torch

from .core.place import Place, _parse, get_place


def resolve_device(device=None) -> torch.device:
    """``None`` means the current place (``set_device``; the card unless set
    otherwise); a Place and the reference's names ("gpu:0") are taken too.
    Raises when CUDA is asked for (explicitly or by default) and no card is
    present."""
    if device is None:
        device = get_place()
    if isinstance(device, str) and device.split(":")[0].lower() in ("gpu", "tpu", "xpu", "npu"):
        device = _parse(device)      # the reference's device names
    if isinstance(device, Place):
        device = device.torch_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (or call set_device('cpu')) to run "
            "the plain PyTorch path")
    return dev
