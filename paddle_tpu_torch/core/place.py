"""Device placement (counterpart of paddle_tpu/core/place.py).

The Place classes keep the reference's API surface (construction, equality,
``set_device`` / ``get_device``). A Place maps onto a ``torch.device``
(``torch_device()``, the counterpart of ``jax_device()``): ``CPUPlace`` and
the pinned places onto the CPU, every accelerator place onto the CUDA card.

The current place starts as the card (``CUDAPlace(0)``), whether or not one
is present: ``paddle_tpu_torch.device.resolve_device(None)`` returns it, and
without a card asking for it raises there. ``set_device("cpu")`` moves every
entry point that takes its device from it. The current place is one for the
process (the reference keeps one a thread, and its threads start from the
backend's default).
"""
from __future__ import annotations

import torch


class Place:
    device_type: str = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return (
            isinstance(other, Place)
            and self.device_type == other.device_type
            and self.device_id == other.device_id
            and getattr(self, "custom_device_type", None)
            == getattr(other, "custom_device_type", None)
        )

    def __hash__(self):
        return hash((self.device_type, self.device_id,
                     getattr(self, "custom_device_type", None)))

    def __repr__(self):
        custom = getattr(self, "custom_device_type", None)
        kind = f"{self.device_type}/{custom}" if custom else self.device_type
        return f"Place({kind}:{self.device_id})"

    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        # card 0 is plain "cuda", the device the entry points have always
        # resolved to
        return torch.device("cuda", self.device_id) if self.device_id else torch.device("cuda")


class CPUPlace(Place):
    device_type = "cpu"


class CUDAPlace(Place):
    device_type = "gpu"


# the reference's accelerator is the TPU; here every accelerator place is
# the CUDA card and every pinned place the host
class TPUPlace(Place):
    device_type = "gpu"


class CUDAPinnedPlace(CPUPlace):
    pass


class NPUPlace(Place):
    device_type = "gpu"


class XPUPlace(Place):
    device_type = "gpu"


class MLUPlace(Place):
    device_type = "gpu"


class IPUPlace(Place):
    device_type = "gpu"


class NPUPinnedPlace(CPUPlace):
    pass


class CustomPlace(Place):
    device_type = "gpu"

    def __init__(self, device_type="custom", device_id=0):
        super().__init__(device_id)
        self.custom_device_type = device_type


_place: Place = CUDAPlace(0)


def _parse(device) -> Place:
    if isinstance(device, Place):
        return device
    if isinstance(device, torch.device):
        return CPUPlace(0) if device.type == "cpu" else CUDAPlace(device.index or 0)
    s = str(device).lower()
    kind, _, idx = s.partition(":")
    idx = int(idx or 0)
    if kind == "cpu":
        return CPUPlace(idx)
    if kind in ("gpu", "cuda", "tpu", "xpu", "npu"):
        return CUDAPlace(idx)
    raise ValueError(f"unknown device {device!r}")


def set_device(device) -> Place:
    """set_device("gpu"), set_device("gpu:1"), set_device("cpu"), a
    ``torch.device`` or a Place; "cuda" and the reference's "tpu" mean the card."""
    global _place
    _place = _parse(device)
    return _place


def get_device() -> str:
    p = get_place()
    return f"{p.device_type}:{p.device_id}"


def get_place() -> Place:
    return _place


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def is_compiled_with_npu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_mlu() -> bool:
    return False


def is_compiled_with_ipu() -> bool:
    return False


def is_compiled_with_cinn() -> bool:
    return False


def is_compiled_with_distribute() -> bool:
    return torch.distributed.is_available()


def is_compiled_with_tpu() -> bool:
    return False


def device_count() -> int:
    return torch.cuda.device_count()
