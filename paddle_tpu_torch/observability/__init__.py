"""Observability of the port (counterpart of paddle_tpu/observability/): the
model-FLOPs accounting that MFU divides by."""
from .flops import PEAK_TFLOPS, peak_flops_per_sec, transformer_flops_per_token

__all__ = ["PEAK_TFLOPS", "peak_flops_per_sec", "transformer_flops_per_token"]
