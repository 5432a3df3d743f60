"""Model-FLOPs accounting for throughput and MFU (the port's own copy of
paddle_tpu/observability/flops.py).

The convention is PaLM's appendix B: 6*N parameter FLOPs per token plus the
full causal attention-matmul term 12*L*h*s. The bench and any telemetry must
divide by the same number, or cross-checking them is meaningless.
"""
from __future__ import annotations

# Dense bf16 tensor-core peak per card, NVIDIA's H100 SXM data sheet (at the
# full 700 W power limit), in TFLOP/s.
PEAK_TFLOPS = {"h100": 989.0}


def transformer_flops_per_token(n_params: int, num_layers: int = 0,
                                hidden_size: int = 0, seq_len: int = 0) -> int:
    """Training FLOPs per token: 6*N (forward + 2x backward over every
    parameter) plus the attention-matmul term. Counts FULL attention matmuls
    even though a causal flash kernel skips about half the blocks, and no
    recompute: model FLOPs, not hardware FLOPs."""
    return 6 * n_params + 12 * num_layers * hidden_size * seq_len


def peak_flops_per_sec(card: str) -> float | None:
    """Per-card peak in FLOP/s for the MFU denominator; None for a device
    without a datasheet number here (the CPU)."""
    tf = PEAK_TFLOPS.get(card)
    return tf * 1e12 if tf is not None else None


def card_peak_flops_per_sec(device_name: str) -> float | None:
    """``peak_flops_per_sec`` of a card named ``device_name``
    (``torch.cuda.get_device_name``); None for a card without a number here."""
    return peak_flops_per_sec("h100") if "H100" in device_name else None
