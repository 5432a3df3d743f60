"""Tensor functions of the port (counterpart of paddle_tpu/ops/)."""
