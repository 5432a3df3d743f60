"""Runnable examples of the port (counterpart of the repository's
examples/): ``python -m paddle_tpu_torch.examples.<name>``."""
