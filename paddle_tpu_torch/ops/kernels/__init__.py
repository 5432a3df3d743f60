"""Hand-written Hopper kernels (counterpart of paddle_tpu/ops/pallas/).

Each kernel module holds the CUDA wrapper, its plain PyTorch version (taken
only for tensors on the CPU) and a ``launches`` counter. Sources live in
``csrc/`` and are compiled by ``_build`` at first use.
"""
