"""Hand-written Hopper kernels (counterpart of paddle_tpu/ops/pallas/).

Each kernel module holds the CUDA wrappers, their plain PyTorch versions
(taken only for tensors on the CPU) and a launch counter per kernel:
``flash_attention`` (forward, FA2 backward), ``layer_norm`` and ``lm_loss``
(the direct-call library ops, forward and backward). Sources live in
``csrc/`` and are compiled by ``_build`` at first use.
"""
