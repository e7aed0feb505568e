"""Kernels and closed forms: ``solve`` (B1, dense SPD solve) and ``hamming``
(B2, descriptor distance matrix) each hold a hand-written CUDA kernel
(``svin_tpu_torch/csrc``) with its plain PyTorch version; ``linalg3`` holds
the batched 3x3 closed forms."""
