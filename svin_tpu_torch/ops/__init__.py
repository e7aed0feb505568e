"""Kernels and closed forms: ``solve`` (B1, dense SPD solve by blocked
Cholesky) and ``hamming`` (B2, the descriptor distance matrix and the fused
matcher) hold hand-written CUDA kernels (``svin_tpu_torch/csrc``), each with
its plain PyTorch version; ``linalg3`` holds the batched 3x3 closed forms."""
