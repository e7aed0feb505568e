"""svin_tpu_torch — the PyTorch/CUDA port of the JAX/TPU SLAM estimator.

The package mirrors the JAX package's layout and names module for module,
so a reader finds each counterpart at the same path (``kinematics/quaternion.py``
in both packages, and so on). State stays NamedTuples
of tensors with the JAX package's field names and layouts; the math is
plain functions on tensors with analytic Jacobians (no autograd).

Layer map of the ported slice (the VIO backend's per-frame step):

  kinematics/   quaternion + SE(3) algebra on tensors
  cameras/      pinhole + distortion models, N-camera rig
  imu/          preintegration, propagation, IMU factor
  estimator/    window/factor tables, factors (reprojection, IMU, depth,
                sonar, priors), LM + Schur solver, FEJ marginalization
  ops/          3x3 closed forms and the two hand-written CUDA kernels:
                the dense SPD solve (``ops/solve.py``) and the Hamming
                distance matrix (``ops/hamming.py``), each with its plain
                PyTorch version beside it
  pipeline/     the two per-frame device programs (projection-gated map
                matching; optimize + marginalize + outlier prune) and the
                ``BackendStep`` module that chains them

Devices: every public entry reads its device from its input tensors or takes
an explicit ``device``. A kernel wrapper launches its CUDA kernel for a CUDA
tensor and runs its plain version only for a CPU tensor.
"""

__version__ = "0.1.0"
