"""svin_tpu_torch — the PyTorch/CUDA port of the JAX/TPU SLAM estimator.

The package mirrors the JAX package's layout and names module for module,
so a reader finds each counterpart at the same path (``kinematics/quaternion.py``
in both packages, and so on). State stays NamedTuples
of tensors with the JAX package's field names and layouts; the math is
plain functions on tensors with analytic Jacobians (no autograd).

Layer map of the port:

  kinematics/   quaternion + SE(3) algebra on tensors
  cameras/      pinhole + distortion models, N-camera rig
  imu/          preintegration, propagation, IMU factor
  estimator/    window/factor tables, factors (reprojection, IMU, depth,
                sonar, priors), LM + Schur solver, FEJ marginalization
  ops/          3x3 closed forms and the hand-written CUDA kernels: the
                dense SPD solve (``ops/solve.py``, blocked Cholesky in one
                block up to D = 320, in a thread-block cluster up to 1024),
                the Hamming distance matrix, the fused matcher and the
                nearest codeword (``ops/hamming.py``), each with its plain
                PyTorch version beside it
  pipeline/     the engine's device programs, ``BackendStep``,
                ``VioEngine`` (serial and pipelined), ``AsyncVioEngine``,
                outputs, checkpoints, dataset sources
  loopclosure/  BoW retrieval (the nearest-codeword kernel assigns words),
                seed-free P3P verification (the fused matcher), the 4/6-DoF
                pose graph, ``LoopCloser``
  apps/         run_synchronous, run_live, train_vocabulary, evaluate,
                convert_bag

Devices: every public entry reads its device from its input tensors or takes
an explicit ``device``; ``VioEngine``, ``LoopCloser`` and the apps run on
``cuda`` unless the caller names another device. A kernel wrapper launches its CUDA kernel for a CUDA
tensor and runs its plain version only for a CPU tensor.
"""

__version__ = "0.1.0"
