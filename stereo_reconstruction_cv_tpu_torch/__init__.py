"""stereo_reconstruction_cv_tpu_torch — the dense stereo path in PyTorch + CUDA.

A port of ``stereo_reconstruction_cv_tpu`` (the JAX reference, which stays
beside it) for NVIDIA Hopper GPUs: rectify -> SGBM disparity -> reprojection
-> point cloud, with hand-written CUDA kernels for the cost volume, the
semi-global sweeps with winner-take-all, and the left-right check
(``csrc/``, built with nvcc at first use). CPU tensors run the plain PyTorch
versions of the same functions.

Importing this package imports neither jax nor the CUDA toolchain.
"""

__version__ = "0.1.0"
