"""stereo_reconstruction_cv_tpu_torch — the stereo pipeline in PyTorch + CUDA.

A port of ``stereo_reconstruction_cv_tpu`` (the JAX reference, which stays
beside it) for NVIDIA Hopper GPUs: a raw pair -> SIFT or learned (XFeat-style
net, shipped weights) matches, F, E, pose -> rectify -> SGBM disparity ->
reprojection -> point cloud (the sparse geometry and the net in torch ops),
with hand-written CUDA kernels for the cost volume, the
semi-global sweeps with winner-take-all, the left-right check and the
speckle filter (``csrc/``, built with nvcc at first use). CPU tensors run the plain PyTorch
versions of the same functions.

Importing this package imports neither jax nor the CUDA toolchain.
"""

__version__ = "0.1.0"
