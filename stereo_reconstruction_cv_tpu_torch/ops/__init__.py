"""Tensor ops of the dense path; kernels and their plain versions in ``cuda``."""
