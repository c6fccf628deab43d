"""CUDA kernel wrappers, each beside the plain PyTorch version it must equal."""
