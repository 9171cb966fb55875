"""Tensor ops of the port: mixing primitives, attention and its kernels."""
