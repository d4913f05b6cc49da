"""Compute ops of the port: plain torch around hand-written CUDA kernels."""
