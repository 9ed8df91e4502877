"""Pallas kernels (Triton route) for the GPU render path."""
