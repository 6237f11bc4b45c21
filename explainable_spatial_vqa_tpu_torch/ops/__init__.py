"""Attention, the fused encoder block, and the build of their CUDA kernels."""
