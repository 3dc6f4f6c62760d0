"""The packed E-step and its CUDA kernels."""
