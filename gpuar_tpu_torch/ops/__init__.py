"""Codec kernels: the CUDA kernels' wrappers and their plain versions."""
