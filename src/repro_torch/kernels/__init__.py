"""Kernels of the PyTorch port: CUDA wrappers, their plain versions, dispatch."""
