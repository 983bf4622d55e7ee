"""Kernels (attention, WKV6): Hopper CUDA kernels, their plain PyTorch
versions and the dispatch between them (``ops``)."""
