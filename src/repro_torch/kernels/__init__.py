"""Attention kernels: Hopper CUDA kernels, their plain PyTorch versions
and the dispatch between them (``ops``)."""
