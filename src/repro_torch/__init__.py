"""PyTorch / CUDA port of the Tropical serving stack (``repro``) for one
NVIDIA H100. Mirrors ``repro``'s module layout; imports nothing of it and
nothing of JAX. See README.md, "PyTorch / H100 port"."""
