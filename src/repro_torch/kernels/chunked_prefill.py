"""Chunked-prefill attention: the Hopper kernel's wrapper.

Replaces ``repro/kernels/chunked_prefill.py::chunked_prefill_attention``
(a Pallas TPU kernel). The CUDA source, ``csrc/chunked_prefill.cu``, says
what bounds it on the card and how its design answers that. A chunk of Sq
new tokens starting at per-request offset ``starts[b]`` attends to the KV
cache prefix [0, starts[b] + i]; the chunk's own K/V are already written.

  q:       (B, Sq, Hq, D)    — the chunk's queries (rope applied)
  k_cache: (B, Smax, Hkv, D)  — q's dtype, or fp8 e4m3 (widened to q's
  v_cache: (B, Smax, Hkv, D)    dtype as the kernel stages it)
  starts:  (B,) int32

Unlike the Pallas kernel, ragged Sq and Smax are masked, not asserted.
The library picks one of two device kernels from (q's dtype, D) alone: the
tensor-core one for bf16 at a D of ``TENSOR_CORE_HEAD_DIMS``, the CUDA-core
f32 one otherwise, whatever the K/V dtype. ``launches`` counts the
wrapper's launches in this process and ``launches_by_variant`` splits them
by device kernel (under a CUDA graph, ``ops.LaunchTally`` adds what a
capture counted on each replay);
``KERNELS`` names the device kernels (as ``torch.profiler`` reports them)
by variant; ``splits`` gives the blocks of a cluster that split each block
of queries' keys in a call of given sizes (more than 1 only at D = 256).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (DTYPE_CODES, CudaLibrary,
                                       check_cuda_inputs, check_head_dim,
                                       kv_code, require, stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("chunked_prefill.cu", {
    "chunked_prefill_launch": [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _I,
                                                     _I, _P],
    "chunked_prefill_max_group": [_I],
    "chunked_prefill_variant": [_I, _I],
    "chunked_prefill_splits": [_I] * 8,
})
KERNELS = {"cuda_core": "chunked_prefill_kernel",
           "tensor_core": "chunked_prefill_mma_kernel"}
_VARIANTS = ("cuda_core", "tensor_core")   # chunked_prefill_variant's codes
# head dims whose bf16 inputs go to the tensor-core kernel
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)

launches = 0
launches_by_variant = dict.fromkeys(KERNELS, 0)


def splits(b: int, sq: int, hq: int, hkv: int, d: int, smax: int,
           window: Optional[int], dtype: torch.dtype) -> int:
    """Blocks of a cluster that split each block of queries' key tiles in
    a call of these sizes."""
    return LIB.lib().chunked_prefill_splits(b, sq, hq, hkv, d, smax,
                                            int(window or 0),
                                            DTYPE_CODES[dtype])


def chunked_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, starts: torch.Tensor, *,
                              softcap: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """Launch the prefill kernel on q's CUDA device; raises on any input
    the kernel does not take."""
    global launches
    name = "chunked_prefill_attention"
    require(q.device.type == "cuda", f"{name}: q is on {q.device}, not CUDA")
    dtype = check_cuda_inputs(name, (q,), (starts,), (k_cache, v_cache))
    require(q.dim() == 4 and k_cache.dim() == 4, f"{name}: q must be "
            "(B, Sq, Hq, D) and the caches (B, Smax, Hkv, D)")
    b, sq, hq, d = q.shape
    bk, smax, hkv, dk = k_cache.shape
    require(v_cache.shape == k_cache.shape and bk == b and dk == d,
            f"{name}: caches {tuple(k_cache.shape)} / "
            f"{tuple(v_cache.shape)} do not match q {tuple(q.shape)}")
    require(tuple(starts.shape) == (b,), f"{name}: starts must be (B,)")
    check_head_dim(name, d)
    require(hkv > 0 and hq % hkv == 0, f"{name}: Hq={hq} not a multiple of "
            f"Hkv={hkv}")
    lib = LIB.lib()
    require(hq // hkv <= lib.chunked_prefill_max_group(d),
            f"{name}: {hq // hkv} query heads per KV head exceed the "
            f"kernel's {lib.chunked_prefill_max_group(d)} at head_dim {d}")
    require(softcap is None or softcap > 0, f"{name}: softcap must be > 0")
    require(window is None or window > 0, f"{name}: window must be > 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = lib.chunked_prefill_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        starts.data_ptr(), out.data_ptr(), b, sq, hq, hkv, d, smax,
        float(softcap or 0.0), int(window or 0), dtype, kv_code(k_cache),
        stream_handle(q.device))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    launches += 1
    launches_by_variant[_VARIANTS[lib.chunked_prefill_variant(d, dtype)]] += 1
    return out
