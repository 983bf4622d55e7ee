"""Chunked-prefill attention: the Hopper kernel's wrapper.

Replaces ``repro/kernels/chunked_prefill.py::chunked_prefill_attention``
(a Pallas TPU kernel). The CUDA source, ``csrc/chunked_prefill.cu``, says
what bounds it on the card and how its design answers that. A chunk of Sq
new tokens starting at per-request offset ``starts[b]`` attends to the KV
cache prefix [0, starts[b] + i]; the chunk's own K/V are already written.

  q:       (B, Sq, Hq, D)    — the chunk's queries (rope applied)
  k_cache: (B, Smax, Hkv, D)
  v_cache: (B, Smax, Hkv, D)
  starts:  (B,) int32

Unlike the Pallas kernel, ragged Sq and Smax are masked, not asserted.
``launches`` counts the kernel's launches in this process.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (CudaLibrary, check_cuda_inputs,
                                       check_head_dim, require, stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("chunked_prefill.cu", {
    "chunked_prefill_launch": [_P] * 5 + [_I] * 6 + [ctypes.c_float, _I, _I,
                                                     _P],
    "chunked_prefill_max_group": [_I],
})

launches = 0


def chunked_prefill_attention(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, starts: torch.Tensor, *,
                              softcap: Optional[float] = None,
                              window: Optional[int] = None) -> torch.Tensor:
    """Launch the prefill kernel on q's CUDA device; raises on any input
    the kernel does not take."""
    global launches
    name = "chunked_prefill_attention"
    require(q.device.type == "cuda", f"{name}: q is on {q.device}, not CUDA")
    dtype = check_cuda_inputs(name, (q, k_cache, v_cache), (starts,))
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
        float(softcap or 0.0), int(window or 0), dtype,
        stream_handle(q.device))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    launches += 1
    return out
