"""Paged decode attention: the Hopper kernel's wrapper.

Replaces ``repro/kernels/paged_attention.py::paged_attention`` (a Pallas
TPU kernel). The CUDA source, ``csrc/paged_attention.cu``, says what bounds
it on the card and how its design answers that. Layout, as in the JAX
package:

  q:            (B, Hq, D)
  k_pages:      (n_pages, page_size, Hkv, D)  — q's dtype or fp8 e4m3
  v_pages:      (n_pages, page_size, Hkv, D)    (widened as staged)
  block_tables: (B, max_pages) int32   — per-request page ids (< 0: page 0)
  lengths:      (B,) int32             — tokens in cache, incl. the new one

``window`` (optional, > 0) keeps the last ``window`` of them, keys
[lengths - window, lengths): the JAX model's ``MaskSpec("lengths",
window)``. The Pallas kernel takes none (the JAX model decodes through
XLA); the port's decode goes through this kernel, hence the window here.

Each call is one launch: a thread-block cluster of S blocks per (b, kv-head)
splits the request's pages and merges its partials in the same kernel.
The library picks one of two device kernels from (q's dtype, D) alone: the
tensor-core one for bf16 at a D of ``TENSOR_CORE_HEAD_DIMS``, the CUDA-core
f32 one otherwise, whatever the K/V dtype.
``launches`` counts the wrapper's launches in this process and
``launches_by_variant`` splits them by device kernel (under a CUDA graph,
``ops.LaunchTally`` adds what a capture counted on each replay);
``KERNELS`` names the device kernels (as ``torch.profiler`` reports them)
by variant; ``splits`` gives S for a call's sizes. ``kernels.ops`` is the
dispatch that sends CPU tensors to ``kernels.ref`` instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (DTYPE_CODES, CudaLibrary,
                                       KV_E4M3, check_cuda_inputs,
                                       check_head_dim, kv_code, require,
                                       stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("paged_attention.cu", {
    "paged_attention_launch": [_P] * 6 + [_I] * 6 + [ctypes.c_float, _I, _I,
                                                     _I, _P],
    "paged_attention_max_group": [_I],
    "paged_attention_variant": [_I, _I],
    "paged_attention_splits": [_I] * 7,
})
KERNELS = {"cuda_core": "paged_attention_kernel",
           "tensor_core": "paged_attention_mma_kernel"}
_VARIANTS = ("cuda_core", "tensor_core")   # paged_attention_variant's codes
# head dims whose bf16 inputs go to the tensor-core kernel
TENSOR_CORE_HEAD_DIMS = (64, 128, 256)

launches = 0
launches_by_variant = dict.fromkeys(KERNELS, 0)


def splits(b: int, hq: int, hkv: int, d: int, max_pages: int,
           dtype: torch.dtype, kv_dtype: Optional[torch.dtype] = None) -> int:
    """Blocks per (b, kv-head) that a call of these sizes launches, with
    K/V in ``kv_dtype`` (default: q's ``dtype``)."""
    return LIB.lib().paged_attention_splits(
        b, hq, hkv, d, max_pages, DTYPE_CODES[dtype],
        int(kv_dtype == KV_E4M3))


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Launch the decode kernel on q's CUDA device; raises on any input the
    kernel does not take."""
    global launches
    name = "paged_attention"
    require(q.device.type == "cuda", f"{name}: q is on {q.device}, not CUDA")
    dtype = check_cuda_inputs(name, (q,), (block_tables, lengths),
                              (k_pages, v_pages))
    require(q.dim() == 3 and k_pages.dim() == 4, f"{name}: q must be "
            "(B, Hq, D) and pages (N, page_size, Hkv, D)")
    b, hq, d = q.shape
    n_pages, ps, hkv, dk = k_pages.shape
    require(v_pages.shape == k_pages.shape and dk == d,
            f"{name}: pages {tuple(k_pages.shape)} / {tuple(v_pages.shape)} "
            f"do not match q {tuple(q.shape)}")
    require(block_tables.dim() == 2 and block_tables.shape[0] == b
            and tuple(lengths.shape) == (b,),
            f"{name}: block_tables must be (B, P) and lengths (B,)")
    check_head_dim(name, d)
    require(hkv > 0 and hq % hkv == 0, f"{name}: Hq={hq} not a multiple of "
            f"Hkv={hkv}")
    lib = LIB.lib()
    require(hq // hkv <= lib.paged_attention_max_group(d),
            f"{name}: {hq // hkv} query heads per KV head exceed the "
            f"kernel's {lib.paged_attention_max_group(d)} at head_dim {d}")
    require(softcap is None or softcap > 0, f"{name}: softcap must be > 0")
    require(window is None or window > 0, f"{name}: window must be > 0")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hq, hkv, d, ps, block_tables.shape[1],
        float(softcap or 0.0), int(window or 0), dtype, kv_code(k_pages),
        stream_handle(q.device))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    launches += 1
    launches_by_variant[_VARIANTS[lib.paged_attention_variant(d, dtype)]] += 1
    return out
