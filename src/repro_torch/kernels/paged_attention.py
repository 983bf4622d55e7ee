"""Paged decode attention: the Hopper kernel's wrapper.

Replaces ``repro/kernels/paged_attention.py::paged_attention`` (a Pallas
TPU kernel). The CUDA source, ``csrc/paged_attention.cu``, says what bounds
it on the card and how its design answers that. Layout, as in the JAX
package:

  q:            (B, Hq, D)
  k_pages:      (n_pages, page_size, Hkv, D)
  v_pages:      (n_pages, page_size, Hkv, D)
  block_tables: (B, max_pages) int32   — per-request page ids (< 0: page 0)
  lengths:      (B,) int32             — tokens in cache, incl. the new one

``launches`` counts the kernel's launches in this process; ``kernels.ops``
is the dispatch that sends CPU tensors to ``kernels.ref`` instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (CudaLibrary, check_cuda_inputs,
                                       check_head_dim, require, stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("paged_attention.cu", {
    "paged_attention_launch": [_P] * 6 + [_I] * 6 + [ctypes.c_float, _I, _P],
    "paged_attention_max_group": [_I],
})

launches = 0


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor, *,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Launch the decode kernel on q's CUDA device; raises on any input the
    kernel does not take."""
    global launches
    name = "paged_attention"
    require(q.device.type == "cuda", f"{name}: q is on {q.device}, not CUDA")
    dtype = check_cuda_inputs(name, (q, k_pages, v_pages),
                              (block_tables, lengths))
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
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, hq, hkv, d, ps, block_tables.shape[1],
        float(softcap or 0.0), dtype, stream_handle(q.device))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    launches += 1
    return out
