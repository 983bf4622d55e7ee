"""RWKV-6 WKV recurrence: the Hopper kernel's wrapper.

Replaces ``repro/kernels/wkv6.py::wkv6_chunked`` (a Pallas TPU kernel) and,
on the model's path, the jnp ``wkv_chunked`` / ``wkv_scan`` / ``wkv_decode``
of ``repro/models/rwkv6.py``. The CUDA source, ``csrc/wkv6.cu``, says what
bounds it on the card and how its design answers that.

  r, k, v: (B, T, H, 64)  bf16 or f32, one dtype
  w:       (B, T, H, 64)  f32 decay in (0, 1)
  u:       (H, 64)        f32 bonus
  s0:      (B, H, 64, 64) f32 state [key, value]

returns ``(out (B, T, H, 64) f32, sT (B, H, 64, 64) f32)``. Unlike the
Pallas kernel, any T >= 1 is taken (no ``T % chunk`` assert) and the
output is f32, as the model consumes it. The library picks one of two
device kernels by T alone: a streaming one for T = 1 (the decode step) and
the chunked one otherwise. ``launches`` counts the wrapper's launches in
this process and ``launches_by_variant`` splits them by device kernel;
``KERNELS`` names the device kernels (as ``torch.profiler`` reports them)
by variant.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import (DTYPE_CODES, CudaLibrary, require,
                                       stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("wkv6.cu", {
    "wkv6_launch": [_P] * 8 + [_I] * 4 + [_P],
    "wkv6_variant": [_I],
})
HEAD_SIZE = 64          # csrc/wkv6.cu's kD
KERNELS = {"chunk": "wkv6_chunk_kernel", "decode": "wkv6_decode_kernel"}
_VARIANTS = ("chunk", "decode")          # wkv6_variant's codes

launches = 0
launches_by_variant = dict.fromkeys(KERNELS, 0)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor):
    """Launch the WKV6 kernel on r's CUDA device; raises on any input the
    kernel does not take."""
    global launches
    name = "wkv6"
    require(r.dtype in DTYPE_CODES and k.dtype == r.dtype
            and v.dtype == r.dtype,
            f"{name}: r, k, v must share one dtype, bf16 or f32 (got "
            f"{r.dtype}, {k.dtype}, {v.dtype})")
    require(all(t.dtype == torch.float32 for t in (w, u, s0)),
            f"{name}: w, u and s0 must be f32 (got {w.dtype}, {u.dtype}, "
            f"{s0.dtype})")
    require(r.dim() == 4, f"{name}: r must be (B, T, H, D)")
    b, t, h, d = r.shape
    require(d == HEAD_SIZE, f"{name}: head size {d} not supported (the "
            f"kernel takes {HEAD_SIZE})")
    require(k.shape == r.shape and v.shape == r.shape and w.shape == r.shape,
            f"{name}: r, k, v, w must share one shape {tuple(r.shape)}")
    require(tuple(u.shape) == (h, d) and tuple(s0.shape) == (b, h, d, d),
            f"{name}: u must be (H, D) and s0 (B, H, D, D)")
    require(b >= 1 and t >= 1 and h >= 1, f"{name}: empty input "
            f"{tuple(r.shape)}")
    require(r.device.type == "cuda", f"{name}: r is on {r.device}, not CUDA")
    for x in (k, v, w, u, s0):
        require(x.device == r.device, f"{name}: tensors on {x.device} and "
                f"{r.device}")
    for x in (r, k, v, w, u, s0):
        require(x.is_contiguous(), f"{name}: inputs must be contiguous")
    require(s0.data_ptr() % 16 == 0, f"{name}: s0 must be 16-byte aligned")
    lib = LIB.lib()
    out = torch.empty(r.shape, dtype=torch.float32, device=r.device)
    sT = torch.empty_like(s0)
    err = lib.wkv6_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        s0.data_ptr(), out.data_ptr(), sT.data_ptr(), b, t, h,
        DTYPE_CODES[r.dtype], stream_handle(r.device))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")
    launches += 1
    launches_by_variant[_VARIANTS[lib.wkv6_variant(t)]] += 1
    return out, sT
