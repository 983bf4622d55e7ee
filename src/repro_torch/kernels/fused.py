"""The fused pointwise passes between a dense block's matrix products: the
Hopper kernels' wrapper.

Replaces no TPU kernel (the JAX package leaves this work to XLA, which
fuses it); the CUDA source, ``csrc/fused.cu``, says what bounds it on the
card and how its design answers that. Three passes, each the one kernel of
a gap between GEMMs, each held to its plain version in ``kernels.ref``:

  add_rms_norm(x, r, w, eps)        (B, S, d): the residual sum x + r in
                                    x's dtype and ``rms_norm`` of it with
                                    the ``1 + w`` scale; r None: the norm
                                    of x alone (the sum is x)
  rope_cache_write(q, k, v, cos, sin, k_cache, v_cache, write_pos,
                   bq, bk, bv)      q (B, S, Hq, D), k, v (B, S, Hkv, D):
                                    the biases added, q and k rotated by
                                    ``rope_tables``' (cos, sin); returns q,
                                    writes k and v into the (B, Smax, Hkv,
                                    D) caches at clamp(write_pos, 0,
                                    Smax - S), e4m3 or the working dtype
  gated_act(g, u, kind)             act(g) * u, "silu" or "gelu" (tanh)

Working dtype bf16 or f32, one for all inputs but the f32 rope tables and
an e4m3 cache. ``launches`` counts the wrapper's launches in this process
and ``launches_by_variant`` splits them by pass (under a CUDA graph,
``ops.LaunchTally`` adds what a capture counted on each replay);
``KERNELS`` names the device kernels (as ``torch.profiler`` reports them)
by variant. ``kernels.ops`` is the dispatch that sends CPU tensors to
``kernels.ref`` instead. The ``check_*`` functions raise on what a kernel
does not take, on any device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (CudaLibrary, check_cuda_inputs,
                                       kv_code, require, stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("fused.cu", {
    "add_rms_norm_launch": [_P] * 5 + [_I, _I, ctypes.c_float, _I, _P],
    "rope_cache_write_launch": [_P] * 12 + [_I] * 8 + [_P],
    "gated_act_launch": [_P] * 3 + [ctypes.c_longlong, _I, _I, _P],
})
KERNELS = {"add_rms_norm": "add_rms_norm_kernel",
           "rms_norm": "add_rms_norm_kernel",
           "rope_cache_write": "rope_cache_write_kernel",
           "rope_cache_write_e4m3": "rope_cache_write_kernel",
           "gated_silu": "gated_act_kernel",
           "gated_gelu": "gated_act_kernel"}
ACTIVATIONS = ("silu", "gelu")          # gated_act_launch's kind codes

launches = 0
launches_by_variant = dict.fromkeys(KERNELS, 0)


def _count(variant: str) -> None:
    global launches
    launches += 1
    launches_by_variant[variant] += 1


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")


def _on_cuda(name: str, t: torch.Tensor) -> None:
    require(t.device.type == "cuda", f"{name}: input is on {t.device}, not "
                                     "CUDA")


def check_add_rms_norm(x, r, w) -> int:
    """The dtype code of an ``add_rms_norm`` call, or ValueError."""
    name = "add_rms_norm"
    floats = (x, w) if r is None else (x, r, w)
    dtype = check_cuda_inputs(name, floats, ())
    require(x.dim() >= 1 and w.dim() == 1 and w.shape[0] == x.shape[-1],
            f"{name}: scale {tuple(w.shape)} does not match x "
            f"{tuple(x.shape)} (the scale is (d,))")
    require(r is None or r.shape == x.shape,
            f"{name}: residual {tuple(r.shape) if r is not None else ()} "
            f"is not x's shape {tuple(x.shape)}")
    return dtype


def add_rms_norm(x: torch.Tensor, r: Optional[torch.Tensor],
                 w: torch.Tensor, eps: float):
    """Launch the norm pass on x's CUDA device: (x + r, the norm of it) in
    x's dtype, or (x, the norm of x) when r is None."""
    name = "add_rms_norm"
    _on_cuda(name, x)
    dtype = check_add_rms_norm(x, r, w)
    d = x.shape[-1]
    out = torch.empty_like(x)
    total = torch.empty_like(x) if r is not None else x
    if x.numel() == 0:
        return total, out
    _launched(name, LIB.lib().add_rms_norm_launch(
        x.data_ptr(), 0 if r is None else r.data_ptr(), w.data_ptr(),
        0 if r is None else total.data_ptr(), out.data_ptr(),
        x.numel() // d, d, float(eps), dtype, stream_handle(x.device)))
    _count("rms_norm" if r is None else "add_rms_norm")
    return total, out


def _rows(t: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """A rope table (cos or sin), broadcast over the heads as ``rotate``
    broadcasts it, as the kernel reads it: (B * S, D/2) rows."""
    return t.expand(b, s, 1, t.shape[-1]).reshape(b * s, t.shape[-1])


def check_rope_cache_write(q, k, v, cos, sin, k_cache, v_cache, write_pos,
                           bq=None, bk=None, bv=None) -> int:
    """The dtype code of a ``rope_cache_write`` call, or ValueError."""
    name = "rope_cache_write"
    biases = tuple(t for t in (bq, bk, bv) if t is not None)
    require(len(biases) in (0, 3), f"{name}: give all three biases or none")
    dtype = check_cuda_inputs(name, (q, k, v, *biases), (write_pos,),
                              (k_cache, v_cache))
    require(q.dim() == 4 and k.dim() == 4 and k_cache.dim() == 4,
            f"{name}: q, k, v must be (B, S, H, D) and the caches "
            "(B, Smax, Hkv, D)")
    b, s, hq, d = q.shape
    hkv, smax = k.shape[2], k_cache.shape[1]
    require(k.shape == v.shape == (b, s, hkv, d),
            f"{name}: k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
            f"q {tuple(q.shape)}")
    require(k_cache.shape == v_cache.shape == (b, smax, hkv, d),
            f"{name}: caches {tuple(k_cache.shape)} / "
            f"{tuple(v_cache.shape)} do not match k {tuple(k.shape)}")
    require(d % 2 == 0 and 0 < s <= smax, f"{name}: head_dim {d} must be "
            f"even and the {s} new rows fit the cache's {smax}")
    require(tuple(write_pos.shape) == (b,), f"{name}: write_pos must be (B,)")
    for t in (cos, sin):
        require(t.dtype == torch.float32 and t.shape[-1] == d // 2
                and t.dim() == 4 and t.shape[-2] == 1,
                f"{name}: rope tables must be f32 (.., S, 1, D/2), got "
                f"{t.dtype} {tuple(t.shape)}")
        require(torch.broadcast_shapes(t.shape, (b, s, 1, d // 2))
                == (b, s, 1, d // 2),
                f"{name}: rope table {tuple(t.shape)} does not broadcast to "
                f"{(b, s, 1, d // 2)}")
    if biases:
        require(bq.shape == (hq, d) and bk.shape == bv.shape == (hkv, d),
                f"{name}: biases must be (Hq, D), (Hkv, D), (Hkv, D)")
    return dtype


def rope_cache_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     cos: torch.Tensor, sin: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     write_pos: torch.Tensor, bq=None, bk=None,
                     bv=None) -> torch.Tensor:
    """Launch the rope and cache-write pass on q's CUDA device: the
    rotated q; k and v go into the caches, in place."""
    name = "rope_cache_write"
    _on_cuda(name, q)
    dtype = check_rope_cache_write(q, k, v, cos, sin, k_cache, v_cache,
                                   write_pos, bq, bk, bv)
    b, s, hq, d = q.shape
    hkv, smax = k.shape[2], k_cache.shape[1]
    cos, sin = _rows(cos, b, s), _rows(sin, b, s)
    for t in (cos, sin):
        require(t.data_ptr() % 16 == 0, f"{name}: rope tables must be "
                                        "16-byte aligned")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    kv = kv_code(k_cache)
    _launched(name, LIB.lib().rope_cache_write_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), *(0 if t is None else t.data_ptr()
                          for t in (bq, bk, bv)),
        out.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        write_pos.data_ptr(), b, s, hq, hkv, d, smax, dtype, kv,
        stream_handle(q.device)))
    _count("rope_cache_write_e4m3" if kv else "rope_cache_write")
    return out


def check_gated_act(g, u, kind: str) -> int:
    """The dtype code of a ``gated_act`` call, or ValueError."""
    name = "gated_act"
    require(kind in ACTIVATIONS, f"{name}: activation {kind!r} is not one "
            f"of {ACTIVATIONS}")
    dtype = check_cuda_inputs(name, (g, u), ())
    require(g.shape == u.shape, f"{name}: g {tuple(g.shape)} and u "
            f"{tuple(u.shape)} differ")
    return dtype


def gated_act(g: torch.Tensor, u: torch.Tensor, kind: str) -> torch.Tensor:
    """Launch the gated activation on g's CUDA device: act(g) * u."""
    name = "gated_act"
    _on_cuda(name, g)
    dtype = check_gated_act(g, u, kind)
    out = torch.empty_like(g)
    if g.numel() == 0:
        return out
    _launched(name, LIB.lib().gated_act_launch(
        g.data_ptr(), u.data_ptr(), out.data_ptr(), g.numel(),
        ACTIVATIONS.index(kind), dtype, stream_handle(g.device)))
    _count(f"gated_{kind}")
    return out
