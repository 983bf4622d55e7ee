"""Routed expert products of a single-card mixture-of-experts layer: the
Hopper kernels' wrapper.

Replaces no TPU kernel (the JAX package's ``apply_moe_reference`` runs every
token through every expert as dense XLA dots); the CUDA source,
``csrc/moe_experts.cu``, says what bounds it on the card and how its design
answers that. One call is four launches a chunk of tokens, each counted as
a variant:

  lists      each held expert's count and offset, the held assignments of
             the live tokens sorted stably by (expert, token), and each
             (token, j)'s place in that list or -1
  gate_up    h = act(x w_gate) * (x w_up), a held expert's tokens at a time
             (an expert no live token picked reads no weight)
  down       y = h w_down
  combine    out[t] = sum_j gate[t, j] * y[place[t, j]] in f32, in x's dtype

Inputs: x (T, d) bf16 or f32; the held tables w_gate, w_up (E, d, f) and
w_down (E, f, d) in x's dtype, global ids ``first`` .. ``first + E - 1`` of
the router's ``experts``; the routes' gates (T, k) f32 and ids (T, k)
int64 (global; rows contiguous); ``live`` (T,) bool or None for every row.
bf16 runs the tensor cores and takes d and f in multiples of ``ALIGN``
(16-byte rows); f32 runs the CUDA cores and takes any d and f; E is at
most ``MAX_HELD``. The grids depend on T, E, d and f alone and nothing is
read back, so a call captures into a CUDA graph. Tokens run in chunks whose
scratch, h (chunk x k, f) and y (chunk x k, d), stays within the caller's
``group_elements``. ``launches`` counts the wrapper's launches in this
process and ``launches_by_variant`` splits them by pass (under a CUDA
graph, ``ops.LaunchTally`` adds what a capture counted on each replay);
``KERNELS`` names the device kernels (as ``torch.profiler`` reports them)
by variant. ``kernels.ops`` sends CPU tensors to ``kernels.ref`` instead;
``check_moe_experts`` raises on what the kernels do not take, on any
device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels.build import (CudaLibrary, check_cuda_inputs,
                                       require, stream_handle)

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("moe_experts.cu", {
    "moe_lists_launch": [_P, _I, _P, _I, _I, ctypes.c_longlong, _I]
    + [_P] * 5,
    "moe_gate_up_launch": [_P] * 7 + [_I] * 6 + [_P],
    "moe_down_launch": [_P] * 5 + [_I] * 5 + [_P],
    "moe_combine_launch": [_P] * 4 + [_I] * 4 + [_P],
})
KERNELS = {"lists": "moe_lists_kernel", "gate_up": "moe_gate_up_kernel",
           "down": "moe_down_kernel", "combine": "moe_combine_kernel"}
ACTIVATIONS = ("silu", "gelu")          # moe_gate_up_launch's codes
ALIGN = 8                               # bf16: d and f in 16-byte rows
MAX_HELD = 1024                         # the lists kernel's offsets
TOKEN_TILES = (8, 16, 32, 64)           # token columns a block may take

launches = 0
launches_by_variant = dict.fromkeys(KERNELS, 0)


def _count(variant: str) -> None:
    global launches
    launches += 1
    launches_by_variant[variant] += 1


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")


def token_tile(tokens: int, k: int, experts: int) -> int:
    """The token columns a bf16 block takes (BN): the smallest of
    ``TOKEN_TILES`` at or above twice an expert's mean load, tokens x k
    over the ``experts`` the router picks among (the held tables are a
    share of them, each as loaded as any other). A decode's 1 to 4 tokens
    an expert take 8; an expert with more tokens takes them a tile at a
    time."""
    load = 2 * tokens * k / experts
    return next((bn for bn in TOKEN_TILES if bn >= load), TOKEN_TILES[-1])


def check_moe_experts(x, w_gate, w_up, w_down, gates, ids, live,
                      activation: str) -> int:
    """The dtype code of a call (``build.DTYPE_CODES``), or ValueError on
    what the kernels do not take."""
    name = "moe_experts"
    require(activation in ACTIVATIONS, f"{name}: activation {activation!r} "
            f"is not one of {ACTIVATIONS}")
    dtype = check_cuda_inputs(name, (x, w_gate, w_up, w_down), ())
    require(x.dim() == 2 and w_gate.dim() == 3, f"{name}: x must be (T, d) "
            "and the tables (E, d, f)")
    (t, d), (e, _, f) = x.shape, w_gate.shape
    require(w_gate.shape == w_up.shape == (e, d, f)
            and w_down.shape == (e, f, d),
            f"{name}: tables {tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
            f"{tuple(w_down.shape)} do not match x {tuple(x.shape)}")
    require(x.dtype != torch.bfloat16 or (d % ALIGN == 0 and f % ALIGN == 0),
            f"{name}: in bf16, d_model {d} and d_ff {f} must be multiples "
            f"of {ALIGN}")
    require(0 < e <= MAX_HELD, f"{name}: {e} held experts (1 to {MAX_HELD})")
    require(ids.dtype == torch.int64 and gates.dtype == torch.float32
            and ids.dim() == 2 and ids.shape == gates.shape
            and ids.shape[0] == t,
            f"{name}: routes must be gates f32 and ids int64, both (T, k) "
            f"with T = {t}; got {gates.dtype} {tuple(gates.shape)}, "
            f"{ids.dtype} {tuple(ids.shape)}")
    require(gates.is_contiguous() and ids.stride(1) == 1,
            f"{name}: gates must be contiguous and ids' rows too")
    require(live is None or (live.dtype == torch.bool
                             and tuple(live.shape) == (t,)
                             and live.is_contiguous()),
            f"{name}: live must be None or a (T,) bool mask")
    for tensor in (gates, ids) + (() if live is None else (live,)):
        require(tensor.device == x.device, f"{name}: tensors on "
                f"{tensor.device} and {x.device}")
    return dtype


def _lists(lib, stream, ids, live, first: int, held: int, counts, offsets,
           tok, place) -> None:
    _launched("moe_experts", lib.moe_lists_launch(
        ids.data_ptr(), ids.stride(0),
        None if live is None else live.data_ptr(), ids.shape[0],
        ids.shape[1], first, held, counts.data_ptr(), offsets.data_ptr(),
        tok.data_ptr(), place.data_ptr(), stream))
    _count("lists")


def lists(ids: torch.Tensor, live: Optional[torch.Tensor], first: int,
          held: int):
    """The lists pass alone on ids' CUDA device (``ref.moe_lists``'s
    outputs; of tok, the first sum(counts) entries are the list)."""
    require(ids.device.type == "cuda" and ids.dtype == torch.int64
            and ids.dim() == 2 and ids.stride(1) == 1
            and 0 < held <= MAX_HELD
            and (live is None or (live.dtype == torch.bool
                                  and tuple(live.shape) == (ids.shape[0],))),
            "moe_experts.lists: ids (T, k) int64 with contiguous rows on a "
            f"card, live (T,) bool or None, 1 to {MAX_HELD} held experts")
    dev, t, k = ids.device, ids.shape[0], ids.shape[1]
    out = [torch.empty(n, dtype=torch.int32, device=dev)
           for n in (held, held, t * k, t * k)]
    _lists(LIB.lib(), stream_handle(dev), ids, live, first, held, *out)
    return tuple(out)


def moe_experts(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, gates: torch.Tensor, ids: torch.Tensor,
                live: Optional[torch.Tensor], first: int, experts: int,
                activation: str, group_elements: int) -> torch.Tensor:
    """Launch the routed products on x's CUDA device: (T, d) in x's dtype,
    each live token's sum over its held picks of gate x expert(x), 0 for
    the other rows."""
    name = "moe_experts"
    require(x.device.type == "cuda", f"{name}: input is on {x.device}, not "
                                     "CUDA")
    dtype = check_moe_experts(x, w_gate, w_up, w_down, gates, ids, live,
                              activation)
    (t, d), (e, _, f), k = x.shape, w_gate.shape, ids.shape[1]
    out = torch.empty_like(x)
    if t == 0:
        return out
    # as many tokens a chunk as keep the scratch (chunk x k, max(d, f))
    # within group_elements, at least one
    chunk = min(t, max(1, group_elements // (k * max(d, f))))
    bn = token_tile(chunk, k, experts)
    dev = x.device
    counts, offsets = (torch.empty(e, dtype=torch.int32, device=dev)
                       for _ in range(2))
    tok, place = (torch.empty(chunk * k, dtype=torch.int32, device=dev)
                  for _ in range(2))
    h = torch.empty((chunk * k, f), dtype=x.dtype, device=dev)
    y = torch.empty((chunk * k, d), dtype=x.dtype, device=dev)
    lib, stream = LIB.lib(), stream_handle(dev)
    gelu = ACTIVATIONS.index(activation)
    for lo in range(0, t, chunk):
        n = min(chunk, t - lo)
        _lists(lib, stream, ids[lo:lo + n],
               None if live is None else live[lo:lo + n], first, e, counts,
               offsets, tok, place)
        _launched(name, lib.moe_gate_up_launch(
            x[lo:].data_ptr(), tok.data_ptr(), counts.data_ptr(),
            offsets.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            h.data_ptr(), e, d, f, bn, gelu, dtype, stream))
        _count("gate_up")
        _launched(name, lib.moe_down_launch(
            h.data_ptr(), counts.data_ptr(), offsets.data_ptr(),
            w_down.data_ptr(), y.data_ptr(), e, f, d, bn, dtype, stream))
        _count("down")
        _launched(name, lib.moe_combine_launch(
            y.data_ptr(), place.data_ptr(), gates[lo:].data_ptr(),
            out[lo:].data_ptr(), n, k, d, dtype, stream))
        _count("combine")
    return out
