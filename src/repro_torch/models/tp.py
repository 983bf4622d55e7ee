"""Tensor parallelism on DTensors: the model's entry points with
parameters, cache and inputs placed under the sharding rules' specs.

The JAX package compiles a step with ``in_shardings`` = param, cache and
input specs and lets GSPMD place the collectives. Here each of those trees
becomes DTensors (``models.sharding.to_placements``) and the model's own
code runs on them: the dense ops (projections, norms, MLPs, rope, the
unembedding) go through DTensor's sharding propagation, which issues the
collectives an op's placements need (the Megatron all-reduce after a
row-parallel product, for one). A parameter is never gathered whole:
``launch.hloanalysis.StepCost(params=...)`` counts the collectives that
take a parameter as input, and the tests require none.

What DTensor has no strategy for, or would meet only by gathering a
weight or a cache, runs on local shards in a ``local_map`` region (JAX's
``shard_map``), each named here:

* ``cache_attention``: the K/V cache write in place on the local shard
  and the attention kernel op (``kernels.ops``) over it. A cache whose
  sequence the rules shard (its KV heads do not divide the model axis) is
  written where each rank's rows lie and gathered along the sequence for
  the kernel; a rank whose query heads are sharded while the KV heads are
  not hands the kernel only the KV heads its query heads read (local G).
* ``scores_attention``: ``layers.attention_scores`` (training, whisper's
  encoder and cross-attention) with the same head selection.
* ``wkv``: rwkv6's WKV op (or its plain forms under autograd) on the
  local heads.
* ``ssd``: mamba2's SSD forms on the local heads.
* ``moe``: the MoE block's per-rank body of ``moe.apply_moe_ep`` (tokens
  routed over the whole mesh, the rank's own experts).
* ``channel_rms_norm``: mamba2's gated RMS norm over sharded channels
  (the sum of squares all-reduced).
* ``embed``: the lookup in a vocabulary-sharded table (each rank's
  rows, summed over the model axis).
* ``take_rows``: a row's last-token hidden state (``x[b, idx[b]]``).
* ``xent``: the cross-entropy over a vocabulary-sharded logit tensor
  (max and sum of exponents reduced over the model axis).

Each region takes its inputs' own placements (``redistribute_inputs``
stays off, so nothing is moved to fit one) and checks the layout it
needs; an unexpected one raises. An input with no batch or head dim that
is replicated where another input is sharded (a weight used on a rank's
rows) takes a ``Partial`` gradient there, which DTensor reduces.

Plain tensors that a step builds from nothing (aranges, zero starts, rope
frequencies, sinusoid tables) count as replicated on every rank
(``implicit_replication``), as JAX's constants are; parameters, cache and
inputs are DTensors and are never read as plain tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)


def is_dt(x) -> bool:
    return isinstance(x, DTensor)


@contextlib.contextmanager
def step_context():
    """What every sharded step runs under: plain constants replicated."""
    with implicit_replication():
        yield


# ---------------------------------------------------------------------------
# placement helpers
# ---------------------------------------------------------------------------


def _mesh_dims(placements, dim: int) -> list:
    """The mesh dims that shard tensor dim ``dim``, in mesh order."""
    return [i for i, p in enumerate(placements)
            if isinstance(p, Shard) and p.dim == dim]


def _coord(mesh, dims) -> int:
    """This rank's row-major index over mesh ``dims``."""
    idx = 0
    for d in dims:
        idx = idx * mesh.size(d) + mesh.get_local_rank(d)
    return idx


def _batch_of(placements) -> tuple:
    """Placements of a per-row tensor (B,) with ``placements``' batch
    sharding (dim 0) and nothing else."""
    return tuple(Shard(0) if isinstance(p, Shard) and p.dim == 0
                 else Replicate() for p in placements)


def _moved(placements, mapping: dict) -> tuple:
    """``placements`` with each Shard(d) re-aimed at ``mapping[d]`` (None:
    that dim is gone, which it must not be sharded on)."""
    out = []
    for p in placements:
        if isinstance(p, Shard):
            if p.dim in mapping and mapping[p.dim] is None:
                raise ValueError(f"tp: dim {p.dim} is sharded and has no "
                                 "place in the region's output")
            out.append(Shard(mapping.get(p.dim, p.dim)))
        else:
            out.append(p)
    return tuple(out)


class _Redistribute(torch.autograd.Function):
    """``x.redistribute(mesh, placements)`` whose gradient goes back
    replicated on the mesh dims where ``x`` was Partial: a summand's
    gradient is the whole sum's (Megatron's pair of all-reduces: the
    gradient, still a partial sum from the column-parallel products after
    this point, is reduced here). DTensor's own adjoint would hand back a
    Partial gradient, which the row-parallel product before this point
    meets by gathering its weight."""

    @staticmethod
    def forward(ctx, x, mesh, placements):
        ctx.mesh, ctx.src = mesh, tuple(x.placements)
        return x.redistribute(mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        want = tuple(Replicate() if p.is_partial() else p for p in ctx.src)
        if tuple(grad.placements) != want:
            grad = grad.redistribute(ctx.mesh, want)
        return grad, None, None


def _to(x: DTensor, placements: tuple):
    if tuple(x.placements) == tuple(placements):
        return x
    return _Redistribute.apply(x, x.device_mesh, tuple(placements))


def keep(x, like):
    """``x`` in ``like``'s placements (the residual stream's layout, which
    DTensor's propagation would otherwise pick op by op: a reduce-scatter
    onto the batch where the JAX layout all-reduces). Plain tensors pass
    through."""
    if not isinstance(x, DTensor):
        return x
    return _to(x, like.placements)


def rows_layout(x, ref):
    """``x`` (B, ...) split on the batch as ``ref`` is and replicated on
    every other mesh dim (a Partial sum reduced): the residual stream's
    layout. Plain tensors pass through."""
    if not isinstance(x, DTensor):
        return x
    return _to(x, _batch_of(ref.placements))


def split_heads(x, shape: tuple):
    """``x.reshape(shape)``, its last dim split into (heads, head_dim). Where
    that dim is sharded over mesh dims whose ranks do not divide the
    heads, DTensor has no layout for the split: the activation is
    gathered along it first (an all-gather of activations, counted)."""
    if isinstance(x, DTensor):
        dims = _mesh_dims(x.placements, x.dim() - 1)
        n = math.prod(x.device_mesh.size(d) for d in dims)
        if dims and shape[-2] % n:
            x = _to(x, tuple(Replicate() if i in dims else p
                             for i, p in enumerate(x.placements)))
    return x.reshape(shape)


class _PinGrad(torch.autograd.Function):
    """The identity, whose gradient is redistributed to the forward
    value's placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad


def merge_heads(x, shape: tuple):
    """``x.reshape(shape)``, (heads, head_dim) merged into one dim. Its
    gradient is brought back to the merged value's placements first: a
    gradient sharded along the merged dim where the heads are not (they
    did not divide the ranks) has no layout for the split back."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return _PinGrad.apply(x.reshape(shape))


def channel_rms_norm(x, scale, eps: float):
    """``layers.rms_norm`` of x (..., C) whose channels are sharded: the
    sum of squares is reduced over the channel's mesh dims (the result is
    used alike on each rank, so its gradient passes unchanged) and the
    rest runs on the local channels (mamba2's gated norm over d_inner)."""
    mesh = x.device_mesh
    cdims = _mesh_dims(x.placements, x.dim() - 1)
    c = x.shape[-1]

    def body(x, scale):
        xf = x.float()
        ss = xf.square().sum(dim=-1, keepdim=True)
        for d in cdims:
            ss = _SumOver.apply(ss, mesh, d, False)
        out = xf * torch.rsqrt(ss / c + eps)
        return (out * (1.0 + scale.float())).to(x.dtype)

    return region(body, (x, scale), list(x.placements))


def rows(t, like: DTensor):
    """``t`` (B, ...) as a DTensor split on the batch as ``like`` is. A
    plain tensor is the same on every rank, so each keeps its own rows
    (nothing is sent); a DTensor with another layout is redistributed."""
    want = _batch_of(like.placements)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == want else t.redistribute(
            like.device_mesh, want)
    return distribute_tensor(t, like.device_mesh, want, src_data_rank=None)


def _grad_placements(args) -> tuple:
    """Per arg: a DTensor's placements with Replicate made Partial on the
    mesh dims where another DTensor arg is sharded (its local gradient is
    this rank's share), else None."""
    dts = [a for a in args if isinstance(a, DTensor)]
    sharded = {i for a in dts for i, p in enumerate(a.placements)
               if isinstance(p, Shard)}
    out = []
    for a in args:
        if not isinstance(a, DTensor):
            out.append(None)
            continue
        out.append(tuple(Partial() if (i in sharded and p == Replicate())
                         else p for i, p in enumerate(a.placements)))
    return tuple(out)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous: a region hands its
    inputs' local gradients back to DTensor, whose reshapes of them are
    views."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def region(fn, args: tuple, out_placements):
    """``fn`` over the local shards of ``args`` (a ``local_map`` region),
    each arg taken in its own placements. ``out_placements``: a list of
    placements for one output, a tuple of them for several."""
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    ins = tuple(tuple(a.placements) if isinstance(a, DTensor) else None
                for a in args)
    grads = None
    if torch.is_grad_enabled() and any(
            isinstance(a, DTensor) and a.requires_grad for a in args):
        grads = _grad_placements(args)
        inner = fn

        def fn(*local):
            return inner(*(_ContiguousGrad.apply(t) if isinstance(
                t, torch.Tensor) and t.requires_grad else t for t in local))
    return local_map(fn, out_placements=out_placements, in_placements=ins,
                     in_grad_placements=grads, device_mesh=mesh,
                     redistribute_inputs=False)(*args)


def _wait(t):
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def _gather(t: torch.Tensor, dim: int, mesh, mesh_dims) -> torch.Tensor:
    """``t``'s shards along ``dim`` over ``mesh_dims`` (the first
    outermost), gathered whole; e4m3 moves as bytes."""
    fp8 = t.dtype == torch.float8_e4m3fn
    if fp8:
        t = t.view(torch.uint8)
    for d in reversed(mesh_dims):
        t = _wait(funcol.all_gather_tensor(t.contiguous(), dim, (mesh, d)))
    return t.view(torch.float8_e4m3fn) if fp8 else t


# ---------------------------------------------------------------------------
# heads
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Heads:
    """Which KV heads a rank's query heads read: the local KV heads as
    they are (both split alike), a range of them, or one per query head
    (G = 1 locally) where a rank's query heads straddle KV heads."""
    first: int          # global index of the rank's first query head
    hq_loc: int
    group: int          # query heads a KV head serves (global)
    kv_sharded: bool

    def select(self, kv: torch.Tensor) -> torch.Tensor:
        if self.kv_sharded:
            return kv
        g, h0, n = self.group, self.first, self.hq_loc
        if n % g == 0:
            return kv.narrow(2, h0 // g, n // g)
        if g % n == 0:
            return kv.narrow(2, h0 // g, 1)
        idx = torch.tensor([(h0 + i) // g for i in range(n)],
                           device=kv.device)
        return kv.index_select(2, idx)


def _heads(q: DTensor, kv: DTensor, head_dim_q: int = 2,
           head_dim_kv: int = 2) -> _Heads:
    mesh = q.device_mesh
    qd = _mesh_dims(q.placements, head_dim_q)
    kd = _mesh_dims(kv.placements, head_dim_kv)
    hq, hkv = q.shape[head_dim_q], kv.shape[head_dim_kv]
    if kd and kd != qd:
        raise ValueError(f"tp: KV heads split over mesh dims {kd}, query "
                         f"heads over {qd}")
    hq_loc = hq
    for d in qd:
        hq_loc //= mesh.size(d)
    return _Heads(first=_coord(mesh, qd) * hq_loc, hq_loc=hq_loc,
                  group=hq // hkv, kv_sharded=bool(kd))


def _check_rows(*ts: DTensor) -> None:
    want = _batch_of(ts[0].placements)
    for t in ts[1:]:
        if _batch_of(t.placements) != want:
            raise ValueError(f"tp: batch split {t.placements} differs from "
                             f"{ts[0].placements}")


# ---------------------------------------------------------------------------
# attention regions
# ---------------------------------------------------------------------------


def _store(cache: torch.Tensor, new: torch.Tensor):
    """(cache view, new values) in the cache's storage type (e4m3 as
    bytes)."""
    from repro_torch.models.layers import to_e4m3
    if cache.dtype == torch.float8_e4m3fn:
        return cache.view(torch.uint8), to_e4m3(new).view(torch.uint8)
    return cache, new.to(cache.dtype)


def _write_sharded(cache, new, write_pos, offset: int, total: int) -> None:
    """The write of ``layers._cache_write`` (rows [start, start + Snew) of
    a ``total``-row cache, start clamped as ``dynamic_update_slice``
    clamps it) into the local rows [offset, offset + S_loc) of a cache
    whose sequence is sharded, in place."""
    b, s_loc = cache.shape[:2]
    snew = new.shape[1]
    cache, new = _store(cache, new)
    start = write_pos.long().clamp(0, total - snew)
    rows_ = torch.arange(b, device=cache.device)
    if snew == 1:
        col = start - offset
        valid = (col >= 0) & (col < s_loc)
        c = col.clamp(0, s_loc - 1)
        old = cache[rows_, c]
        cache[rows_, c] = torch.where(valid[:, None, None], new[:, 0], old)
        return
    src = offset + torch.arange(s_loc, device=cache.device)[None] \
        - start[:, None]                                      # (B, S_loc)
    valid = (src >= 0) & (src < snew)
    picked = new[rows_[:, None], src.clamp(0, snew - 1)]
    cache.copy_(torch.where(valid[..., None, None], picked, cache))


def cache_attention(q, k, v, k_cache, v_cache, *, cache_positions, lengths,
                    mask, softcap):
    """The cache branch of ``layers.apply_attention`` on DTensors: write
    the new K/V (B, Snew, Hkv, D) into the layer's cache (B, Smax, Hkv, D)
    in place at ``cache_positions``, then attend through the kernel op.
    ``mask.kind`` "causal" / "chunk" (the prefill op, ``starts`` 0 or
    ``lengths``), "lengths" / "ring" (the decode op, lengths + 1, clamped
    to the ring's size for "ring"). Returns the output with q's
    placements."""
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L

    _check_rows(q, k, k_cache)
    if _mesh_dims(q.placements, 1) or _mesh_dims(k.placements, 1):
        raise ValueError("tp: the new tokens' sequence dim is sharded")
    mesh = q.device_mesh
    heads = _heads(q, k_cache)
    seq_dims = _mesh_dims(k_cache.placements, 1)
    if _mesh_dims(k.placements, 2) != _mesh_dims(k_cache.placements, 2):
        raise ValueError(f"tp: new K/V heads {k.placements} and the "
                         f"cache's {k_cache.placements} split differently")
    n_seq = math.prod(mesh.size(d) for d in seq_dims)
    total = k_cache.shape[1]
    offset = _coord(mesh, seq_dims) * (total // n_seq)
    pos = rows(cache_positions, q)
    lens = rows(lengths if lengths is not None else cache_positions, q)
    kind, window = mask.kind, mask.window
    q_offset = mask.q_offset

    def body(q, k, v, kc, vc, pos, lens):
        if seq_dims:
            _write_sharded(kc, k, pos, offset, total)
            _write_sharded(vc, v, pos, offset, total)
            kc = _gather(kc, 1, mesh, seq_dims)
            vc = _gather(vc, 1, mesh, seq_dims)
        else:
            L._cache_write(kc, k, pos)
            L._cache_write(vc, v, pos)
        # the kernels take contiguous tensors: a narrowed head range or a
        # DTensor view's local shard is copied once here
        q = q.contiguous()
        kc, vc = heads.select(kc).contiguous(), heads.select(vc).contiguous()
        if kind in ("lengths", "ring"):
            pages = L.decode_block_table(kc.shape[0], kc.shape[1], q.device)
            n = lens + 1
            if kind == "ring":
                n = n.clamp(max=kc.shape[1])
            return L._decode_attention(q[:, 0], kc, vc, pages, n, softcap,
                                       window)[:, None]
        if kind == "causal":
            starts = torch.full((q.shape[0],), q_offset, dtype=torch.int32,
                                device=q.device)
        else:
            starts = lens.to(torch.int32)
        return ops.chunked_prefill_op(q, kc, vc, starts, softcap=softcap,
                                      window=window)

    return region(body, (q, k, v, k_cache, v_cache, pos, lens),
                  list(q.placements))


def scores_attention(q, k, v, mask, softcap, q_chunk):
    """``layers.attention_scores`` on DTensors: q (B, Sq, Hq, D) over k, v
    (B, Sk, Hkv, D); a K/V sequence split over the mesh (a cross cache
    under the rules) is gathered first."""
    from repro_torch.models import layers as L

    _check_rows(q, k, v)
    mesh = q.device_mesh
    heads = _heads(q, k)
    seq_dims = _mesh_dims(k.placements, 1)
    if _mesh_dims(q.placements, 1):
        raise ValueError("tp: the queries' sequence dim is sharded")

    def body(q, k, v):
        if seq_dims:
            k = _gather(k, 1, mesh, seq_dims)
            v = _gather(v, 1, mesh, seq_dims)
        return L.attention_scores(q, heads.select(k), heads.select(v), mask,
                                  softcap, q_chunk)

    return region(body, (q, k, v), list(q.placements))


# ---------------------------------------------------------------------------
# recurrences
# ---------------------------------------------------------------------------


def _state_placements(x: DTensor, head_dim: int) -> tuple:
    """A (B, H, ...) state's placements for an input (B, T, H, ...)."""
    return _moved(x.placements, {0: 0, 1: None, head_dim: 1})


def wkv(r, k, v, w, u, s0, mode: str):
    """rwkv6's WKV on the local heads: ``kernels.ops.wkv6_op`` for
    "decode" / "chunked", the plain ``rwkv6.wkv_sequence`` for "train"
    (autograd). ``s0`` is the layer's state (B, H, D, D), or a plain
    tensor (training's zero state), which each rank makes at its local
    shape. Returns (out f32 with r's placements, sT)."""
    from repro_torch.kernels import ops
    from repro_torch.models import rwkv6

    _check_rows(r, k, v, w)
    sp = _state_placements(r, 2)
    fresh = not is_dt(s0)
    if not fresh and tuple(s0.placements) != sp:
        raise ValueError(f"tp: WKV state placements {s0.placements}, "
                         f"expected {sp}")

    def body(r, k, v, w, u, s0):
        if fresh:
            b, _, h, d = r.shape
            s0 = torch.zeros((b, h, d, d), dtype=torch.float32,
                             device=r.device)
        if mode == "train":
            return rwkv6.wkv_sequence(r, k, v, w, u, s0)
        return ops.wkv6_op(r, k, v, w, u, s0, mode)

    args = (r, k, v, w, u, None if fresh else s0)
    return region(body, args, (tuple(r.placements), sp))


def ssd(form, xh, dt, A, Bm, Cm, D, s0):
    """mamba2's SSD ``form`` (``ssd_decode`` / ``ssd_chunked`` /
    ``ssd_scan``) on the local heads. xh (B, T, H, P) or (B, H, P) for a
    decode; ``s0`` the layer's state or a plain zero state (training).
    Returns (y f32 with xh's placements, sT)."""
    _check_rows(xh, dt, Bm)
    decode = xh.dim() == 3
    hd = 1 if decode else 2
    sp = _moved(xh.placements, {0: 0, hd: 1} if decode
                else {0: 0, 1: None, 2: 1})
    fresh = not is_dt(s0)
    if not fresh and tuple(s0.placements) != sp:
        raise ValueError(f"tp: SSD state placements {s0.placements}, "
                         f"expected {sp}")
    def body(xh, dt, A, Bm, Cm, D, s0):
        if fresh:
            b, h, p = xh.shape[0], xh.shape[hd], xh.shape[-1]
            s0 = torch.zeros((b, h, p, Bm.shape[-1]), dtype=torch.float32,
                             device=xh.device)
        return form(xh, dt, A, Bm, Cm, D, s0)

    args = (xh, dt, A, Bm, Cm, D, None if fresh else s0)
    return region(body, args, (tuple(xh.placements), sp))


# ---------------------------------------------------------------------------
# MoE, rows, loss
# ---------------------------------------------------------------------------


def moe(params, x, cfg, info):
    """The MoE block's routed experts: ``moe.apply_moe_ep``'s per-rank body
    on this rank's rows (x (B, S, d) split on the batch over
    ``info.batch_axes``, replicated over the rest) and its experts (the
    tables' leading dim split over the whole mesh). The shared expert is
    the caller's (DTensor ops)."""
    from repro_torch.models import moe as M

    names = ("router", "w_gate", "w_up", "w_down")
    if _mesh_dims(x.placements, 2) or _mesh_dims(x.placements, 1):
        raise ValueError(f"tp: MoE input placements {x.placements}")
    body_fn = M._moe_ep_allgather_local if info.ep_mode == "allgather" \
        else M._moe_ep_local

    # the body's collectives have the EP path's adjoints, which sum every
    # rank's gradient (each rank's loss is its own share there); DTensor
    # hands each rank holding a copy of the replicated output the whole
    # gradient, so it is divided among the copies
    copies = math.prod(x.device_mesh.size(i) for i, p in
                       enumerate(x.placements) if p == Replicate())

    def body(x, *ws):
        out = body_fn(dict(zip(names, ws)), x, cfg=cfg, info=info)
        return _ScaleGrad.apply(out, 1.0 / copies) if copies > 1 else out

    return region(body, (x,) + tuple(params[k] for k in names),
                  list(x.placements))


def embed(table, tokens):
    """The rows of a table (V, d) split on its vocabulary over mesh dims:
    each rank looks up the tokens its shard holds (zeros elsewhere), and
    the partial rows are summed over those dims into the residual
    stream's layout (split on the batch as ``tokens``)."""
    mesh = table.device_mesh
    vdims = _mesh_dims(table.placements, 0)
    v_loc = table.shape[0]
    for d in vdims:
        v_loc //= mesh.size(d)
    lo = _coord(mesh, vdims) * v_loc

    def body(table, tokens):
        local = tokens.long() - lo
        ok = (local >= 0) & (local < table.shape[0])
        x = F.embedding(local.clamp(0, table.shape[0] - 1), table)
        return torch.where(ok[..., None], x, torch.zeros((), dtype=x.dtype,
                                                          device=x.device))

    out = [Partial() if i in vdims else p
           for i, p in enumerate(_batch_of(tokens.placements))]
    return rows_layout(region(body, (table, tokens), out), tokens)


def take_rows(x, idx):
    """x (B, S, d) -> x[b, idx[b]] (B, d) on each rank's rows."""
    if _mesh_dims(x.placements, 1):
        raise ValueError("tp: take_rows over a sharded sequence")
    idx = rows(idx, x)

    def body(x, idx):
        return x[torch.arange(x.shape[0], device=x.device), idx.long()]

    return region(body, (x, idx), list(_moved(x.placements, {0: 0, 2: 1})))


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over one mesh dim. ``shared``: its result is used
    alike on every rank of the group, so each rank's gradient is already
    the whole one and passes through unchanged; else each rank uses it in
    its own way and the gradients are summed."""

    @staticmethod
    def forward(ctx, x, mesh, dim, shared):
        ctx.mesh, ctx.dim, ctx.shared = mesh, dim, shared
        return _wait(funcol.all_reduce(x, "sum", (mesh, dim)))

    @staticmethod
    def backward(ctx, grad):
        if not ctx.shared:
            grad = _wait(funcol.all_reduce(grad.contiguous(), "sum",
                                           (ctx.mesh, ctx.dim)))
        return grad, None, None, None


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose gradient is scaled by ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.factor, None


def xent(logits, labels):
    """Per-token cross-entropy (B, S) f32 of logits (B, S, V) against
    labels (B, S): ``logsumexp - logits[label]``. A vocabulary split over
    mesh dims is reduced over them (the max, then the sum of exponents and
    the label's logit); the result takes the batch split. A vocabulary
    whole on each rank (not split, or split over mesh dims of size 1)
    takes the plain path's ops (``layers.token_xent``), so that what
    autograd saves for the backward is what the single-device step saves:
    the max / exp-sum form holds one (B, S, V) f32 buffer less there, and
    the dry-run's memory count of a step on one card would miss it."""
    from repro_torch.models import layers as L
    labels = rows(labels, logits)
    mesh = logits.device_mesh
    vdims = _mesh_dims(logits.placements, 2)
    v_loc = logits.shape[2]
    for d in vdims:
        v_loc //= mesh.size(d)
    lo = _coord(mesh, vdims) * v_loc

    def body(lg, lab):
        if v_loc == logits.shape[2]:
            return L.token_xent(lg, lab)
        m = lg.detach().amax(dim=-1)
        for d in vdims:
            m = _wait(funcol.all_reduce(m, "max", (mesh, d)))
        se = torch.exp(lg - m[..., None]).sum(dim=-1)
        local = lab.long() - lo
        ok = (local >= 0) & (local < lg.shape[-1])
        true = lg.gather(-1, local.clamp(0, lg.shape[-1] - 1)[..., None])
        true = torch.where(ok, true[..., 0], torch.zeros((), device=lg.device))
        for d in vdims:
            se = _SumOver.apply(se, mesh, d, True)
            true = _SumOver.apply(true, mesh, d, True)
        return torch.log(se) + m - true

    out = [Replicate() if (isinstance(p, Shard) and p.dim == 2) else p
           for p in logits.placements]
    return region(body, (logits, labels), out)


# ---------------------------------------------------------------------------
# placing trees
# ---------------------------------------------------------------------------


def place(tree, specs, mesh):
    """A tree of whole tensors (the same on every rank, or meta ones: the
    dry-run's shapes) as DTensors under ``specs``: each rank keeps a copy
    of its own slice (``sharding.local_slices``), so the whole tensor can
    be freed, and nothing is sent. Ring caches' per-layer tuples too."""
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(place(v, s, mesh) for v, s in zip(tree, specs))
    from repro_torch.models import sharding as S
    coords = {n: mesh.get_local_rank(n) for n in mesh.mesh_dim_names}
    local = tree[S.local_slices(tuple(tree.shape), specs, mesh,
                                coords)].clone()
    return DTensor.from_local(local, mesh, S.to_placements(specs, mesh),
                              run_check=False, shape=tree.shape,
                              stride=tree.stride())


def local_bytes(tree) -> int:
    """Bytes of this rank's local shards of a tree of DTensors."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(local_bytes(v) for v in tree)
    if tree is None:
        return 0
    t = tree.to_local() if isinstance(tree, DTensor) else tree
    return t.numel() * t.element_size()


def respec(tree, specs, mesh):
    """A tree of DTensors redistributed to ``specs`` (a step's
    ``out_shardings``)."""
    if isinstance(tree, dict):
        return {k: respec(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(respec(v, s, mesh) for v, s in zip(tree, specs))
    from repro_torch.models import sharding as S
    want = tuple(S.to_placements(specs, mesh))
    if tuple(tree.placements) == want:
        return tree
    return tree.redistribute(mesh, want)

