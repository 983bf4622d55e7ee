"""Mixture-of-Experts in PyTorch: one device, and expert parallelism.

Counterpart of ``repro/models/moe.py``. Two execution paths share one set
of parameters (router f32 ``(d, E)``; ``w_gate`` / ``w_up``
``(E_phys, d, f)``, ``w_down`` ``(E_phys, f, d)``; a ``shared`` expert of
width ``d_ff * num_shared_experts``) and one routing (top-k of the f32
router logits, ties to the lower expert id as ``lax.top_k`` breaks them,
softmax over the k values):

* ``apply_moe_reference``: the JAX function of the same name. Every token
  routed, each one's held picks combined in f32 with the top-k gates, no
  capacity, no drops. The JAX reference runs every token through every
  expert and builds (T, E, f) and (T, E, d) intermediates; at full width
  that is gigabytes (arctic, 8 rows x 256 tokens: 2.5 GB each for the gate
  and up products, 7.5 GB for the f32 combine). Where the op takes the
  tensors (``layers.untracked``: no DTensor, no gradient) the experts run
  through ``ops.moe_experts_op``, and rows that hold no request
  (``Probe``'s live mask) take nothing: on the card routed, each held
  expert multiplying only the live tokens that picked it, so a decode step
  reads the tables of the experts its tokens touch and no others; on the
  CPU its plain version. The training forwards and the sharded path keep
  the dense dispatch (``_expert_sum``), as does the plain version: every
  token through every held expert in groups of ``group_size(T, cfg)``
  whose intermediates stay within ``GROUP_ELEMENTS``, the combine a (T, d)
  f32 sum (zero weights add exactly, so both add the same products; past
  two picks a token, in another order). Either way the shapes depend on T
  alone and nothing waits for the card, so a step still captures as a
  CUDA graph.
* ``apply_moe_ep``: expert parallelism over a ``DeviceMesh``, per rank.
  Where JAX runs a ``shard_map`` body, each rank here runs the same body
  on its own batch rows (``x`` sharded over ``batch_axes``, replicated over
  the rest) and its own experts (the leading dim of the expert tables
  split over ``ep_axes``, row-major), with explicit collectives. In
  "alltoall" mode tokens go to their experts' ranks in static-capacity
  buckets (an all-to-all per mesh axis, or one over the whole EP group
  with ``fused_a2a``), through the local experts as batched matmuls, and
  back; assignments past a bucket's capacity are dropped. In "allgather"
  mode every rank gathers all tokens, runs its experts on them with the
  combine weights as masks, and the sum over the EP group is sliced back
  to the rank's rows: no drops.

Layout inside the all-to-all path: send/recv buffers are (N, L_e, C, d):
N = ranks in the EP group, L_e = experts per rank (E padded to a multiple
of N), C = per (destination rank, local expert) slot capacity. The
collectives are autograd functions over plain ``torch.distributed`` calls
(all_to_all_single, all_gather, all_reduce), each with its adjoint as the
backward, so ``api.loss(ep=...)`` has gradients. They are written here
because ``torch.distributed.nn.functional.all_gather``'s backward fails on
a subgroup under gloo ("Global rank 1 is not part of group", torch 2.13
on the CPU) and the module is deprecated.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ref import held_combine
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import layers, tp
from repro_torch.models.layers import (ModelConfig, _activate, _dense_init,
                                      _normal)
from repro_torch.tracing import span

# Elements of one group's largest intermediate, (G, T, max(d, f)), at most
# (32 Mi: 64 MB in bf16)
GROUP_ELEMENTS = 1 << 25


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def physical_experts(cfg: ModelConfig) -> int:
    if cfg.expert_pad_to <= 0:
        return cfg.num_experts
    return math.ceil(cfg.num_experts / cfg.expert_pad_to) * cfg.expert_pad_to


def whole_experts(cfg: ModelConfig) -> int:
    """The leading size of the whole model's expert tables, which sets
    their scales: ``physical_experts``, or for a share of the experts
    (``layers.ExpertShare``) every expert the router scores, so that a
    share draws from the whole's distributions."""
    if cfg.router_width != cfg.num_experts:
        return cfg.router_width
    return physical_experts(cfg)


def init_moe(gen: torch.Generator, cfg: ModelConfig, stack: int = 0):
    """The JAX ``init_moe``'s tree and distributions (``stack`` layers along
    a new leading axis). The router stays f32 in a bf16 model, and scores
    every expert (``cfg.router_width``); the expert tables are the held
    experts' (``cfg.expert_ids``), scaled as the whole's
    (``whole_experts``). A share's values are its own draws, not a slice
    of the whole's: ``init_experts`` draws each expert alike in any
    share."""
    e, d, f = physical_experts(cfg), cfg.d_model, cfg.d_ff
    whole = whole_experts(cfg)
    p = {
        "router": _dense_init(gen, (d, cfg.router_width), torch.float32,
                              stack=stack),
        "w_gate": _dense_init(gen, (e, d, f), cfg.dtype, in_axis_size=whole,
                              stack=stack),
        "w_up": _dense_init(gen, (e, d, f), cfg.dtype, in_axis_size=whole,
                            stack=stack),
        "w_down": _dense_init(gen, (e, f, d), cfg.dtype, in_axis_size=f,
                              stack=stack),
    }
    if cfg.num_shared_experts:
        fs = cfg.d_ff * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": _dense_init(gen, (d, fs), cfg.dtype, stack=stack),
            "w_up": _dense_init(gen, (d, fs), cfg.dtype, stack=stack),
            "w_down": _dense_init(gen, (fs, d), cfg.dtype, in_axis_size=fs,
                                  stack=stack),
        }
    return p


def init_experts(cfg: ModelConfig, experts: range, seed: int, device,
                 stack: int = 0) -> dict:
    """The expert tables (``w_gate``, ``w_up``, ``w_down``) of the experts
    ``experts`` (global ids: a rank's own under expert parallelism, a
    share's ``cfg.expert_ids``), each (layer, expert) drawn from its own
    generator seeded by (seed, layer, expert), with ``init_moe``'s
    distributions (the whole table's scales: 1/sqrt(E) for w_gate and
    w_up, E the whole's ``whole_experts``, as the JAX package takes
    shape[0] for the fan-in, 1/sqrt(d_ff) for w_down). Any split of the
    experts over ranks or shares draws the same values, and each draws
    only its own. ``stack`` > 0: that many layers along a new leading
    axis."""
    e, d, f = whole_experts(cfg), cfg.d_model, cfg.d_ff
    lead = (stack,) if stack else ()
    shapes = {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}
    scales = {"w_gate": e ** -0.5, "w_up": e ** -0.5, "w_down": f ** -0.5}
    out = {k: torch.empty(lead + (len(experts),) + s, dtype=cfg.dtype,
                          device=device) for k, s in shapes.items()}
    for layer in range(max(1, stack)):
        for i, expert in enumerate(experts):
            gen = torch.Generator(device=device).manual_seed(
                (seed << 40) + (layer << 20) + expert)
            for k, s in shapes.items():
                dst = out[k][layer, i] if stack else out[k][i]
                dst.copy_(_normal(gen, s, cfg.dtype, scales[k]))
    return out


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int,
          num_experts_padded: int):
    """x: (T, d) -> (gates (T, k) f32, expert_ids (T, k) int64).

    Padding experts (id >= real E) receive -inf logits and are never
    picked. Equal logits go to the lower expert id, as ``lax.top_k`` breaks
    ties (``torch.topk`` does not promise an order; on the CPU it picks the
    higher ids): a stable descending sort. A padded zero row of the EP path
    ties every expert."""
    logits = x.float() @ router_w                             # (T, E)
    e_real = logits.shape[-1]
    if num_experts_padded > e_real:
        pad = torch.full((x.shape[0], num_experts_padded - e_real),
                         float("-inf"), dtype=torch.float32, device=x.device)
        logits = torch.cat([logits, pad], dim=-1)
    gate_vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    gate_vals, ids = gate_vals[:, :top_k], ids[:, :top_k]
    return torch.softmax(gate_vals, dim=-1), ids


# ---------------------------------------------------------------------------
# dense dispatch
# ---------------------------------------------------------------------------


def group_size(tokens: int, cfg: ModelConfig) -> int:
    """Experts computed together for ``tokens`` tokens: as many as keep a
    group's (G, T, max(d, f)) intermediate within ``GROUP_ELEMENTS``, at
    least one."""
    return ref.expert_group(tokens, cfg.num_experts, cfg.d_model, cfg.d_ff,
                            GROUP_ELEMENTS)


def _expert_sum(xt, w_gate, w_up, w_down, combine, n: int,
                cfg: ModelConfig) -> torch.Tensor:
    """sum_e combine[:, e] * expert_e(xt) over the first ``n`` experts of
    the tables, in f32: (T, d). The products run in ``xt``'s dtype, in
    groups of ``group_size(T, cfg)`` experts (``ref.expert_sum``)."""
    return ref.expert_sum(xt, w_gate, w_up, w_down, combine, n,
                          cfg.mlp_activation, group_size(xt.shape[0], cfg))


class Probe:
    """What the single-card MoE layers of one step report while it is open
    (``probe``): each layer's routes (ids (T, k), global) beside the experts
    it holds, and with ``timed`` a pair of timing CUDA events around each
    layer's expert products. The events are external, so a step captured
    as a CUDA graph records them as nodes of the graph, and every replay
    times the products on the card's clock. ``live``, the (T,) bool mask
    of the step's rows that a request reads: the experts give the others
    nothing. None: every row is live."""

    def __init__(self, timed: bool = False,
                 live: Optional[torch.Tensor] = None):
        self.timed = timed
        self.live = live
        self.routes: list = []
        self.events: list = []

    def counts(self, live: torch.Tensor) -> torch.Tensor:
        """Per layer, over the tokens where ``live`` (T,) holds: the
        token-expert assignments to held experts, the held experts that at
        least one of them went to, and all the tokens' assignments; (3 x
        layers,) int32, computed on the device (nothing waits for it)."""
        rows = []
        for ids, held in self.routes:
            local = ids - held.start
            mine = (local >= 0) & (local < len(held)) & live[:, None]
            slot = torch.where(mine, local, len(held)).reshape(-1)
            hit = torch.zeros(len(held) + 1, dtype=torch.int32,
                              device=ids.device).scatter_(0, slot, 1)
            rows.append(torch.stack([mine.sum(), hit[:-1].sum(),
                                     live.sum() * ids.shape[1]]))
        return torch.stack(rows).to(torch.int32).reshape(-1)


_PROBE: Optional[Probe] = None


@contextlib.contextmanager
def probe(timed: bool = False, live: Optional[torch.Tensor] = None):
    """Open a ``Probe`` for the single-card MoE layers run inside."""
    global _PROBE
    outer, _PROBE = _PROBE, Probe(timed, live)
    try:
        yield _PROBE
    finally:
        _PROBE = outer


def apply_moe_reference(params, x: torch.Tensor,
                        cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d). The JAX ``apply_moe_reference``'s function: every
    token routed over every expert the router scores, each one's picks
    among the held real experts (a padding expert is never picked) through
    those experts, the products in ``x``'s dtype, the combine in f32, then
    the cast back and the shared expert. Where the op takes the tensors
    (``layers.untracked``) only the live rows' picks count
    (``ops.moe_experts_op``; an open ``Probe``'s ``live``, else every row),
    elsewhere the dense dispatch (``_expert_sum``). Where the weights hold
    a share of the experts (``layers.ExpertShare``) the result is the held
    experts' part alone: what one rank of expert parallelism adds before
    the exchange sums the ranks."""
    b, s, d = x.shape
    held = cfg.expert_ids
    n = len(held)
    e_tables = params["w_gate"].shape[0]
    xt = x.reshape(b * s, d)
    with span("repro_torch.moe.route"):
        e_route = e_tables if n == cfg.router_width else cfg.router_width
        gates, ids = route(params["router"], xt, cfg.top_k, e_route)
    pr = _PROBE
    if pr is not None:
        pr.routes.append((ids, held))
    routed = layers.untracked(xt, params["w_gate"])
    live = pr.live if pr is not None else None
    if live is not None and live.shape != (b * s,):
        raise ValueError(f"apply_moe_reference: the probe's live mask "
                         f"{tuple(live.shape)} is not the step's {b * s} rows")
    with span("repro_torch.moe.experts"):
        if pr is not None and pr.timed:
            pair = tuple(torch.cuda.Event(enable_timing=True, external=True)
                         for _ in range(2))
            pair[0].record()
        if routed:
            out = ops.moe_experts_op(
                xt, params["w_gate"][:n], params["w_up"][:n],
                params["w_down"][:n], gates, ids, live, held.start,
                cfg.router_width, cfg.mlp_activation, GROUP_ELEMENTS)
        else:
            combine = held_combine(gates, ids, range(held.start,
                                                     held.start + e_tables))
            out = _expert_sum(xt, params["w_gate"], params["w_up"],
                              params["w_down"], combine, n, cfg)
        if pr is not None and pr.timed:
            pair[1].record()
            pr.events.append(pair)
    out = out.to(x.dtype).reshape(b, s, d)
    return out + _shared_expert(params, x, cfg)


def _shared_expert(params, x: torch.Tensor, cfg: ModelConfig):
    if "shared" not in params:
        return torch.zeros_like(x)
    sp = params["shared"]
    g = _activate(x @ sp["w_gate"], cfg.mlp_activation)
    return tp.rows_layout((g * (x @ sp["w_up"])) @ sp["w_down"], x)




# ---------------------------------------------------------------------------
# collectives with their adjoints
# ---------------------------------------------------------------------------


class _AllToAll(torch.autograd.Function):
    """Row block j of ``x`` (dim 0 split evenly over the group) goes to
    group rank j; the output's block j came from rank j. Its adjoint is
    the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllToAll.apply(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    """Every rank's ``x`` concatenated along dim 0 in group-rank order (a
    tiled all-gather). Adjoint: each rank's block of every rank's gradient,
    summed (a reduce-scatter, as an all-to-all and a sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=0)

    @staticmethod
    def backward(ctx, grad):
        n = dist.get_world_size(ctx.group)
        blocks = _AllToAll.apply(grad, ctx.group)
        return blocks.reshape(n, -1, *grad.shape[1:]).sum(dim=0), None


class _AllReduce(torch.autograd.Function):
    """The sum of every rank's ``x``; adjoint: the sum of every rank's
    gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduce.apply(grad, ctx.group), None


# ---------------------------------------------------------------------------
# EP path
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EPInfo:
    mesh: DeviceMesh
    ep_axes: tuple[str, ...]      # axes experts are sharded over (in order)
    batch_axes: tuple[str, ...]   # axes the batch dim is sharded over
    seq_split_axis: str = "model"  # axis used to split tokens for routing
    capacity_factor: float = 2.0
    capacity_floor: int = 4       # min slots per (dst, local-expert) pair
    ep_mode: str = "alltoall"     # alltoall | allgather (tiny-batch decode:
                                  # broadcast tokens, compute local experts
                                  # masked, all-reduce: moves O(T·d) instead
                                  # of O(N·C·d) padded buffers)
    fused_a2a: bool = False       # one all-to-all over the whole EP group
                                  # instead of one per mesh axis

    @property
    def n_devices(self) -> int:
        sizes = axis_sizes(self.mesh)
        return int(math.prod(sizes[a] for a in self.ep_axes))

    @property
    def seq_split(self) -> int:
        return int(axis_sizes(self.mesh)[self.seq_split_axis])

    def coord(self, axes) -> int:
        """This rank's row-major index over ``axes`` (JAX's
        ``lax.axis_index(axes)``)."""
        sizes, idx = axis_sizes(self.mesh), 0
        for a in axes:
            idx = idx * sizes[a] + self.mesh.get_local_rank(a)
        return idx

    @functools.cached_property
    def ep_group(self):
        """The process group over all of ``ep_axes``, its ranks in
        row-major order (a flattened sub-mesh for several axes, made on
        first use, which every rank of the mesh must reach)."""
        if len(self.ep_axes) == 1:
            return self.mesh.get_group(self.ep_axes[0])
        group = self.mesh[self.ep_axes]._flatten().get_group()
        if dist.get_rank(group) != self.coord(self.ep_axes):
            raise RuntimeError(
                f"EPInfo.ep_group: this rank is {dist.get_rank(group)} in "
                f"the group over {self.ep_axes}, not its row-major index "
                f"{self.coord(self.ep_axes)}")
        return group


def ep_padded_experts(num_experts: int, n_devices: int) -> tuple[int, int]:
    l_e = max(1, math.ceil(num_experts / n_devices))
    return l_e * n_devices, l_e


def _multi_axis_all_to_all(buf: torch.Tensor, info: EPInfo) -> torch.Tensor:
    """buf: (N, ...) where N = prod(ep_axes sizes), laid out so that the
    linear destination index is ``info.coord(ep_axes)`` (row-major over
    ep_axes). ``fused_a2a``: one all-to-all over the whole EP group (each
    element crosses the wire once). Otherwise one all-to-all per mesh axis
    over that axis's group, composed (the buffer moves once per axis)."""
    if info.fused_a2a:
        return _AllToAll.apply(buf, info.ep_group)
    sizes = [axis_sizes(info.mesh)[a] for a in info.ep_axes]
    x = buf.reshape(*sizes, *buf.shape[1:])
    for i, a in enumerate(info.ep_axes):
        x = _AllToAll.apply(x.movedim(i, 0),
                            info.mesh.get_group(a)).movedim(0, i)
    return x.reshape(buf.shape)


def _dispatch_indices(ids, gates, l_e: int, n_dev: int, capacity: int):
    """Flatten (T,k) routing into send-buffer slots.

    Returns (slot (T*k,) int64 in [0, n_dev*l_e*capacity] — == size means
    dropped; flat buffer layout is (dst_dev, local_expert, capacity)), and
    the dropped mask. An assignment's rank in its bucket is its place in a
    stable sort by bucket, so the first ``capacity`` in token order keep
    their slots, as in JAX."""
    tk = ids.shape[0] * ids.shape[1]
    bucket = ids.reshape(tk)                      # == dst*l_e + local_e
    order = torch.argsort(bucket, stable=True)
    sorted_b = bucket[order]
    # rank within bucket: index - first-occurrence-index of this bucket value
    first = torch.searchsorted(sorted_b, sorted_b, side="left")
    rank_sorted = torch.arange(tk, device=ids.device) - first
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    dropped = rank >= capacity
    slot = torch.where(dropped, n_dev * l_e * capacity,
                       bucket * capacity + rank)
    return slot, dropped


def apply_moe_ep(params, x: torch.Tensor, cfg: ModelConfig,
                 info: EPInfo) -> torch.Tensor:
    """x: (B_loc, S, d), this rank's batch rows (sharded over
    ``info.batch_axes``, the same on every rank of the other axes); the
    expert tables hold this rank's experts (the leading dim split over
    ``info.ep_axes``, row-major), the router and the shared expert
    replicated. Output: this rank's rows."""
    if info.ep_mode not in ("alltoall", "allgather"):
        raise ValueError(f"apply_moe_ep: ep_mode must be alltoall or "
                         f"allgather, got {info.ep_mode!r}")
    moe_params = {k: params[k] for k in ("router", "w_gate", "w_up",
                                         "w_down")}
    body = _moe_ep_allgather_local if info.ep_mode == "allgather" \
        else _moe_ep_local
    out = body(moe_params, x, cfg=cfg, info=info)
    return out + _shared_expert(params, x, cfg)


def _moe_ep_allgather_local(p, x, *, cfg: ModelConfig, info: EPInfo):
    """Tiny-batch EP (decode): gather every rank's tokens, compute the
    local experts over all tokens with combine-weight masking, sum the
    contributions over the EP group, keep this rank's rows."""
    b_loc, s, d = x.shape
    n_dev = info.n_devices
    l_e = p["w_gate"].shape[0]
    e_pad = l_e * n_dev

    xt = x.reshape(b_loc * s, d)
    # gather over the batch axes only (x is already replicated over the
    # rest); reversed, so that the FIRST batch axis ends up outermost,
    # matching coord(batch_axes)'s row-major order
    x_all = xt
    for a in reversed(info.batch_axes):
        x_all = _AllGather.apply(x_all, info.mesh.get_group(a))

    gates, ids = route(p["router"], x_all, cfg.top_k, e_pad)    # (T, k)
    my_dev = info.coord(info.ep_axes)
    # combine weight of each token for each LOCAL expert: (T, l_e)
    w = held_combine(gates, ids, range(my_dev * l_e, (my_dev + 1) * l_e))
    real = min(l_e, max(0, cfg.num_experts - my_dev * l_e))
    contrib = _expert_sum(x_all, p["w_gate"], p["w_up"], p["w_down"], w,
                          real, cfg)                            # (T, d) f32
    # sum expert contributions across the EP group, axis by axis
    for a in info.ep_axes:
        contrib = _AllReduce.apply(contrib, info.mesh.get_group(a))
    t_loc = b_loc * s
    my_batch = info.coord(info.batch_axes)
    out = contrib[my_batch * t_loc:(my_batch + 1) * t_loc]
    return out.to(x.dtype).reshape(b_loc, s, d)


def _moe_ep_local(p, x, *, cfg: ModelConfig, info: EPInfo):
    """Per-rank body. x: (B_loc, S, d), the same on every member of the
    ``seq_split_axis``; each member routes a distinct 1/seq_split slice of
    the rows, padded with zero rows to ``t_chunk * seq_split``, which are
    routed too (they tie every expert and go to the lowest ids)."""
    b_loc, s, d = x.shape
    n_dev = info.n_devices
    l_e = p["w_gate"].shape[0]
    e_pad = l_e * n_dev
    assert e_pad >= cfg.num_experts, (
        f"padded expert table ({e_pad}) smaller than real experts "
        f"({cfg.num_experts}) — set ModelConfig.expert_pad_to for this mesh")
    sp = info.seq_split

    t_all = b_loc * s
    t_chunk = -(-t_all // sp)  # ceil
    xt = x.reshape(t_all, d)
    if t_chunk * sp != t_all:
        xt = F.pad(xt, (0, 0, 0, t_chunk * sp - t_all))
    m_idx = info.coord((info.seq_split_axis,))
    x_chunk = xt[m_idx * t_chunk:(m_idx + 1) * t_chunk]

    gates, ids = route(p["router"], x_chunk, cfg.top_k, e_pad)  # (Tc,k)
    tk = t_chunk * cfg.top_k
    capacity = max(info.capacity_floor,
                   math.ceil(info.capacity_factor * tk / e_pad))

    slot, dropped = _dispatch_indices(ids, gates, l_e, n_dev, capacity)
    nslots = n_dev * l_e * capacity

    tok_idx = torch.arange(t_chunk, device=x.device).repeat_interleave(
        cfg.top_k)
    # one spare row takes the dropped assignments (JAX's mode="drop")
    send = x_chunk.new_zeros((nslots + 1, d)).index_put(
        (slot,), x_chunk[tok_idx])
    send = send[:nslots].reshape(n_dev, l_e, capacity, d)
    recv = _multi_axis_all_to_all(send, info)          # (n_dev, l_e, C, d)

    # ---- local expert compute: (l_e, n_dev*C, d) batched GEMMs ----------
    h = recv.transpose(0, 1).reshape(l_e, n_dev * capacity, d)
    g = _activate(torch.bmm(h, p["w_gate"]), cfg.mlp_activation)
    u = torch.bmm(h, p["w_up"])
    y = torch.bmm(g * u, p["w_down"])                  # (l_e, n_dev*C, d)

    back = y.reshape(l_e, n_dev, capacity, d).transpose(0, 1)
    ret = _multi_axis_all_to_all(back, info)           # (n_dev, l_e, C, d)
    ret = ret.reshape(nslots, d)

    # ---- combine: gather each assignment's output, weight by gate -------
    safe_slot = torch.where(dropped, 0, slot)
    picked = ret[safe_slot].float()                    # (T*k, d)
    w = torch.where(dropped, 0.0, gates.reshape(tk))
    contrib = picked * w[:, None]
    out_chunk = torch.zeros((t_chunk, d), dtype=torch.float32,
                            device=x.device).index_add(0, tok_idx, contrib)
    out_chunk = out_chunk.to(x.dtype)

    # ---- reassemble the full token set (undo the seq split) -------------
    full = _AllGather.apply(out_chunk,
                            info.mesh.get_group(info.seq_split_axis))
    return full[:t_all].reshape(b_loc, s, d)


def apply_moe(params, x: torch.Tensor, cfg: ModelConfig,
              ep: Optional[EPInfo] = None) -> torch.Tensor:
    if ep is None:
        return apply_moe_reference(params, x, cfg)
    if cfg.router_width != cfg.num_experts:
        raise ValueError(f"apply_moe: {cfg.name} holds a share of the "
                         "experts, which runs on one card without an "
                         "exchange; expert parallelism splits the whole")
    if not isinstance(ep, EPInfo):
        raise TypeError(f"apply_moe: ep must be an EPInfo or None, got "
                        f"{type(ep).__name__}")
    if tp.is_dt(x):
        return tp.moe(params, x, cfg, ep) + _shared_expert(params, x, cfg)
    return apply_moe_ep(params, x, cfg, ep)
