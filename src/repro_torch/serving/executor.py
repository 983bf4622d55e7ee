"""Real executors on PyTorch: the clock sources behind the engine.

Counterpart of ``repro/serving/executor.py`` for the families it serves:
dense, moe and vlm transformers, rwkv6 and zamba2 (hybrid). The encdec
family (whisper) is refused at construction, as the JAX executor cannot
serve it (``refuse_encdec``).

* ``RealExecutor`` runs the model on one device: a slotted cache (dense:
  ``{"k","v"}`` of shape (L, max_slots, max_len, Hkv, D); rwkv6: the
  recurrent state; zamba2: a nested tree of the mamba layers' states and
  the shared block's K/V; every leaf with its slot on axis 1), chunked
  prefill into slot rows, batched decode. Iteration durations are measured
  wall-clock.
* ``ClusterRealExecutors`` holds one executor per worker; replicas share
  weights and one ``ExecutorKernels``.
* ``RealTorchBackend`` is the ``ExecutionBackend`` that plugs the cluster
  into ``ClusterScheduler``: measured durations (``clock="wall"``) or the
  cost model's (``clock="model"``), under which scheduling decisions equal
  the pure simulator's.

Two regimes per executor, as in the JAX package:

* ``batched=False`` — the scalar reference: one ``prefill_chunk`` per
  request on its slot, a host transfer per sampled token.
* ``batched=True`` (default) — the fast path, for families with a
  ``prefill_chunk`` (dense): prefill chunks are padded to
  a pow2 bucket grid and all same-bucket parts of an iteration run as one
  call over gathered slot rows, then the decode batch, with one host to
  device upload and exactly one device to host transfer of the sampled
  tokens per iteration (``_to_host``). Rows pad LEFT with already-prefilled
  prefix tokens and spill right only while ``start + bucket <= max_len``;
  pad rows duplicate row 0, so their writes are idempotent. On a CUDA
  device each step is a CUDA graph replay: one graph per (executor cache,
  bucket, rows) prefill key and one per executor cache for the decode step
  (``ExecutorKernels``, the counterpart of the JAX ``jit``s); on the CPU
  the steps run eagerly.

Stateful families (rwkv6, zamba2) have no ``prefill_chunk``, so they run
the scalar reference under either setting, as in the JAX package: each
prefill chunk replays the prompt so far on a fresh one-slot state, and a
migration replays prompt and output on the destination. Their decode runs
ONLY the batch's slots (each leaf's batch rows gathered, decoded, written
back; zamba2's K/V leaves too). That is the one intended departure from
the JAX executor, whose scalar decode steps every slot with token 0 for
slots outside the batch: the recurrent state of a request whose last
prefill chunk rides on another request's decode batch then takes in a
bogus token (ROADMAP.md, queue 3).

Caches are updated in place (the JAX executor donates its buffers). On a
CUDA device the attention and the WKV recurrence run in the Hopper kernels.
An fp8 (e4m3) cache moves between slots and workers as bytes
(``_bytes``): torch implements no ``index_copy_`` for that dtype.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.ops import LaunchTally
from repro_torch.models import api as model_api
from repro_torch.models import moe as model_moe
from repro_torch.models.transformer import uses_ring
from repro_torch.sched.backend import SlotExhausted
from repro_torch.serving.engine import IterationPlan, Worker
from repro_torch.tracing import span

_BUCKET_FLOOR = 32
_REPLAY = {"prefill": "repro_torch.executor.replay.prefill",
           "decode": "repro_torch.executor.replay.decode"}


def _bucket_grid(max_len: int) -> tuple[int, ...]:
    """Pow2 chunk buckets from the floor up, capped by the cache length
    (the last bucket is ``max_len`` itself so padded writes stay in
    bounds even for a non-pow2 cache)."""
    grid = []
    b = min(_BUCKET_FLOOR, max_len)
    while b < max_len:
        grid.append(b)
        b *= 2
    grid.append(max_len)
    return tuple(grid)


def _next_pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length() if n > 1 else 1


def resolve_device(device=None) -> torch.device:
    """The port runs on the card: ``None`` means CUDA and raises without
    one. The CPU is used only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the PyTorch port runs on the card; pass "
                "device='cpu' to run its plain versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def refuse_ring(cfg) -> None:
    """The executors keep a slotted (L, slots, max_len, Hkv, D) cache and
    move slot rows of it; gemma2's per-layer ring cache has no slot rows
    of one shape. The JAX executor fails on it too (its cache view slices
    the sequence axis of the per-layer leaves: ``vmap got inconsistent
    sizes``), so it is refused here, not served another way."""
    if uses_ring(cfg):
        raise NotImplementedError(
            f"{cfg.name}: the executor does not serve the window-sized ring "
            "cache (window_sized_cache without scan_layers), as the JAX "
            "executor cannot; serve the full-length cache, or decode a ring "
            "through models.transformer (ROADMAP.md)")


def refuse_encdec(cfg) -> None:
    """The JAX executor cannot serve the encoder-decoder family: its
    stateful prefill hands ``api.prefill`` a token array, and the encdec
    branch there reads ``inputs["frames"]`` from it, which fails at the
    first prefill in both regimes. So it is refused here, not served
    another way."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the executor does not serve the encdec family, as "
            "the JAX executor cannot (its prefill passes tokens where "
            "api.prefill reads inputs['frames']); run whisper through "
            "models.api's prefill({'frames', 'tokens'}) and decode "
            "(ROADMAP.md)")


def _tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of tensors, as ``jax.tree.map``
    (the first tree's structure); the result keeps the structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _upload(arrays: list[np.ndarray], device) -> torch.Tensor:
    """One host->device upload of an iteration's int32 inputs, laid end to
    end in one flat tensor."""
    return torch.from_numpy(np.concatenate([a.ravel() for a in arrays])).to(
        device)


def _to_device(arrays: list[np.ndarray], device) -> list[torch.Tensor]:
    """``_upload``, then a view of each array."""
    return _split(_upload(arrays, device), [a.shape for a in arrays])


def _split(flat: torch.Tensor, shapes) -> list[torch.Tensor]:
    """Views of consecutive pieces of ``flat`` in ``shapes``."""
    out, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        out.append(flat[off:off + n].view(shape))
        off += n
    return out


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """A cache leaf as raw bytes, so that gathers, scatters and copies take
    every dtype (the e4m3 cache's included)."""
    return t.view(torch.uint8)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """The one device->host transfer of an iteration; it waits for the
    device, so the iteration's work is done when it returns."""
    return t.cpu().numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def capture_cuda_graph(fn, pool):
    """``fn``'s work captured as a ``torch.cuda.CUDAGraph`` whose memory
    comes from ``pool``: (the graph's replay, ``fn``'s output). Nothing
    runs on the card until a replay. The garbage collector is off during
    the capture: a collection could free another graph (say, of a
    cluster no longer referenced), and destroying a graph is not
    permitted while a stream captures, which invalidates the capture."""
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
    finally:
        if collecting:
            gc.enable()
    return graph.replay, out


class _StepGraph:
    """One captured step: its static int32 inputs (one flat buffer, which
    each replay's inputs are copied into), the static buffer it writes the
    sampled tokens (and a MoE model's counts) into, the launches each
    replay makes, and the timing event pairs it records around each MoE
    layer's expert products (``moe.Probe``)."""

    def __init__(self, params, flat, replay, out, tally, events=()):
        self.params = params        # the weights it reads, kept alive
        self.flat = flat
        self._replay = replay
        self.out = out
        self.tally = tally
        self.events = list(events)

    def replay(self, flat: torch.Tensor) -> torch.Tensor:
        self.flat.copy_(flat)
        self._replay()
        self.tally.replay()
        return self.out


class ExecutorKernels:
    """Slot-indexed entry points over one cache geometry, shared by every
    executor in a cluster.

    A step is keyed as the JAX ``jit``s are: ``("prefill", bucket, rows)``
    or ``("decode",)``. Its output is the sampled tokens, and after them,
    for a model with single-card MoE layers, ``moe.Probe.counts`` over the
    step's live tokens, in the same int32 buffer, so that they reach the
    host in the iteration's one transfer. On a CUDA device ``step``
    replays a ``torch.cuda.CUDAGraph`` per (cache, key): a graph holds its
    cache's addresses, and every worker owns a cache. A key is run eagerly
    once and captured at its first use (``warmup`` captures (bucket, 1) for every
    bucket and the decode step for each cache given, as the JAX warmup
    compiles them); ``prefill_traces`` / ``decode_traces`` count the
    captures as the JAX counters count traces, ``capture_seconds`` sums
    their time. All graphs of the cluster share one memory pool for their
    scratch: steps run one at a time on one stream, and each graph's
    static inputs and outputs lie outside the pool and stay referenced
    while it lives, so graphs replay in any order. A failed capture or
    replay raises; nothing runs the step eagerly in its place. On the CPU
    every step runs eagerly (the device the caller asked for) and nothing
    is captured.
    """

    def __init__(self, api, max_slots: int, max_len: int, device):
        self.api = api
        self.max_slots = max_slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.buckets = _bucket_grid(max_len)
        self.graphed = self.device.type == "cuda"
        self.prefill_traces = 0
        self.decode_traces = 0
        self.capture_seconds = 0.0
        self._graphs: dict = {}
        self._pool = torch.cuda.graph_pool_handle() if self.graphed else None

    def bucket_for(self, take: int) -> int:
        for b in self.buckets:
            if take <= b:
                return b
        raise ValueError(f"chunk of {take} tokens exceeds max_len "
                         f"{self.max_len}")

    def input_shapes(self, key) -> list[tuple]:
        """The int32 inputs of a step, in order: a prefill's chunk, slots,
        starts and takes; a decode's tokens and lengths."""
        if key[0] == "prefill":
            _, bucket, rows = key
            return [(rows, bucket), (rows,), (rows,), (rows,)]
        return [(self.max_slots,), (self.max_slots,)]

    # ---------------------------------------------------------- entry points
    def prefill_fn(self, params, cache, chunk, slots, starts, takes,
                   events=None):
        """Batched bucketed prefill: gathers the ``slots`` rows, runs one
        padded ``prefill_chunk`` on them, scatters the rows back, and
        samples every row's next token on the device. A row's live tokens
        are its first ``takes``; the MoE counts leave out the rows that
        repeat row 0, while the experts run them as row 0 (their scatter
        writes row 0's bytes again)."""
        idx = slots.long()
        view = {k: _bytes(a).index_select(1, idx).view(a.dtype)
                for k, a in cache.items()}
        taken = None
        if self.api.cfg.is_moe:
            cols = torch.arange(chunk.shape[1], device=chunk.device)
            taken = cols[None, :] < takes[:, None]
        with model_moe.probe(timed=events is not None,
                             live=None if taken is None
                             else taken.reshape(-1)) as pr:
            logits, view = self.api.prefill_chunk(params, view, chunk,
                                                  starts, take=takes)
        for k, a in cache.items():
            _bytes(a).index_copy_(1, idx, _bytes(view[k]))
        toks = logits.argmax(dim=-1).to(torch.int32)
        if not pr.routes:
            return toks, cache
        rows = torch.arange(chunk.shape[0], device=chunk.device)
        first = (rows == 0) | (slots != slots[0])
        live = taken & first[:, None]
        return self._counted(toks, pr, live.reshape(-1), events), cache

    def decode_fn(self, params, cache, tokens, lengths, events=None):
        """The decode step over every slot; its live rows are the slots
        that hold a request (length above 0)."""
        live = lengths > 0 if self.api.cfg.is_moe else None
        with model_moe.probe(timed=events is not None, live=live) as pr:
            logits, cache = self.api.decode(params, cache, tokens, lengths)
        toks = logits.argmax(dim=-1).to(torch.int32)
        if not pr.routes:
            return toks, cache
        return self._counted(toks, pr, live, events), cache

    @staticmethod
    def _counted(toks, pr, live, events):
        """The tokens, then the MoE layers' counts over the live tokens;
        the layers' event pairs into ``events``."""
        if events is not None:
            events.extend(pr.events)
        return torch.cat([toks, pr.counts(live)])

    @staticmethod
    def copy_fn(dst, src, dslot: int, sslot: int):
        """Device-to-device KV slot copy (migration fast path), in place."""
        for k in dst:
            _bytes(dst[k])[:, dslot].copy_(_bytes(src[k])[:, sslot])
        return dst

    def _eager(self, params, cache, key, flat: torch.Tensor,
               events=None) -> torch.Tensor:
        fn = self.prefill_fn if key[0] == "prefill" else self.decode_fn
        toks, _ = fn(params, cache, *_split(flat, self.input_shapes(key)),
                     events=events)
        return toks

    @staticmethod
    def _gkey(params, cache, key) -> tuple:
        return (id(params), cache["k"].data_ptr(), cache["v"].data_ptr(),
                key)

    def events(self, params, cache, key) -> list:
        """The timing event pairs of the graph that runs ``key`` on
        ``cache``, one a MoE layer (none where the step runs eagerly)."""
        g = self._graphs.get(self._gkey(params, cache, key))
        return g.events if g is not None else []

    def step(self, params, cache, key, flat: torch.Tensor) -> torch.Tensor:
        """One step of ``key`` on ``cache`` with its int32 inputs ``flat``
        (``input_shapes`` laid end to end): the sampled tokens. On a CUDA
        device a graph replay, captured at the key's first use."""
        if not self.graphed:
            return self._eager(params, cache, key, flat)
        gkey = self._gkey(params, cache, key)
        if gkey not in self._graphs:
            self._graphs[gkey] = self._capture(params, cache, key, flat)
        return self._graphs[gkey].replay(flat)

    # --------------------------------------------------------------- graphs
    def _capture(self, params, cache, key, flat) -> _StepGraph:
        """Run ``key`` eagerly once on a copy of ``flat`` (the kernel
        launchers cache their device queries in that run), then capture it
        into the cluster's pool with that copy as the graph's static input
        buffer and the eager run's tokens as its static output. Both lie
        outside the pool, whose memory another graph's replay may reuse as
        scratch: a graph's output in the pool could be overwritten before
        it is read. The eager run and the replays write the same K/V rows,
        so a capture at first use changes nothing a step would not. On a
        card the captured run times its MoE layers' expert products
        (``moe.Probe``)."""
        with span("repro_torch.executor.capture", key=key):
            static = flat.clone()
            out = self._eager(params, cache, key, static)
            t0 = time.perf_counter()
            tally = LaunchTally()
            events = [] if self.device.type == "cuda" else None
            replay, _ = tally.record(lambda: capture_cuda_graph(
                lambda: out.copy_(self._eager(params, cache, key, static,
                                              events)),
                self._pool))
            _sync(self.device)
            self.capture_seconds += time.perf_counter() - t0
        if key[0] == "prefill":
            self.prefill_traces += 1
        else:
            self.decode_traces += 1
        return _StepGraph(params, static, replay, out, tally, events or ())

    @property
    def captures(self) -> int:
        return self.prefill_traces + self.decode_traces

    def pool_bytes(self) -> int:
        """Device memory the graphs' shared pool holds (its segments)."""
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == pool)

    # --------------------------------------------------------------- warmup
    def warmup(self, params, caches) -> None:
        """Step the (bucket, 1-row) grid and the decode step once on each
        of ``caches`` (on a CUDA device: capture them), then zero the
        caches, so the first scheduled iterations measure steady state.
        Each step is a placeholder: slot 0 from position 0, one token."""
        for cache in caches:
            for key in [("prefill", b, 1) for b in self.buckets] + \
                    [("decode",)]:
                n = sum(math.prod(s) for s in self.input_shapes(key))
                flat = torch.zeros((n,), dtype=torch.int32,
                                   device=self.device)
                if key[0] == "prefill":
                    flat[-1] = 1                   # takes
                self.step(params, cache, key, flat)
            for a in cache.values():
                a.zero_()
        _sync(self.device)


class RealExecutor:
    """One executor per worker; owns a slotted cache (weights shared)."""

    def __init__(self, cfg, seed: int = 0, max_slots: int = 8,
                 max_len: int = 256, params=None, batched: bool = True,
                 wid: int = 0, kernels: Optional[ExecutorKernels] = None,
                 owner=None, device=None):
        refuse_ring(cfg)
        refuse_encdec(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.api = model_api.build(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.api.init(gen)
        self.params = self.api.prepare(params)
        self.max_slots = max_slots
        self.max_len = max_len
        self.wid = wid
        self.cache = self.api.init_cache(max_slots, max_len, self.device)
        self.free_slots = list(range(max_slots))
        self.slot_of: dict[int, int] = {}
        self.owner = owner                   # cluster rid -> wid registry
        self.lengths = np.zeros(max_slots, np.int32)
        self.prompts: dict[int, np.ndarray] = {}     # rid -> prompt tokens
        self.generated: dict[int, list[int]] = {}
        self.fast = bool(batched and self.api.prefill_chunk is not None)
        # the last plan's MoE layers (fast path): each step's counts, a row
        # (held assignments, held experts touched, all assignments) a
        # layer, and the seconds its expert products took on the card
        self.moe_counts: Optional[np.ndarray] = None
        self.moe_expert_seconds: Optional[float] = None
        if self.fast and kernels is None:
            kernels = ExecutorKernels(self.api, max_slots, max_len,
                                      self.device)
        self.kernels = kernels

    # ------------------------------------------------------------ requests
    def register(self, req) -> None:
        if req.rid not in self.prompts:
            rng = np.random.default_rng(req.rid)
            self.prompts[req.rid] = rng.integers(
                0, self.cfg.vocab_size, size=req.prompt_len).astype(np.int32)
            self.generated[req.rid] = []

    def _slot(self, rid: int) -> int:
        if rid not in self.slot_of:
            if not self.free_slots:
                raise SlotExhausted(self.wid, rid, self.max_slots)
            self.slot_of[rid] = self.free_slots.pop()
            self.lengths[self.slot_of[rid]] = 0
            if self.owner is not None:
                self.owner[rid] = self.wid
        return self.slot_of[rid]

    def release(self, rid: int) -> None:
        slot = self.slot_of.pop(rid, None)
        if slot is not None:
            self.lengths[slot] = 0
            self.free_slots.append(slot)
            if self.owner is not None and self.owner.get(rid) == self.wid:
                del self.owner[rid]

    # ----------------------------------------------------------- execution
    def _cache_view(self, slot: int):
        """The slot's rows of every leaf as views: writes through them land
        in the cache."""
        return _tree_map(lambda a: a[:, slot:slot + 1], self.cache)

    def _cache_write(self, slot: int, view) -> None:
        _tree_map(lambda a, v: a[:, slot:slot + 1].copy_(v), self.cache, view)

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(
            self.device)

    def run_prefill_chunk(self, req, tokens_this_chunk: int) -> None:
        self.register(req)
        slot = self._slot(req.rid)
        start = int(req.prefilled_tokens)
        take = tokens_this_chunk
        if self.api.prefill_chunk is not None:
            chunk = self.prompts[req.rid][start:start + take]
            logits, _ = self.api.prefill_chunk(
                self.params, self._cache_view(slot),
                self._tensor(chunk[None, :]),
                self._tensor(np.asarray([start])))
        else:
            # stateful families: re-run full prefill up to this point
            full = self.prompts[req.rid][:start + take]
            view = self._fresh_view()
            logits, view = self.api.prefill(
                self.params, view, self._tensor(full[None, :]),
                self._tensor(np.asarray([start + take])))
            self._cache_write(slot, view)
        self.lengths[slot] = start + take
        if start + take >= req.prompt_len:
            tok = int(logits[0].argmax())
            self.generated[req.rid].append(tok)

    def _fresh_view(self):
        return self.api.init_cache(1, self.max_len, self.device)

    def run_decode_batch(self, reqs) -> None:
        if not reqs:
            return
        if self.api.prefill_chunk is None:
            self._decode_slots(reqs)
            return
        slots = [self._slot(r.rid) for r in reqs]
        tokens = np.zeros(self.max_slots, np.int32)
        lengths = np.array(self.lengths)
        for r, s in zip(reqs, slots):
            tokens[s] = self.generated[r.rid][-1]
        logits, self.cache = self.api.decode(
            self.params, self.cache, self._tensor(tokens),
            self._tensor(lengths))
        logits = logits.cpu().numpy()
        for r, s in zip(reqs, slots):
            self.generated[r.rid].append(int(logits[s].argmax()))
            self.lengths[s] += 1

    def _decode_slots(self, reqs) -> None:
        """Stateful families: decode only the batch's slots. Their rows of
        every state leaf (nested ones included) are gathered, decoded and
        written back, so a slot outside the batch keeps its state bit for
        bit."""
        slots = [self._slot(r.rid) for r in reqs]
        tokens = np.asarray([self.generated[r.rid][-1] for r in reqs],
                            np.int32)
        idx, tok, lengths = _to_device(
            [np.asarray(slots, np.int32), tokens, self.lengths[slots]],
            self.device)
        idx = idx.long()
        view = _tree_map(lambda a: a.index_select(1, idx), self.cache)
        logits, view = self.api.decode(self.params, view, tok, lengths)
        _tree_map(lambda a, v: a.index_copy_(1, idx, v), self.cache, view)
        host = _to_host(logits.argmax(dim=-1))
        for r, s, t in zip(reqs, slots, host):
            self.generated[r.rid].append(int(t))
            self.lengths[s] += 1

    # ------------------------------------------------------ fused fast path
    def assign_slots(self, plan: IterationPlan) -> None:
        """Reserve every slot the plan needs BEFORE any compute runs, so a
        ``SlotExhausted`` refusal is side-effect-free on the device (re-
        running a final prefill chunk would double-append its sampled
        token)."""
        for req, _ in plan.prefill_parts:
            self.register(req)
            self._slot(req.rid)
        for r in plan.decode_reqs:
            self._slot(r.rid)

    def run_plan(self, plan: IterationPlan) -> None:
        """Execute one composed iteration (either regime), returning after
        the device is idle."""
        self.assign_slots(plan)
        self.moe_counts = self.moe_expert_seconds = None
        if self.fast:
            self._run_plan_fast(plan)
            return
        for req, take in plan.prefill_parts:
            self.run_prefill_chunk(req, take)
        self.run_decode_batch(plan.decode_reqs)
        _sync(self.device)

    def _run_plan_fast(self, plan: IterationPlan) -> None:
        with span("repro_torch.executor.prepare", wid=self.wid):
            calls, pending = self._prepare(plan)
        if not calls:
            return
        arrays = [a for _, arrs in calls for a in arrs]
        with span("repro_torch.executor.upload",
                  bytes=lambda: sum(a.nbytes for a in arrays)):
            flat = _upload(arrays, self.device)
        tok_parts, off = [], 0
        for key, arrs in calls:
            n = sum(a.size for a in arrs)
            with span(_REPLAY[key[0]], key=key):
                tok_parts.append(self.kernels.step(self.params, self.cache,
                                                   key, flat[off:off + n]))
            off += n
        sizes = [t.shape[0] for t in tok_parts]
        toks = torch.cat(tok_parts)
        # exactly one device->host transfer per iteration
        with span("repro_torch.executor.to_host"):
            host = _to_host(toks)
        with span("repro_torch.executor.scatter"):
            self._scatter(pending, host, sizes)
        pairs = [p for key, _ in calls
                 for p in self.kernels.events(self.params, self.cache, key)]
        if pairs:       # done: the transfer waited for the card
            self.moe_expert_seconds = 1e-3 * sum(
                a.elapsed_time(b) for a, b in pairs)

    def _prepare(self, plan: IterationPlan) -> tuple[list, list]:
        """Every host input of the iteration, before its one upload: the
        steps' ``(key, [int32 inputs])`` and, in the same order, what each
        step's sampled tokens go to (``("prefill", finals)`` or
        ``("decode", pairs)``)."""
        groups: dict[int, list] = {}
        for req, take in plan.prefill_parts:
            bucket = self.kernels.bucket_for(take)
            groups.setdefault(bucket, []).append((req, take))
        calls = []          # (step key, [int32 inputs])
        pending = []        # ("prefill", finals) | ("decode", pairs)
        for bucket in sorted(groups):
            parts = groups[bucket]
            rows = _next_pow2(len(parts))
            chunk = np.zeros((rows, bucket), np.int32)
            slots = np.zeros(rows, np.int32)
            starts = np.zeros(rows, np.int32)
            takes = np.ones(rows, np.int32)
            finals: list = [None] * rows
            for i, (req, take) in enumerate(parts):
                start = int(req.prefilled_tokens)
                slot = self.slot_of[req.rid]
                # pad LEFT with the already-prefilled prefix (recomputing
                # identical KV) so the padded write window never crosses
                # max_len
                pad_l = min(bucket - take, start)
                row_start = start - pad_l
                toks = self.prompts[req.rid][row_start:start + take]
                chunk[i, :len(toks)] = toks
                slots[i] = slot
                starts[i] = row_start
                takes[i] = pad_l + take
                self.lengths[slot] = start + take
                if start + take >= req.prompt_len:
                    finals[i] = req
            for i in range(len(parts), rows):   # duplicate row 0: idempotent
                chunk[i] = chunk[0]
                slots[i] = slots[0]
                starts[i] = starts[0]
                takes[i] = takes[0]
            calls.append((("prefill", bucket, rows),
                          [chunk, slots, starts, takes]))
            pending.append(("prefill", finals))
        if plan.decode_reqs:
            dpairs = [(r, self._slot(r.rid)) for r in plan.decode_reqs]
            tokens = np.zeros(self.max_slots, np.int32)
            for r, s in dpairs:
                tokens[s] = self.generated[r.rid][-1]
            calls.append((("decode",), [tokens, np.array(self.lengths)]))
            pending.append(("decode", dpairs))
        return calls, pending

    def _scatter(self, pending: list, host: np.ndarray, sizes) -> None:
        """The sampled tokens into ``generated``, and each decoded slot's
        length up by one; the entries each step's output has past its
        tokens (``sizes``: each output's length) into ``moe_counts``."""
        off, counts = 0, []
        for (kind, data), size in zip(pending, sizes):
            if kind == "prefill":
                for i, req in enumerate(data):
                    if req is not None:
                        self.generated[req.rid].append(int(host[off + i]))
                n = len(data)
            else:
                for r, s in data:
                    self.generated[r.rid].append(int(host[off + s]))
                    self.lengths[s] += 1
                n = self.max_slots
            if size > n:
                counts.append(host[off + n:off + size].reshape(-1, 3))
            off += size
        if counts:
            self.moe_counts = np.concatenate(counts).astype(np.int64)


class ClusterRealExecutors:
    """Per-worker RealExecutor registry.

    All replicas share weights and entry points. ``params`` are the port's
    parameters (e.g. from ``models.convert.params_from_jax``); without them
    the weights are drawn from a ``torch.Generator`` seeded with ``seed``.
    ``device=None`` means CUDA and raises without a card. ``warmup`` runs
    every entry point once before the first measured iteration (kernels
    built and loaded; on a CUDA device the dense fast path's warmup keys
    captured for every worker's cache).
    """

    def __init__(self, cfg, n_workers: int, max_slots: int = 8,
                 max_len: int = 256, batched: bool = True,
                 warmup: bool = True, device=None, params=None,
                 seed: int = 0):
        refuse_ring(cfg)
        refuse_encdec(cfg)
        device = resolve_device(device)
        api = model_api.build(cfg)
        if params is None:
            params = api.init(torch.Generator(device=device).manual_seed(seed))
        self.params = api.prepare(params)   # replicas share weights
        self._owner: dict[int, int] = {}     # rid -> owning wid
        kernels = ExecutorKernels(api, max_slots, max_len, device) \
            if batched and api.prefill_chunk is not None else None
        self.kernels = kernels
        self.execs = {
            i: RealExecutor(cfg, max_slots=max_slots, max_len=max_len,
                            params=self.params, batched=batched, wid=i,
                            kernels=kernels, owner=self._owner,
                            device=device)
            for i in range(n_workers)
        }
        if warmup and kernels is not None:
            kernels.warmup(self.params,
                           [e.cache for e in self.execs.values()])
        elif warmup and api.prefill_chunk is None:
            _warmup_stateful(api, self.params, max_len, device)

    def on_finish(self, req) -> None:
        wid = self._owner.get(req.rid)
        if wid is not None:
            self.execs[wid].release(req.rid)

    def as_backend(self, clock: str = "wall") -> "RealTorchBackend":
        return RealTorchBackend(self, clock=clock)

    def migrate(self, req, src: int, dst: int) -> None:
        """Move the request across workers: the fast path copies the KV
        slot device-to-device; the scalar reference and stateful families
        re-derive it by replaying prefill of prompt and output so far."""
        with span("repro_torch.executor.migrate", rid=req.rid, src=src,
                  dst=dst):
            se, de = self.execs[src], self.execs[dst]
            de.prompts[req.rid] = se.prompts[req.rid]
            de.generated[req.rid] = list(se.generated[req.rid])
            slot = de._slot(req.rid)    # SlotExhausted reaches the scheduler
            sslot = se.slot_of.get(req.rid)
            if de.fast and sslot is not None and se.fast:
                de.cache = de.kernels.copy_fn(de.cache, se.cache, slot,
                                              sslot)
                de.lengths[slot] = se.lengths[sslot]
                se.release(req.rid)
                return
            # replay KV on the destination (simulating the transfer)
            full = np.concatenate([
                de.prompts[req.rid],
                np.asarray(de.generated[req.rid][:-1], np.int32)]) \
                if len(de.generated[req.rid]) > 1 else de.prompts[req.rid]
            view = de._fresh_view()
            de.api.prefill(de.params, view, de._tensor(full[None, :]),
                           de._tensor(np.asarray([len(full)])))
            de._cache_write(slot, view)
            de.lengths[slot] = len(full)
            se.release(req.rid)


def _warmup_stateful(api, params, max_len: int, device) -> None:
    """One short prefill and one decode of a stateful family on a
    throwaway one-slot state."""
    state = api.init_cache(1, max_len, device)
    toks = torch.zeros((1, 8), dtype=torch.int32, device=device)
    n = torch.full((1,), 8, dtype=torch.int32, device=device)
    api.prefill(params, state, toks, n)
    api.decode(params, state, toks[:, 0], n)
    _sync(device)


class RealTorchBackend:
    """ExecutionBackend over per-worker RealExecutors.

    ``clock="wall"``   — report measured wall-clock durations.
    ``clock="model"``  — run the real compute but report the analytical
                         cost-model duration, so decision logs equal the
                         pure simulator's.

    A worker out of KV slots raises ``SlotExhausted`` before any compute
    runs; the scheduler turns it into a dispatch refusal. ``iterations``
    and ``mixed_iterations`` count the plans run and those that carried
    both prefill parts and decode requests; ``busy_seconds`` sums their
    measured durations. ``prefill_tokens`` counts the prompt tokens the
    plans prefilled (padding left out), and ``ridden_prefill_tokens`` those
    of them that rode on an iteration with decode requests: Tropical's
    multiplexing at work. For a model with single-card MoE layers on the
    fast path, ``moe_counts`` keeps each iteration's counts (a row a step
    and layer: held assignments, held experts touched, all assignments,
    over the step's live tokens; ``moe.Probe.counts``) and
    ``moe_expert_seconds`` sums the card time of the expert products
    (on a card: the event pairs of each graph).
    """

    def __init__(self, execs: ClusterRealExecutors, clock: str = "wall"):
        if clock not in ("wall", "model"):
            raise ValueError(f"clock must be 'wall' or 'model', got {clock!r}")
        self.execs = execs
        self.clock = clock
        self.iterations = 0
        self.mixed_iterations = 0
        self.busy_seconds = 0.0
        self.prefill_tokens = 0
        self.ridden_prefill_tokens = 0
        self.moe_counts: list = []
        self.moe_expert_seconds = 0.0

    def run_iteration(self, worker: Worker, plan: IterationPlan) -> float:
        e = self.execs.execs[worker.wid]
        with span("repro_torch.executor.iteration", wid=worker.wid,
                  it=self.iterations,
                  decode=lambda: [r.rid for r in plan.decode_reqs],
                  prefill=lambda: [f"{r.rid}:{take}"
                                   for r, take in plan.prefill_parts]):
            t0 = time.perf_counter()
            e.run_plan(plan)
            measured = time.perf_counter() - t0
        self.iterations += 1
        self.busy_seconds += measured
        mixed = bool(plan.prefill_parts and plan.decode_reqs)
        self.mixed_iterations += mixed
        tokens = sum(take for _, take in plan.prefill_parts)
        self.prefill_tokens += tokens
        self.ridden_prefill_tokens += tokens if mixed else 0
        if e.moe_counts is not None:
            self.moe_counts.append(e.moe_counts)
        if e.moe_expert_seconds is not None:
            self.moe_expert_seconds += e.moe_expert_seconds
        return measured if self.clock == "wall" else worker.plan_duration(plan)

    def on_finish(self, req) -> None:
        self.execs.on_finish(req)

    def on_migrate(self, req, src_wid: int, dst_wid: int) -> None:
        self.execs.migrate(req, src_wid, dst_wid)
