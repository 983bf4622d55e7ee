"""Real executors on PyTorch: the clock sources behind the engine.

Counterpart of ``repro/serving/executor.py`` for the families the port
carries (dense transformers).

* ``RealExecutor`` runs the model on one device: a slotted cache
  ``{"k","v"}`` of shape (L, max_slots, max_len, Hkv, D), chunked prefill
  into slot rows, batched decode across all slots. Iteration durations are
  measured wall-clock.
* ``ClusterRealExecutors`` holds one executor per worker; replicas share
  weights and one ``ExecutorKernels``.
* ``RealTorchBackend`` is the ``ExecutionBackend`` that plugs the cluster
  into ``ClusterScheduler``: measured durations (``clock="wall"``) or the
  cost model's (``clock="model"``), under which scheduling decisions equal
  the pure simulator's.

Two regimes per executor, as in the JAX package:

* ``batched=False`` — the scalar reference: one ``prefill_chunk`` per
  request on its slot, a host transfer per sampled token.
* ``batched=True`` (default) — the fast path: prefill chunks are padded to
  a pow2 bucket grid and all same-bucket parts of an iteration run as one
  call over gathered slot rows, then the decode batch, with one host to
  device upload and exactly one device to host transfer of the sampled
  tokens per iteration (``_to_host``). Rows pad LEFT with already-prefilled
  prefix tokens and spill right only while ``start + bucket <= max_len``;
  pad rows duplicate row 0, so their writes are idempotent.

Caches are updated in place (the JAX executor donates its buffers). On a
CUDA device the attention of both regimes runs in the Hopper kernels.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.models import api as model_api
from repro_torch.sched.backend import SlotExhausted
from repro_torch.serving.engine import IterationPlan, Worker

_BUCKET_FLOOR = 32


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


def _to_device(arrays: list[np.ndarray], device) -> list[torch.Tensor]:
    """One host->device upload of an iteration's int32 inputs."""
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in arrays]))
    flat = flat.to(device)
    out, off = [], 0
    for a in arrays:
        out.append(flat[off:off + a.size].view(a.shape))
        off += a.size
    return out


def _to_host(t: torch.Tensor) -> np.ndarray:
    """The one device->host transfer of an iteration; it waits for the
    device, so the iteration's work is done when it returns."""
    return t.cpu().numpy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ExecutorKernels:
    """Slot-indexed entry points over one cache geometry, shared by every
    executor in a cluster."""

    def __init__(self, api, max_slots: int, max_len: int, device):
        self.api = api
        self.max_slots = max_slots
        self.max_len = max_len
        self.device = torch.device(device)
        self.buckets = _bucket_grid(max_len)

    def bucket_for(self, take: int) -> int:
        for b in self.buckets:
            if take <= b:
                return b
        raise ValueError(f"chunk of {take} tokens exceeds max_len "
                         f"{self.max_len}")

    # ---------------------------------------------------------- entry points
    def prefill_fn(self, params, cache, chunk, slots, starts, takes):
        """Batched bucketed prefill: gathers the ``slots`` rows, runs one
        padded ``prefill_chunk`` on them, scatters the rows back, and
        samples every row's next token on the device."""
        idx = slots.long()
        view = {k: a.index_select(1, idx) for k, a in cache.items()}
        logits, view = self.api.prefill_chunk(params, view, chunk, starts,
                                              take=takes)
        for k, a in cache.items():
            a.index_copy_(1, idx, view[k])
        return logits.argmax(dim=-1).to(torch.int32), cache

    def decode_fn(self, params, cache, tokens, lengths):
        logits, cache = self.api.decode(params, cache, tokens, lengths)
        return logits.argmax(dim=-1).to(torch.int32), cache

    @staticmethod
    def copy_fn(dst, src, dslot: int, sslot: int):
        """Device-to-device KV slot copy (migration fast path), in place."""
        for k in dst:
            dst[k][:, dslot].copy_(src[k][:, sslot])
        return dst

    # --------------------------------------------------------------- warmup
    def warmup(self, params) -> None:
        """Run the (bucket, 1-row) grid and the decode step once on a
        throwaway cache, so the first scheduled iterations measure steady
        state (kernels built and loaded, allocator warm)."""
        dev = self.device
        cache = self.api.init_cache(self.max_slots, self.max_len, dev)
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        one = torch.ones((1,), dtype=torch.int32, device=dev)
        for b in self.buckets:
            self.prefill_fn(params, cache, torch.zeros(
                (1, b), dtype=torch.int32, device=dev), zero, zero, one)
        zeros = torch.zeros((self.max_slots,), dtype=torch.int32, device=dev)
        self.decode_fn(params, cache, zeros, zeros)
        _sync(dev)


class RealExecutor:
    """One executor per worker; owns a slotted cache (weights shared)."""

    def __init__(self, cfg, seed: int = 0, max_slots: int = 8,
                 max_len: int = 256, params=None, batched: bool = True,
                 wid: int = 0, kernels: Optional[ExecutorKernels] = None,
                 owner=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.api = model_api.build(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.api.init(gen)
        self.params = params
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
        self.fast = batched
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
        """The slot's rows as views: writes through them land in the cache."""
        return {k: a[:, slot:slot + 1] for k, a in self.cache.items()}

    def _cache_write(self, slot: int, view) -> None:
        for k, a in self.cache.items():
            a[:, slot:slot + 1].copy_(view[k])

    def _tensor(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr, np.int32)).to(
            self.device)

    def run_prefill_chunk(self, req, tokens_this_chunk: int) -> None:
        self.register(req)
        slot = self._slot(req.rid)
        start = int(req.prefilled_tokens)
        take = tokens_this_chunk
        chunk = self.prompts[req.rid][start:start + take]
        logits, _ = self.api.prefill_chunk(
            self.params, self._cache_view(slot), self._tensor(chunk[None, :]),
            self._tensor(np.asarray([start])))
        self.lengths[slot] = start + take
        if start + take >= req.prompt_len:
            tok = int(logits[0].argmax())
            self.generated[req.rid].append(tok)

    def _fresh_view(self):
        return self.api.init_cache(1, self.max_len, self.device)

    def run_decode_batch(self, reqs) -> None:
        if not reqs:
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
        if self.fast:
            self._run_plan_fast(plan)
            return
        for req, take in plan.prefill_parts:
            self.run_prefill_chunk(req, take)
        self.run_decode_batch(plan.decode_reqs)
        _sync(self.device)

    def _run_plan_fast(self, plan: IterationPlan) -> None:
        groups: dict[int, list] = {}
        for req, take in plan.prefill_parts:
            bucket = self.kernels.bucket_for(take)
            groups.setdefault(bucket, []).append((req, take))
        # host side first: every input of the iteration, then one upload
        calls = []          # (prefill_fn | decode_fn, [int32 inputs])
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
            calls.append((self.kernels.prefill_fn,
                          [chunk, slots, starts, takes]))
            pending.append(("prefill", finals))
        if plan.decode_reqs:
            dpairs = [(r, self._slot(r.rid)) for r in plan.decode_reqs]
            tokens = np.zeros(self.max_slots, np.int32)
            for r, s in dpairs:
                tokens[s] = self.generated[r.rid][-1]
            calls.append((self.kernels.decode_fn,
                          [tokens, np.array(self.lengths)]))
            pending.append(("decode", dpairs))
        if not calls:
            return
        dev = _to_device([a for _, arrs in calls for a in arrs], self.device)
        tok_parts = []
        for fn, arrs in calls:
            args, dev = dev[:len(arrs)], dev[len(arrs):]
            toks, self.cache = fn(self.params, self.cache, *args)
            tok_parts.append(toks)
        # exactly one device->host transfer per iteration
        host = _to_host(torch.cat(tok_parts))
        off = 0
        for kind, data in pending:
            if kind == "prefill":
                for i, req in enumerate(data):
                    if req is not None:
                        self.generated[req.rid].append(int(host[off + i]))
                off += len(data)
            else:
                for r, s in data:
                    self.generated[r.rid].append(int(host[off + s]))
                    self.lengths[s] += 1
                off += self.max_slots

class ClusterRealExecutors:
    """Per-worker RealExecutor registry.

    All replicas share weights and entry points. ``params`` are the port's
    parameters (e.g. from ``models.convert.params_from_jax``); without them
    the weights are drawn from a ``torch.Generator`` seeded with ``seed``.
    ``device=None`` means CUDA and raises without a card.
    """

    def __init__(self, cfg, n_workers: int, max_slots: int = 8,
                 max_len: int = 256, batched: bool = True,
                 warmup: bool = True, device=None, params=None,
                 seed: int = 0):
        device = resolve_device(device)
        api = model_api.build(cfg)
        if params is None:
            params = api.init(torch.Generator(device=device).manual_seed(seed))
        self.params = params            # replicas share weights
        self._owner: dict[int, int] = {}     # rid -> owning wid
        kernels = ExecutorKernels(api, max_slots, max_len, device) \
            if batched else None
        self.kernels = kernels
        self.execs = {
            i: RealExecutor(cfg, max_slots=max_slots, max_len=max_len,
                            params=params, batched=batched, wid=i,
                            kernels=kernels, owner=self._owner,
                            device=device)
            for i in range(n_workers)
        }
        if kernels is not None and warmup:
            kernels.warmup(params)

    def on_finish(self, req) -> None:
        wid = self._owner.get(req.rid)
        if wid is not None:
            self.execs[wid].release(req.rid)

    def as_backend(self, clock: str = "wall") -> "RealTorchBackend":
        return RealTorchBackend(self, clock=clock)

    def migrate(self, req, src: int, dst: int) -> None:
        """Move the request across workers: the fast path copies the KV
        slot device-to-device; the scalar reference re-derives it by
        replaying prefill."""
        se, de = self.execs[src], self.execs[dst]
        de.prompts[req.rid] = se.prompts[req.rid]
        de.generated[req.rid] = list(se.generated[req.rid])
        slot = de._slot(req.rid)      # SlotExhausted surfaces to scheduler
        sslot = se.slot_of.get(req.rid)
        if de.fast and sslot is not None and se.fast:
            de.cache = de.kernels.copy_fn(de.cache, se.cache, slot, sslot)
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
    measured durations.
    """

    def __init__(self, execs: ClusterRealExecutors, clock: str = "wall"):
        if clock not in ("wall", "model"):
            raise ValueError(f"clock must be 'wall' or 'model', got {clock!r}")
        self.execs = execs
        self.clock = clock
        self.iterations = 0
        self.mixed_iterations = 0
        self.busy_seconds = 0.0

    def run_iteration(self, worker: Worker, plan: IterationPlan) -> float:
        e = self.execs.execs[worker.wid]
        t0 = time.perf_counter()
        e.run_plan(plan)
        measured = time.perf_counter() - t0
        self.iterations += 1
        self.busy_seconds += measured
        self.mixed_iterations += bool(plan.prefill_parts and plan.decode_reqs)
        return measured if self.clock == "wall" else worker.plan_duration(plan)

    def on_finish(self, req) -> None:
        self.execs.on_finish(req)

    def on_migrate(self, req, src_wid: int, dst_wid: int) -> None:
        self.execs.migrate(req, src_wid, dst_wid)
