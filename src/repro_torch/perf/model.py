"""Analytical worker step-time model — the one iteration-cost oracle.

Used by (a) the SimExecutor / ``CostModelBackend`` as the simulation
clock, (b) the scheduler's execution-time predictor (§IV-C: "we leverage
offline profiling tools to estimate the execution time of a prefill
request"), and (c) the toggle's admission maths. Before this package the
same quantity was computed three different ways in three layers; every
consumer now shares the ``IterationCostModel`` interface.

The model is a two-term roofline per iteration:

    t = max(FLOPs / (chips·peak·mfu),  bytes / (chips·bw·eff)) + t_fixed

with per-family FLOP/byte accounting (dense / MoE active params / rwkv &
mamba constant-state / enc-dec), plus an optional §IV **interference
term** for mixed batches: co-batched prefill chunks contend with decode's
memory streaming, so the mixed iteration exceeds the combined roofline by

    γ · β_p · β_d · min(t_prefill_alone, t_decode_alone)

where β_p is the prefill side's compute-boundedness, β_d the decode
side's memory-boundedness and γ the calibrated contention coefficient —
``HardwareSpec.interference`` as a uniform scalar, or an
``InterferenceTable`` looked up by the iteration's actual
``(n_decode, prefill_tokens)`` bucket (``perf.calibrate`` measures the
grid from mixed-vs-pure kernel runs; ``perf.recalibrate`` re-fits it
online). Contention is worst when each phase
saturates a *different* resource (overlap beyond the max is impossible and
the iteration drifts toward the additive sum); when both phases are bound
on the same resource the combined roofline already charges the serialised
cost and the penalty vanishes with 1-β. γ = 0 reproduces the legacy
purely-additive model bit-exactly — the default, so every pre-existing
benchmark and decision-parity test is unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.models.layers import ModelConfig
from repro_torch.perf.hardware import (V5E, HardwareSpec, InterferenceTable,
                                 WorkerSpec, gamma_at, gamma_at_batch)

# One constant-state request (rwkv/mamba/hybrid) is granted this many
# token-equivalents of HBM budget: ``kv_capacity_tokens`` sizes the pool
# as (#states that fit) × this, and ``state_tokens`` pins the same amount
# per admitted request, so page accounting gates at exactly the number of
# states the free HBM holds. One unit therefore equals
# ``state_bytes / STATE_TOKEN_EQUIV`` bytes.
STATE_TOKEN_EQUIV = 10_000


@runtime_checkable
class IterationCostModel(Protocol):
    """What every layer consuming step-time estimates depends on: the
    simulator clock, the §IV-C predictors, toggle admission, decode
    routing, and KV migration pricing all speak this interface."""

    def iteration_time(self, n_decode: int, sum_ctx: float,
                       prefill_tokens: int = 0,
                       prefill_ctx_offset: float = 0.0) -> float: ...

    def prefill_time(self, prompt_tokens: int, ctx_offset: int = 0) -> float: ...

    def decode_iter_time(self, n_decode: int, sum_ctx: float) -> float: ...

    def migration_time(self, ctx_tokens: int) -> float: ...

    def kv_transfer_bytes(self, ctx_tokens: int) -> float: ...


@dataclasses.dataclass(frozen=True)
class ModelCostSpec:
    """Closed-form per-token cost coefficients for one architecture."""
    name: str
    n_params: float                 # total parameters
    n_active: float                 # matmul-active params per token
    kv_bytes_per_token: float       # bytes of KV/state written per token
    attn_flops_per_ctx_token: float  # 4·Hq·Dh summed over ctx-attending layers
    ctx_cap: Optional[int]          # sliding-window cap (gemma2 local layers)
    state_bytes: float              # constant per-request state (rwkv/mamba)
    bytes_per_weight: float = 2.0   # bf16


def _transformer_attn_params(cfg: ModelConfig) -> float:
    p = (cfg.d_model * cfg.num_heads * cfg.head_dim          # wq
         + 2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim  # wk, wv
         + cfg.num_heads * cfg.head_dim * cfg.d_model)        # wo
    if cfg.qkv_bias:
        p += (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
    return p


def build_cost_spec(cfg: ModelConfig) -> ModelCostSpec:
    d, f, L, v = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.vocab_size
    embed = v * d * (1 if cfg.tie_embeddings else 2)
    mlp = (3 if cfg.mlp_gated else 2) * d * f

    if cfg.family in ("dense", "vlm"):
        per_layer = _transformer_attn_params(cfg) + mlp
        total = embed + L * per_layer
        active = L * per_layer + v * d      # unembed matmul counts as active
        kv = 2 * L * cfg.num_kv_heads * cfg.head_dim * 2.0
        attn_c = 4.0 * cfg.num_heads * cfg.head_dim * L
        ctx_cap = cfg.sliding_window if cfg.local_global_alternating else None
        state = 0.0
    elif cfg.family == "moe":
        experts = cfg.num_experts * 3 * d * f
        shared = cfg.num_shared_experts * 3 * d * f
        dense_res = (3 * d * cfg.moe_dense_residual_ff
                     if cfg.moe_dense_residual_ff else 0)
        router = d * cfg.num_experts
        per_layer = _transformer_attn_params(cfg) + experts + shared \
            + dense_res + router
        per_layer_active = _transformer_attn_params(cfg) \
            + cfg.top_k * 3 * d * f + shared + dense_res + router
        total = embed + L * per_layer
        active = L * per_layer_active + v * d
        kv = 2 * L * cfg.num_kv_heads * cfg.head_dim * 2.0
        attn_c = 4.0 * cfg.num_heads * cfg.head_dim * L
        ctx_cap, state = None, 0.0
    elif cfg.family == "rwkv":
        # tm: 5 square proj + lora; cm: 2 d·f + d·d
        per_layer = 5 * d * d + d * (5 * 32) + d * 64 + 64 * d \
            + 2 * d * f + d * d
        total = embed + L * per_layer
        active = L * per_layer + v * d
        kv = 0.0
        attn_c = 0.0
        ctx_cap = None
        state = L * (d / 64) * 64 * 64 * 4.0 + 2 * L * d * 2.0  # wkv f32
    elif cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * d
        n_heads = d_inner // 64
        mamba = 2 * d * d_inner + 2 * d * cfg.ssm_state + d * n_heads \
            + d_inner * d
        shared = _transformer_attn_params(cfg) + mlp + 2 * d * d + d * d
        ninv = (L + cfg.attn_every - 1) // cfg.attn_every
        total = embed + L * mamba + shared
        active = L * mamba + ninv * shared + v * d
        kv = 2 * ninv * cfg.num_kv_heads * cfg.head_dim * 2.0
        attn_c = 4.0 * cfg.num_heads * cfg.head_dim * ninv
        ctx_cap = None
        state = L * (n_heads * 64 * cfg.ssm_state * 4.0
                     + (cfg.ssm_conv - 1) * (d_inner + 2 * cfg.ssm_state) * 2.0)
    elif cfg.family == "encdec":
        n_enc = cfg.encoder_layers or L
        enc_layer = _transformer_attn_params(cfg) + mlp
        dec_layer = 2 * _transformer_attn_params(cfg) + mlp
        total = embed + n_enc * enc_layer + L * dec_layer
        active = L * dec_layer + v * d          # decode-side active
        kv = 2 * L * cfg.num_kv_heads * cfg.head_dim * 2.0
        attn_c = 4.0 * cfg.num_heads * cfg.head_dim * L * 2  # self + cross
        ctx_cap = None
        state = 0.0
    else:
        raise ValueError(cfg.family)

    return ModelCostSpec(
        name=cfg.name, n_params=float(total), n_active=float(active),
        kv_bytes_per_token=float(kv), attn_flops_per_ctx_token=float(attn_c),
        ctx_cap=ctx_cap, state_bytes=float(state),
    )


class CostModel:
    """Iteration-time + capacity model for one (model, worker) pair.

    Implements ``IterationCostModel``. Heterogeneous clusters instantiate
    one per worker (each with its own ``WorkerSpec``/``HardwareSpec``); a
    homogeneous cluster may share a single instance across workers."""

    def __init__(self, cfg: ModelConfig, worker: WorkerSpec = WorkerSpec(),
                 page_size: int = 16):
        self.cfg = cfg
        self.spec = build_cost_spec(cfg)
        self.worker = worker
        self.page_size = page_size          # KV block granularity (tokens)
        self.params_bytes = self.spec.n_params * self.spec.bytes_per_weight
        # opt-in iteration-time memo (build_cluster(vectorized=True) arms
        # it): the scheduler re-prices identical (n, ctx, chunk) shapes many
        # times per event. Keyed on args; invalidated when ``self.worker``
        # is replaced (DriftMonitor recalibration swaps the WorkerSpec).
        self.cached = False
        self._memo: dict = {}
        self._memo_worker: Optional[WorkerSpec] = None

    # ------------------------------------------------------------ capacity
    def kv_capacity_pages(self, reserve_frac: float = 0.1) -> int:
        """Allocatable KV pages per worker (page = ``page_size`` tokens)."""
        return max(1, self.kv_capacity_tokens(reserve_frac) // self.page_size)

    def kv_capacity_tokens(self, reserve_frac: float = 0.1) -> int:
        free = self.worker.hbm_bytes * (1 - reserve_frac) - self.params_bytes
        if self.spec.kv_bytes_per_token <= 0:
            # constant-state family: capacity = #states that fit
            per = max(self.spec.state_bytes, 1.0)
            return int(free / per) * STATE_TOKEN_EQUIV
        return max(0, int(free / self.spec.kv_bytes_per_token))

    def state_tokens(self, ctx: int) -> float:
        """HBM tokens-equivalent held by a request with context ctx.

        Constant-state families (rwkv/mamba/hybrid) hold one fixed-size
        state regardless of context; it pins ``STATE_TOKEN_EQUIV`` units —
        the per-state grant ``kv_capacity_tokens`` sizes the pool in — so
        the ``PageAccountant`` sees the true footprint and admission /
        watermark preemption gate at exactly the number of states the HBM
        fits. (A prior ternary returned 0.0 here, which made every
        constant-state request invisible to page accounting: admission
        never gated and the watermark never preempted.)"""
        if self.spec.kv_bytes_per_token <= 0:
            return float(STATE_TOKEN_EQUIV) if self.spec.state_bytes > 0 \
                else 0.0
        cap = self.spec.ctx_cap
        if cap is not None:
            # gemma2: half the layers hold only window-sized KV
            return ctx * 0.5 + min(ctx, cap) * 0.5
        return float(ctx)

    def state_token_delta_sum(self, ctx_new) -> float:
        """Exact sum of ``state_tokens(c) - state_tokens(c - 1)`` over an
        int64 array of post-step contexts — the engine's batched KV-growth
        charge for one decode token per request. Every per-element delta
        is 0.0 (constant-state), 1.0 (dense KV), or 0.5 (past a sliding
        window's cap): dyadic values whose float64 accumulation is exact
        at any magnitude this simulator reaches, so the batched sum lands
        on the same bits as the scalar per-request loop regardless of
        association order."""
        spec = self.spec
        if spec.kv_bytes_per_token <= 0:
            return 0.0
        cap = spec.ctx_cap
        if cap is None:
            return float(ctx_new.size)
        inside = int(np.count_nonzero(ctx_new <= cap))
        return inside * 1.0 + (ctx_new.size - inside) * 0.5

    # --------------------------------------------------------------- steps
    def _roofline(self, flops: float, bytes_: float, mfu: float) -> float:
        hw = self.worker.hw
        t_c = flops / (self.worker.peak_flops * mfu)
        t_m = bytes_ / (self.worker.hbm_bw * hw.bw_eff)
        return max(t_c, t_m) + hw.t_fixed

    def _attn_ctx(self, ctx: float) -> float:
        cap = self.spec.ctx_cap
        if cap is None:
            return ctx
        return 0.5 * ctx + 0.5 * min(ctx, cap)

    def _decode_terms(self, n_decode: int, sum_ctx: float
                      ) -> tuple[float, float, float, float]:
        """Decode-side accounting terms, kept individual so both the
        combined iteration roofline and the interference penalty sum them
        in their own (bit-pinned) order from one source of truth:
        (gemm_flops, attn_flops, kv_bytes, state_bytes)."""
        s = self.spec
        return (2.0 * s.n_active * n_decode,
                s.attn_flops_per_ctx_token * self._attn_ctx(sum_ctx),
                s.kv_bytes_per_token * self._attn_ctx(sum_ctx),
                s.state_bytes * n_decode * 2)   # rwkv/mamba state rw

    def _prefill_terms(self, prefill_tokens: int, ctx_offset: float
                       ) -> tuple[float, float, float]:
        """Prefill-chunk accounting terms: (gemm_flops, attn_flops,
        kv_bytes)."""
        s = self.spec
        p, c = float(prefill_tokens), float(ctx_offset)
        return (2.0 * s.n_active * p,
                s.attn_flops_per_ctx_token * self._attn_ctx(c + p / 2) * p,
                s.kv_bytes_per_token * (self._attn_ctx(c + p) + p))

    def iteration_time(self, n_decode: int, sum_ctx: float,
                       prefill_tokens: int = 0,
                       prefill_ctx_offset: float = 0.0) -> float:
        """One engine iteration: a decode batch (n_decode requests whose
        contexts sum to sum_ctx) plus an optional piggybacked prefill chunk
        of ``prefill_tokens`` starting at context ``prefill_ctx_offset``."""
        if not self.cached:
            return self._iteration_time(n_decode, sum_ctx, prefill_tokens,
                                        prefill_ctx_offset)
        if self._memo_worker is not self.worker:
            self._memo_worker = self.worker
            self._memo.clear()
        key = (n_decode, sum_ctx, prefill_tokens, prefill_ctx_offset)
        t = self._memo.get(key)
        if t is None:
            if len(self._memo) >= 4096:
                self._memo.clear()
            t = self._iteration_time(n_decode, sum_ctx, prefill_tokens,
                                     prefill_ctx_offset)
            self._memo[key] = t
        return t

    def _iteration_time(self, n_decode: int, sum_ctx: float,
                        prefill_tokens: int = 0,
                        prefill_ctx_offset: float = 0.0) -> float:
        flops = 0.0
        bytes_ = 0.0
        if n_decode > 0:
            df_gemm, df_attn, db_kv, db_state = \
                self._decode_terms(n_decode, sum_ctx)
            flops += df_gemm
            flops += df_attn
            bytes_ += db_kv
            bytes_ += db_state
        if prefill_tokens > 0:
            pf_gemm, pf_attn, pb_kv = \
                self._prefill_terms(prefill_tokens, prefill_ctx_offset)
            flops += pf_gemm
            flops += pf_attn
            bytes_ += pb_kv
        if flops == 0.0 and bytes_ == 0.0:
            return 0.0
        bytes_ += self.params_bytes  # weights stream once per iteration
        mfu = (self.worker.hw.mfu_prefill if prefill_tokens > 0
               else self.worker.hw.mfu_decode)
        t = self._roofline(flops, bytes_, mfu)
        if n_decode > 0 and prefill_tokens > 0:
            gamma = gamma_at(self.worker.hw.interference, n_decode,
                             prefill_tokens)
            if gamma != 0.0:
                t += self._interference(gamma, n_decode, sum_ctx,
                                        prefill_tokens, prefill_ctx_offset)
        return t

    def interference_penalty(self, n_decode: int, sum_ctx: float,
                             prefill_tokens: int,
                             prefill_ctx_offset: float = 0.0) -> float:
        """The §IV contention penalty alone — what a mixed iteration costs
        beyond the additive combined roofline. Exactly 0.0 for pure
        batches and whenever the governing γ is 0, so admission paths that
        *add* it to their additive estimates stay bit-identical to the
        legacy model until a calibration turns γ on."""
        if n_decode <= 0 or prefill_tokens <= 0:
            return 0.0
        gamma = gamma_at(self.worker.hw.interference, n_decode,
                         prefill_tokens)
        if gamma == 0.0:
            return 0.0
        return self._interference(gamma, n_decode, sum_ctx,
                                  prefill_tokens, prefill_ctx_offset)

    def _interference(self, gamma: float, n_decode: int, sum_ctx: float,
                      prefill_tokens: int, prefill_ctx_offset: float) -> float:
        """§IV contention penalty for a mixed prefill+decode batch.

        Phase-alone roofline terms (no ``t_fixed``; each phase streams the
        weights once when run alone):

            β_p = prefill compute-boundedness = t_cᵖ / max(t_cᵖ, t_mᵖ)
            β_d = decode  memory-boundedness  = t_mᵈ / max(t_cᵈ, t_mᵈ)

        penalty = γ · β_p · β_d · min(t_prefill_alone, t_decode_alone):
        zero whenever either phase is absent, largest when a compute-bound
        prefill is inserted into a memory-bound decode batch (the paper's
        observed super-additive slowdown; DistServe §3 measures the same
        asymmetry), bounded by the smaller phase's standalone time so the
        mixed iteration never exceeds the fully-serialised sum."""
        hw = self.worker.hw
        comp = self.worker.peak_flops
        mem = self.worker.hbm_bw * hw.bw_eff

        df_gemm, df_attn, db_kv, db_state = \
            self._decode_terms(n_decode, sum_ctx)
        d_flops = df_gemm + df_attn
        d_bytes = db_kv + db_state + self.params_bytes
        pf_gemm, pf_attn, pb_kv = \
            self._prefill_terms(prefill_tokens, prefill_ctx_offset)
        p_flops = pf_gemm + pf_attn
        p_bytes = pb_kv + self.params_bytes

        t_cp = p_flops / (comp * hw.mfu_prefill)
        t_mp = p_bytes / mem
        t_cd = d_flops / (comp * hw.mfu_decode)
        t_md = d_bytes / mem
        t_p = max(t_cp, t_mp)
        t_d = max(t_cd, t_md)
        if t_p <= 0.0 or t_d <= 0.0:
            return 0.0
        beta_p = t_cp / t_p
        beta_d = t_md / t_d
        return gamma * beta_p * beta_d * min(t_p, t_d)

    def prefill_time(self, prompt_tokens: int, ctx_offset: int = 0) -> float:
        return self.iteration_time(0, 0.0, prompt_tokens, ctx_offset)

    def decode_iter_time(self, n_decode: int, sum_ctx: float) -> float:
        return self.iteration_time(n_decode, sum_ctx)

    # ------------------------------------------------- batched entry points
    # One candidate priced against many workers (or many candidates against
    # one worker) in a single numpy evaluation. Every elementwise operation
    # mirrors the scalar path's exact association order, masked terms enter
    # through ``np.where(mask, term, 0.0)`` and ``x + 0.0`` is exact in
    # IEEE-754, so each element is bit-identical to the scalar call —
    # tests/test_vectorized.py pins that.

    def _attn_ctx_batch(self, ctx: np.ndarray) -> np.ndarray:
        cap = self.spec.ctx_cap
        if cap is None:
            return ctx
        return 0.5 * ctx + 0.5 * np.minimum(ctx, float(cap))

    def _batch_terms(self, n, sc, p, c):
        """Unmasked decode/prefill accounting terms, elementwise mirrors of
        ``_decode_terms``/``_prefill_terms``."""
        s = self.spec
        df_gemm = 2.0 * s.n_active * n
        df_attn = s.attn_flops_per_ctx_token * self._attn_ctx_batch(sc)
        db_kv = s.kv_bytes_per_token * self._attn_ctx_batch(sc)
        db_state = s.state_bytes * n * 2
        pf_gemm = 2.0 * s.n_active * p
        pf_attn = s.attn_flops_per_ctx_token \
            * self._attn_ctx_batch(c + p / 2) * p
        pb_kv = s.kv_bytes_per_token * (self._attn_ctx_batch(c + p) + p)
        return df_gemm, df_attn, db_kv, db_state, pf_gemm, pf_attn, pb_kv

    def _interference_batch(self, gamma: np.ndarray, terms) -> np.ndarray:
        hw = self.worker.hw
        comp = self.worker.peak_flops
        mem = self.worker.hbm_bw * hw.bw_eff
        df_gemm, df_attn, db_kv, db_state, pf_gemm, pf_attn, pb_kv = terms
        d_flops = df_gemm + df_attn
        d_bytes = db_kv + db_state + self.params_bytes
        p_flops = pf_gemm + pf_attn
        p_bytes = pb_kv + self.params_bytes
        t_cp = p_flops / (comp * hw.mfu_prefill)
        t_mp = p_bytes / mem
        t_cd = d_flops / (comp * hw.mfu_decode)
        t_md = d_bytes / mem
        t_p = np.maximum(t_cp, t_mp)
        t_d = np.maximum(t_cd, t_md)
        live = (t_p > 0.0) & (t_d > 0.0)
        beta_p = t_cp / np.where(live, t_p, 1.0)
        beta_d = t_md / np.where(live, t_d, 1.0)
        pen = gamma * beta_p * beta_d * np.minimum(t_p, t_d)
        return np.where(live, pen, 0.0)

    def _prefill_only_batch(self, prefill_tokens, prefill_ctx_offset  # lint: parity-ref(_iteration_time)
                            ) -> np.ndarray:
        """``iteration_time_batch`` lane for pure prefill rows (scalar
        n_decode == 0): only the prefill terms are evaluated. Bit-identical
        to the general path — its masked sums associate as
        ``((0.0+0.0)+a)+b`` and IEEE-754 ``0.0+x == x``."""
        p = np.asarray(prefill_tokens, dtype=np.float64)
        c = np.asarray(prefill_ctx_offset, dtype=np.float64)
        p, c = np.broadcast_arrays(p, c)
        s = self.spec
        hw = self.worker.hw
        pf_gemm = 2.0 * s.n_active * p
        pf_attn = s.attn_flops_per_ctx_token \
            * self._attn_ctx_batch(c + p / 2) * p
        pb_kv = s.kv_bytes_per_token * (self._attn_ctx_batch(c + p) + p)
        has_p = p > 0
        flops = np.where(has_p, pf_gemm, 0.0) + np.where(has_p, pf_attn, 0.0)
        bytes_ = np.where(has_p, pb_kv, 0.0)
        zero = (flops == 0.0) & (bytes_ == 0.0)
        bytes_ = bytes_ + self.params_bytes
        mfu = np.where(has_p, hw.mfu_prefill, hw.mfu_decode)
        t_c = flops / (self.worker.peak_flops * mfu)
        t_m = bytes_ / (self.worker.hbm_bw * hw.bw_eff)
        t = np.maximum(t_c, t_m) + hw.t_fixed
        return np.where(zero, 0.0, t)

    def _decode_only_batch(self, n_decode, sum_ctx) -> np.ndarray:  # lint: parity-ref(_iteration_time)
        """``iteration_time_batch`` lane for pure decode rows (scalar
        prefill_tokens == 0): only the decode terms are evaluated. The
        general path's masked sums associate as ``((a+b)+0.0)+0.0`` and its
        mfu select resolves to the scalar ``mfu_decode``, so this is
        bit-identical."""
        n = np.asarray(n_decode, dtype=np.float64)
        sc = np.asarray(sum_ctx, dtype=np.float64)
        n, sc = np.broadcast_arrays(n, sc)
        s = self.spec
        hw = self.worker.hw
        df_gemm = 2.0 * s.n_active * n
        df_attn = s.attn_flops_per_ctx_token * self._attn_ctx_batch(sc)
        db_kv = s.kv_bytes_per_token * self._attn_ctx_batch(sc)
        db_state = s.state_bytes * n * 2
        has_d = n > 0
        flops = np.where(has_d, df_gemm, 0.0) + np.where(has_d, df_attn, 0.0)
        bytes_ = np.where(has_d, db_kv, 0.0) + np.where(has_d, db_state, 0.0)
        zero = (flops == 0.0) & (bytes_ == 0.0)
        bytes_ = bytes_ + self.params_bytes
        t_c = flops / (self.worker.peak_flops * hw.mfu_decode)
        t_m = bytes_ / (self.worker.hbm_bw * hw.bw_eff)
        t = np.maximum(t_c, t_m) + hw.t_fixed
        return np.where(zero, 0.0, t)

    def iteration_time_batch(self, n_decode, sum_ctx, prefill_tokens=0,
                             prefill_ctx_offset=0.0) -> np.ndarray:
        """Elementwise ``iteration_time`` over broadcast scalar-or-array
        arguments; returns float64 with the broadcast shape."""
        # Uniform-phase fast lanes: dispatch prices pure prefill chunks and
        # pure decode batches far more often than mixed iterations, and a
        # scalar 0 for the absent phase proves every row skips it — so only
        # the present phase's terms are evaluated. (sum_ctx is ignored when
        # n_decode == 0, exactly as the general path masks it out.)
        if isinstance(n_decode, (int, float)) and n_decode == 0:
            return self._prefill_only_batch(prefill_tokens,
                                            prefill_ctx_offset)
        if isinstance(prefill_tokens, (int, float)) and prefill_tokens == 0:
            return self._decode_only_batch(n_decode, sum_ctx)
        n = np.asarray(n_decode, dtype=np.float64)
        sc = np.asarray(sum_ctx, dtype=np.float64)
        p = np.asarray(prefill_tokens, dtype=np.float64)
        c = np.asarray(prefill_ctx_offset, dtype=np.float64)
        n, sc, p, c = np.broadcast_arrays(n, sc, p, c)
        hw = self.worker.hw
        terms = self._batch_terms(n, sc, p, c)
        df_gemm, df_attn, db_kv, db_state, pf_gemm, pf_attn, pb_kv = terms
        has_d = n > 0
        has_p = p > 0
        flops = np.where(has_d, df_gemm, 0.0) \
            + np.where(has_d, df_attn, 0.0) \
            + np.where(has_p, pf_gemm, 0.0) \
            + np.where(has_p, pf_attn, 0.0)
        bytes_ = np.where(has_d, db_kv, 0.0) \
            + np.where(has_d, db_state, 0.0) \
            + np.where(has_p, pb_kv, 0.0)
        zero = (flops == 0.0) & (bytes_ == 0.0)
        bytes_ = bytes_ + self.params_bytes
        mfu = np.where(has_p, hw.mfu_prefill, hw.mfu_decode)
        t_c = flops / (self.worker.peak_flops * mfu)
        t_m = bytes_ / (self.worker.hbm_bw * hw.bw_eff)
        t = np.maximum(t_c, t_m) + hw.t_fixed
        mixed = has_d & has_p
        if np.any(mixed):
            gamma = gamma_at_batch(hw.interference, n, p)
            if gamma.any():     # all-zero gamma adds exact 0.0 everywhere
                pen = self._interference_batch(gamma, terms)
                t = t + np.where(mixed & (gamma != 0.0), pen, 0.0)
        return np.where(zero, 0.0, t)

    def interference_penalty_batch(self, n_decode, sum_ctx, prefill_tokens,
                                   prefill_ctx_offset=0.0) -> np.ndarray:
        """Elementwise ``interference_penalty`` over broadcast args."""
        n = np.asarray(n_decode, dtype=np.float64)
        sc = np.asarray(sum_ctx, dtype=np.float64)
        p = np.asarray(prefill_tokens, dtype=np.float64)
        c = np.asarray(prefill_ctx_offset, dtype=np.float64)
        n, sc, p, c = np.broadcast_arrays(n, sc, p, c)
        mixed = (n > 0) & (p > 0)
        if not np.any(mixed):
            return np.zeros(n.shape)
        gamma = gamma_at_batch(self.worker.hw.interference, n, p)
        if not gamma.any():     # γ=0 table: the masked result is all 0.0
            return np.zeros(n.shape)
        pen = self._interference_batch(gamma, self._batch_terms(n, sc, p, c))
        return np.where(mixed & (gamma != 0.0), pen, 0.0)

    def prefill_time_batch(self, prompt_tokens, ctx_offset=0) -> np.ndarray:
        return self.iteration_time_batch(0, 0.0, prompt_tokens, ctx_offset)

    def decode_iter_time_batch(self, n_decode, sum_ctx) -> np.ndarray:
        return self.iteration_time_batch(n_decode, sum_ctx)

    # ------------------------------------------- slack-chunk inversion
    def chunk_candidates(self, lo: int, hi: int, budget, n_decode, sum_ctx,
                         ctx_offset, s_scale=1.0, q_scale=1.0) -> np.ndarray:
        """Closed-form support for slack-sized prefill chunking: candidate
        chunk sizes containing every integer where the admission cost

            S·prefill_time(p, c) + Q·interference_penalty(n, sc, p, c)

        can cross ``budget`` on ``[lo, hi]``. The cost is piecewise
        quadratic in p: ``t_cp = a2·p² + a1·p`` (compute roofline),
        ``t_mp = m1·p + m0`` (memory roofline incl. weights), and the §IV
        penalty collapses per region — ``P·t_cp`` while the prefill-alone
        time is the iteration minimum, ``P·t_d`` (constant) or
        ``P·t_d·t_cp/t_mp`` (quadratic after clearing the linear
        denominator) once it dominates — with P = Q·γ·β_d piecewise
        constant over the γ table's chunk buckets. So every feasibility
        flip sits at a quadratic root or at a structural breakpoint (γ
        bucket edge, sliding-window cap crossing), all solved here in
        closed form. Callers verify the candidates with ONE batched cost
        evaluation and keep the largest feasible — replacing the lockstep
        bisection loop (~12 batched evaluations) while returning the same
        chunk wherever the cost is monotone in p (everywhere the model's
        increasing rooflines make it so).

        ``budget``/``n_decode``/``sum_ctx``/``ctx_offset``/``s_scale``
        broadcast per row; ``q_scale`` is scalar. Returns (rows, K) int64
        clipped to [lo, hi]; ``lo`` and ``hi`` are always included."""
        bud0 = np.atleast_1d(np.asarray(budget, dtype=np.float64))
        nd = np.asarray(n_decode, dtype=np.float64)
        sc = np.asarray(sum_ctx, dtype=np.float64)
        c = np.asarray(ctx_offset, dtype=np.float64)
        S = np.asarray(s_scale, dtype=np.float64)
        bud0, nd, sc, c, S = np.broadcast_arrays(bud0, nd, sc, c, S)
        Q = float(q_scale)
        s_ = self.spec
        hw = self.worker.hw
        comp = self.worker.peak_flops
        mem = self.worker.hbm_bw * hw.bw_eff
        F = comp * hw.mfu_prefill
        # decode-alone constants (mirroring _interference): t_d and the
        # memory-boundedness β_d do not depend on the chunk size
        df_gemm = 2.0 * s_.n_active * nd
        df_attn = s_.attn_flops_per_ctx_token * self._attn_ctx_batch(sc)
        db_kv = s_.kv_bytes_per_token * self._attn_ctx_batch(sc)
        db_state = s_.state_bytes * nd * 2
        t_cd = (df_gemm + df_attn) / (comp * hw.mfu_decode)
        t_md = (db_kv + db_state + self.params_bytes) / mem
        t_d = np.maximum(t_cd, t_md)
        live = (nd > 0) & (t_d > 0.0)
        beta_d = np.where(live, t_md / np.where(t_d > 0.0, t_d, 1.0), 0.0)
        t_d = np.where(live, t_d, 0.0)
        # γ is piecewise constant over the table's chunk buckets: one
        # penalty coefficient P per (row, chunk-cell)
        interf = hw.interference
        if isinstance(interf, InterferenceTable):
            de = np.asarray(interf.decode_edges, dtype=np.float64)
            row = np.maximum(np.searchsorted(de, nd, side="right") - 1, 0)
            gam = np.asarray(interf.gamma, dtype=np.float64)[row]
            edges = [float(e) for e in interf.chunk_edges]
        else:
            gam = np.full(nd.shape + (1,), float(interf))
            edges = []
        pen = Q * gam * beta_d[..., None]
        # prefill rooflines per sliding-window regime:
        #   t_cp = a2·p² + a1·p,  t_mp = m1·p + m0
        attn = s_.attn_flops_per_ctx_token
        kv = s_.kv_bytes_per_token
        gemm = 2.0 * s_.n_active
        cap = s_.ctx_cap
        a_regimes = [(attn / 2.0 / F, (gemm + attn * c) / F)]
        m_regimes = [(2.0 * kv / mem, (kv * c + self.params_bytes) / mem)]
        if cap is not None:
            a_regimes.append((attn / 4.0 / F,
                              (gemm + attn * (c + cap) / 2.0) / F))
            m_regimes.append((1.5 * kv / mem,
                              (kv * (c + cap) / 2.0 + self.params_bytes)
                              / mem))
        bud = bud0 - S * hw.t_fixed
        roots = []
        with np.errstate(divide="ignore", invalid="ignore"):
            for a2, a1 in a_regimes:
                for j in range(pen.shape[-1]):
                    P = pen[..., j]
                    sp = S + P
                    # compute-bound, penalty tracks t_cp: (S+P)·t_cp = bud
                    roots.append(_quad_roots(
                        a2, a1, -bud / np.where(sp > 0.0, sp, np.nan)))
                    # compute-bound past t_d: S·t_cp + P·t_d = bud
                    roots.append(_quad_roots(
                        a2, a1,
                        -(bud - P * t_d) / np.where(S > 0.0, S, np.nan)))
                # region boundary t_cp = t_d
                roots.append(_quad_roots(a2, a1, -t_d))
                for m1, m0 in m_regimes:
                    # region boundary t_cp = t_mp
                    roots.append(_quad_roots(a2, a1 - m1, -m0))
                    for j in range(pen.shape[-1]):
                        P = pen[..., j]
                        # memory-bound, penalty P·t_cp: S·t_mp + P·t_cp
                        roots.append(_quad_roots(
                            P * a2, S * m1 + P * a1, S * m0 - bud))
                        # memory-bound past t_d: S·t_mp² + P·t_d·t_cp
                        # − bud·t_mp = 0 (×t_mp clears the denominator)
                        roots.append(_quad_roots(
                            S * m1 * m1 + P * t_d * a2,
                            2.0 * S * m1 * m0 + P * t_d * a1 - bud * m1,
                            S * m0 * m0 - bud * m0))
            for m1, m0 in m_regimes:
                # region boundary t_mp = t_d (linear)
                r = (t_d - m0) / (m1 if m1 != 0.0 else np.nan)
                roots.append(np.stack([r, np.full_like(r, np.nan)],
                                      axis=-1))
        fl = np.floor(np.concatenate(roots, axis=-1))
        cols = [fl - 1.0, fl, fl + 1.0, fl + 2.0]
        # structural breakpoints: interval ends, γ bucket edges, and the
        # per-row sliding-window crossings (KV at cap−c, attention midpoint
        # at 2(cap−c))
        fixed = [float(lo), float(hi)]
        for e in edges:
            fixed += [e - 1.0, e, e + 1.0]
        cols.append(np.broadcast_to(np.asarray(fixed),
                                    nd.shape + (len(fixed),)))
        if cap is not None:
            for bp in (cap - c, 2.0 * (cap - c)):
                f = np.floor(bp)[..., None]
                cols.append(np.concatenate([f - 1.0, f, f + 1.0, f + 2.0],
                                           axis=-1))
        cand = np.concatenate(cols, axis=-1)
        cand = np.where(np.isfinite(cand), cand, float(lo))
        return np.clip(cand, float(lo), float(hi)).astype(np.int64)

    # ----------------------------------------------------------- migration
    def kv_transfer_bytes(self, ctx_tokens: int) -> float:
        """Bytes of KV/state that must cross the ICI links to migrate a
        request with context ``ctx_tokens``."""
        return self.spec.kv_bytes_per_token * self.state_tokens(ctx_tokens) \
            + self.spec.state_bytes

    def migration_time(self, ctx_tokens: int) -> float:
        """Uncontended lower bound (the seed's fixed-delay model); the
        contended path lives in serving/transfer.py."""
        hw = self.worker.hw
        bw = hw.ici_bw * hw.ici_links
        return hw.migration_latency + self.kv_transfer_bytes(ctx_tokens) / bw

    # ---------------------------------------------------------- tiered KV
    def host_capacity_pages(self, host_bytes: float) -> int:
        """Pages of KV a ``host_bytes``-sized host-DRAM tier holds for this
        model (same page arithmetic as the HBM pool; constant-state
        families count states via their token-equivalent grant)."""
        if host_bytes <= 0:
            return 0
        if self.spec.kv_bytes_per_token <= 0:
            per = max(self.spec.state_bytes, 1.0)
            tokens = int(host_bytes / per) * STATE_TOKEN_EQUIV
        else:
            tokens = int(host_bytes / self.spec.kv_bytes_per_token)
        return max(0, tokens // self.page_size)

    def restore_time(self, ctx_tokens: int, residue_tokens: int = 0) -> float:
        """Uncontended lower bound on pulling an offloaded request's KV
        back from the host tier: host-link wire time plus the prefill cost
        of any ``residue_tokens`` not captured by the offload (tokens
        generated after the snapshot that must be re-prefilled). The
        contended wire path lives in serving/transfer.py; the offload
        direction costs the same (symmetric host link)."""
        hw = self.worker.hw
        if hw.host_bw <= 0:
            return float("inf")
        t = hw.host_latency + self.kv_transfer_bytes(ctx_tokens) / hw.host_bw
        if residue_tokens > 0:
            t += self.prefill_time(residue_tokens, ctx_offset=ctx_tokens)
        return t


def _quad_roots(a, b, c) -> np.ndarray:
    """Real roots of ``a·x² + b·x + c = 0``, elementwise over broadcast
    arrays. Degenerate rows (a == 0) fall back to the linear root −c/b;
    rows with no real root (or 0·x² + 0·x + c) yield NaN. Returns the
    inputs' broadcast shape with a trailing axis of 2."""
    a, b, c = np.broadcast_arrays(np.asarray(a, dtype=np.float64),
                                  np.asarray(b, dtype=np.float64),
                                  np.asarray(c, dtype=np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        disc = b * b - 4.0 * a * c
        sq = np.sqrt(np.where(disc >= 0.0, disc, np.nan))
        quad = a != 0.0
        den = np.where(quad, 2.0 * a, 1.0)
        r1 = np.where(quad, (-b - sq) / den, -c / np.where(b != 0.0, b, np.nan))
        r2 = np.where(quad, (-b + sq) / den, np.nan)
    return np.stack([r1, r2], axis=-1)


def canonical_iteration_time(cost: IterationCostModel) -> float:
    """One canonical mixed iteration (decode batch of 8 at ctx 2048 each,
    plus a 2048-token prefill chunk): THE probe that ranks heterogeneous
    hardware. Both the relative-speed normalisation and
    ``ClusterPredictor``'s reference-worker choice use it, so the two
    notions of 'fastest worker' can never drift apart."""
    return cost.iteration_time(8, 8 * 2048.0, 2048, 0.0)


def relative_speeds(costs: dict[int, CostModel]) -> dict[int, float]:
    """Per-worker relative throughput (fastest worker = 1.0), from each
    worker's predicted time on the canonical mixed iteration. Load metrics
    divide by this so 'least loaded' means 'finishes soonest', not 'fewest
    tokens' — on a homogeneous cluster every speed is exactly 1.0 and all
    orderings are unchanged."""
    ref = {wid: canonical_iteration_time(c) for wid, c in costs.items()}
    fastest = min(ref.values())
    return {wid: fastest / t if t > 0 else 1.0 for wid, t in ref.items()}
