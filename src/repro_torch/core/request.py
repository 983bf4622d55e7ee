"""Request lifecycle + SLO bookkeeping (paper §II-B).

Timestamps are simulation-clock (or wall-clock for the real executor)
seconds. TTFT/TPOT follow the paper's Eq. (1)-(3):

    TTFT  = first_token_time - arrival
    TPOT  = (sum of decode-phase time) / (#generated tokens beyond first)
    A     = |R_TTFT ∩ R_TPOT| / |R|
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Phase(enum.Enum):
    QUEUED_PREFILL = "queued_prefill"
    PREFILLING = "prefilling"
    MIGRATING = "migrating"
    QUEUED_DECODE = "queued_decode"
    DECODING = "decoding"
    OFFLOADED = "offloaded"     # KV parked in the host-DRAM tier
    FINISHED = "finished"
    FAILED = "failed"


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A named SLO tier in a multi-tenant workload (paper §II-B + the
    per-application TTFT/TPOT requirements of DistServe §5).

    ``name`` identifies the tenant class in per-class metrics and the
    rebalancer's windowed attainment; ``weight`` is its share in the
    weighted cluster attainment (Σ w_c·A_c / Σ w_c). The single-tenant
    legacy entry points construct the anonymous ``default`` class via the
    ``SLOSpec`` alias, which keeps every pre-multi-tenant call site and
    pickle/CSV schema working unchanged."""
    ttft: float             # seconds
    tpot: float             # seconds / output token
    name: str = "default"
    weight: float = 1.0


# Legacy alias: an SLOSpec *is* the anonymous default-class SLOClass.
SLOSpec = SLOClass


# eq=False: requests are identities, not values — every membership /
# equality check in the stack compares the same live object, and identity
# comparison keeps hot ``in``-list checks O(1) per element instead of a
# 25-field structural compare (it also restores hashability).
# ``slots=True``: the engine reads/writes these fields millions of times
# per simulated minute; slot access skips the per-instance __dict__ and
# shrinks each request by ~100 bytes at 100k-request trace scale.
@dataclasses.dataclass(eq=False, slots=True)
class Request:
    rid: int
    arrival_time: float
    prompt_len: int
    output_len: int            # tokens to generate (incl. first token)
    slo: SLOSpec

    # --- runtime state -----------------------------------------------------
    phase: Phase = Phase.QUEUED_PREFILL
    worker: Optional[int] = None          # current worker id
    prefilled_tokens: int = 0             # chunked-prefill progress
    generated_tokens: int = 0
    prefill_start: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    decode_time: float = 0.0              # accumulated decode-phase seconds
    tpot_slack: float = 0.0               # paper §IV-B accumulated slack
    migrations: int = 0
    migration_wait: float = 0.0           # seconds spent MIGRATING on links
    restarts: int = 0                     # fault-tolerance: re-prefills
    preemptions: int = 0                  # KV evictions (watermark/pool)
    prior_tokens: int = 0                 # tokens streamed before KV loss
    stall_start: Optional[float] = None   # stream stalled (KV lost) at
    # --- tiered KV + prefix reuse ------------------------------------------
    offloads: int = 0                     # KV spills to the host-DRAM tier
    restores: int = 0                     # KV pulls back from the host tier
    prefix_key: Optional[int] = None      # shared-prompt identity (workload)
    prefix_len: int = 0                   # leading tokens covered by the key
    cached_prefix: int = 0                # tokens borrowed from a worker's
                                          # prefix cache at current placement
    prefix_hits: int = 0                  # lifetime prefix-cache hits

    # ------------------------------------------------------------------ SLO
    @property
    def context_len(self) -> int:
        return self.prompt_len + self.generated_tokens

    @property
    def remaining_prefill(self) -> int:
        return max(0, self.prompt_len - self.prefilled_tokens)

    @property
    def streamed_tokens(self) -> int:
        """Tokens delivered to the user across KV losses (restarts fold
        generated tokens into ``prior_tokens``; the stream itself never
        rewinds — the user keeps what was sent)."""
        return self.prior_tokens + self.generated_tokens

    @property
    def remaining_output(self) -> int:
        return max(0, self.output_len - self.streamed_tokens)

    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def tpot(self) -> Optional[float]:
        if self.finish_time is None or self.streamed_tokens <= 1:
            return 0.0 if self.finish_time is not None else None
        return self.decode_time / (self.streamed_tokens - 1)

    def ttft_ok(self) -> bool:
        t = self.ttft()
        return t is not None and t <= self.slo.ttft

    def tpot_ok(self) -> bool:
        t = self.tpot()
        return t is not None and t <= self.slo.tpot

    def slo_ok(self) -> bool:
        return self.ttft_ok() and self.tpot_ok()

    # ------------------------------------------------------- event recording
    def record_decode_iteration(self, duration: float) -> None:
        """One decode iteration this request took part in (paper §IV-B:
        slack accumulates by TPOT_SLO - iteration_time)."""
        self.decode_time += duration
        self.generated_tokens += 1
        self.tpot_slack += self.slo.tpot - duration

    def record_first_token(self, now: float) -> None:
        self.generated_tokens = 1    # the prefill's forward pass emits it
        if self.first_token_time is None:
            self.first_token_time = now
            # one iteration of initial credit: TPOT is measured per
            # *generated* token, so the budget of the first decode iteration
            # is available the moment the request enters decode (paper
            # Fig. 7 banks slack from the first tokens before admitting a
            # prefill).
            self.tpot_slack = self.slo.tpot
        else:
            # resumed stream after KV loss: TTFT was already achieved; the
            # stall since eviction is inter-token latency the user saw
            if self.stall_start is not None:
                gap = now - self.stall_start
                self.decode_time += gap
                self.tpot_slack = self.slo.tpot - gap
                self.stall_start = None

    def effective_slack(self, base_iter: float, horizon: int = 4) -> float:
        """Delay this request can absorb NOW without its final TPOT
        average exceeding the SLO (paper §II-B: users read at an average
        rate, so early/remaining tokens bank budget). banked slack plus a
        bounded forward credit over the next ``horizon`` iterations at the
        current base decode rate."""
        credit = max(0.0, (self.slo.tpot - base_iter)) \
            * min(self.remaining_output, horizon)
        return self.tpot_slack + credit

    def ttft_deadline_slack(self, now: float) -> float:
        """Remaining TTFT budget at ``now`` (before any predicted costs)."""
        return self.slo.ttft - (now - self.arrival_time)

    def rel_ttft_slack(self, now: float) -> float:
        """TTFT budget remaining as a fraction of the class's whole budget.
        The class-aware dispatch order serves tightest-relative-slack
        first: absolute seconds are not comparable across SLO classes (2 s
        of slack is plenty for an interactive class and nothing for a
        batch class), the consumed *fraction* is."""
        return self.ttft_deadline_slack(now) / max(self.slo.ttft, 1e-9)

    def reset_for_reprefill(self, now: Optional[float] = None) -> None:
        """KV/state was lost (worker failure, page eviction, failed
        migration placement): the full context re-prefills wherever
        dispatch next places the request, then the stream resumes — only
        ``remaining_output`` tokens are still owed (what was streamed
        stays streamed). Callers bump the counter that names the cause
        (``restarts``/``preemptions``)."""
        self.prompt_len = self.context_len   # generated tokens fold in
        self.prior_tokens += self.generated_tokens
        self.generated_tokens = 0
        self.prefilled_tokens = 0
        self.prefill_start = None
        self.phase = Phase.QUEUED_PREFILL
        self.worker = None
        self.cached_prefix = 0   # any borrowed prefix ref was released by
                                 # the worker before this reset
        if now is not None and self.prior_tokens > 0 \
                and self.stall_start is None:
            self.stall_start = now           # mid-stream: stall clock runs
