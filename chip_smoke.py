"""Drive the PyTorch port on one NVIDIA card and check it, phase by phase.

    python3 chip_smoke.py

Phases (one line each, a non-zero exit on any failure):
  device    card name and power limit (nvidia-smi), torch and CUDA versions
  build     nvcc builds both CUDA kernels from src/repro_torch/kernels/csrc
  kernels   each kernel against its plain PyTorch version on the card
            (bf16 rtol = atol = 2e-2; f32 1e-4, sums run in another order),
            then timed against the plain version, its bound and
            torch's scaled_dot_product_attention on the same work
  model     full-width qwen2-1.5b (random weights from a seed): prefill_chunk
            then decode steps through the kernels and through the plain
            attention, logits compared (stated tolerance below)
  executor  two workers of ClusterRealExecutors sharing weights on the card:
            multi-chunk, 2-row, left-padded and mixed iterations, a
            migration, decode on both workers
  profile   torch.profiler over a prefill, a decode and a mixed iteration:
            wall and device time, idle share, attention vs matmul time
  serve     the user entry point, repro_torch.launch.serve, on full-width
            qwen2-1.5b under the tropical policy (the main path); the
            kernels' launch counts are zeroed just before it and read just
            after

The last lines are the kernels' JSON record, the nvidia-smi line and
{"ok": true, "device": {...}}. Without a CUDA device, or without the
repository beside it, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "runs on an NVIDIA card")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.kernels import (build, chunked_prefill, ops,  # noqa: E402
                                 paged_attention, ref)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models.layers import decode_page_size  # noqa: E402
from repro_torch.serving.engine import IterationPlan  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# model phase: relative L2 error of the logits, kernels vs plain attention
MODEL_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
ARCH = "qwen2-1.5b"
MAX_LEN = 1024


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def time_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of ``fn`` with L2 flushed before each rep."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# --------------------------------------------------------------- phases


def phase_device() -> str:
    card = smi()
    say("device", card=repr(card), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build_all([paged_attention.LIB, chunked_prefill.LIB])
    say("build", seconds=f"{time.perf_counter() - t0:.2f}")
    for lib in (paged_attention.LIB, chunked_prefill.LIB):
        name, spill = "?", ""
        for line in lib.build_log.splitlines():       # nvcc -Xptxas -v
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                t = re.search(r"I(f|13__nv_bfloat16)Li(\d)E", entry.group(1))
                name = f"<{'f32' if t.group(1) == 'f' else 'bf16'}, " \
                    f"col_pairs={t.group(2)}>" if t else entry.group(1)[:48]
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                say("build", kernel=lib.source.stem + name,
                    ptxas=repr(line.split(":", 1)[1].strip() + "; " + spill))


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _prefill_case(gen, b, sq, smax, dtype, starts=None, window=None,
                  softcap=None, hq=12, hkv=2, d=128):
    q = _rand(gen, (b, sq, hq, d), dtype)
    kc = _rand(gen, (b, smax, hkv, d), dtype)
    vc = _rand(gen, (b, smax, hkv, d), dtype)
    if starts is None:
        starts = torch.randint(0, smax - sq + 1, (b,), generator=gen,
                               device=DEV)
    starts = torch.as_tensor(starts, device=DEV).to(torch.int32)
    return (q, kc, vc, starts), dict(softcap=softcap, window=window)


def _decode_case(gen, b, s, dtype, lengths=None, shuffle=False,
                 softcap=None, hq=12, hkv=2, d=128):
    ps = decode_page_size(s)
    npp = s // ps
    q = _rand(gen, (b, hq, d), dtype)
    kp = _rand(gen, (b * npp, ps, hkv, d), dtype)
    vp = _rand(gen, (b * npp, ps, hkv, d), dtype)
    order = torch.randperm(b * npp, generator=gen, device=DEV) if shuffle \
        else torch.arange(b * npp, device=DEV)
    tables = order.view(b, npp).to(torch.int32)
    if lengths is None:
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device=DEV)
    lengths = torch.as_tensor(lengths, device=DEV).to(torch.int32)
    return (q, kp, vp, tables, lengths), dict(softcap=softcap)


def _compare(name, kernel, plain, args, kw, dtype) -> float:
    out = kernel(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err = (out.float() - want.float()).abs()
    tol = TOL[dtype]
    bad = err > tol + tol * want.float().abs()
    check(torch.isfinite(out.float()).all().item(), f"{name}: non-finite")
    check(not bad.any().item(),
          f"{name}: {int(bad.sum())} elements beyond rtol=atol={tol}, "
          f"max abs err {err.max().item():.3e}")
    return err.max().item()


def _prefill_work(args, window):
    """(bytes, flops) the prefill function needs on these inputs: q and out
    once, K and V over each row's attended range once; 4*D*Hq per (query,
    attended key)."""
    q, kc, _, starts = args
    b, sq, hq, d = q.shape
    smax, hkv = kc.shape[1], kc.shape[2]
    es = q.element_size()
    pairs, kv_tokens = 0, 0
    for st in starts.tolist():
        qpos = np.arange(st, st + sq)
        hi = np.minimum(qpos + 1, smax)
        lo = np.zeros_like(qpos) if window is None \
            else np.maximum(qpos - window + 1, 0)
        pairs += int(np.maximum(hi - lo, 0).sum())
        kv_tokens += int(hi.max() - lo.min())
    byts = 2 * q.numel() * es + 2 * kv_tokens * hkv * d * es + 4 * b
    return byts, 4 * d * hq * pairs


def _decode_work(args):
    q, kp, _, tables, lengths = args
    b, hq, d = q.shape
    hkv = kp.shape[2]
    es = q.element_size()
    toks = int(lengths.clamp(max=tables.shape[1] * kp.shape[1]).sum())
    byts = 2 * q.numel() * es + 2 * toks * hkv * d * es \
        + 4 * (tables.numel() + b)
    return byts, 4 * d * hq * toks


def _sdpa_prefill(args, kw):
    """The same attention as one torch call: explicit mask, GQA."""
    q, kc, vc, starts = args
    sq, smax = q.shape[1], kc.shape[1]
    qpos = starts.long()[:, None] + torch.arange(sq, device=DEV)[None]
    kpos = torch.arange(smax, device=DEV)
    ok = kpos[None, None] <= qpos[:, :, None]
    if kw["window"] is not None:
        ok &= kpos[None, None] > qpos[:, :, None] - kw["window"]
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kc, vc))
    mask = ok[:, None]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qt, kt, vt, attn_mask=mask, enable_gqa=True)


def _sdpa_decode(args):
    q, kp, vp, tables, lengths = args
    b, hq, d = q.shape
    ps, hkv = kp.shape[1], kp.shape[2]
    s = tables.shape[1] * ps
    k = kp[tables.long()].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
    v = vp[tables.long()].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=DEV)[None] < lengths.long()[:, None])
    mask = mask[:, None, None]
    qt = q[:, :, None]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qt, k, v, attn_mask=mask, enable_gqa=True)


def phase_kernels(card: str) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(0)
    pre_k, pre_p = (chunked_prefill.chunked_prefill_attention,
                    ref.chunked_prefill_attention_ref)
    dec_k, dec_p = paged_attention.paged_attention, ref.paged_attention_ref
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        cases = {
            "rows2_sq256": _prefill_case(gen, 2, 256, MAX_LEN, dtype),
            "rows8_sq32": _prefill_case(gen, 8, 32, MAX_LEN, dtype),
            "full_bucket": _prefill_case(gen, 1, 1024, 1024, dtype,
                                         starts=[0]),
            "ragged_sq100_smax1000": _prefill_case(gen, 2, 100, 1000, dtype),
            "window64_softcap30": _prefill_case(gen, 2, 128, 1000, dtype,
                                                window=64, softcap=30.0),
        }
        for name, (args, kw) in cases.items():
            e = _compare(f"prefill/{name}/{tag}", pre_k, pre_p, args, kw,
                         dtype)
            say("kernels", kernel="chunked_prefill", case=name, dtype=tag,
                max_abs_err=f"{e:.3e}")
        cases = {
            "slots8_len1024": _decode_case(gen, 8, MAX_LEN, dtype),
            "partial_page_softcap": _decode_case(
                gen, 4, MAX_LEN, dtype, lengths=[1, 65, 300, 1023],
                softcap=30.0),
            "shuffled_tables": _decode_case(gen, 8, 512, dtype, shuffle=True),
        }
        for name, (args, kw) in cases.items():
            e = _compare(f"decode/{name}/{tag}", dec_k, dec_p, args, kw,
                         dtype)
            say("kernels", kernel="paged_attention", case=name, dtype=tag,
                max_abs_err=f"{e:.3e}")

    # timing at the main path's shapes, bf16
    dtype = torch.bfloat16
    records = {}
    pargs, pkw = _prefill_case(gen, 2, 256, MAX_LEN, dtype, starts=[0, 384])
    byts, flops = _prefill_work(pargs, None)
    records["chunked_prefill"] = dict(
        name="chunked_prefill", route="cuda",
        source="src/repro_torch/kernels/csrc/chunked_prefill.cu",
        replaces="src/repro/kernels/chunked_prefill.py:103",
        shape="rows=2 Sq=256 Smax=1024 starts=[0,384] Hq=12 Hkv=2 D=128 bf16",
        max_abs_err=_compare("prefill/timed", pre_k, pre_p, pargs, pkw,
                             dtype),
        ms=time_ms(lambda: pre_k(*pargs, **pkw)),
        plain_ms=time_ms(lambda: pre_p(*pargs, **pkw)),
        library_ms=time_ms(_sdpa_prefill(pargs, pkw)),
        **_bound(byts, flops, dtype))
    dargs, dkw = _decode_case(gen, 8, MAX_LEN, dtype,
                              lengths=[300, 420, 96, 512, 280, 333, 64, 450])
    byts, flops = _decode_work(dargs)
    records["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:107",
        shape="slots=8 max_len=1024 page=64 lengths~300 Hq=12 Hkv=2 D=128 "
              "bf16",
        max_abs_err=_compare("decode/timed", dec_k, dec_p, dargs, dkw, dtype),
        ms=time_ms(lambda: dec_k(*dargs, **dkw)),
        plain_ms=time_ms(lambda: dec_p(*dargs, **dkw)),
        library_ms=time_ms(_sdpa_decode(dargs)),
        **_bound(byts, flops, dtype))
    for r in records.values():
        say("kernels", timed=r["name"], shape=repr(r["shape"]),
            ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
            bound_ms=f"{r['bound_ms']:.5f}", bound_by=r["bound_by"],
            library_ms=f"{r['library_ms']:.4f}", card=repr(card))
    say("kernels", kernels="chunked_prefill,paged_attention",
        launches_so_far={"chunked_prefill": chunked_prefill.launches,
                         "paged_attention": paged_attention.launches})
    return records


def _bound(byts: int, flops: int, dtype) -> dict:
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


class _PlainAttention:
    """Inside this block the model's attention runs the plain versions on
    the card (a comparison only; the port's ops never do this)."""

    def __enter__(self):
        self.saved = ops.paged_attention_op, ops.chunked_prefill_op
        ops.paged_attention_op = lambda *a, softcap=None: \
            ref.paged_attention_ref(*a, softcap=softcap)
        ops.chunked_prefill_op = lambda *a, softcap=None, window=None: \
            ref.chunked_prefill_attention_ref(*a, softcap=softcap,
                                              window=window)

    def __exit__(self, *exc):
        ops.paged_attention_op, ops.chunked_prefill_op = self.saved


def phase_model() -> None:
    import dataclasses
    base = get_config(ARCH)
    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(base, dtype=dtype)
        api = model_api.build(cfg)
        params = api.init(torch.Generator(device=DEV).manual_seed(0))
        rng = np.random.default_rng(0)
        chunk = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 200)),
                                dtype=torch.int32, device=DEV)
        starts = torch.zeros(2, dtype=torch.int32, device=DEV)
        take = torch.tensor([200, 150], dtype=torch.int32, device=DEV)

        def run(tokens_in=None):
            cache = api.init_cache(2, MAX_LEN, DEV)
            logits, cache = api.prefill_chunk(params, cache, chunk, starts,
                                              take=take)
            outs, toks = [logits], []
            lengths = take.clone()
            for step in range(4):
                tok = logits.argmax(-1).to(torch.int32) if tokens_in is None \
                    else tokens_in[step]
                toks.append(tok)
                logits, cache = api.decode(params, cache, tok, lengths)
                outs.append(logits)
                lengths = lengths + 1
            return outs, toks

        k0 = (chunked_prefill.launches, paged_attention.launches)
        got, toks = run()
        check(chunked_prefill.launches > k0[0]
              and paged_attention.launches > k0[1],
              "model phase did not launch both kernels")
        with _PlainAttention():
            want, _ = run(toks)                  # teacher-forced
        rel = max(((g - w).norm() / w.norm()).item()
                  for g, w in zip(got, want))
        agree = float(np.mean([(g.argmax(-1) == w.argmax(-1)).float()
                               .mean().item() for g, w in zip(got, want)]))
        finite = all(torch.isfinite(g).all().item() for g in got)
        say("model", arch=ARCH, dtype=str(dtype).split(".")[-1],
            params_b=f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f}",
            logits_rel_l2=f"{rel:.3e}", tol=MODEL_TOL[dtype],
            argmax_agreement=f"{agree:.3f}")
        check(finite, "model phase: non-finite logits")
        check(rel <= MODEL_TOL[dtype],
              f"model phase: logits differ by {rel:.3e} (relative L2)")
        del params
        torch.cuda.empty_cache()


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else [v])


def _req(rid, prompt_len, output_len=32):
    return Request(rid=rid, arrival_time=0.0, prompt_len=prompt_len,
                   output_len=output_len, slo=SLOSpec(ttft=30.0, tpot=5.0))


def _plan(prefill=(), decode=()):
    pp = [(r, int(t)) for r, t in prefill]
    dr = list(decode)
    return IterationPlan(
        decode_reqs=dr, prefill_parts=pp, n_decode=len(dr),
        sum_ctx=float(sum(r.prompt_len for r in dr)),
        prefill_tokens=int(sum(t for _, t in pp)),
        prefill_ctx_offset=0.0, exclusive_prefill=not dr)


def phase_executor(card: str) -> None:
    cfg = get_config(ARCH)
    execs = ClusterRealExecutors(cfg, 2, max_slots=4, max_len=MAX_LEN,
                                 seed=0)
    e0, e1 = execs.execs[0], execs.execs[1]
    a, b, c, d = _req(0, 300), _req(1, 260), _req(2, 128), _req(3, 1000)
    k0 = (chunked_prefill.launches, paged_attention.launches)
    steps = [
        ("prefill a 256 (chunk 1)", e0, _plan(prefill=[(a, 256)])),
        ("2-row bucket a 44 + b 60", e0, _plan(prefill=[(a, 44), (b, 60)])),
        ("left-padded b 200 + decode a (mixed)", e0,
         _plan(prefill=[(b, 200)], decode=[a])),
        ("prefill d 1000 (bucket = max_len)", e1, _plan(prefill=[(d, 1000)])),
        ("decode a b", e0, _plan(decode=[a, b])),
        ("migrate b 0->1", None, None),
        ("prefill c 128 + decode a (mixed)", e0,
         _plan(prefill=[(c, 128)], decode=[a])),
        ("decode b d", e1, _plan(decode=[b, d])),
        ("decode d b", e1, _plan(decode=[d, b])),
        ("decode c a", e0, _plan(decode=[c, a])),
    ]
    for label, ex, plan in steps:
        t0 = time.perf_counter()
        if ex is None:
            execs.migrate(b, 0, 1)
        else:
            ex.run_plan(plan)
            for r, t in plan.prefill_parts:     # the engine's bookkeeping
                r.prefilled_tokens += t
        torch.cuda.synchronize()
        say("executor", step=repr(label),
            ms=f"{(time.perf_counter() - t0) * 1e3:.3f}", card=repr(card))
    streams = {0: e0.generated[0], 1: e1.generated[1], 2: e0.generated[2],
               3: e1.generated[3]}
    for rid, toks in streams.items():
        check(len(toks) >= 2 and all(0 <= t < cfg.vocab_size for t in toks),
              f"executor: rid {rid} stream {toks}")
    check(chunked_prefill.launches > k0[0] and paged_attention.launches > k0[1],
          "executor phase did not launch both kernels")
    say("executor", streams={k: len(v) for k, v in streams.items()},
        prefill_launches=chunked_prefill.launches - k0[0],
        decode_launches=paged_attention.launches - k0[1])
    del execs
    torch.cuda.empty_cache()


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def phase_profile(card: str) -> None:
    """Where an iteration's time goes: torch.profiler over one prefill
    iteration (8 rows x 256 tokens), one decode iteration (8 slots at
    ~260 tokens) and one mixed iteration (a 256-token chunk + 8 decodes),
    full width. Device time is the sum of kernel times (one stream, so
    kernels do not overlap); idle share = 1 - device / wall."""
    from torch.profiler import ProfilerActivity, profile
    cfg = get_config(ARCH)
    execs = ClusterRealExecutors(cfg, 1, max_slots=16, max_len=MAX_LEN,
                                 seed=0)
    ex = execs.execs[0]
    reqs = [_req(i, 256 + i) for i in range(9)]
    for label in ("prefill 8x256", "decode 8", "mixed 256 + decode 8"):
        if label == "prefill 8x256":
            plan = _plan(prefill=[(r, 256) for r in reqs[:8]])
        else:
            tails = [(r, r.prompt_len - r.prefilled_tokens) for r in reqs[:8]
                     if r.prompt_len > r.prefilled_tokens]
            if tails:                  # finish the prompts first, unprofiled
                ex.run_plan(_plan(prefill=tails))
                for r, t in tails:
                    r.prefilled_tokens += t
            plan = _plan(decode=reqs[:8]) if label == "decode 8" else \
                _plan(prefill=[(reqs[8], 256)], decode=reqs[:8])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ex.run_plan(plan)
            wall = (time.perf_counter() - t0) * 1e3
        for r, t in plan.prefill_parts:
            r.prefilled_tokens += t
        kernels = [e for e in prof.key_averages() if _device_us(e) > 0
                   and e.device_type == torch.autograd.DeviceType.CUDA]
        dev = sum(_device_us(e) for e in kernels) / 1e3
        n = sum(e.count for e in kernels)
        attn = sum(_device_us(e) for e in kernels
                   if "prefill_kernel" in e.key or "paged_attention_kernel"
                   in e.key) / 1e3
        gemm = sum(_device_us(e) for e in kernels
                   if any(s in e.key.lower() for s in ("gemm", "nvjet", "xmma",
                                                       "cutlass"))) / 1e3
        say("profile", iteration=repr(label), wall_ms=f"{wall:.3f}",
            device_ms=f"{dev:.3f}" if dev else "not-measured",
            idle_share=f"{1 - dev / wall:.3f}" if dev else "not-measured",
            attention_kernels_ms=f"{attn:.3f}", gemm_ms=f"{gemm:.3f}",
            other_ms=f"{dev - attn - gemm:.3f}", device_kernels=n,
            card=repr(card))
        top = sorted(kernels, key=_device_us, reverse=True)[:4]
        for e in top:
            say("profile", kernel=repr(e.key[:70]), count=e.count,
                device_ms=f"{_device_us(e) / 1e3:.3f}")
    del execs
    torch.cuda.empty_cache()


def phase_serve(card: str) -> dict:
    # Explicit SLOs: the trace's default limits come from the copied
    # TPU-v5e cost model, which this card's iterations do not meet; with no
    # slack the toggle (rightly) rides no prefill on a decode batch, and the
    # run would not exercise the mixed iterations the paper is about.
    argv = ["--mode", "real", "--arch", ARCH, "--size", "full",
            "--policy", "tropical", "--workers", "2", "--rate", "1.5",
            "--duration", "5", "--seed", "1", "--max-len", str(MAX_LEN),
            "--max-prompt", "512", "--max-output", "32",
            "--slo-classes", "chat:ttft=5,tpot=0.5", "--json"]
    chunked_prefill.launches = 0
    paged_attention.launches = 0
    t0 = time.perf_counter()
    row, backend = serve.run(argv)
    wall = time.perf_counter() - t0
    launches = {"chunked_prefill": chunked_prefill.launches,
                "paged_attention": paged_attention.launches}
    generated = sum(len(g) for e in backend.execs.execs.values()
                    for g in e.generated.values())
    say("serve", n_finished=row["n_finished"], n_total=row["n_total"],
        ttft_p90_s=f"{row['ttft_p90']:.4f}", tpot_p90_s=f"{row['tpot_p90']:.5f}",
        iterations=backend.iterations,
        mixed_iterations=backend.mixed_iterations,
        tokens_generated=generated,
        busy_s=f"{backend.busy_seconds:.3f}",
        tokens_per_busy_s=f"{generated / backend.busy_seconds:.1f}",
        wall_s=f"{wall:.2f}", card=repr(card))
    say("serve", launches=launches)
    check(row["n_total"] > 0 and row["n_finished"] == row["n_total"],
          "serve: not every request finished")
    check(backend.mixed_iterations >= 1, "serve: no mixed iteration")
    check(all(n > 0 for n in launches.values()),
          f"serve: a kernel was never launched on the main path {launches}")
    for lat in (row["ttft_avg"], row["tpot_avg"]):
        check(math.isfinite(lat) and lat > 0, "serve: bad latency")
    return launches


def main() -> None:
    card = phase_device()
    phase_build()
    records = phase_kernels(card)
    phase_model()
    phase_executor(card)
    phase_profile(card)
    launches = phase_serve(card)
    kernels = []
    for name, r in records.items():
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces")} | {
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]})
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
