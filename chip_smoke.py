"""Drive the PyTorch port on one NVIDIA card and check it, phase by phase.

    python3 chip_smoke.py

Phases (one line each, a non-zero exit on any failure):
  device    card name and power limit (nvidia-smi), torch and CUDA versions
  build     nvcc builds the three CUDA libraries from
            src/repro_torch/kernels/csrc, one nvcc each, all at once, and
            prints ptxas's registers and spills for every device kernel;
            fails if a tensor-core instance spills
  kernels   each kernel against its plain PyTorch version on the card,
            every case checked to run the device kernel variant the
            library picks for it (prefill and decode attention: tensor
            cores for bf16 at D = 64/80/128/256, CUDA cores for f32 and for
            bf16 at a head dim outside the set (D = 96, G = 1), the rule
            held against each library's C function; wkv6: decode for
            T = 1); prefill cases at D = 256 whose key tiles split across
            clusters of 1, 2 and 4 blocks (the launcher's split count held
            to ``PREFILL_SPLITS``, and every bf16 case at D = 256 also to
            a relative L2 limit); decode cases with a sliding window
            (gemma2's D = 256, G = 2, window 4096 at length 4300; len -
            window on a page boundary and window >= len; 16-token pages
            with shuffled tables; the tensor cores at D = 128) and
            gemma2's prefill shape; the MoE and VLM heads: decode at
            arctic's G = 7 and kimi's G = 8 (D = 128) and paligemma's G = 8
            at D = 256 over one KV head, prefill at arctic's G = 7 and at
            paligemma's 1088-token prefix from 0; zamba2's shared block
            (32 query over 32 KV heads of 80, on the tensor cores in bf16)
            in prefill (2 rows of 256 at 0 and 384) and decode (8 slots at
            64..512, one slot at 1000), and D = 80 at G = 4 (prefill) and
            G = 16 (decode)
            (attention: bf16 rtol = atol = 2e-2, f32 1e-4, sums run in
            another order; wkv6 against the sequential scan, bf16 and f32
            inputs alike: out rtol = atol = 3e-4, state rtol 3e-4 atol 3e-3,
            the JAX package's own tolerances); every attention case runs
            again with e4m3 K/V (the fp8 cache) at the same tolerances,
            each held to the variant's e4m3 instance, and bf16 q adds
            e4m3 cases across the edges of the kernels' rings of raw e4m3
            tiles (zero-filled rows past Smax or a split, D = 64, 16-token
            shuffled pages with holes, window floors inside a tile,
            gemma2's prefill split over 4, 2 and 1 blocks; each again at
            D = 80, whose rows of 5 raw chunks do not divide a pass); then
            timed
            against the plain version, its bound
            and, for attention, torch's scaled_dot_product_attention on the
            same work (``time_ms``: the card sleeps before each timed call,
            so no host time is timed), the timed attention shapes again
            with e4m3 K/V (SDPA over bf16 copies, the widening timed apart),
            and arctic's and paligemma's decode and paligemma's prefill,
            zamba2's prefill and decode at D = 80 and whisper's decode;
            last the fused pointwise passes (add_rms_norm with and without
            a residual, rope_cache_write into a bf16 and an e4m3 cache,
            gated_act with SiLU and GELU) at deepseek-7b's widths, a decode
            step's 16 rows and a prefill step's 16 x 512, held to
            kernels.ref (the norm within one unit in the last place, the
            rest bit for bit) and timed against it; rope_cache_write also
            at the other families' heads (biases, D = 80, 256, 64); and
            the routed expert products at arctic's widths (32 held of 128,
            top-2): a decode step of 64 slots, 30 of them live, and a
            prefill of 2 x 256, held to kernels.ref (relative L2 within
            2^-8, rows not live exactly 0) and timed against it, against
            the dense dispatch over every held table (library) and against
            the bound of the tables the routes touch
  model     full-width qwen2-1.5b (random weights from a seed): prefill_chunk
            then decode steps through the kernels and through the plain
            attention and pointwise ops, logits compared (stated tolerance
            below)
  model_gemma2  the same for full-width gemma2-2b: one slot of a 4352-token
            cache prefilled to 4200 tokens in chunks, then decode steps
            at positions past 4096, so the local layers' window masks
            real keys (tensor-core variants of both attention kernels
            in bf16, CUDA-core ones in f32)
  model_fp8  the same for full-width qwen2-1.5b with its cache in e4m3
  model_moe  full-width arctic-480b (2 of its 35 layers) and kimi-k2-1t (1
            of 61), bf16: chunked prefill then decode through the kernels,
            every attention call shadowed by its plain version, and through
            the plain attention; the (token, layer) routes whose experts
            differ between the runs reported, the logits held on the
            outputs whose token kept its routes
  model_vlm  full-width paligemma-3b: 1024 random patch features and 64
            text tokens prefilled in one call (lengths 1088), then 8 decode
            steps, through the kernels (tensor-core variants only) and the
            plain attention, logits compared
  model_zamba2  full-width zamba2-2.7b (54 mamba2 blocks, the shared
            attention block after every 6), bf16: two rows' prompts of 512
            tokens (the SSD's chunked form) and of 500 (the scan's function)
            prefilled, then 16 decode steps each, through the kernels (the
            tensor-core variants only, every call shadowed) and the plain
            attention, logits compared; parameters, weight and state bytes
  model_whisper  full-width whisper-medium (24 + 24 layers), bf16: two rows
            of 1500 seeded frame embeddings and a 64-token prompt
            prefilled, then 16 decode steps, the decoder's self-attention
            through the kernels (tensor-core variants only, launch counts
            asserted) and the plain attention, logits compared; the
            encoder's and the cross-attention's "full" attention is plain
            torch ops in both, as JAX computes it through XLA
  model_ring  full-width gemma2-2b with the window-sized ring cache, bf16
            and e4m3: one slot prefilled to 4200 tokens on a full cache,
            copied into the ring cache (the local layers' 4096-slot rings
            wrapped), then 16 decode steps on the ring through the paged
            kernel (counts zeroed just before, read just after: only its
            tensor_core / tensor_core_e4m3 instance, no plain version),
            logits held to the full cache's and to the ring's through the
            plain attention; times the kernel over the wrapped ring
  paged_store  a PagedKVStore on the card at qwen2-1.5b's decode shape,
            bf16 and e4m3: 8 requests of 64-512 tokens written in ragged
            pieces (pages scattered by the allocator), the paged kernel
            over the allocator's tables for every layer (counts as in
            model_ring), held to its plain version and to plain attention
            over gather_dense; times the kernel over the scattered pages
  model_rwkv  the same for full-width rwkv6-7b: prefill then decode steps
            through the wkv6 kernel (each call also checked against the
            plain scan on the same live inputs: within the kernel
            tolerances, or twice the plain chunked form's error there) and
            through the plain WKV; the logits are held to the larger of
            the dense bound and twice the floor between two plain forms
  executor  two workers of ClusterRealExecutors sharing weights on the card:
            multi-chunk, 2-row, left-padded and mixed iterations, a
            migration, decode on both workers
  executor_rwkv  the same for rwkv6-7b: replayed multi-chunk prefill, a
            request's final chunk riding on another's decode, a migration,
            decode on both workers; a slot outside the decode batch must
            keep its state bit for bit
  executor_zamba2  the same for zamba2-2.7b, whose nested state (the mamba
            layers' leaves and the shared block's K/V) must keep every leaf
            of a slot outside the decode batch bit for bit
  graphs    CUDA graphs against eager steps, full-width qwen2-1.5b and
            gemma2-2b: two workers sharing weights, prefill keys of 1-4
            rows, decode, mixed iterations and a migration, replayed in an
            order unlike the capture order, twice; the same on a second
            cluster run eagerly. Sampled tokens identical, caches within
            the bf16 model tolerance, launch counts per variant equal;
            prints captures, their seconds and the graph pool's memory
  profile   torch.profiler over a prefill, a decode and a mixed iteration,
            each through the graphs and eagerly: wall and device time,
            idle share, host ms (wall - device), attention vs matmul time
            (kernels matched by the names the wrappers export; attention
            and wkv6 must show device time); profile_gemma2 the same for
            full-width gemma2-2b, profile_fp8 for qwen2-1.5b with the fp8
            (e4m3) cache, profile_moe for arctic-480b's 2 layers with the
            routed expert kernels' share of the device time against the
            bound of the experts the routes need; profile_zamba2 the same
            for zamba2-2.7b's eager steps (its family takes no graphs yet),
            with the SSD's share of the device time and the decode batch's
            K/V gather and scatter timed beside the decode
  calibrate perf.calibrate on the card: calibrate_hardware(H100) at serving
            shapes with and without the GEMM pass and
            calibrate_interference over decode batches (1, 4, 8) x chunks
            (128, 256, 512), through the kernels (their launch counts must
            rise, the tensor-core variants included); fails if a measured
            fraction, before the clamp, reads over 1.05. Prints the
            measured specs and the cost model's predicted time of the
            profile phase's three iterations under H100's assumed and the
            measured fractions, beside the profiled wall and device time
  serve     the user entry point, repro_torch.launch.serve, on full-width
            qwen2-1.5b under the tropical policy (the dense main path);
            each serve phase of an RMSNorm family checks the fused
            passes' launches: whole forwards, in the config's variants
  serve_rwkv  the same on full-width rwkv6-7b (the rwkv main path)
  serve_gemma2  the same on full-width gemma2-2b (the windowed path)
  serve_fp8, serve_gemma2_fp8  the same on qwen2-1.5b and gemma2-2b with
            the fp8 (e4m3) cache, the config varied as the JAX
            launch/hillclimb.py varies it (the CLI has no flag for it)
  serve_moe  the same on arctic-480b at full width, 2 of its 35 layers
            (varied as the fp8 phases vary the cache), the MoE main path:
            the routed expert kernels' four passes launch, as many of each
  serve_vlm  the same on paligemma-3b, text only (the VLM main path)
  serve_zamba2  the same on zamba2-2.7b (the hybrid main path: both
            attention kernels' tensor-core bf16 instances at D = 80 and no
            other)
  serve_gemma2_long  the same on gemma2-2b past its 4096-token window:
            the longctx scenario's trace (rate 1.0, 5 s, seed 1) under the
            same SLO class, replayed through --trace-csv, into slots of
            8192 tokens (prompts capped at 6144, outputs at 128); the
            cache's size stated before the run and read after it; at least
            half the requests reach a length past 4096, both attention
            kernels are given window 4096 (eagerly or captured), on their
            tensor-core variants only, and every request finishes
  quickstart  the port's quickstart (src/repro_torch/examples/
            quickstart.py) on the card for qwen2-1.5b, gemma2-2b,
            rwkv6-7b, arctic-480b and kimi-k2-1t at SMOKE size (f32):
            prefill, 8 decode steps, 3 AdamW steps; the CUDA-core attention
            variants, both WKV kernels or the routed experts' f32 passes
            launch (counts zeroed just before each run), and the logits
            are held to the plain versions' on the same weights and tokens
  train     the training main path on full-width qwen2-1.5b (bf16, remat
            "dots"): 20 AdamW steps (lr 1e-3, warmup 5, f32 master copy) of
            8 x 512 tokens from train/data.py's stream. Step 0 by its parts:
            every parameter leaf's gradient finite and non-zero (an
            attention branch cut out of the graph would leave wq / wk / wv
            without one); every step through make_train_step with no kernel
            launch (ops.LaunchTally); finite losses, the last below the
            first. Prints step ms (median of steps 5-19), tokens/s, the
            share of peak (6 N T / step / 989 TFLOP/s, N every parameter),
            peak memory; the step ms under remat "full" (3 steps); one
            step's forward / backward / optimizer parts
            with the card synchronised between them, their wall ms, then
            (another step, profiled) their device ms, the GEMMs' and the
            plain attention's shares and the top kernels; the measured
            peak against the dry-run's prediction of the same step (traced
            on a fake group of 1, a 1 x 1 mesh), within 10% of the predicted
            transient; then api.prefill of 2 rows x 256 on the trained weights
            through the tensor-core prefill kernel, its last logits held to
            forward_train's at the same positions (MODEL_TOL, bf16)
  train_families  every family's SMOKE config in f32 (qwen2, gemma2,
            arctic, paligemma, rwkv6 at S 64 and 40, zamba2 at S 64 and 40,
            whisper at S 64): api.loss and every leaf's gradient on the card
            held to the CPU's from the same init and batch (relative L2
            1e-4); the three kernel ops refuse CUDA inputs that require
            grad; a qwen2 SMOKE run of 6 steps on the card restarted from a
            checkpoint at step 3 ends bit for bit where an uninterrupted run
            does
  moe_ep    arctic-480b's MoE layer at full width (128 experts of d_ff
            4864, top-2, bf16) on 8 x 256 prefill tokens and an 8-token
            decode: the single-process apply_moe_reference first (outputs
            kept on the host), the same weights through an NCCL group of
            world size 1, then the experts split over the (1, 4) worker
            mesh, 32 a rank, in 4 processes on the one card under gloo
            (launch.dist.spawn; gloo stages CUDA tensors through the host),
            each drawing only its own experts: allgather held to the
            reference, alltoall on the tokens that kept their assignments
            and routes (drops reported), fused_a2a bit-equal to the
            per-axis all-to-alls; ms per layer per mode, each rank's peak
            memory
  model_moe_ep  arctic-480b at full width, 2 of 35 layers, through
            api.prefill (4 rows of 256) and 4 api.decode steps with ep over
            the same 4 ranks (prefill allgather, decode alltoall), after a
            single-process run of the same weights (freed before the ranks
            start): both attention kernels' tensor-core variants launch in
            every rank (counts zeroed just before, read just after), logits
            held where the routes agree, as model_moe holds them
  shard_restore  full-width qwen2-1.5b saved, then restored on the 4 ranks
            under param_specs for the (1, 4) worker mesh (each rank reads
            its slices): every local shard byte-equal to its slice of the
            saved tensor, distribute_tensor(src_data_rank=None) slicing the
            embedding the same way; local bytes against the replicated size
  dryrun    the port's dry-run (launch.dryrun.run_cell) of one full-width
            cell a family on the 16 x 16 mesh, as rank 0 of a fake group of
            256 on the host (meta DTensors, nothing on the card): qwen2-1.5b
            and arctic-480b decode_32k, rwkv6-7b long_500k, zamba2-2.7b and
            whisper-medium prefill_32k, paligemma-3b train_4k; each must end
            ok and prints its bytes a device, dot FLOPs, wire bytes,
            dominant term (H100 peaks) and trace seconds
  dryrun_check  the trace's prediction against a real sharded run:
            qwen2-1.5b (a prefill of 4 x 1024, 8 decode steps) and
            arctic-480b cut to 2 of 35 layers (4 x 256, 4 steps; TP and EP
            together) traced on a fake group of 4 with the (1, 4) worker
            mesh's shape, run single-process (freed), then on 4 gloo ranks
            with CUDA DTensors under the specs: each rank's placed bytes
            within 2% of the trace's arguments (qwen2's parameters at
            shard_restore's 0.805 GB), its dot FLOPs and collectives (count
            and bytes by kind) equal to the trace's, no collective on a
            parameter, the tensor-core attention kernels only, logits held
            to the single-process run (arctic's where routes agree); each
            rank's peak memory and decode ms (gloo through the host); then
            one prefill and one decode step more, each from a peak reset
            just before it: the measured step peak within the larger of
            10% of the predicted transient and 64 MiB of the trace's
            predicted peak (bytes_per_device_incl_cpu_temps)
Each phase prints its seconds. Each serve phase zeroes the kernels' launch counts just before it and reads
them just after, per device kernel variant too (a CUDA graph replay adds
what its capture counted): the dense paths must launch the tensor-core
prefill and decode kernels, the gemma2 paths too (head_dim 256), the fp8
paths their e4m3 instances and no other; the rwkv path both wkv6 kernels;
the zamba2 path both attention kernels' tensor-core instances (D = 80).
The transformer paths' steps (dense, MoE, VLM) are CUDA graph replays.
The training path launches no kernel of this repository (the JAX package
trains through XLA's attention and the jnp WKV forms, not its Pallas
kernels); the train phase asserts so and then runs the prefill kernel on
the weights it trained.

The last lines are the kernels' JSON record, the run's seconds, the
nvidia-smi line and {"ok": true, "device": {...}}. Without a CUDA device,
or without the repository beside it, the script exits non-zero and prints
no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as tdist
from torch.distributed.tensor import DTensor, distribute_tensor

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False; this script "
             "runs on an NVIDIA card")

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.request import Request, SLOClass, SLOSpec  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.kernels import (build, chunked_prefill, fused,  # noqa: E402
                                 moe_experts, ops, paged_attention, ref,
                                 wkv6)
from repro_torch.launch import dist as dist_launch  # noqa: E402
from repro_torch.launch import dryrun, hloanalysis  # noqa: E402
from repro_torch.launch import mesh as mesh_launch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import api as model_api  # noqa: E402
from repro_torch.models import (layers, mamba2, moe, rwkv6,  # noqa: E402
                                sharding, tp, transformer)
from repro_torch.models.layers import (MetaGenerator,  # noqa: E402
                                       _dense_init, decode_page_size,
                                       rope_tables, to_e4m3)
from repro_torch.perf import H100, CostModel, WorkerSpec  # noqa: E402
from repro_torch.perf.calibrate import (calibrate_hardware,  # noqa: E402
                                        calibrate_interference)
from repro_torch.serving.engine import IterationPlan  # noqa: E402
from repro_torch.serving import executor as texec  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402
from repro_torch.serving.paged_store import PagedKVStore  # noqa: E402
from repro_torch.train import checkpoint, optimizer  # noqa: E402
from repro_torch.train.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.workload import get_scenario  # noqa: E402
from repro_torch.workload.csvio import save_csv  # noqa: E402
from repro_torch.workload.scenario import Scenario  # noqa: E402

DEV = torch.device("cuda")
E4M3 = torch.float8_e4m3fn
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# bf16 attention at D = 256 (whose prefill key tiles split over a cluster
# and merge through distributed shared memory) is also held to a relative L2
# error of the whole output, ||out - want|| / ||want||: sound kernels read
# about 2e-3, a merge with one split's weight 10% off 3e-2 to 5e-2, which
# the elementwise limit above can pass (PERF.md §6)
REL_L2_TOL = {torch.bfloat16: 1e-2}
# wkv6 against wkv_scan (tests/test_wkv6_kernel.py's tolerances)
WKV_OUT_TOL = (3e-4, 3e-4)           # (rtol, atol)
WKV_STATE_TOL = (3e-4, 3e-3)
# model phases: relative L2 error of the logits, kernels vs plain versions
MODEL_TOL = {torch.bfloat16: 5e-2, torch.float32: 1e-3}
# rwkv6-7b at full width parts its logits by about 1.5e-2 (f32) and 6e-2
# (bf16) between two plain WKV forms that differ only in the order of their
# f32 sums (chunked vs sequential scan; NVIDIA H100 80GB HBM3, 700 W), so
# the model phase holds the kernel's logits to twice that floor, measured
# in the same run, and holds every wkv6 call of the run to the kernel
# tolerances against the plain version on the same live inputs
FLOOR_FACTOR = 2.0
ARCH = "qwen2-1.5b"
RWKV = "rwkv6-7b"
GEMMA2 = "gemma2-2b"
MAX_LEN = 1024
# gemma2's long case: one slot of this cache holds a 4200-token prompt, past
# the local layers' 4096-token window
GEMMA2_LEN = 4352
GEMMA2_HEADS = dict(hq=8, hkv=4, d=256, softcap=50.0, window=4096)
# the MoE and VLM paths (full width; arctic and kimi cut in depth, below)
ARCTIC = "arctic-480b"
KIMI = "kimi-k2-1t"
PALIGEMMA = "paligemma-3b"
ARCTIC_HEADS = dict(hq=56, hkv=8, d=128)                 # G = 7
KIMI_HEADS = dict(hq=64, hkv=8, d=128)                   # G = 8
PALIGEMMA_HEADS = dict(hq=8, hkv=1, d=256)               # G = 8, MQA
# paligemma's prefill: 1024 patches and 64 text tokens from position 0,
# in a cache of 18 pages of 64 (room for the decode steps after it)
VLM_TEXT = 64
VLM_SEQ = 1024 + VLM_TEXT
VLM_LEN = 1152
# the hybrid and encdec paths (full width and depth): zamba2's shared
# attention block, 32 query over 32 KV heads of 80 (G = 1; bf16 at D = 80
# runs the tensor-core variants), and whisper's decoder, 16 heads of 64
ZAMBA2 = "zamba2-2.7b"
WHISPER = "whisper-medium"
ZAMBA2_HEADS = dict(hq=32, hkv=32, d=80)
WHISPER_HEADS = dict(hq=16, hkv=16, d=64)
# the serve phases' decode lengths at 8 slots (64..512, sum 2455)
SERVE_LENGTHS = (300, 420, 96, 512, 280, 333, 64, 450)
LIBS = (paged_attention.LIB, chunked_prefill.LIB, wkv6.LIB, fused.LIB,
        moe_experts.LIB)


def say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def time_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of ``fn`` with L2 flushed before each rep.
    After each flush the card sleeps (``torch.cuda._sleep``) for twice the
    host time of one call, at least 0.3 ms, and the start event follows the
    sleep: the host has queued ``fn`` before the card takes the start
    timestamp, so the window holds device time only, not the wrapper's
    host work."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(1_000_000)
    e.record()
    e.synchronize()
    cycles_per_ms = 1_000_000 / s.elapsed_time(e)
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep = int(cycles_per_ms * max(0.3, 2 * host_ms))
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(sleep)
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


def _kernel_label(mangled: str) -> str:
    """``wkv6_chunk_kernel<bf16,32>`` (or ``..._kernel<128,e4m3>``) from the
    mangled name of a kernel
    template in a (hashed) anonymous namespace, as ptxas prints it:
    ``_ZN<len><namespace><len><name>I<args>E...``."""
    m = re.match(r"_ZN", mangled)
    if not m:
        return mangled[:48]
    i, name = m.end(), mangled[:48]
    while (n := re.match(r"\d+", mangled[i:])):
        i += n.end()
        name, i = mangled[i:i + int(n.group())], i + int(n.group())
    arg = r"f|13__nv_bfloat16|13__nv_fp8_e4m3|Li\d+E|S[0-9A-Z]*_"
    t = re.match(rf"I((?:{arg})+)E", mangled[i:])
    if not t:
        return name
    label = {"f": "f32", "13__nv_bfloat16": "bf16", "13__nv_fp8_e4m3": "e4m3"}
    args = []
    for a in re.findall(arg, t.group(1)):
        if a.startswith("S"):          # a substitution: the type named before
            args.append(args[-1])
        else:
            args.append(label.get(a, a[2:-1]))
    return f"{name}<{','.join(args)}>"


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build_all(LIBS)
    say("build", seconds=f"{time.perf_counter() - t0:.2f}")
    for lib in LIBS:
        name, spill = "?", ""
        for line in lib.build_log.splitlines():       # nvcc -Xptxas -v
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                name = _kernel_label(entry.group(1))
            elif "spill" in line:
                spill = line.strip()
            elif "registers" in line:
                say("build", kernel=f"{lib.source.name}:{name}",
                    ptxas=repr(line.split(":", 1)[1].strip() + "; " + spill))
                spilled = [int(n) for n in re.findall(
                    r"(\d+) bytes spill (?:stores|loads)", spill)]
                check("_mma_kernel<" not in name or not any(spilled),
                      f"build: {name} spills ({spill})")


def _rand(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def _kv(kv, t):
    """K or V of a case: in q's dtype, or (``kv`` = e4m3) cast to e4m3 as
    the model's cache stores it."""
    return t if kv is None else to_e4m3(t)


def _prefill_case(gen, b, sq, smax, dtype, starts=None, window=None,
                  softcap=None, hq=12, hkv=2, d=128, kv=None):
    q = _rand(gen, (b, sq, hq, d), dtype)
    kc = _kv(kv, _rand(gen, (b, smax, hkv, d), dtype))
    vc = _kv(kv, _rand(gen, (b, smax, hkv, d), dtype))
    if starts is None:
        starts = torch.randint(0, smax - sq + 1, (b,), generator=gen,
                               device=DEV)
    starts = torch.as_tensor(starts, device=DEV).to(torch.int32)
    return (q, kc, vc, starts), dict(softcap=softcap, window=window)


def _decode_case(gen, b, s, dtype, lengths=None, shuffle=False,
                 softcap=None, hq=12, hkv=2, d=128, ps=None, holes=False,
                 window=None, kv=None):
    """``holes``: every third table entry is -1 (the kernel reads page 0
    there, as the plain version does)."""
    ps = ps or decode_page_size(s)
    npp = s // ps
    q = _rand(gen, (b, hq, d), dtype)
    kp = _kv(kv, _rand(gen, (b * npp, ps, hkv, d), dtype))
    vp = _kv(kv, _rand(gen, (b * npp, ps, hkv, d), dtype))
    order = torch.randperm(b * npp, generator=gen, device=DEV) if shuffle \
        else torch.arange(b * npp, device=DEV)
    tables = order.view(b, npp).to(torch.int32)
    if holes:
        tables[:, 1::3] = -1
    if lengths is None:
        lengths = torch.randint(1, s + 1, (b,), generator=gen, device=DEV)
    lengths = torch.as_tensor(lengths, device=DEV).to(torch.int32)
    return (q, kp, vp, tables, lengths), dict(softcap=softcap, window=window)


def _compare(name, kernel, plain, args, kw, dtype) -> float:
    """The kernel against its plain version, elementwise at ``TOL`` and,
    for bf16 attention at D = 256, at ``REL_L2_TOL`` on the whole output;
    returns the largest absolute error."""
    out = kernel(*args, **kw).float()
    want = plain(*args, **kw).float()
    torch.cuda.synchronize()
    err = (out - want).abs()
    tol = TOL[dtype]
    bad = err > tol + tol * want.abs()
    check(torch.isfinite(out).all().item(), f"{name}: non-finite")
    check(not bad.any().item(),
          f"{name}: {int(bad.sum())} elements beyond rtol=atol={tol}, "
          f"max abs err {err.max().item():.3e}")
    if dtype in REL_L2_TOL and args[0].shape[-1] == 256:
        rel = ((out - want).norm() / want.norm().clamp_min(1e-30)).item()
        say("kernels", check=name, rel_l2=f"{rel:.3e}",
            limit=REL_L2_TOL[dtype])
        check(rel <= REL_L2_TOL[dtype], f"{name}: relative L2 error "
              f"{rel:.3e} beyond {REL_L2_TOL[dtype]}")
    return err.max().item()


def _prefill_work(args, window):
    """(bytes, flops) the prefill function needs on these inputs: q and out
    once, K and V over each row's attended range once; 4*D*Hq per (query,
    attended key)."""
    q, kc, _, starts = args
    b, sq, hq, d = q.shape
    smax, hkv = kc.shape[1], kc.shape[2]
    es, kv_es = q.element_size(), kc.element_size()
    pairs, kv_tokens = 0, 0
    for st in starts.tolist():
        qpos = np.arange(st, st + sq)
        hi = np.minimum(qpos + 1, smax)
        lo = np.zeros_like(qpos) if window is None \
            else np.maximum(qpos - window + 1, 0)
        pairs += int(np.maximum(hi - lo, 0).sum())
        kv_tokens += int(hi.max() - lo.min())
    byts = 2 * q.numel() * es + 2 * kv_tokens * hkv * d * kv_es + 4 * b
    return byts, 4 * d * hq * pairs


def _decode_work(args, window=None):
    """(bytes, flops) of the decode on these inputs: q and out once, the
    K and V of each request's attended tokens (the last ``window`` under a
    window) once, the table and lengths; 4*D*Hq per attended token."""
    q, kp, _, tables, lengths = args
    b, hq, d = q.shape
    hkv = kp.shape[2]
    es, kv_es = q.element_size(), kp.element_size()
    lens = lengths.clamp(max=tables.shape[1] * kp.shape[1])
    toks = int((lens if window is None else lens.clamp(max=window)).sum())
    byts = 2 * q.numel() * es + 2 * toks * hkv * d * kv_es \
        + 4 * (tables.numel() + b)
    return byts, 4 * d * hq * toks


def _sdpa_prefill(args, kw):
    """The same attention as one torch call: explicit mask, GQA (no
    softcap: SDPA takes none); e4m3 K/V are widened to q's dtype first,
    outside the timed call (``_widen_ms`` times that)."""
    q, kc, vc, starts = args
    kc, vc = kc.to(q.dtype), vc.to(q.dtype)
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


def _widen_ms(args) -> dict:
    """For e4m3 K/V: the time of widening them to q's dtype, the cast a
    library call such as SDPA needs first."""
    q, k, v = args[:3]
    if k.dtype == q.dtype:
        return {}
    return {"widen_ms": time_ms(lambda: (k.to(q.dtype), v.to(q.dtype)))}


def _sdpa_note(kw) -> dict:
    """A record's note on its SDPA time where the kernel applies a softcap
    that SDPA cannot."""
    return {"library_note": "SDPA without the softcap (it takes none)"} \
        if kw.get("softcap") else {}


def _sdpa_decode(args, window=None):
    """The same decode as one torch call over the gathered pages (no
    softcap: SDPA takes none); e4m3 pages are widened to q's dtype first,
    outside the timed call."""
    q, kp, vp, tables, lengths = args
    kp, vp = kp.to(q.dtype), vp.to(q.dtype)
    b, hq, d = q.shape
    ps, hkv = kp.shape[1], kp.shape[2]
    s = tables.shape[1] * ps
    k = kp[tables.long()].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
    v = vp[tables.long()].reshape(b, s, hkv, d).transpose(1, 2).contiguous()
    pos = torch.arange(s, device=DEV)[None]
    mask = pos < lengths.long()[:, None]
    if window is not None:
        mask &= pos >= lengths.long()[:, None] - window
    mask = mask[:, None, None]
    qt = q[:, :, None]
    f = torch.nn.functional.scaled_dot_product_attention
    return lambda: f(qt, k, v, attn_mask=mask, enable_gqa=True)


def _wkv_case(gen, b, t, dtype, h=64, decay="model", s0_scale=0.0):
    """r, k, v ~ N(0, 1) in ``dtype``; the decay as the model draws it at
    init ("model": decay_base -6 plus its LoRA term, std about 0.05), with
    the JAX test's spread ("spread": N * 2 - 4), or all at the model's clip
    ("clip": 0.5, the strongest decay it allows, which stretches the chunked
    form's exponents the most); w = exp(-exp(decay)), u ~ N(0, 0.5^2) and
    s0 ~ N(0, s0_scale^2) in f32."""
    r, k, v = (_rand(gen, (b, t, h, 64), dtype) for _ in range(3))
    z = torch.randn((b, t, h, 64), generator=gen, device=DEV)
    dec = {"model": -6.0 + 0.05 * z, "spread": z * 2 - 4,
           "clip": torch.full_like(z, 0.5)}[decay]
    w = torch.exp(-torch.exp(dec.clamp(-20.0, 0.5)))
    u = torch.randn((h, 64), generator=gen, device=DEV) * 0.5
    s0 = torch.randn((b, h, 64, 64), generator=gen, device=DEV) * s0_scale
    return r, k, v, w, u, s0


def _compare_wkv(name, args) -> float:
    """The kernel against the sequential scan on the same inputs; returns
    the largest absolute error of out and of the state."""
    out, st = wkv6.wkv6(*args)
    want, s_want = rwkv6.wkv_scan(*args)
    torch.cuda.synchronize()
    check(torch.isfinite(out).all().item() and torch.isfinite(st).all().item(),
          f"{name}: non-finite")
    errs = []
    for got, exp, (rtol, atol), what in ((out, want, WKV_OUT_TOL, "out"),
                                         (st, s_want, WKV_STATE_TOL, "state")):
        err = (got - exp).abs()
        bad = err > atol + rtol * exp.abs()
        check(not bad.any().item(),
              f"{name}: {int(bad.sum())} {what} elements beyond rtol={rtol} "
              f"atol={atol}, max abs err {err.max().item():.3e}")
        errs.append(err.max().item())
    return max(errs)


def _wkv_work(args):
    """(bytes, flops) of the recurrence on these inputs: r, k, v at their
    dtype, w and out in f32, u, s0 and sT once; 4 * D * D f32 operations
    per (token, head): r^T S and the decayed rank-1 update."""
    r = args[0]
    b, t, h, d = r.shape
    n = b * t * h * d
    byts = 3 * n * r.element_size() + 2 * n * 4 + h * d * 4 \
        + 2 * b * h * d * d * 4
    return byts, 4 * d * d * b * t * h


def _expect_variant(want: str, run, *modules) -> None:
    """Run ``run`` and check it launched each of ``modules``' ``want``
    variant and no other."""
    before = [dict(m.launches_by_variant) for m in modules]
    run()
    for m, was in zip(modules, before):
        got = {k: n - was[k] for k, n in m.launches_by_variant.items()}
        check(got[want] > 0 and sum(got.values()) == got[want],
              f"{m.__name__}: expected the {want} variant, launched {got}")


def _attention_variant(dtype, d) -> str:
    """The attention kernels' variant for (dtype, head_dim); both wrappers
    export the head dims (``_check_variant_rule`` holds each library's C
    function to them)."""
    return "tensor_core" if dtype == torch.bfloat16 and \
        d in chunked_prefill.TENSOR_CORE_HEAD_DIMS else "cuda_core"


def _e4m3(variant: str, kv) -> str:
    """The ``launches_by_variant`` key of ``variant``'s instance for K/V in
    ``kv`` (None: q's dtype)."""
    return variant if kv is None else f"{variant}_e4m3"


def _check_variant_rule(d, dtype) -> None:
    """Each attention library's C variant function picks, for (d, dtype),
    the variant its wrapper's ``TENSOR_CORE_HEAD_DIMS`` names."""
    code = build.DTYPE_CODES[dtype]
    for module, fn in ((chunked_prefill, "chunked_prefill_variant"),
                       (paged_attention, "paged_attention_variant")):
        want = dtype == torch.bfloat16 and d in module.TENSOR_CORE_HEAD_DIMS
        got = getattr(module.LIB.lib(), fn)(d, code)
        check(got == int(want), f"{fn}({d}, {code}) = {got}, but "
              f"TENSOR_CORE_HEAD_DIMS = {module.TENSOR_CORE_HEAD_DIMS}")


# The prefill launcher's split count (``chunked_prefill_splits``) on a card
# of 132 SMs (an H100 SXM), bf16, keyed (B, Sq, Hq, Hkv, D, Smax, window);
# tests/test_torch_kernels.py emulates the kernel at these counts
PREFILL_SPLITS = {
    # the tests' D = 256 rows of MMA_SWEEP: a global layer, a window with
    # both starts past it, a window with one start past it
    (2, 64, 8, 4, 256, 512, None): 4,
    (2, 64, 8, 4, 256, 640, 300): 2,
    (2, 32, 8, 4, 256, 448, 128): 1,
    # the kernels phase's D = 256 cases (the first is the timed shape)
    (2, 256, 8, 4, 256, 4352, 4096): 4,
    (2, 45, 8, 4, 256, 700, None): 4,
    (1, 300, 16, 4, 256, 2000, 500): 2,
    (1, 64, 4, 4, 256, 4096, None): 4,
    (8, 256, 8, 4, 256, 1024, None): 1,
    # gemma2's local and global layers on the serve path (a mixed
    # iteration's row of 256, a prefill iteration's 8 rows) and in
    # model_gemma2 (a 1024-token chunk of a 4352-token cache)
    (1, 256, 8, 4, 256, 1024, 4096): 4,
    (1, 256, 8, 4, 256, 1024, None): 4,
    (8, 256, 8, 4, 256, 1024, 4096): 1,
    (1, 1024, 8, 4, 256, 4352, 4096): 2,
    (1, 1024, 8, 4, 256, 4352, None): 2,
    # paligemma (G = 8, Hkv = 1): model_vlm's 1088-token prefill of 2 rows
    # (272 blocks: no split), and the serve path's rows of 256 (1 row: 32
    # blocks, 4 splits; 8 rows: 256 blocks, none)
    (2, 1088, 8, 1, 256, 1152, None): 1,
    (1, 256, 8, 1, 256, 1024, None): 4,
    (8, 256, 8, 1, 256, 1024, None): 1,
    # D = 128 never splits
    (2, 256, 12, 2, 128, 1024, None): 1,
    # nor does zamba2's D = 80 (G = 1): the kernels phase's and the timed
    # 2 rows of 256, a serve iteration's row of 256, model_zamba2's prompts
    (2, 256, 32, 32, 80, 1024, None): 1,
    (1, 256, 32, 32, 80, 1024, None): 1,
    (2, 512, 32, 32, 80, 1024, None): 1,
    (2, 500, 32, 32, 80, 1024, None): 1,
}


def _check_prefill_splits() -> None:
    """The launcher's split count is ``PREFILL_SPLITS``' at every shape
    (on a card of another SM count the table does not apply)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sms != 132:
        say("kernels", prefill_splits=f"not checked on {sms} SMs")
        return
    for key, want in PREFILL_SPLITS.items():
        got = chunked_prefill.splits(*key, torch.bfloat16)
        check(got == want, f"chunked_prefill_splits{key} = {got}, but "
              f"PREFILL_SPLITS says {want}")
    say("kernels", prefill_splits=f"{len(PREFILL_SPLITS)} shapes as "
        f"PREFILL_SPLITS")


# The e4m3 edge cases' split counts (PREFILL_SPLITS' gemma2 serving shapes)
E4M3_PREFILL_SPLITS = {"e4m3_gemma2_splits4": 4, "e4m3_gemma2_splits2": 2,
                       "e4m3_gemma2_splits1": 1}


def _e4m3_prefill_edges(gen) -> dict:
    """Prefill cases (bf16 q, e4m3 K/V) across the edges of the e4m3 ring
    of raw tiles: a causal frontier at a ragged Smax, so zero-filled rows
    land in a staged tile, at D = 128 and 80; D = 64 (four 16-byte copies
    a row); a window floor inside a staged tile at D = 64, 80, 128 and
    256; gemma2's D = 256 serving shapes whose key tiles split over
    clusters of 4, 2 and 1 blocks (``E4M3_PREFILL_SPLITS``). At D = 80 a
    row is 5 raw chunks: a tile's 320 take 2.5 copy passes and 5
    widening passes with the column changing from pass to pass."""
    pc = functools.partial(_prefill_case, gen, dtype=torch.bfloat16, kv=E4M3)
    gemma2 = dict(hq=8, hkv=4, d=256, softcap=50.0, window=4096)
    return {
        "e4m3_frontier_smax999": pc(2, 45, 999, starts=[954, 100]),
        "e4m3_d64_g6_smax333": pc(2, 70, 333, starts=[263, 0], d=64),
        "e4m3_d64_g1_window50": pc(1, 64, 700, starts=[636], window=50,
                                   hq=4, hkv=4, d=64),
        "e4m3_window100_floor401": pc(2, 64, 1000, starts=[500, 37],
                                      window=100),
        "e4m3_d256_window300_floor701": pc(
            1, 96, 1500, starts=[1000], window=300, softcap=50.0, hq=8,
            hkv=4, d=256),
        "e4m3_gemma2_splits4": pc(1, 256, MAX_LEN, starts=[700], **gemma2),
        "e4m3_gemma2_splits2": pc(1, 1024, GEMMA2_LEN, starts=[3000],
                                  **gemma2),
        "e4m3_gemma2_splits1": pc(8, 256, MAX_LEN, **gemma2),
        "e4m3_d80_frontier_smax999": pc(2, 70, 999, starts=[929, 100],
                                        **ZAMBA2_HEADS),
        "e4m3_d80_g1_window50": pc(1, 64, 700, starts=[636], window=50,
                                   hq=4, hkv=4, d=80),
    }


def _e4m3_decode_edges(gen) -> dict:
    """Decode cases (bf16 q, e4m3 K/V) across the edges of each warp's
    e4m3 ring: splits that end mid-tile at the length (zero-filled rows),
    at D = 128 and 80; D = 64 at G = 6 and G = 16; 16-token shuffled pages
    with -1 holes at D = 80, 128 and 256; window floors inside a staged
    tile (the per-row address path) at D = 80, 128 and 256. At D = 80 a
    tile's 80 raw chunks take 2.5 copy passes of a warp."""
    dc = functools.partial(_decode_case, gen, dtype=torch.bfloat16, kv=E4M3)
    return {
        "e4m3_lengths_mid_tile": dc(4, MAX_LEN, lengths=[17, 100, 333, 1000]),
        "e4m3_d64": dc(4, 512, d=64, lengths=[1, 17, 250, 511]),
        "e4m3_d64_g16": dc(2, 512, d=64, hq=32, hkv=2, lengths=[300, 77]),
        "e4m3_page16_shuffled_holes": dc(3, 400, shuffle=True, ps=16,
                                         holes=True, lengths=[15, 177, 399]),
        "e4m3_d256_page16_shuffled_holes": dc(
            2, 512, shuffle=True, ps=16, holes=True, lengths=[250, 509],
            hq=8, hkv=4, d=256, softcap=50.0),
        "e4m3_window100_floor_mid_tile": dc(
            4, MAX_LEN, lengths=[150, 333, 700, 1024], window=100),
        "e4m3_d256_window250_floor_mid_tile": dc(
            2, MAX_LEN, lengths=[300, 1000], hq=8, hkv=4, d=256, window=250,
            softcap=50.0),
        "e4m3_d80_lengths_mid_tile": dc(
            4, MAX_LEN, lengths=[17, 100, 333, 1000], hq=4, hkv=4, d=80),
        "e4m3_d80_page16_shuffled_holes": dc(
            3, 400, shuffle=True, ps=16, holes=True, lengths=[15, 177, 399],
            hq=4, hkv=4, d=80),
        "e4m3_d80_window100_floor_mid_tile": dc(
            4, MAX_LEN, lengths=[150, 333, 700, 1024], window=100, hq=4,
            hkv=4, d=80),
    }


def phase_kernels(card: str) -> dict:
    gen = torch.Generator(device=DEV).manual_seed(0)
    _check_prefill_splits()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    pre_k, pre_p = (chunked_prefill.chunked_prefill_attention,
                    ref.chunked_prefill_attention_ref)
    dec_k, dec_p = paged_attention.paged_attention, ref.paged_attention_ref
    # every case with K/V in q's dtype, then again with e4m3 K/V (the fp8
    # cache; the variant still follows q's dtype)
    for dtype, kv in itertools.product((torch.bfloat16, torch.float32),
                                       (None, E4M3)):
        tag = str(dtype).split(".")[-1] + ("" if kv is None else "/e4m3")
        pc = functools.partial(_prefill_case, kv=kv)
        dc = functools.partial(_decode_case, kv=kv)
        # G = 6, D = 128 unless named; a block holds 64 // G queries (10
        # at G = 6, 64 at G = 1 on the tensor-core variant)
        cases = {
            "rows2_sq256": pc(gen, 2, 256, MAX_LEN, dtype),
            "rows8_sq32": pc(gen, 8, 32, MAX_LEN, dtype),
            "full_bucket": pc(gen, 1, 1024, 1024, dtype,
                              starts=[0]),
            "ragged_sq100_smax1000": pc(gen, 2, 100, 1000, dtype),
            "window64_softcap30": pc(gen, 2, 128, 1000, dtype,
                                     window=64, softcap=30.0),
            "sq37": pc(gen, 3, 37, MAX_LEN, dtype),
            "d64_g6_sq45": pc(gen, 2, 45, 512, dtype, d=64),
            "d64_g1_sq100": pc(gen, 2, 100, 1000, dtype, hq=8,
                               hkv=8, d=64),
            "d128_g1_sq70": pc(gen, 2, 70, 512, dtype, hq=8,
                               hkv=8),
            "d64_g1_window32_softcap50": pc(
                gen, 2, 150, 600, dtype, window=32, softcap=50.0, hq=4,
                hkv=4, d=64),
            # gemma2: the second row's queries lie past the window
            "gemma2_d256_g2_window4096_softcap50": pc(
                gen, 2, 256, GEMMA2_LEN, dtype, starts=[0, 3900],
                window=4096, softcap=50.0, hq=8, hkv=4, d=256),
            # D = 256 with its key tiles split across 4, 2, 4 and 1 blocks
            # (bf16): ragged, G = 4 under a window, G = 1 over 4096 keys,
            # gemma2's serving iteration of 8 rows
            "d256_g2_sq45_smax700": pc(gen, 2, 45, 700, dtype,
                                       hq=8, hkv=4, d=256),
            "d256_g4_window500_softcap30": pc(
                gen, 1, 300, 2000, dtype, window=500, softcap=30.0, hq=16,
                hkv=4, d=256),
            "d256_g1_sq64_smax4096": pc(
                gen, 1, 64, 4096, dtype, starts=[4032], hq=4, hkv=4, d=256),
            "d256_g2_rows8_sq256_softcap50": pc(
                gen, 8, 256, MAX_LEN, dtype, softcap=50.0, hq=8, hkv=4,
                d=256),
            # arctic's heads (G = 7: 9 queries, 63 rows a block) and
            # paligemma's 1088-token prefix + text prefill from 0 (G = 8 at
            # D = 256 over one KV head)
            "arctic_g7_sq256": pc(gen, 2, 256, MAX_LEN, dtype,
                                  **ARCTIC_HEADS),
            "paligemma_prefix_g8_d256_hkv1": pc(
                gen, 2, VLM_SEQ, VLM_LEN, dtype, starts=[0, 0],
                **PALIGEMMA_HEADS),
            # zamba2's shared block: G = 1 at D = 80 (64 queries a block on
            # the tensor cores in bf16), and D = 80 at G = 4
            "zamba2_d80_g1_sq256": pc(gen, 2, 256, MAX_LEN, dtype,
                                      starts=[0, 384], **ZAMBA2_HEADS),
            "d80_g4_sq37": pc(gen, 2, 37, 160, dtype, hq=16, hkv=4, d=80),
            # bf16 at a head dim outside TENSOR_CORE_HEAD_DIMS: the
            # CUDA-core kernel's bf16 instances
            "d96_g1_sq100": pc(gen, 2, 100, 512, dtype, hq=4, hkv=4, d=96),
        }
        if kv is not None and dtype == torch.bfloat16:
            cases |= _e4m3_prefill_edges(gen)
        for name, (args, kw) in cases.items():
            q, kc = args[0], args[1]
            _check_variant_rule(q.shape[-1], dtype)
            errs = []
            _expect_variant(_e4m3(_attention_variant(dtype, q.shape[-1]), kv),
                            lambda: errs.append(_compare(
                                f"prefill/{name}/{tag}", pre_k, pre_p, args,
                                kw, dtype)), chunked_prefill)
            nsplit = chunked_prefill.splits(
                q.shape[0], q.shape[1], q.shape[2], kc.shape[2], q.shape[3],
                kc.shape[1], kw["window"], dtype)
            say("kernels", kernel="chunked_prefill", case=name, dtype=tag,
                splits=nsplit, max_abs_err=f"{errs[0]:.3e}")
            want = E4M3_PREFILL_SPLITS.get(name) if sms == 132 else None
            check(want is None or nsplit == want, f"prefill/{name}/{tag}: "
                  f"{nsplit} splits, the case is for {want}")
        # G = 6, D = 128, 64-token pages unless named; splits: blocks per
        # (b, kv-head), from B * Hkv and the table's pages
        cases = {
            "slots8_len1024": dc(gen, 8, MAX_LEN, dtype),
            "partial_page_softcap": dc(
                gen, 4, MAX_LEN, dtype, lengths=[1, 65, 300, 1023],
                softcap=30.0),
            "shuffled_tables": dc(gen, 8, 512, dtype, shuffle=True),
            "one_slot_len1024": dc(gen, 1, MAX_LEN, dtype,
                                   lengths=[MAX_LEN]),
            "lengths_1_2_64_65": dc(gen, 4, MAX_LEN, dtype,
                                    lengths=[1, 2, 64, 65]),
            "g16_d128": dc(gen, 4, 512, dtype, hq=32, hkv=2),
            "g8_d256": dc(gen, 4, 512, dtype, hq=16, hkv=2, d=256),
            "d64": dc(gen, 4, 512, dtype, d=64),
            "page16_shuffled_holes": dc(
                gen, 3, 400, dtype, shuffle=True, ps=16, holes=True),
            # sliding windows: the first key is len - window (0 when the
            # window covers the request); gemma2 at one slot of 4300
            "gemma2_len4300_window4096": dc(
                gen, 1, GEMMA2_LEN, dtype, lengths=[4300], **GEMMA2_HEADS),
            # 164 - 100 and 228 - 100 on page boundaries; 1, 50, 100
            # inside the window
            "slots8_window100": dc(
                gen, 8, MAX_LEN, dtype,
                lengths=[1, 50, 100, 101, 164, 228, 300, 1023], window=100),
            "page16_shuffled_window40": dc(
                gen, 3, 400, dtype, shuffle=True, ps=16,
                lengths=[40, 56, 399], window=40),
            "g8_d128_window64": dc(
                gen, 4, MAX_LEN, dtype, lengths=[63, 64, 65, 1000], hq=16,
                hkv=2, window=64),
            # the MoE and VLM heads at 8 slots: arctic's odd G = 7 (padded
            # to 8 columns), kimi's G = 8 at D = 128, paligemma's G = 8 at
            # D = 256 over one KV head (the kernel's largest group there;
            # 8 clusters, so S = 16)
            "arctic_g7_d128": dc(gen, 8, MAX_LEN, dtype, **ARCTIC_HEADS),
            "kimi_g8_d128": dc(gen, 8, MAX_LEN, dtype, **KIMI_HEADS),
            "paligemma_g8_d256_hkv1": dc(gen, 8, MAX_LEN, dtype,
                                         **PALIGEMMA_HEADS),
            # zamba2's decode: 8 slots at the serve lengths, one at 1000
            "zamba2_d80_g1_slots8": dc(gen, 8, MAX_LEN, dtype,
                                       lengths=list(SERVE_LENGTHS),
                                       **ZAMBA2_HEADS),
            "zamba2_d80_g1_one_slot_len1000": dc(
                gen, 1, MAX_LEN, dtype, lengths=[1000], **ZAMBA2_HEADS),
            # D = 80 at G = 16 (two n-tiles), and bf16 at D = 96 (outside
            # TENSOR_CORE_HEAD_DIMS: the CUDA-core kernel's bf16 instances)
            "d80_g16": dc(gen, 2, 512, dtype, hq=32, hkv=2, d=80),
            "d96_g1": dc(gen, 4, 512, dtype, hq=4, hkv=4, d=96,
                         lengths=[1, 17, 250, 511]),
        }
        if kv is not None and dtype == torch.bfloat16:
            cases |= _e4m3_decode_edges(gen)
        for name, (args, kw) in cases.items():
            q, kp, _, tables, _ = args
            _check_variant_rule(q.shape[-1], dtype)
            errs = []
            _expect_variant(_e4m3(_attention_variant(dtype, q.shape[-1]), kv),
                            lambda: errs.append(_compare(
                                f"decode/{name}/{tag}", dec_k, dec_p, args,
                                kw, dtype)), paged_attention)
            say("kernels", kernel="paged_attention", case=name, dtype=tag,
                splits=paged_attention.splits(
                    q.shape[0], q.shape[1], kp.shape[2], q.shape[2],
                    tables.shape[1], dtype, kp.dtype),
                window=kw["window"], max_abs_err=f"{errs[0]:.3e}")

    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        # B*H < 132 runs 32-column slices, B*H >= 132 64-column ones
        cases = {
            "b1_t512_h64": _wkv_case(gen, 1, 512, dtype),
            "b4_t130_h64": _wkv_case(gen, 4, 130, dtype, decay="spread",
                                     s0_scale=0.5),
            "decode_b1_t1_s0": _wkv_case(gen, 1, 1, dtype, s0_scale=1.0),
            "decode_b8_t1_s0": _wkv_case(gen, 8, 1, dtype, s0_scale=1.0),
            "decode_b16_t1_s0": _wkv_case(gen, 16, 1, dtype, s0_scale=1.0),
            "t65": _wkv_case(gen, 1, 65, dtype, h=8, decay="spread",
                             s0_scale=0.1),
            "ragged_t100": _wkv_case(gen, 2, 100, dtype, h=8,
                                     decay="spread", s0_scale=0.1),
            "t544_clip": _wkv_case(gen, 1, 544, dtype, h=8, decay="clip",
                                   s0_scale=0.1),
            "t130_s0": _wkv_case(gen, 2, 130, dtype, h=8, decay="spread",
                                 s0_scale=1.0),
        }
        for name, args in cases.items():
            errs = []
            _expect_variant("decode" if args[0].shape[1] == 1 else "chunk",
                            lambda: errs.append(_compare_wkv(
                                f"wkv6/{name}/{tag}", args)), wkv6)
            say("kernels", kernel="wkv6", case=name, dtype=tag,
                max_abs_err=f"{errs[0]:.3e}")

    # timing at the main path's shapes, bf16 q; each shape again with e4m3
    # K/V (records named ..._e4m3; SDPA over bf16 copies of them, the
    # widening's own time beside it)
    dtype = torch.bfloat16
    records = {}
    for (key, smax, starts, heads, shape), kv in itertools.product(
            PREFILL_TIMED, (None, E4M3)):
        pargs, pkw = _prefill_case(gen, 2, 256, smax, dtype, starts=starts,
                                   kv=kv, **heads)
        name = key if kv is None else f"{key}_e4m3"
        records[name] = _prefill_record(
            name, shape if kv is None else f"{shape}, K/V e4m3", pargs, pkw)
    for kv in (None, E4M3):
        for key, lengths, shape in DECODE_TIMED:
            r = _time_decode(gen, key, lengths, shape, kv=kv)
            records[r["name"]] = r
        for key, s, lengths, shape in GEMMA2_DECODE_TIMED:
            r = _time_decode(gen, key, lengths, shape, s=s, kv=kv,
                             **GEMMA2_HEADS)
            records[r["name"]] = r
    # the MoE and VLM paths' shapes, K/V in bf16 as their serve paths keep
    # them: arctic's and paligemma's decode steps of 8 slots, paligemma's
    # 1088-token prefill (model_vlm's)
    for key, lengths, shape, heads in MOE_VLM_DECODE_TIMED:
        r = _time_decode(gen, key, lengths, shape, **heads)
        records[r["name"]] = r
    pargs, pkw = _prefill_case(gen, 2, VLM_SEQ, VLM_LEN, dtype,
                               starts=[0, 0], **PALIGEMMA_HEADS)
    records["chunked_prefill_paligemma"] = _prefill_record(
        "chunked_prefill_paligemma",
        f"rows=2 Sq={VLM_SEQ} Smax={VLM_LEN} starts=[0,0] Hq=8 Hkv=1 D=256 "
        "bf16", pargs, pkw)
    # zamba2's shared attention (the tensor-core variants at D = 80) and
    # whisper's decoder decode (tensor cores at D = 64), K/V in bf16 as
    # their paths keep them
    pargs, pkw = _prefill_case(gen, 2, 256, MAX_LEN, dtype, starts=[0, 384],
                               **ZAMBA2_HEADS)
    records["chunked_prefill_zamba2"] = _prefill_record(
        "chunked_prefill_zamba2",
        "rows=2 Sq=256 Smax=1024 starts=[0,384] Hq=32 Hkv=32 D=80 bf16",
        pargs, pkw)
    for key, lengths, shape, heads in HYBRID_ENCDEC_DECODE_TIMED:
        r = _time_decode(gen, key, lengths, shape, **heads)
        records[r["name"]] = r
    # wkv6: a decode step of 8 slots (its own device kernel), a prefill replay
    for key, variant, args, mode in (
            ("wkv6_decode", "decode", _wkv_case(gen, 8, 1, dtype,
                                                s0_scale=1.0), "decode"),
            ("wkv6", "chunk", _wkv_case(gen, 1, 512, dtype), "chunked")):
        byts, flops = _wkv_work(args)
        b, t, h, _ = args[0].shape
        records[key] = dict(
            name=key, route="cuda", variant=variant,
            source="src/repro_torch/kernels/csrc/wkv6.cu",
            replaces="src/repro/kernels/wkv6.py:89",
            shape=f"B={b} T={t} H={h} D=64 bf16 r/k/v, f32 w/u/s0",
            max_abs_err=_compare_wkv(f"wkv6/timed_{key}", args),
            ms=time_ms(lambda: wkv6.wkv6(*args)),
            plain_ms=time_ms(lambda: ref.wkv6_ref(*args, mode)),
            library_ms=None, **_bound(byts, flops, torch.float32))
    for r in records.values():
        _say_timed(r, card)
    for r in _fused_records(gen):
        _say_timed(r, card)
    for r in _moe_records(gen):
        _say_timed(r, card)
    say("kernels", kernels="chunked_prefill,paged_attention,wkv6,fused,"
        "moe_experts",
        launches_so_far={"chunked_prefill": chunked_prefill.launches_by_variant,
                         "paged_attention": paged_attention.launches_by_variant,
                         "wkv6": wkv6.launches_by_variant,
                         "fused": fused.launches_by_variant,
                         "moe_experts": moe_experts.launches_by_variant})
    return records


# the fused pointwise passes at deepseek-7b's widths (d_model 4096, 32 / 32
# heads of 128, d_ff 11008), a decode step's 16 rows and a prefill step's
# 16 x 512, bf16, the cache 16 slots of 1024
FUSED_TIMED = (("decode", 16, 1), ("prefill", 16, 512))
FUSED_WIDTHS = dict(d=4096, hq=32, hkv=32, hd=128, ff=11008, smax=MAX_LEN)


def _ulps(got, want) -> float:
    """The largest |got - want| in units in the last place of want."""
    w = want.float()
    ulp = torch.finfo(want.dtype).eps * torch.exp2(torch.floor(torch.log2(
        w.abs().clamp_min(torch.finfo(want.dtype).tiny))))
    return float(((got.float() - w).abs() / ulp).max())


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        t.element_size()])


def _fused_records(gen) -> list:
    """Each fused pass against its plain chain (``kernels.ref``) at a decode
    and a prefill step's shapes: checked (the norm within one unit in the
    last place, the rest bit for bit, e4m3 cache included) and timed. The
    norm with a residual and without (layer 0's, gemma2's post-norms,
    mamba2's), both activations; then, checked only, the attention pass at
    the other families' heads (``FUSED_HEADS``)."""
    w, bf = FUSED_WIDTHS, torch.bfloat16
    out = []
    for step, b, s in FUSED_TIMED:
        rows = b * s
        x, r = (_rand(gen, (b, s, w["d"]), bf) for _ in "xr")
        scale = _rand(gen, (w["d"],), bf) * 0.1
        for res in (r, None):
            total, normed = fused.add_rms_norm(x, res, scale, 1e-6)
            want_total, want = ref.add_rms_norm_ref(x, res, scale, 1e-6)
            ulps = _ulps(normed, want)
            name = "add_rms_norm" if res is not None else "rms_norm"
            check(torch.equal(_bits(total), _bits(want_total)) and ulps <= 1,
                  f"kernels: {name} {step} off by {ulps} ulp")
            tensors = 4 if res is not None else 2
            out.append(dict(
                name=f"{name}_{step}", shape=f"{b}x{s}x{w['d']} bf16",
                max_abs_err=ulps,
                ms=time_ms(lambda: fused.add_rms_norm(x, res, scale, 1e-6)),
                plain_ms=time_ms(lambda: ref.add_rms_norm_ref(x, res, scale,
                                                              1e-6)),
                library_ms=None, **_bound(
                    2 * (tensors * rows * w["d"] + w["d"]), 0, bf)))
        q = _rand(gen, (b, s, w["hq"], w["hd"]), bf)
        k, v = (_rand(gen, (b, s, w["hkv"], w["hd"]), bf) for _ in "kv")
        pos = torch.randint(0, w["smax"] - s + 1, (b,), generator=gen,
                            device=DEV, dtype=torch.int32)
        rot = _rope_at(pos, s, w["hd"])
        for cache_dtype in (bf, E4M3):
            kc, vc = (_rand(gen, (b, w["smax"], w["hkv"], w["hd"]),
                            bf).to(cache_dtype) for _ in "kv")
            kw, vw = kc.clone(), vc.clone()
            got = fused.rope_cache_write(q, k, v, *rot, kc, vc, pos)
            want = ref.rope_cache_write_ref(q, k, v, *rot, kw, vw, pos)
            check(all(torch.equal(_bits(a), _bits(c)) for a, c in
                      ((got, want), (kc, kw), (vc, vw))),
                  f"kernels: rope_cache_write {step} {cache_dtype} differs")
            tag = "" if cache_dtype == bf else "_e4m3"
            new_rows = 2 * rows * w["hkv"] * w["hd"] * kc.element_size()
            byts = 2 * (2 * q.numel() + 2 * k.numel()) \
                + 2 * 4 * rows * w["hd"] // 2 + new_rows
            out.append(dict(
                name=f"rope_cache_write_{step}{tag}",
                shape=f"{b}x{s} Hq={w['hq']} Hkv={w['hkv']} D={w['hd']} "
                      f"bf16, cache {cache_dtype}",
                max_abs_err=0.0,
                ms=time_ms(lambda: fused.rope_cache_write(q, k, v, *rot, kc,
                                                          vc, pos)),
                plain_ms=time_ms(lambda: ref.rope_cache_write_ref(
                    q, k, v, *rot, kw, vw, pos)),
                library_ms=None, **_bound(byts, 0, bf)))
        g, u = (_rand(gen, (b, s, w["ff"]), bf) for _ in "gu")
        for act in fused.ACTIVATIONS:
            check(torch.equal(_bits(fused.gated_act(g, u, act)),
                              _bits(ref.gated_act_ref(g, u, act))),
                  f"kernels: gated_act {act} {step} differs")
            out.append(dict(
                name=f"gated_{act}_{step}",
                shape=f"{b}x{s}x{w['ff']} bf16 {act}", max_abs_err=0.0,
                ms=time_ms(lambda: fused.gated_act(g, u, act)),
                plain_ms=time_ms(lambda: ref.gated_act_ref(g, u, act)),
                library_ms=None, **_bound(3 * 2 * g.numel(), 0, bf)))
    _check_fused_heads(gen)
    return out


# the attention pass at the other families' heads, checked at a decode
# step's 16 rows and a 64-token prefill chunk: (label, Hq, Hkv, head_dim,
# q/k/v biases)
FUSED_HEADS = (("qwen2", 12, 2, 128, True), ("zamba2", 32, 32, 80, False),
               ("gemma2", 8, 4, 256, False), ("d64", 16, 16, 64, False))


def _check_fused_heads(gen) -> None:
    bf, smax = torch.bfloat16, FUSED_WIDTHS["smax"]
    for label, hq, hkv, hd, bias in FUSED_HEADS:
        for b, s in ((16, 1), (2, 64)):
            q = _rand(gen, (b, s, hq, hd), bf)
            k, v = (_rand(gen, (b, s, hkv, hd), bf) for _ in "kv")
            biases = [_rand(gen, (h, hd), bf) for h in (hq, hkv, hkv)] \
                if bias else []
            # the last start past Smax - s, where the write is clamped back
            pos = torch.randint(0, smax - s + 1, (b,), generator=gen,
                                device=DEV, dtype=torch.int32)
            pos[-1] = smax - s // 2
            rot = _rope_at(pos, s, hd)
            for cache_dtype in (bf, E4M3):
                kc, vc = (_rand(gen, (b, smax, hkv, hd), bf).to(cache_dtype)
                          for _ in "kv")
                kw, vw = kc.clone(), vc.clone()
                got = fused.rope_cache_write(q, k, v, *rot, kc, vc, pos,
                                             *biases)
                want = ref.rope_cache_write_ref(q, k, v, *rot, kw, vw, pos,
                                                *biases)
                check(all(torch.equal(_bits(a), _bits(c)) for a, c in
                          ((got, want), (kc, kw), (vc, vw))),
                      f"kernels: rope_cache_write {label} {b}x{s} "
                      f"{cache_dtype} differs")
    say("kernels", fused_heads_bit_equal=",".join(h[0] for h in FUSED_HEADS))


# the routed expert products at arctic's widths (d_model 7168, d_ff 4864;
# 32 held tables of the 128 the router scores, top-2): a decode step of 64
# slots of which 30 hold a request (the cell's rate), and a prefill of 2
# rows x 256, every position live; bf16, the model's scales
MOE_WIDTHS = dict(d=7168, f=4864, router=128, held=32, k=2)
MOE_TIMED = (("decode", 64, 30), ("prefill", 512, 512))
# one unit of bf16 (2^-8) of the output's norm: the products' sums run in
# another order than cuBLAS's and round to bf16 where the plain ops round
MOE_REL_L2 = 2.0 ** -8


def _moe_records(gen) -> list:
    """The routed products (``moe_experts``) against their plain version
    (``ref.moe_experts_ref``: the dense dispatch with the rows that are not
    live zeroed) at ``MOE_TIMED``'s steps: checked (relative L2 within
    ``MOE_REL_L2``, the rows that are not live exactly 0) and timed beside
    the plain version, the dense dispatch the layer ran before
    (``moe._expert_sum`` over every held table, the library yardstick) and
    the bound of the tables the routes touch (or their products' FLOPs)."""
    w, bf = MOE_WIDTHS, torch.bfloat16
    d, f, held, k = w["d"], w["f"], w["held"], w["k"]
    tabs = []
    for shape, std in (((d, f), w["router"] ** -0.5),
                       ((d, f), w["router"] ** -0.5), ((f, d), f ** -0.5)):
        t = torch.empty((held,) + shape, dtype=bf, device=DEV)
        for e in range(held):
            t[e] = torch.randn(shape, generator=gen, device=DEV) * std
        tabs.append(t)
    cfg = dataclasses.replace(get_config(ARCTIC), num_experts=held)
    group = moe.GROUP_ELEMENTS
    out = []
    for step, t, n_live in MOE_TIMED:
        x = _rand(gen, (t, d), bf)
        keys = torch.rand((t, w["router"]), generator=gen, device=DEV)
        ids = keys.argsort(-1)[:, :k]
        gates = torch.softmax(torch.randn((t, k), generator=gen,
                                          device=DEV), -1)
        live = torch.zeros(t, dtype=torch.bool, device=DEV)
        live[torch.randperm(t, generator=gen, device=DEV)[:n_live]] = True
        args = (x, *tabs, gates, ids, live, 0)
        routed = (*args, w["router"], "silu", group)
        plain = (*args, "silu", group)
        got = moe_experts.moe_experts(*routed)
        want = ref.moe_experts_ref(*plain)
        counts = ref.moe_lists(ids.cpu(), live.cpu(), 0, held)[0]
        touched, pairs = int((counts > 0).sum()), int(counts.sum())
        rel = ((got[live].float() - want[live].float()).norm()
               / want[live].float().norm()).item()
        check(rel <= MOE_REL_L2 and not got[~live].any(),
              f"kernels: moe_experts {step} relative L2 {rel:.2e}, or a row "
              "that is not live took a value")
        combine = ref.held_combine(gates, ids, range(held))
        out.append(dict(
            name=f"moe_experts_{step}",
            shape=f"T={t} live={n_live} d={d} f={f} top-{k} of "
                  f"{w['router']}, {held} held, {touched} touched, bf16",
            max_abs_err=rel,
            ms=time_ms(lambda: moe_experts.moe_experts(*routed)),
            plain_ms=time_ms(lambda: ref.moe_experts_ref(*plain)),
            library_ms=time_ms(lambda: moe._expert_sum(
                x, *tabs, combine, held, cfg).to(bf)),
            library_note="dense dispatch: cuBLAS batched products over "
                         "every held table",
            **_bound(2 * (3 * touched * d * f + 2 * t * d),
                     6 * pairs * d * f, bf)))
    del tabs
    return out


def _rope_at(starts, s: int, hd: int):
    """The rope tables of a step whose rows start at ``starts``."""
    positions = starts.long()[:, None] + torch.arange(s, device=DEV)[None]
    return rope_tables(positions, hd, 10_000.0)


# prefill shapes the kernels phase times (bf16, 2 rows of 256 queries):
# qwen2's, and gemma2's (its second row past the window)
PREFILL_TIMED = (
    ("chunked_prefill", MAX_LEN, [0, 384], {},
     "rows=2 Sq=256 Smax=1024 starts=[0,384] Hq=12 Hkv=2 D=128 bf16"),
    ("chunked_prefill_gemma2", GEMMA2_LEN, [0, 3900], GEMMA2_HEADS,
     "rows=2 Sq=256 Smax=4352 starts=[0,3900] Hq=8 Hkv=4 D=256 window=4096 "
     "softcap=50 bf16"),
)

# gemma2's decode shapes (bf16, 64-token pages): the serve path's step of 8
# slots, and one slot at 4300 whose window starts at 204
GEMMA2_DECODE_TIMED = (
    ("paged_attention_gemma2", MAX_LEN, (300, 420, 96, 512, 280, 333, 64, 450),
     "slots=8 max_len=1024 page=64 lengths~300 Hq=8 Hkv=4 D=256 window=4096 "
     "softcap=50 bf16"),
    ("paged_attention_gemma2_long", GEMMA2_LEN, (4300,),
     "slots=1 max_len=4352 page=64 length=4300 Hq=8 Hkv=4 D=256 window=4096 "
     "softcap=50 bf16"),
)

# decode shapes the kernels phase times (bf16, G = 6, D = 128, 64-token
# pages of a 1024-token cache): a step of 8 slots, and one slot (the
# low-load case); kernel_ab.py times them on another tree too
DECODE_TIMED = (
    ("paged_attention", (300, 420, 96, 512, 280, 333, 64, 450),
     "slots=8 max_len=1024 page=64 lengths~300 Hq=12 Hkv=2 D=128 bf16"),
    ("paged_attention_1slot", (1000,),
     "slots=1 max_len=1024 page=64 length=1000 Hq=12 Hkv=2 D=128 bf16"),
)


# the MoE and VLM paths' decode shapes (bf16, 64-token pages of a
# 1024-token cache, the serve phases' 8 slots at lengths as above)
MOE_VLM_DECODE_TIMED = (
    ("paged_attention_arctic", (300, 420, 96, 512, 280, 333, 64, 450),
     "slots=8 max_len=1024 page=64 lengths~300 Hq=56 Hkv=8 D=128 bf16",
     ARCTIC_HEADS),
    ("paged_attention_paligemma", (300, 420, 96, 512, 280, 333, 64, 450),
     "slots=8 max_len=1024 page=64 lengths~300 Hq=8 Hkv=1 D=256 bf16",
     PALIGEMMA_HEADS),
)


# zamba2's and whisper's decode steps of 8 slots (bf16, 64-token pages of a
# 1024-token cache, the serve lengths)
HYBRID_ENCDEC_DECODE_TIMED = (
    ("paged_attention_zamba2", SERVE_LENGTHS,
     "slots=8 max_len=1024 page=64 lengths~300 Hq=32 Hkv=32 D=80 bf16",
     ZAMBA2_HEADS),
    ("paged_attention_whisper", SERVE_LENGTHS,
     "slots=8 max_len=1024 page=64 lengths~300 Hq=16 Hkv=16 D=64 bf16",
     WHISPER_HEADS),
)


def _prefill_record(name, shape, args, kw) -> dict:
    """The prefill kernel's record on given inputs: checked against the
    plain version, then timed beside it, its bound and SDPA."""
    q, kc = args[0], args[1]
    dtype = q.dtype
    byts, flops = _prefill_work(args, kw["window"])
    kernel, plain = (chunked_prefill.chunked_prefill_attention,
                     ref.chunked_prefill_attention_ref)
    kv = None if kc.dtype == dtype else kc.dtype
    return dict(
        name=name, route="cuda",
        variant=_e4m3(_attention_variant(dtype, q.shape[-1]), kv),
        splits=chunked_prefill.splits(
            q.shape[0], q.shape[1], q.shape[2], kc.shape[2], q.shape[3],
            kc.shape[1], kw["window"], dtype),
        source="src/repro_torch/kernels/csrc/chunked_prefill.cu",
        replaces="src/repro/kernels/chunked_prefill.py:103", shape=shape,
        max_abs_err=_compare(f"prefill/timed_{name}", kernel, plain, args,
                             kw, dtype),
        ms=time_ms(lambda: kernel(*args, **kw)),
        plain_ms=time_ms(lambda: plain(*args, **kw)),
        library_ms=time_ms(_sdpa_prefill(args, kw)),
        **_widen_ms(args), **_sdpa_note(kw), **_bound(byts, flops, dtype))


def _time_decode(gen, key, lengths, shape, s=MAX_LEN, kv=None,
                 **case) -> dict:
    """The decode kernel's record on one timed shape (``case``: heads,
    head_dim, softcap, window for ``_decode_case``; ``kv``: e4m3 K/V, the
    record then named ``<key>_e4m3``). A window and e4m3 K/V go to the
    helpers only when set, so that kernel_ab.py can run this in another
    tree's module, whose helpers may take neither."""
    dtype = torch.bfloat16
    if kv is not None:
        case = dict(case, kv=kv)
        key, shape = f"{key}_e4m3", f"{shape}, K/V e4m3"
    args, kw = _decode_case(gen, len(lengths), s, dtype,
                            lengths=list(lengths), **case)
    return _decode_record(key, shape, args, kw)


def _decode_record(name, shape, args, kw) -> dict:
    """The decode kernel's record on given inputs: checked against the
    plain version, then timed beside it, its bound and SDPA. The e4m3
    variant key is spelled out here (not ``_e4m3``), for kernel_ab.py as
    above."""
    q, kp, _, tables, _ = args
    dtype = q.dtype
    extra = {} if kw.get("window") is None else {"window": kw["window"]}
    byts, flops = _decode_work(args, **extra)
    kernel, plain = paged_attention.paged_attention, ref.paged_attention_ref
    e4m3 = kp.dtype != dtype
    return dict(
        name=name, route="cuda",
        variant=_attention_variant(dtype, q.shape[-1])
        + ("_e4m3" if e4m3 else ""),
        splits=paged_attention.splits(q.shape[0], q.shape[1], kp.shape[2],
                                      q.shape[2], tables.shape[1], dtype,
                                      kp.dtype),
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention.py:107", shape=shape,
        max_abs_err=_compare(f"decode/timed_{name}", kernel, plain, args, kw,
                             dtype),
        ms=time_ms(lambda: kernel(*args, **kw)),
        plain_ms=time_ms(lambda: plain(*args, **kw)),
        library_ms=time_ms(_sdpa_decode(args, **extra)),
        **(_widen_ms(args) if e4m3 else {}),
        **_sdpa_note(kw), **_bound(byts, flops, dtype))


def _say_timed(r: dict, card: str) -> None:
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
    extra = {"widen_ms": f"{r['widen_ms']:.4f}"} if "widen_ms" in r else {}
    if "splits" in r:
        extra["splits"] = r["splits"]
    say("kernels", timed=r["name"], shape=repr(r["shape"]),
        ms=f"{r['ms']:.4f}", plain_ms=f"{r['plain_ms']:.4f}",
        bound_ms=f"{r['bound_ms']:.5f}", bound_by=r["bound_by"],
        library_ms=lib, **extra, card=repr(card))


def _bound(byts: int, flops: int, dtype) -> dict:
    t_bytes = byts / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


class _PlainKernels:
    """Inside this block the model's attention and WKV run the plain
    versions on the card, and so does the pointwise work between the
    dense block's GEMMs (``layers.fuses`` says no to every tensor, so the
    residual adds, norms, rope, cache writes and gated activations are
    the plain ops at the model's own shapes), and the MoE layers' experts
    (``ref.moe_experts_ref``, the dense dispatch). A comparison only; the
    port's ops never do this. ``wkv`` is the plain WKV: by default the
    form the JAX model picks; ``scale`` multiplies every attention output
    (a nudge the size of a kernel's rounding)."""

    def __init__(self, wkv=ref.wkv6_ref, scale=1.0):
        self.wkv, self.scale = wkv, scale

    def __enter__(self):
        self.saved = (ops.paged_attention_op, ops.chunked_prefill_op,
                      ops.wkv6_op, layers.fuses, ops.moe_experts_op)
        layers.fuses = lambda *tensors: False
        ops.moe_experts_op = lambda *a: ref.moe_experts_ref(*a[:8], *a[9:])
        x = self.scale
        ops.paged_attention_op = lambda *a, softcap=None, window=None: \
            ref.paged_attention_ref(*a, softcap=softcap, window=window) * x
        ops.chunked_prefill_op = lambda *a, softcap=None, window=None: \
            ref.chunked_prefill_attention_ref(*a, softcap=softcap,
                                              window=window) * x
        ops.wkv6_op = self.wkv

    def __exit__(self, *exc):
        (ops.paged_attention_op, ops.chunked_prefill_op,
         ops.wkv6_op, layers.fuses, ops.moe_experts_op) = self.saved


# the dense model phases: (arch, rows, prompt tokens, chunk, cache length,
# tokens the last chunk takes per row, or None for all of it, config
# changes: model_fp8 stores the cache as e4m3)
MODELS = {
    "model": (ARCH, 2, 200, 200, MAX_LEN, [200, 150], {}),
    "model_gemma2": (GEMMA2, 1, 4200, 1024, GEMMA2_LEN, None, {}),
    "model_fp8": (ARCH, 2, 200, 200, MAX_LEN, [200, 150],
                  {"kv_cache_quant": True}),
}


def phase_model(phase: str = "model") -> None:
    """Full-width ``MODELS[phase]`` (random weights from a seed): its rows'
    prompts prefilled in chunks, then 4 decode steps, through the kernels
    (the variant the library picks for the dtype and head_dim, and no
    other) and, teacher-forced, through the plain attention; the logits
    of every chunk and step compared. gemma2's 4200-token prompt puts the
    decode positions (4200-4203) past its 4096-token window, so each of
    the 13 local layers leaves out the first 105-108 keys.

    model_fp8 is qwen2 with its cache stored as e4m3. There a difference
    in the last bits of an attention output moves some later K/V values
    across an e4m3 rounding boundary, a step of 6-12% of the value, so
    the logits part by more than the kernels' error: every attention call
    of the kernel run is also held to the kernel tolerances against the
    plain version on the same live inputs (``_ShadowAttention``), and the
    logits to the larger of ``MODEL_TOL`` and twice the floor measured in
    the same run, between the plain run and one whose attention outputs
    are scaled by 1 + 2^-20 (about the f32 kernels' error)."""
    arch, rows, n_prompt, chunk, max_len, take, changes = MODELS[phase]
    base = dataclasses.replace(get_config(arch), **changes)
    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(base, dtype=dtype)
        api = model_api.build(cfg)
        params = api.init(torch.Generator(device=DEV).manual_seed(0))
        rng = np.random.default_rng(0)
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              (rows, n_prompt)),
                                 dtype=torch.int32, device=DEV)
        takes = None if take is None else torch.tensor(
            take, dtype=torch.int32, device=DEV)

        def run(tokens_in=None):
            cache = api.init_cache(rows, max_len, DEV)
            outs, toks = [], []
            for start in range(0, n_prompt, chunk):
                piece = prompt[:, start:start + chunk]
                final = start + chunk >= n_prompt
                starts = torch.full((rows,), start, dtype=torch.int32,
                                    device=DEV)
                logits, cache = api.prefill_chunk(
                    params, cache, piece, starts,
                    take=takes if final else None)
                outs.append(logits)
            lengths = starts + (piece.shape[1] if takes is None else takes)
            for step in range(4):
                tok = logits.argmax(-1).to(torch.int32) if tokens_in is None \
                    else tokens_in[step]
                toks.append(tok)
                logits, cache = api.decode(params, cache, tok, lengths)
                outs.append(logits)
                lengths = lengths + 1
            return outs, toks

        result = []
        with _ShadowAttention(dtype, cfg.kv_cache_quant) as shadow:
            _expect_variant(_e4m3(_attention_variant(dtype, cfg.head_dim),
                                  E4M3 if cfg.kv_cache_quant else None),
                            lambda: result.extend(run()), chunked_prefill,
                            paged_attention)
        got, toks = result
        with _PlainKernels():
            want, _ = run(toks)                  # teacher-forced
        rel, agree = _logit_errors(got, want)
        tol, fp8 = MODEL_TOL[dtype], {}
        if cfg.kv_cache_quant:
            with _PlainKernels(scale=1 + 2 ** -20):
                nudged, _ = run(toks)
            floor = _logit_errors(nudged, want)[0]
            tol = max(tol, FLOOR_FACTOR * floor)
            fp8 = dict(plain_floor=f"{floor:.3e}",
                       attention_calls=shadow.calls,
                       worst_call_share_of_kernel_tol=f"{shadow.worst:.3f}")
        finite = all(torch.isfinite(g).all().item() for g in got)
        say(phase, arch=arch, dtype=str(dtype).split(".")[-1],
            params_b=f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f}",
            prompt=n_prompt, window=cfg.sliding_window,
            kv_cache="e4m3" if cfg.kv_cache_quant else "as the weights",
            logits_rel_l2=f"{rel:.3e}", tol=f"{tol:.3e}",
            argmax_agreement=f"{agree:.3f}", **fp8)
        check(finite, f"{phase}: non-finite logits")
        check(shadow.worst <= 1.0, f"{phase}: an attention call is "
              f"{shadow.worst:.2f}x the kernel tolerance from the plain "
              "version on its inputs")
        check(rel <= tol,
              f"{phase}: logits differ by {rel:.3e} (relative L2)")
        del params
        torch.cuda.empty_cache()


class _ShadowAttention:
    """Inside this block (when ``on``) every attention call of the model
    runs the kernel and, on the same live inputs, its plain version; the
    kernel's result goes on. ``worst`` keeps the largest error as a share
    of the kernel tolerance (``TOL`` elementwise; 1.0 = at the
    tolerance)."""

    def __init__(self, dtype, on: bool = True):
        self.tol, self.on = TOL[dtype], on

    def __enter__(self):
        self.saved = (ops.paged_attention_op, ops.chunked_prefill_op)
        self.calls, self.worst = 0, 0.0
        if not self.on:
            return self

        def shadow(kernel, plain):
            def op(*args, softcap=None, window=None):
                got = kernel(*args, softcap=softcap, window=window)
                want = plain(*args, softcap=softcap, window=window).float()
                share = ((got.float() - want).abs()
                         / (self.tol + self.tol * want.abs())).max().item()
                self.worst = max(self.worst, share)
                self.calls += 1
                return got
            return op

        ops.paged_attention_op = shadow(self.saved[0],
                                        ref.paged_attention_ref)
        ops.chunked_prefill_op = shadow(self.saved[1],
                                        ref.chunked_prefill_attention_ref)
        return self

    def __exit__(self, *exc):
        ops.paged_attention_op, ops.chunked_prefill_op = self.saved


def _logit_errors(got, want):
    """Largest relative L2 error over the steps, and the mean share of rows
    whose argmax agrees."""
    rel = max(((g - w).norm() / w.norm()).item() for g, w in zip(got, want))
    agree = float(np.mean([(g.argmax(-1) == w.argmax(-1)).float().mean()
                           .item() for g, w in zip(got, want)]))
    return rel, agree


def _tol_share(got, want) -> float:
    """The largest error of (out, sT) against (out, sT) as a share of the
    kernel tolerances (1.0 = at the tolerance)."""
    return max(((g - w).abs() / (atol + rtol * w.abs())).max().item()
               for g, w, (rtol, atol) in zip(got, want, (WKV_OUT_TOL,
                                                         WKV_STATE_TOL)))


class _ShadowWKV:
    """Inside this block every wkv6 call of the model runs the kernel and,
    on the same live inputs, the plain sequential scan and the plain form
    the CPU route picks; the kernel's result goes on. ``worst`` and
    ``plain_worst`` keep the largest share of the kernel tolerances by
    which the kernel and the plain form part from the scan."""

    def __enter__(self):
        self.saved, self.calls = ops.wkv6_op, 0
        self.worst = self.plain_worst = 0.0

        def shadow(r, k, v, w, u, s0, mode):
            got = self.saved(r, k, v, w, u, s0, mode)
            want = rwkv6.wkv_scan(r, k, v, w, u, s0)
            self.worst = max(self.worst, _tol_share(got, want))
            self.plain_worst = max(self.plain_worst, _tol_share(
                ref.wkv6_ref(r, k, v, w, u, s0, mode), want))
            self.calls += 1
            return got

        ops.wkv6_op = shadow
        return self

    def __exit__(self, *exc):
        ops.wkv6_op = self.saved


def phase_model_rwkv() -> None:
    """Full-width rwkv6-7b, 2 rows: prefill of 256 tokens then 4 decode
    steps through the wkv6 kernel (each call shadowed by the plain scan on
    the same inputs), then again through the plain WKV and through the
    plain sequential scan, teacher-forced with the kernel run's tokens. The
    two plain runs give the floor the kernel's logits are held to."""
    base = get_config(RWKV)
    for dtype in (torch.bfloat16, torch.float32):
        cfg = dataclasses.replace(base, dtype=dtype)
        api = model_api.build(cfg)
        params = api.init(torch.Generator(device=DEV).manual_seed(0))
        rng = np.random.default_rng(0)
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 256)),
                                 dtype=torch.int32, device=DEV)
        n = torch.full((2,), 256, dtype=torch.int32, device=DEV)

        def run(tokens_in=None):
            state = api.init_cache(2, MAX_LEN, DEV)
            logits, state = api.prefill(params, state, prompt, n)
            outs, toks = [logits], []
            for step in range(4):
                tok = logits.argmax(-1).to(torch.int32) if tokens_in is None \
                    else tokens_in[step]
                toks.append(tok)
                logits, state = api.decode(params, state, tok, n)
                outs.append(logits)
            return outs, toks, state

        k0 = wkv6.launches
        with _ShadowWKV() as shadow:
            got, toks, s_got = run()
        launched = wkv6.launches - k0
        check(launched == shadow.calls == 5 * cfg.num_layers,
              f"model_rwkv: {launched} wkv6 launches, want "
              f"{5 * cfg.num_layers}")
        with _PlainKernels():
            want, _, s_want = run(toks)
        with _PlainKernels(lambda r, k, v, w, u, s0, mode:
                           rwkv6.wkv_scan(r, k, v, w, u, s0)):
            scan, _, s_scan = run(toks)
        rel, agree = _logit_errors(got, want)
        floor, _ = _logit_errors(scan, want)

        def state_rel(a, b):
            return ((a["wkv"] - b["wkv"]).norm() / b["wkv"].norm()).item()

        s_rel, s_floor = state_rel(s_got, s_want), state_rel(s_scan, s_want)
        tol = max(MODEL_TOL[dtype], FLOOR_FACTOR * floor)
        s_tol = max(MODEL_TOL[dtype], FLOOR_FACTOR * s_floor)
        finite = all(torch.isfinite(g).all().item() for g in got)
        say("model_rwkv", arch=RWKV, dtype=str(dtype).split(".")[-1],
            params_b=f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f}",
            logits_rel_l2=f"{rel:.3e}", plain_floor=f"{floor:.3e}",
            tol=f"{tol:.3e}", wkv_state_rel_l2=f"{s_rel:.3e}",
            state_floor=f"{s_floor:.3e}", argmax_agreement=f"{agree:.3f}",
            wkv6_launches=launched,
            worst_call_share_of_kernel_tol=f"{shadow.worst:.3f}",
            plain_chunked_share=f"{shadow.plain_worst:.3f}")
        check(finite, "model_rwkv: non-finite logits")
        check(shadow.worst <= max(1.0, FLOOR_FACTOR * shadow.plain_worst),
              f"model_rwkv: a wkv6 call is {shadow.worst:.2f}x the kernel "
              f"tolerance from the plain scan (the plain chunked form "
              f"{shadow.plain_worst:.2f}x)")
        check(rel <= tol and s_rel <= s_tol,
              f"model_rwkv: logits / state differ by {rel:.3e} / "
              f"{s_rel:.3e} (relative L2; tolerances {tol:.3e} / "
              f"{s_tol:.3e})")
        del params, s_got, s_want, s_scan
        torch.cuda.empty_cache()


def _release() -> None:
    """Free what a phase left (its weights): a collection for reference
    cycles, then the allocator's cache, so the next model's weights do not
    meet this one's."""
    gc.collect()
    torch.cuda.empty_cache()


# The MoE models at full width, cut in depth to fit one card: arctic-480b
# keeps 2 of its 35 layers (13.61 B parameters a layer, 27.2 GB in bf16; two
# and the tied embedding 54.9 GB), kimi-k2-1t 1 of its 61 (36.5 GB with its
# 163840 x 7168 embedding; two layers would be 70.7 GB)
MOE_CUTS = {ARCTIC: {"num_layers": 2}, KIMI: {"num_layers": 1}}
MOE_ROWS, MOE_PROMPT, MOE_CHUNK, MOE_STEPS = 2, 256, 128, 4


class _Routes:
    """Inside this block every ``models.moe.route`` call keeps the expert
    ids it picked (on the card, read after the run)."""

    def __enter__(self):
        self.saved, self.ids = moe.route, []

        def recorded(*args):
            gates, ids = self.saved(*args)
            self.ids.append(ids)
            return gates, ids

        moe.route = recorded
        return self

    def __exit__(self, *exc):
        moe.route = self.saved


def _route_flips(got: list, want: list, rows: int, widths: list,
                 layers: int):
    """Two runs' routes, one (rows * width, k) id tensor per (forward,
    layer): the (token, layer) routes whose expert sets differ, and for
    each forward a (rows,) mask of the rows whose read token (the last of
    the forward) kept its route in every layer."""
    check(len(got) == len(want) == len(widths) * layers,
          f"route calls {len(got)} / {len(want)}, want "
          f"{len(widths) * layers}")
    flips, keep = 0, []
    for f, width in enumerate(widths):
        ok = torch.ones(rows, dtype=torch.bool, device=DEV)
        for layer in range(layers):
            a, b = (r[f * layers + layer].view(rows, width, -1).sort(-1)[0]
                    for r in (got, want))
            differ = (a != b).any(-1)                   # (rows, width)
            flips += int(differ.sum())
            ok &= ~differ[:, -1]
        keep.append(ok)
    return flips, keep


def _held_logit_error(got, want, keep) -> tuple:
    """The largest relative L2 error of the logits over the rows ``keep``
    holds (forwards with none held are skipped), and the rows held."""
    rel, held = 0.0, 0
    for g, w, k in zip(got, want, keep):
        if k.any():
            rel = max(rel, ((g[k] - w[k]).norm() / w[k].norm()).item())
            held += int(k.sum())
    return rel, held


def _model_moe(arch: str) -> None:
    cfg = dataclasses.replace(get_config(arch), **MOE_CUTS[arch])  # bf16
    api = model_api.build(cfg)
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE_ROWS, MOE_PROMPT)), dtype=torch.int32,
        device=DEV)
    widths = [MOE_CHUNK] * (MOE_PROMPT // MOE_CHUNK) + [1] * MOE_STEPS

    def run(tokens_in=None):
        cache = api.init_cache(MOE_ROWS, MAX_LEN, DEV)
        outs, toks = [], []
        for start in range(0, MOE_PROMPT, MOE_CHUNK):
            starts = torch.full((MOE_ROWS,), start, dtype=torch.int32,
                                device=DEV)
            logits, cache = api.prefill_chunk(
                params, cache, prompt[:, start:start + MOE_CHUNK], starts)
            outs.append(logits)
        lengths = torch.full((MOE_ROWS,), MOE_PROMPT, dtype=torch.int32,
                             device=DEV)
        for step in range(MOE_STEPS):
            tok = logits.argmax(-1).to(torch.int32) if tokens_in is None \
                else tokens_in[step]
            toks.append(tok)
            logits, cache = api.decode(params, cache, tok, lengths)
            outs.append(logits)
            lengths = lengths + 1
        return outs, toks

    result = []
    t0 = time.perf_counter()
    with _Routes() as routes, _ShadowAttention(torch.bfloat16) as shadow:
        _expect_variant("tensor_core", lambda: result.extend(run()),
                        chunked_prefill, paged_attention)
    torch.cuda.synchronize()
    kernel_s = time.perf_counter() - t0
    got, toks = result
    with _Routes() as plain_routes, _PlainKernels():
        want, _ = run(toks)                      # teacher-forced
    flips, keep = _route_flips(routes.ids, plain_routes.ids, MOE_ROWS,
                               widths, cfg.num_layers)
    rel, held = _held_logit_error(got, want, keep)
    total = MOE_ROWS * sum(widths) * cfg.num_layers
    finite = all(torch.isfinite(g).all().item() for g in got)
    say("model_moe", arch=arch, layers=cfg.num_layers, dtype="bfloat16",
        params_b=f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f}",
        experts=f"{cfg.num_experts} top-{cfg.top_k}",
        routes=total, routes_differing=flips,
        outputs_held=f"{held}/{MOE_ROWS * len(widths)}",
        logits_rel_l2_held=f"{rel:.3e}", tol=MODEL_TOL[torch.bfloat16],
        attention_calls=shadow.calls,
        worst_call_share_of_kernel_tol=f"{shadow.worst:.3f}",
        kernel_run_s=f"{kernel_s:.2f}")
    check(finite, f"model_moe: {arch}: non-finite logits")
    check(shadow.worst <= 1.0, f"model_moe: {arch}: an attention call is "
          f"{shadow.worst:.2f}x the kernel tolerance from the plain version "
          "on its inputs")
    check(held > 0, f"model_moe: {arch}: every output's route flipped")
    check(rel <= MODEL_TOL[torch.bfloat16], f"model_moe: {arch}: logits of "
          f"rows whose routes agree differ by {rel:.3e} (relative L2)")


def phase_model_moe() -> None:
    """Full-width arctic-480b (2 layers) and kimi-k2-1t (1 layer), bf16
    only (f32 would take 110 / 73 GB; the CPU tests hold f32): 2 rows'
    256-token prompts prefilled in chunks of 128, then 4 decode steps,
    through the kernels (tensor-core variants only, every call shadowed by
    the plain version on its live inputs) and, teacher-forced, through the
    plain attention. A last-bit attention difference can flip a token's
    top-k where two router logits nearly tie, which moves that token far
    more than ``MODEL_TOL``: each layer's expert ids are kept in both runs,
    the (token, layer) routes that differ are reported, and the logits are
    held to ``MODEL_TOL`` on the outputs whose read token kept its route in
    every layer."""
    for arch in MOE_CUTS:
        _model_moe(arch)
        _release()


def phase_model_vlm() -> dict:
    """Full-width paligemma-3b (18 layers, bf16): two rows of 1024 random
    patch features (dim 1152, from a seed) and 64 text tokens prefilled in
    one call with lengths = 1088 (the prefix counts), then 8 decode steps,
    through the kernels (tensor-core variants only, every call shadowed)
    and, teacher-forced, through the plain attention; the logits compared.
    Returns the kernel run's launches per variant (counts zeroed just
    before it)."""
    cfg = get_config(PALIGEMMA)
    api = model_api.build(cfg)
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    gen = torch.Generator(device=DEV).manual_seed(1)
    inputs = {
        "prefix_embeds": torch.randn(
            (2, cfg.num_patches, cfg.vision_feature_dim), generator=gen,
            device=DEV).to(cfg.dtype),
        "tokens": torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, VLM_TEXT)), dtype=torch.int32,
            device=DEV)}
    n = torch.full((2,), cfg.num_patches + VLM_TEXT, dtype=torch.int32,
                   device=DEV)

    def run(tokens_in=None):
        cache = api.init_cache(2, VLM_LEN, DEV)
        logits, cache = api.prefill(params, cache, inputs, n)
        outs, toks, lengths = [logits], [], n
        for step in range(8):
            tok = logits.argmax(-1).to(torch.int32) if tokens_in is None \
                else tokens_in[step]
            toks.append(tok)
            logits, cache = api.decode(params, cache, tok, lengths)
            outs.append(logits)
            lengths = lengths + 1
        return outs, toks

    result = []
    _zero_counts()
    with _ShadowAttention(torch.bfloat16) as shadow:
        _expect_variant("tensor_core", lambda: result.extend(run()),
                        chunked_prefill, paged_attention)
    launches = _counts()
    got, toks = result
    with _PlainKernels():
        want, _ = run(toks)
    rel, agree = _logit_errors(got, want)
    finite = all(torch.isfinite(g).all().item()
                 and tuple(g.shape) == (2, cfg.vocab_size) for g in got)
    say("model_vlm", arch=PALIGEMMA, dtype="bfloat16",
        params_b=f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f}",
        prefix=f"{cfg.num_patches}x{cfg.vision_feature_dim}", text=VLM_TEXT,
        lengths=int(n[0]), logits_rel_l2=f"{rel:.3e}",
        tol=MODEL_TOL[torch.bfloat16], argmax_agreement=f"{agree:.3f}",
        attention_calls=shadow.calls,
        worst_call_share_of_kernel_tol=f"{shadow.worst:.3f}",
        launches=launches)
    check(finite, "model_vlm: non-finite logits or a wrong shape")
    check(shadow.worst <= 1.0, f"model_vlm: an attention call is "
          f"{shadow.worst:.2f}x the kernel tolerance from the plain version")
    check(rel <= MODEL_TOL[torch.bfloat16],
          f"model_vlm: logits differ by {rel:.3e} (relative L2)")
    return {f"{m}.{v}": c for m, by in launches.items() for v, c in by.items()}


# zamba2's prompts: 512 tokens (the SSD's chunked form) and 500 (the scan's
# function: its tail padded to a whole chunk); decode steps after each
ZAMBA2_PROMPTS = (512, 500)
ZAMBA2_STEPS = 16


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def _generate(api, params, cache, inputs, n, steps, tokens_in=None):
    """``api.prefill(inputs)`` at lengths ``n``, then ``steps`` decode
    steps (greedy, or teacher-forced with ``tokens_in``): (logits of each,
    the decoded tokens, the cache)."""
    logits, cache = api.prefill(params, cache, inputs, n)
    outs, toks = [logits], []
    for step in range(steps):
        tok = logits.argmax(-1).to(torch.int32) if tokens_in is None \
            else tokens_in[step]
        toks.append(tok)
        logits, cache = api.decode(params, cache, tok, n)
        outs.append(logits)
        n = n + 1
    return outs, toks, cache


def phase_model_zamba2() -> None:
    """Full-width zamba2-2.7b (54 mamba2 blocks and the shared attention
    block after every 6, bf16, weights from a seed): two rows' prompts of
    512 tokens (the SSD's chunked form) and of 500 (the scan's function)
    prefilled, then 16 decode steps each, through the kernels (the
    tensor-core variants only, D = 80; every attention call shadowed by the
    plain version on its live inputs) and, teacher-forced, through the plain
    attention;
    the logits of every step compared, the SSD states' difference printed,
    and the kernel runs' launches per variant (counts zeroed just before
    them)."""
    cfg = get_config(ZAMBA2)
    api = model_api.build(cfg)
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    rng = np.random.default_rng(0)
    _zero_counts()
    runs = []
    with _ShadowAttention(torch.bfloat16) as shadow:
        for t in ZAMBA2_PROMPTS:
            prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, t)),
                                     dtype=torch.int32, device=DEV)
            n = torch.full((2,), t, dtype=torch.int32, device=DEV)
            _expect_variant("tensor_core", lambda: runs.append(
                (prompt, n) + _generate(api, params, api.init_cache(
                    2, MAX_LEN, DEV), prompt, n, ZAMBA2_STEPS)),
                chunked_prefill, paged_attention)
    launches = _counts()
    for prompt, n, got, toks, s_got in runs:
        with _PlainKernels():
            want, _, s_want = _generate(api, params, api.init_cache(
                2, MAX_LEN, DEV), prompt, n, ZAMBA2_STEPS, toks)
        rel, agree = _logit_errors(got, want)
        ssd = [s["mamba"]["ssd"] for s in (s_got, s_want)]
        ssd_rel = ((ssd[0] - ssd[1]).norm() / ssd[1].norm()).item()
        finite = all(torch.isfinite(g).all().item()
                     and tuple(g.shape) == (2, cfg.vocab_size) for g in got)
        say("model_zamba2", arch=ZAMBA2, dtype="bfloat16",
            prompt=prompt.shape[1],
            ssd_form="chunked" if prompt.shape[1] % mamba2.CHUNK == 0
            else "scan (tail padded)", decode_steps=ZAMBA2_STEPS,
            logits_rel_l2=f"{rel:.3e}", tol=MODEL_TOL[torch.bfloat16],
            argmax_agreement=f"{agree:.3f}", ssd_state_rel_l2=f"{ssd_rel:.3e}")
        check(finite, "model_zamba2: non-finite logits or a wrong shape")
        check(rel <= MODEL_TOL[torch.bfloat16],
              f"model_zamba2: logits differ by {rel:.3e} (relative L2)")
    state = api.init_cache(1, MAX_LEN, DEV)
    say("model_zamba2",
        params_b=f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f}",
        weight_gb=f"{_bytes(params) / 1e9:.3f}",
        state_mb_per_slot=f"{_bytes(state) / 1e6:.1f}",
        kv_mb_per_slot=f"{_bytes({k: state[k] for k in 'kv'}) / 1e6:.1f}",
        attention_calls=shadow.calls,
        worst_call_share_of_kernel_tol=f"{shadow.worst:.3f}",
        launches=launches)
    check(shadow.worst <= 1.0, f"model_zamba2: an attention call is "
          f"{shadow.worst:.2f}x the kernel tolerance from the plain version")
    inv = (cfg.num_layers + cfg.attn_every - 1) // cfg.attn_every
    check(shadow.calls == 2 * inv * (1 + ZAMBA2_STEPS),
          f"model_zamba2: {shadow.calls} attention calls")


# whisper-medium's inputs: 1500 frame embeddings (its 30 s window after the
# conv frontend, a stub in JAX too) and a 64-token decoder prompt
WHISPER_FRAMES = 1500
WHISPER_PROMPT = 64
WHISPER_STEPS = 16


def phase_model_whisper() -> dict:
    """Full-width whisper-medium (24 encoder + 24 decoder layers, bf16,
    weights from a seed): two rows of 1500 seeded frame embeddings and a
    64-token decoder prompt prefilled (the encoder, the cross K/V, the
    decoder's causal prefill), then 16 decode steps, through the kernels
    (the decoder's self-attention: tensor-core variants only, every call
    shadowed) and, teacher-forced, through the plain attention; the logits
    compared. The encoder's and the cross-attention's bidirectional
    ("full") attention is plain torch ops in both runs, as JAX computes it
    through XLA. Returns the kernel run's launches per variant (counts
    zeroed just before it)."""
    cfg = get_config(WHISPER)
    api = model_api.build(cfg)
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    gen = torch.Generator(device=DEV).manual_seed(1)
    inputs = {
        "frames": torch.randn((2, WHISPER_FRAMES, cfg.d_model), generator=gen,
                              device=DEV).to(cfg.dtype),
        "tokens": torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (2, WHISPER_PROMPT)), dtype=torch.int32,
            device=DEV)}
    n = torch.full((2,), WHISPER_PROMPT, dtype=torch.int32, device=DEV)

    def run(tokens_in=None):
        cache = api.init_cache(2, MAX_LEN, DEV, enc_len=WHISPER_FRAMES)
        return _generate(api, params, cache, inputs, n, WHISPER_STEPS,
                         tokens_in)

    result = []
    _zero_counts()
    with _ShadowAttention(torch.bfloat16) as shadow:
        _expect_variant("tensor_core", lambda: result.extend(run()),
                        chunked_prefill, paged_attention)
    launches = _counts()
    got, toks, cache = result
    with _PlainKernels():
        want, _, _ = run(toks)
    rel, agree = _logit_errors(got, want)
    finite = all(torch.isfinite(g).all().item()
                 and tuple(g.shape) == (2, cfg.vocab_size) for g in got)
    say("model_whisper", arch=WHISPER, dtype="bfloat16",
        params_b=f"{sum(p.numel() for p in _leaves(params)) / 1e9:.3f}",
        frames=WHISPER_FRAMES, prompt=WHISPER_PROMPT,
        decode_steps=WHISPER_STEPS,
        cross_kv_shape=list(cache["cross_k"].shape),
        logits_rel_l2=f"{rel:.3e}", tol=MODEL_TOL[torch.bfloat16],
        argmax_agreement=f"{agree:.3f}", attention_calls=shadow.calls,
        worst_call_share_of_kernel_tol=f"{shadow.worst:.3f}",
        launches=launches)
    check(finite, "model_whisper: non-finite logits or a wrong shape")
    check(shadow.worst <= 1.0, f"model_whisper: an attention call is "
          f"{shadow.worst:.2f}x the kernel tolerance from the plain version")
    check(rel <= MODEL_TOL[torch.bfloat16],
          f"model_whisper: logits differ by {rel:.3e} (relative L2)")
    want_launches = {"chunked_prefill": cfg.num_layers,
                     "paged_attention": cfg.num_layers * WHISPER_STEPS}
    check(all(launches[m]["tensor_core"] == k
              for m, k in want_launches.items()),
          f"model_whisper: launches {launches}, want {want_launches} "
          "tensor-core ones")
    return {f"{m}.{v}": c for m, by in launches.items() for v, c in by.items()}


# gemma2's ring phase: decode steps past the 4200-token prompt, the local
# layers' 4096-slot rings long wrapped
RING_STEPS = 16
RING_PROMPT = 4200


class _NoPlain:
    """Inside this block a call of a plain attention version counts in
    ``calls``: the main path on the card must make none."""

    def __enter__(self):
        self.saved = (ref.paged_attention_ref,
                      ref.chunked_prefill_attention_ref)
        self.calls = 0

        def count(fn):
            def plain(*a, **kw):
                self.calls += 1
                return fn(*a, **kw)
            return plain

        ref.paged_attention_ref = count(self.saved[0])
        ref.chunked_prefill_attention_ref = count(self.saved[1])
        return self

    def __exit__(self, *exc):
        ref.paged_attention_ref, ref.chunked_prefill_attention_ref = \
            self.saved


def _ring_from(full, ring, n: int) -> None:
    """Scaffolding of the ring phase (not a port API): fill ``ring`` (the
    per-layer cache of ``window_sized_cache``) from the full-length cache
    ``full`` that holds positions [0, n): a ring layer's slot ``p mod
    size`` gets position ``p`` for ``p`` in [n - size, n), as decoding
    from an empty cache would have left it; a full-length layer a copy."""
    for name in ("k", "v"):
        for i, dst in enumerate(ring[name]):
            src = full[name][i].view(torch.uint8)
            dst = dst.view(torch.uint8)
            size = dst.shape[1]
            if size == src.shape[1]:
                dst.copy_(src)
            else:
                pos = torch.arange(n - size, n, device=DEV)
                dst[:, pos % size] = src[:, pos]


def _ring_record(ring, fp8: bool) -> dict:
    """The decode kernel's record on the ring phase's shape: one slot
    over layer 0's wrapped 4096-slot ring (64-token pages, an identity
    table, kernel length 4096, no window), q drawn from a seed."""
    dtype = torch.bfloat16
    k, v = ring["k"][0], ring["v"][0]
    s, hkv, d = k.shape[1:]
    ps = decode_page_size(s)
    hq, softcap = GEMMA2_HEADS["hq"], GEMMA2_HEADS["softcap"]
    gen = torch.Generator(device=DEV).manual_seed(3)
    args = (_rand(gen, (1, hq, d), dtype), k.view(s // ps, ps, hkv, d),
            v.view(s // ps, ps, hkv, d),
            torch.arange(s // ps, dtype=torch.int32, device=DEV)[None],
            torch.tensor([s], dtype=torch.int32, device=DEV))
    kw = dict(softcap=softcap, window=None)
    name = "paged_attention_ring" + ("_e4m3" if fp8 else "")
    shape = (f"slots=1 ring={s} (wrapped, positions {RING_PROMPT - s}.."
             f"{RING_PROMPT - 1}) page=64 length={s} Hq={hq} Hkv={hkv} "
             f"D={d} softcap={softcap} no window bf16"
             + (", K/V e4m3" if fp8 else ""))
    return _decode_record(name, shape, args, kw)


def phase_model_ring(card: str):
    """Full-width gemma2-2b with the window-sized ring cache
    (``window_sized_cache``, ``scan_layers`` off), bf16 weights with the
    cache in bf16 and in e4m3: one slot of a 4352-token full cache
    prefilled to 4200 tokens in chunks through the kernels, its K/V copied
    into the ring cache (``_ring_from``: the 13 local layers' rings of 4096
    slots hold positions 104-4199, long wrapped), then ``RING_STEPS``
    decode steps on the full cache (greedy) and on the ring through the
    kernels (teacher-forced), counts zeroed just before the ring's run and
    read just after: the paged kernel's ``tensor_core`` /
    ``tensor_core_e4m3`` instance only, no plain version, no prefill. The
    ring's logits are held to the full cache's and to the ring's through
    the plain attention at ``MODEL_TOL`` (the e4m3 cache: the larger of
    that and twice the floor between the plain run and one nudged by
    2^-20, as in ``model_fp8``). Returns the ring's kernel records and the
    launches of its runs."""
    records, launches = {}, {}
    for fp8 in (False, True):
        cfg = dataclasses.replace(get_config(GEMMA2), scan_layers=False,
                                  kv_cache_quant=fp8)
        rcfg = dataclasses.replace(cfg, window_sized_cache=True)
        api, rapi = model_api.build(cfg), model_api.build(rcfg)
        params = api.prepare(api.init(
            torch.Generator(device=DEV).manual_seed(0)))
        rng = np.random.default_rng(0)
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                              (1, RING_PROMPT)),
                                 dtype=torch.int32, device=DEV)
        full = api.init_cache(1, GEMMA2_LEN, DEV)
        for start in range(0, RING_PROMPT, 1024):
            logits, full = api.prefill_chunk(
                params, full, prompt[:, start:start + 1024],
                torch.full((1,), start, dtype=torch.int32, device=DEV))
        first = logits.argmax(-1).to(torch.int32)
        prefilled = {k: t.clone() for k, t in full.items()}

        def decode(m, cache, tokens_in=None):
            tok, outs, toks = first, [], []
            n = torch.full((1,), RING_PROMPT, dtype=torch.int32, device=DEV)
            for step in range(RING_STEPS):
                if tokens_in is not None:
                    tok = tokens_in[step]
                toks.append(tok)
                logits, cache = m.decode(params, cache, tok, n)
                outs.append(logits)
                tok = logits.argmax(-1).to(torch.int32)
                n = n + 1
            return outs, toks, cache

        def ring():
            r = rapi.init_cache(1, GEMMA2_LEN, DEV)
            _ring_from(prefilled, r, RING_PROMPT)
            return r

        want_full, toks, _ = decode(api, full)
        cache = ring()
        sizes = sorted({k.shape[1] for k in cache["k"]})
        check(sizes == [cfg.sliding_window, GEMMA2_LEN],
              f"model_ring: cache lengths {sizes}")
        _zero_counts()
        with _NoPlain() as plain_calls:
            got, _, cache = decode(rapi, cache, toks)
        counts = _counts()
        variant = _e4m3("tensor_core", E4M3 if fp8 else None)
        launches[f"paged_attention.{variant}"] = \
            counts["paged_attention"][variant]
        with _PlainKernels():
            want_plain, _, _ = decode(rapi, ring(), toks)
        rel_full, agree = _logit_errors(got, want_full)
        rel_plain, _ = _logit_errors(got, want_plain)
        tol, extra = MODEL_TOL[torch.bfloat16], {}
        if fp8:
            with _PlainKernels(scale=1 + 2 ** -20):
                nudged, _, _ = decode(rapi, ring(), toks)
            floor = _logit_errors(nudged, want_plain)[0]
            tol = max(tol, FLOOR_FACTOR * floor)
            extra = dict(plain_floor=f"{floor:.3e}")
        say("model_ring", arch=GEMMA2, kv_cache="e4m3" if fp8 else "bf16",
            ring=cfg.sliding_window, full=GEMMA2_LEN,
            positions=f"{RING_PROMPT}..{RING_PROMPT + RING_STEPS - 1}",
            logits_rel_l2_vs_full=f"{rel_full:.3e}",
            logits_rel_l2_vs_plain=f"{rel_plain:.3e}", tol=f"{tol:.3e}",
            argmax_agreement_vs_full=f"{agree:.3f}", **extra,
            launches=counts, plain_calls=plain_calls.calls)
        check(all(torch.isfinite(g).all().item() for g in got),
              "model_ring: non-finite logits")
        check(plain_calls.calls == 0, "model_ring: the ring decode called a "
              "plain attention version on the card")
        want_n = RING_STEPS * cfg.num_layers
        check(counts["paged_attention"][variant] == want_n and
              sum(counts["paged_attention"].values()) == want_n and
              sum(counts["chunked_prefill"].values()) == 0,
              f"model_ring: want {want_n} {variant} decode launches and "
              f"nothing else, got {counts}")
        check(rel_full <= tol and rel_plain <= tol,
              f"model_ring: logits differ by {rel_full:.3e} from the full "
              f"cache's, {rel_plain:.3e} from the plain attention's "
              f"(relative L2, tolerance {tol:.3e})")
        r = _ring_record(cache, fp8)
        records[r["name"]] = r
        del params, full, prefilled, cache
        torch.cuda.empty_cache()
    return records, launches


# the paged store phase: qwen2-1.5b's decode shape over a page pool
STORE_LENGTHS = (300, 420, 96, 512, 280, 333, 64, 450)
STORE_PAGE = 16


def phase_paged_store(card: str):
    """A ``PagedKVStore`` on the card at qwen2-1.5b's decode shape (28
    layers, 12 / 2 heads of 128, 16-token pages), in bf16 and e4m3: 8
    requests of 64-512 tokens written in ragged pieces of 1-96 tokens,
    round robin, beside a request that leaves half way, so the
    allocator's free list scatters their pages. The decode op over the
    allocator's stacked tables (-1 past each request's pages), every
    layer, counts zeroed just before and read just after: the paged
    kernel's ``tensor_core`` / ``tensor_core_e4m3`` instance only, no
    plain version. Each layer's output is held to the plain version on the
    same pages and to the plain attention over ``gather_dense`` (``TOL``),
    and ``gather_dense`` to the bytes written. Returns the store's kernel
    records and the launches of its runs."""
    cfg = get_config(ARCH)
    layers, hkv, hq, d = (cfg.num_layers, cfg.num_kv_heads, cfg.num_heads,
                          cfg.head_dim)
    dtype = torch.bfloat16
    records, launches = {}, {}
    for fp8 in (False, True):
        store = PagedKVStore.create(layers, 256, STORE_PAGE, hkv, d,
                                    dtype=E4M3 if fp8 else dtype, device=DEV)
        gen = torch.Generator(device=DEV).manual_seed(0)
        rng = np.random.default_rng(0)
        rids = list(range(len(STORE_LENGTHS)))
        total = dict(zip(rids, STORE_LENGTHS)) | {99: 200}
        done, written = dict.fromkeys(total, 0), {r: [] for r in rids}
        step = 0
        while any(done[r] < total[r] for r in done):
            for rid in list(done):
                if rid == 99 and step == 3:      # it leaves; pages return
                    store.allocator.release(99)
                    del done[99]
                    continue
                t = min(int(rng.integers(1, 97)), total[rid] - done[rid])
                if t == 0:
                    continue
                k = _rand(gen, (layers, t, hkv, d), dtype)
                v = _rand(gen, (layers, t, hkv, d), dtype)
                store.write_tokens(rid, done[rid], k, v)
                if rid in written:
                    written[rid].append((k, v))
                done[rid] += t
            step += 1
        pages = [p for r in rids for p in store.allocator.allocated[r]]
        max_pages = max(STORE_LENGTHS) // STORE_PAGE
        tables = torch.as_tensor(np.stack([
            store.allocator.table(r, max_pages) for r in rids]), device=DEV)
        lengths = torch.tensor(STORE_LENGTHS, dtype=torch.int32, device=DEV)
        q = _rand(gen, (layers, len(rids), hq, d), dtype)
        _zero_counts()
        with _NoPlain() as plain_calls:
            outs = [ops.paged_attention_op(q[i], store.k_pages[i],
                                           store.v_pages[i], tables, lengths)
                    for i in range(layers)]
        counts = _counts()
        variant = _e4m3("tensor_core", E4M3 if fp8 else None)
        launches[f"paged_attention.{variant}"] = \
            counts["paged_attention"][variant]
        worst_plain = worst_dense = 0.0
        tol = TOL[dtype]
        for i, out in enumerate(outs):
            want = ref.paged_attention_ref(q[i], store.k_pages[i],
                                           store.v_pages[i], tables, lengths)
            worst_plain = max(worst_plain, ((out.float() - want.float()).abs()
                                            / (tol + tol * want.float().abs())
                                            ).max().item())
        for b, rid in enumerate(rids):
            n = STORE_LENGTHS[b]
            gk, gv = store.gather_dense(rid, n)
            wk = torch.cat([k for k, _ in written[rid]], dim=1)
            wv = torch.cat([v for _, v in written[rid]], dim=1)
            if fp8:
                wk, wv = to_e4m3(wk), to_e4m3(wv)
            check(torch.equal(gk.view(torch.uint8), wk.view(torch.uint8))
                  and torch.equal(gv.view(torch.uint8), wv.view(torch.uint8)),
                  f"paged_store: gather_dense of request {rid} differs from "
                  "what was written")
            # plain attention over the dense gather, every layer at once:
            # one query at position n - 1 attends [0, n)
            starts = torch.full((layers,), n - 1, dtype=torch.int32,
                                device=DEV)
            want = ref.chunked_prefill_attention_ref(
                q[:, b][:, None], gk, gv, starts)[:, 0]
            got = torch.stack([o[b] for o in outs])
            worst_dense = max(worst_dense, ((got.float() - want.float()).abs()
                                            / (tol + tol * want.float().abs())
                                            ).max().item())
        say("paged_store", arch=ARCH, kv="e4m3" if fp8 else "bf16",
            layers=layers, pages_used=store.allocator.used_blocks,
            pages_in_order=pages == sorted(pages),
            tables=tuple(tables.shape), holes=int((tables < 0).sum()),
            worst_share_of_tol_vs_plain=f"{worst_plain:.3f}",
            worst_share_of_tol_vs_gather_dense=f"{worst_dense:.3f}",
            launches=counts, plain_calls=plain_calls.calls, card=repr(card))
        check(pages != sorted(pages), "paged_store: the pages lie in order")
        check(plain_calls.calls == 0, "paged_store: the decode called a plain "
              "attention version on the card")
        check(counts["paged_attention"][variant] == layers and
              sum(counts["paged_attention"].values()) == layers,
              f"paged_store: want {layers} {variant} launches, got {counts}")
        check(worst_plain <= 1.0 and worst_dense <= 1.0,
              f"paged_store: the kernel is {worst_plain:.2f}x / "
              f"{worst_dense:.2f}x the tolerance from the plain version / "
              "the plain attention over gather_dense")
        name = "paged_attention_store" + ("_e4m3" if fp8 else "")
        shape = (f"slots=8 PagedKVStore page=16 scattered pages, tables "
                 f"(8, {max_pages}) with -1 holes, lengths~300 Hq={hq} "
                 f"Hkv={hkv} D={d} bf16" + (", K/V e4m3" if fp8 else ""))
        r = _decode_record(name, shape, (
            q[0], store.k_pages[0], store.v_pages[0], tables, lengths),
            dict(softcap=None, window=None))
        records[name] = r
        del store, outs, written
        torch.cuda.empty_cache()
    return records, launches


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


def _leaf_items(tree, path=()):
    """(path, leaf) of every leaf of a nested dict of tensors."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, path + (k,))
        else:
            yield path + (k,), v


def phase_executor_stateful(card: str, arch: str, phase: str,
                            modules: tuple) -> None:
    """Two workers of a stateful family (rwkv6-7b, zamba2-2.7b) sharing
    weights: prefill chunks replay the prompt so far, b's final chunk rides
    on a's decode, a migration replays b on worker 1, decode runs on both.
    b's state after the mixed iteration must equal a fresh prefill of its
    prompt, and a decode of a alone must leave every leaf of b's slot
    (zamba2's nested mamba leaves and its K/V included) bit for bit as it
    was. The mixed iteration and a decode of two slots run under
    torch.profiler; ``modules``' kernels must show device time there and
    launch on the run."""
    cfg = get_config(arch)
    execs = ClusterRealExecutors(cfg, 2, max_slots=4, max_len=MAX_LEN,
                                 seed=0)
    e0, e1 = execs.execs[0], execs.execs[1]
    a, b, c = _req(0, 300), _req(1, 200), _req(2, 128)
    mixed, outside = "b final 80 rides on decode a (mixed)", \
        "decode a (b's slot outside the batch)"
    steps = [
        ("prefill a 256 (chunk 1 of 2)", e0, _plan(prefill=[(a, 256)])),
        ("replay a 300 (final) + b 120", e0,
         _plan(prefill=[(a, 44), (b, 120)])),
        (mixed, e0, _plan(prefill=[(b, 80)], decode=[a])),
        ("prefill c 128", e1, _plan(prefill=[(c, 128)])),
        (outside, e0, _plan(decode=[a])),
        ("decode a b", e0, _plan(decode=[a, b])),
        ("migrate b 0->1", None, None),
        ("decode b c", e1, _plan(decode=[b, c])),
        ("decode a", e0, _plan(decode=[a])),
        ("decode c b", e1, _plan(decode=[c, b])),
    ]

    def slot_state(ex, rid):
        slot = ex.slot_of[rid]
        return {p: v[:, slot].clone() for p, v in _leaf_items(ex.cache)}

    k0 = [m.launches for m in modules]
    for label, ex, plan in steps:
        before = slot_state(e0, b.rid) if label == outside else None
        t0 = time.perf_counter()
        if ex is None:
            execs.migrate(b, 0, 1)
        elif label in (mixed, "decode a b"):
            wall, kernels, _ = _profiled(lambda: ex.run_plan(plan))
            dev = _device_ms(kernels)
            kernel_ms = _device_ms(kernels, _named(*modules))
            gemm = _device_ms(kernels, _is_gemm)
            check(kernel_ms > 0, f"{phase}: no device time under the names "
                  f"{sorted(n for m in modules for n in m.KERNELS.values())} "
                  f"in {label!r}")
            say(phase, profiled=repr(label), wall_ms=f"{wall:.3f}",
                device_ms=f"{dev:.3f}" if dev else "not-measured",
                idle_share=f"{1 - dev / wall:.3f}" if dev else "not-measured",
                kernel_ms=f"{kernel_ms:.3f}",
                kernels=",".join(_short(m) for m in modules),
                gemm_ms=f"{gemm:.3f}",
                other_ms=f"{dev - kernel_ms - gemm:.3f}",
                device_kernels=sum(e.count for e in kernels), card=repr(card))
        else:
            ex.run_plan(plan)
        if plan is not None:
            for r, t in plan.prefill_parts:      # the engine's bookkeeping
                r.prefilled_tokens += t
        torch.cuda.synchronize()
        say(phase, step=repr(label),
            ms=f"{(time.perf_counter() - t0) * 1e3:.3f}", card=repr(card))
        if label == mixed:
            fresh = e0.api.init_cache(1, MAX_LEN, DEV)
            e0.api.prefill(e0.params, fresh, e0._tensor(e0.prompts[b.rid][None]),
                           e0._tensor(np.asarray([b.prompt_len])))
            got = slot_state(e0, b.rid)
            ref_leaves = dict(_leaf_items(fresh))
            rel = max(((got[p].float() - ref_leaves[p][:, 0].float()).norm()
                       / ref_leaves[p].float().norm().clamp_min(1e-30)).item()
                      for p in got)
            say(phase, b_state_vs_fresh_prefill_rel_l2=f"{rel:.3e}",
                leaves=len(got))
            check(rel <= 1e-3, f"{phase}: b's state after the mixed "
                  f"iteration differs from a fresh prefill by {rel:.3e}")
        if before is not None:
            after = slot_state(e0, b.rid)
            check(all(torch.equal(before[p], after[p]) for p in before),
                  f"{phase}: decoding a changed b's slot")
    streams = {0: e0.generated[0], 1: e1.generated[1], 2: e1.generated[2]}
    want = {0: 5, 1: 4, 2: 3}             # 1 from the prefill + decodes
    for rid, toks in streams.items():
        check(len(toks) == want[rid] and all(0 <= t < cfg.vocab_size
                                             for t in toks),
              f"{phase}: rid {rid} stream {toks}")
    launched = {_short(m): m.launches - n for m, n in zip(modules, k0)}
    check(all(n > 0 for n in launched.values()),
          f"{phase}: a kernel did not launch {launched}")
    say(phase, streams={k: len(v) for k, v in streams.items()},
        launches=launched, slot_outside_batch="unchanged")
    del execs
    torch.cuda.empty_cache()


def _profiled(fn, shapes: bool = False):
    """Run ``fn`` under torch.profiler: (wall ms, the device kernels'
    averaged events, largest device time first, and every event averaged:
    with ``shapes`` by input shape as well)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if _device_us(e) > 0
               and e.device_type == torch.autograd.DeviceType.CUDA]
    ops = prof.key_averages(group_by_input_shape=True) if shapes else events
    return wall, sorted(kernels, key=_device_us, reverse=True), ops


def _short(module) -> str:
    return module.__name__.rsplit(".", 1)[-1]


def _device_ms(kernels, match=lambda key: True) -> float:
    return sum(_device_us(e) for e in kernels if match(e.key)) / 1e3


def _named(*modules):
    """A match on the profiler keys of ``modules``' device kernels, by the
    names each wrapper module exports in ``KERNELS``."""
    pat = re.compile(r"(?<!\w)(?:" + "|".join(
        sorted(n for m in modules for n in m.KERNELS.values())) + r")(?!\w)")
    return lambda key: pat.search(key) is not None


def _is_gemm(key: str) -> bool:
    return any(s in key.lower() for s in ("gemm", "nvjet", "xmma", "cutlass"))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _routed_bound(ids: list, cfg) -> dict:
    """The least time of the expert work the routes need, as if only the
    routed tokens went through their experts: each MoE call (one per layer
    of each step; ``ids`` (T, k) on the card) reads its distinct experts'
    three matrices once and does 2 * 3 * d * f operations per (token,
    expert) pair; against the dense dispatch's bound, which reads every
    expert and multiplies every token by each."""
    mat = 3 * cfg.d_model * cfg.d_ff
    es = torch.empty((), dtype=cfg.dtype).element_size()
    routed = [(int(torch.unique(i).numel()), i.numel()) for i in ids]
    out = _bound(sum(e for e, _ in routed) * mat * es,
                 sum(2 * mat * pairs for _, pairs in routed), cfg.dtype)
    dense = _bound(len(ids) * cfg.num_experts * mat * es,
                   sum(2 * mat * i.shape[0] * cfg.num_experts for i in ids),
                   cfg.dtype)
    return dict(routed_experts=[e for e, _ in routed],
                routed_bound_ms=f"{out['bound_ms']:.4f}",
                routed_bound_by=out["bound_by"],
                dense_bound_ms=f"{dense['bound_ms']:.4f}",
                dense_bound_by=dense["bound_by"])


class _Eager:
    """Inside this block (when ``on``) the cluster's steps run eagerly on
    the card, the graphs' yardstick (a comparison only: on a CUDA device
    the executor itself always replays its graphs)."""

    def __init__(self, kernels, on: bool = True):
        self.kernels, self.on = kernels, on

    def __enter__(self):
        self.saved = self.kernels.graphed
        self.kernels.graphed = self.saved and not self.on

    def __exit__(self, *exc):
        self.kernels.graphed = self.saved


def _profile_plans(reqs):
    """The profile's iterations over 9 requests of about 256 tokens, as
    (label, plan): a prefill of 8 rows x 256, then (label None: not
    profiled) the rest of their prompts, a decode of the 8, and a mixed
    iteration (the ninth's 256-token chunk on their decode batch). Each
    plan is made when the caller has run the one before."""
    yield "prefill 8x256", _plan(prefill=[(r, 256) for r in reqs[:8]])
    for label in ("decode 8", "mixed 256 + decode 8"):
        tails = [(r, r.prompt_len - r.prefilled_tokens) for r in reqs[:8]
                 if r.prompt_len > r.prefilled_tokens]
        if tails:
            yield None, _plan(prefill=tails)
        yield label, (_plan(decode=reqs[:8]) if label == "decode 8" else
                      _plan(prefill=[(reqs[8], 256)], decode=reqs[:8]))


def _run(execs, wid, plan, eager=False) -> None:
    """One plan on worker ``wid`` (eagerly if asked), then the engine's
    bookkeeping."""
    with _Eager(execs.kernels, eager):
        execs.execs[wid].run_plan(plan)
    for r, t in plan.prefill_parts:
        r.prefilled_tokens += t


def phase_profile(card: str, arch: str = ARCH, phase: str = "profile",
                  changes: Optional[dict] = None) -> list:
    """Where an iteration's time goes: torch.profiler over one prefill
    iteration (8 rows x 256 tokens), one decode iteration (8 slots at
    ~260 tokens) and one mixed iteration (a 256-token chunk + 8 decodes),
    full width, each run through the CUDA graphs on worker 0 and eagerly on
    worker 1 (the same weights and requests). Both first run the same plans
    twice on other requests: the first pass captures every graph, the
    second gives each iteration's wall time without the profiler (which
    slows a graph replay severalfold: it traces each of its kernels). The
    two must sample the same tokens. Device time is the sum of kernel
    times under the profiler (one stream, so kernels do not overlap);
    where the profiler reports no kernels of a graph replay, it is the
    CUDA-event span of the iteration, and the by-name breakdown is the
    eager run's. idle share = 1 - device / wall; host ms = wall - device,
    the iteration's host term (the cost model's ``t_fixed``). ``changes``
    vary the config (profile_fp8: the e4m3 cache; profile_moe: arctic's
    two layers). For an MoE model each eager iteration also reports the
    device ms of its routed expert kernels (``moe_experts``) and their
    share of the device time, beside the bound of the experts its routes
    need alone and of the dense dispatch over every held table.
    Returns (label, plan, wall ms, device ms) per graphed iteration."""
    rows = []
    cfg = dataclasses.replace(get_config(arch), **(changes or {}))
    execs = ClusterRealExecutors(cfg, 2, max_slots=16, max_len=MAX_LEN,
                                 seed=0)
    modes = {"graphs": 0, "eager": 1}
    walls = {}                                  # (mode, label): ms
    for mode, wid in modes.items():             # warm, then timed
        for base in (100, 200):
            warm = [_req(base + i, 256 + i) for i in range(9)]
            for label, plan in _profile_plans(warm):
                t0 = time.perf_counter()
                _run(execs, wid, plan, eager=mode == "eager")
                walls[mode, label] = (time.perf_counter() - t0) * 1e3
            for r in warm:
                execs.on_finish(r)
    reqs = {mode: [_req(i, 256 + i) for i in range(9)] for mode in modes}
    for steps in zip(*(_profile_plans(reqs[m]) for m in modes)):
        label = steps[0][0]
        eager_kernels = None
        for (mode, wid), (_, plan) in zip(modes.items(), steps):
            if label is None:
                _run(execs, wid, plan, eager=mode == "eager")
                continue
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

            def once():
                ev[0].record()
                _run(execs, wid, plan, eager=mode == "eager")
                ev[1].record()

            moe_eager = cfg.is_moe and mode == "eager"
            with _Routes() as routes:
                profiled_wall, kernels, _ = _profiled(once)
            wall = walls[mode, label]
            span = ev[0].elapsed_time(ev[1])
            dev = _device_ms(kernels)
            source = "profiler"
            if mode == "eager":
                eager_kernels = kernels
            elif dev == 0:
                source, dev = "cuda-events", span
            by_name = kernels if source == "profiler" else eager_kernels
            attn = _device_ms(by_name, _named(chunked_prefill,
                                              paged_attention))
            gemm = _device_ms(by_name, _is_gemm)
            check(attn > 0, f"{phase}: no attention kernel time in "
                  f"{label!r} ({mode})")
            say(phase, arch=arch, iteration=repr(label), steps=mode,
                wall_ms=f"{wall:.3f}", device_ms=f"{dev:.3f}",
                device_source=source, profiled_wall_ms=f"{profiled_wall:.3f}",
                profiled_event_span_ms=f"{span:.3f}",
                idle_share=f"{1 - dev / wall:.3f}",
                host_ms=f"{wall - dev:.3f}",
                attention_kernels_ms=f"{attn:.3f}", gemm_ms=f"{gemm:.3f}",
                other_ms=f"{_device_ms(by_name) - attn - gemm:.3f}",
                device_kernels=sum(e.count for e in by_name),
                card=repr(card))
            if moe_eager:
                experts = _device_ms(by_name, _named(moe_experts))
                say(phase, iteration=repr(label), steps=mode,
                    expert_kernels_ms=f"{experts:.3f}",
                    expert_share=f"{experts / dev:.3f}",
                    **_routed_bound(routes.ids, cfg), card=repr(card))
                check(0 < experts <= dev, f"{phase}: routed expert kernels' "
                      f"time {experts:.3f} ms outside (0, device "
                      f"{dev:.3f} ms] in {label!r}")
            if mode == "eager":
                for e in kernels[:4]:
                    say(phase, kernel=repr(e.key[:70]), count=e.count,
                        device_ms=f"{_device_us(e) / 1e3:.3f}")
            else:
                rows.append((label, plan, wall, dev))
    streams = {m: [execs.execs[wid].generated[r.rid] for r in reqs[m]]
               for m, wid in modes.items()}
    check(streams["graphs"] == streams["eager"],
          f"{phase}: graphs and eager sampled different tokens {streams}")
    del execs
    torch.cuda.empty_cache()
    return rows


class _SSDRegions:
    """Inside this block every SSD call of the mamba2 blocks runs inside a
    ``torch.profiler.record_function`` region named ``NAME`` (a call inside
    another one, the scan's chunked form, in its caller's only), so that a
    profile gives the device time of the kernels the SSD launched. The
    profiler also lists each region on the device as an event of its own
    whose time is the region's span there, idle gaps included: not a
    kernel."""

    NAME = "ssd"
    NAMES = ("ssd_chunked", "ssd_scan", "ssd_decode")

    def __enter__(self):
        self.saved = {n: getattr(mamba2, n) for n in self.NAMES}
        depth = [0]

        def region(fn):
            def run(*args):
                if depth[0]:
                    return fn(*args)
                depth[0] += 1
                try:
                    with torch.profiler.record_function(self.NAME):
                        return fn(*args)
                finally:
                    depth[0] -= 1
            return run

        for n, fn in self.saved.items():
            setattr(mamba2, n, region(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(mamba2, n, fn)


def _region_ms(ops, name: str) -> float:
    """Device ms of the kernels launched inside the host regions ``name``
    (their children's included)."""
    total = 0.0
    for e in ops:
        if e.key == name and e.device_type == torch.autograd.DeviceType.CPU:
            total += next(float(getattr(e, a)) for a in (
                "device_time_total", "cuda_time_total") if hasattr(e, a))
    return total / 1e3


def phase_profile_stateful(card: str, arch: str, phase: str) -> None:
    """Where a stateful family's iteration goes (zamba2-2.7b, eager: it
    takes no CUDA graphs yet): torch.profiler over the profile phase's
    prefill (8 requests x 256 tokens, each replayed on its own), decode (8
    slots) and mixed (a 256-token chunk + the 8 decodes) iterations on one
    worker, after a warm pass and an unprofiled pass that gives each
    iteration's wall time. Prints wall and device ms, idle share, host ms,
    attention, GEMM and other ms, the SSD's device ms and share (the
    kernels launched inside ``_SSDRegions``), then the decode batch's K/V
    gather and scatter (``_decode_slots`` moves every leaf's batch rows;
    the shared block's K/V are the large ones) timed alone beside the
    decode's device time."""
    cfg = get_config(arch)
    execs = ClusterRealExecutors(cfg, 1, max_slots=16, max_len=MAX_LEN,
                                 seed=0)
    ex = execs.execs[0]

    def drive(reqs, profile: bool):
        for label, plan in _profile_plans(reqs):
            if label is None or not profile:
                t0 = time.perf_counter()
                ex.run_plan(plan)
                walls[label] = (time.perf_counter() - t0) * 1e3
            else:
                with _SSDRegions():
                    prof_wall, kernels, ops = _profiled(
                        lambda: ex.run_plan(plan))
                yield label, prof_wall, [e for e in kernels
                                         if e.key != _SSDRegions.NAME], ops
            for r, t in plan.prefill_parts:
                r.prefilled_tokens += t

    walls = {}
    for base in (100, 200):                  # warm, then the timed walls
        warm = [_req(base + i, 256 + i) for i in range(9)]
        for _ in drive(warm, False):
            pass
        for r in warm:
            execs.on_finish(r)
    timed = dict(walls)
    reqs = [_req(i, 256 + i) for i in range(9)]
    decode_dev = 0.0
    for label, prof_wall, kernels, ops in drive(reqs, True):
        dev = _device_ms(kernels)
        attn = _device_ms(kernels, _named(chunked_prefill, paged_attention))
        gemm = _device_ms(kernels, _is_gemm)
        ssd = _region_ms(ops, _SSDRegions.NAME)
        wall = timed[label]
        check(attn > 0, f"{phase}: no attention kernel time in {label!r}")
        say(phase, arch=arch, iteration=repr(label), steps="eager",
            wall_ms=f"{wall:.3f}", device_ms=f"{dev:.3f}",
            profiled_wall_ms=f"{prof_wall:.3f}",
            idle_share=f"{1 - dev / wall:.3f}", host_ms=f"{wall - dev:.3f}",
            attention_kernels_ms=f"{attn:.3f}", gemm_ms=f"{gemm:.3f}",
            other_ms=f"{dev - attn - gemm:.3f}",
            ssd_ms=f"{ssd:.3f}" if ssd else "not-measured",
            ssd_share=f"{ssd / dev:.3f}" if ssd else "not-measured",
            device_kernels=sum(e.count for e in kernels), card=repr(card))
        for e in kernels[:4]:
            say(phase, kernel=repr(e.key[:70]), count=e.count,
                device_ms=f"{_device_us(e) / 1e3:.3f}")
        if label == "decode 8":
            decode_dev = dev
    idx = torch.tensor([ex.slot_of[r.rid] for r in reqs[:8]], device=DEV)

    def gather_scatter(leaves):
        for a in leaves:
            a.index_copy_(1, idx, a.index_select(1, idx))

    kv = [ex.cache["k"], ex.cache["v"]]
    kv_ms = time_ms(lambda: gather_scatter(kv))
    all_ms = time_ms(lambda: gather_scatter(list(_leaves(ex.cache))))
    kv_bytes = sum(a[:, :8].numel() * a.element_size() for a in kv)
    say(phase, kv_gather_scatter_ms=f"{kv_ms:.4f}",
        state_gather_scatter_ms=f"{all_ms:.4f}",
        kv_bytes_each_way_gb=f"{kv_bytes / 1e9:.3f}",
        kv_bound_ms=f"{4 * kv_bytes / HBM_BYTES_PER_S * 1e3:.4f}",
        kv_share_of_decode_device=f"{kv_ms / decode_dev:.3f}",
        card=repr(card))
    del execs


# The graphs phase's iterations, as (worker, prefill parts, decode
# requests) or ("migrate", request, from, to); prompt lengths below. Its
# first replays (worker 1's 512-token bucket, worker 0's 128-token 2-row
# bucket, worker 0's 64-token bucket, ...) follow no capture order.
GRAPH_PROMPTS = dict(a=300, b=100, c=90, d=40, e=200, f=700, g=600, h=520,
                     i=1000, j=30)
GRAPH_DRIVE = (
    (1, [("a", 300)], []),                     # bucket 512: a warmup key
    (0, [("b", 100), ("c", 90)], []),          # 128 x 2 rows: first use
    (0, [("d", 40)], []),
    (1, [], ["a"]),
    (0, [("e", 200)], ["b", "c", "d"]),        # mixed
    (1, [("f", 700), ("g", 600), ("h", 520), ("i", 1000)], ["a"]),
    (0, [], ["b", "c", "d", "e"]),
    ("migrate", "b", 0, 1),
    (1, [("j", 30)], ["a", "b", "f", "g", "h", "i"]),
    (0, [], ["c", "d", "e"]),
    (1, [], ["a", "b", "f", "g", "h", "i", "j"]),
)


def _graph_drive(execs, rid0: int, eager: bool):
    """``GRAPH_DRIVE`` on requests rid0, rid0 + 1, ...: (each request's
    sampled tokens, each iteration's wall ms); the requests are released
    after."""
    reqs = {n: _req(rid0 + i, n_prompt)
            for i, (n, n_prompt) in enumerate(GRAPH_PROMPTS.items())}
    walls = []
    for step in GRAPH_DRIVE:
        t0 = time.perf_counter()
        if step[0] == "migrate":
            execs.migrate(reqs[step[1]], step[2], step[3])
        else:
            wid, prefill, decode = step
            _run(execs, wid, _plan(prefill=[(reqs[n], t) for n, t in prefill],
                                   decode=[reqs[n] for n in decode]), eager)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    tokens = {n: list(execs.execs[execs._owner[r.rid]].generated[r.rid])
              for n, r in reqs.items()}
    for r in reqs.values():
        execs.on_finish(r)
    return tokens, walls


def _zero_counts() -> None:
    for module in ops.COUNTED:
        module.launches = 0
        for v in module.launches_by_variant:
            module.launches_by_variant[v] = 0


def _counts() -> dict:
    return {m.__name__.rsplit(".", 1)[-1]: dict(m.launches_by_variant)
            for m in ops.COUNTED}


def phase_graphs(card: str, arch: str) -> None:
    """CUDA graphs against eager steps at full width: two workers sharing
    weights capture their warmup keys, then ``GRAPH_DRIVE`` (prefill keys
    of 1-4 rows up to the 1024-token bucket, some captured at first use,
    decode and mixed iterations, a migration) runs twice through the
    graphs, replayed in an order that differs from the capture order, and
    twice eagerly on a second cluster with the same weights and requests.
    Sampled tokens must be identical; the caches are held to the bf16
    model tolerance (relative L2; max abs difference printed, expected 0);
    the second passes' launch counts, per device kernel variant, must be
    equal (a replay adds what its capture counted)."""
    cfg = get_config(arch)
    t0 = time.perf_counter()
    graphed = ClusterRealExecutors(cfg, 2, max_slots=8, max_len=MAX_LEN,
                                   seed=0)
    k = graphed.kernels
    say("graphs", arch=arch, warmup_s=f"{time.perf_counter() - t0:.2f}",
        warmup_captures=k.captures, capture_s=f"{k.capture_seconds:.3f}")
    eager = ClusterRealExecutors(cfg, 2, max_slots=8, max_len=MAX_LEN,
                                 params=graphed.params, warmup=False)
    order = []
    replay = texec._StepGraph.replay

    def logged(self, flat):
        order.append(self)
        return replay(self, flat)

    texec._StepGraph.replay = logged
    try:
        runs = {}
        for p in range(2):
            for name, execs in (("graphs", graphed), ("eager", eager)):
                _zero_counts()
                runs[name, p] = _graph_drive(execs, 1000 * p,
                                             name == "eager") + (_counts(),)
    finally:
        texec._StepGraph.replay = replay
    captured = list(k._graphs.values())
    first = [captured.index(g) for g in dict.fromkeys(order)]
    diff = max((a.float() - b.float()).abs().max().item()
               for ga, ea in zip(graphed.execs.values(),
                                 eager.execs.values())
               for a, b in ((ga.cache[key], ea.cache[key])
                            for key in ("k", "v")))
    rel = max(((ga.cache[key].float() - ea.cache[key].float()).norm()
               / ea.cache[key].float().norm().clamp_min(1e-30)).item()
              for ga, ea in zip(graphed.execs.values(), eager.execs.values())
              for key in ("k", "v"))
    for p in range(2):
        (gt, gw, gc), (et, ew, ec) = runs["graphs", p], runs["eager", p]
        say("graphs", arch=arch, drive_pass=p,
            graphed_ms=[round(w, 3) for w in gw],
            eager_ms=[round(w, 3) for w in ew],
            graphed_total_ms=f"{sum(gw):.3f}", eager_total_ms=f"{sum(ew):.3f}",
            tokens_equal=gt == et, card=repr(card))
        check(gt == et, f"graphs: {arch} pass {p}: graphs and eager sampled "
              f"different tokens {gt} / {et}")
    (_, _, gc), (_, _, ec) = runs["graphs", 1], runs["eager", 1]
    say("graphs", arch=arch, captures=k.captures,
        prefill_captures=k.prefill_traces, decode_captures=k.decode_traces,
        capture_s=f"{k.capture_seconds:.3f}",
        pool_mb=f"{k.pool_bytes() / 2**20:.1f}",
        first_replay_order=first, cache_max_abs_diff=f"{diff:.3e}",
        cache_rel_l2=f"{rel:.3e}", launches_graphed=gc, launches_eager=ec)
    check(first != sorted(first), "graphs: replays followed the capture "
          f"order {first}")
    check(rel <= MODEL_TOL[torch.bfloat16], f"graphs: {arch} caches differ "
          f"by {rel:.3e} (relative L2)")
    check(gc == ec and all(gc[m]["tensor_core"] > 0 for m in
                           ("chunked_prefill", "paged_attention")),
          f"graphs: launch counts differ: graphed {gc}, eager {ec}")
    del graphed, eager
    torch.cuda.empty_cache()


# calibrate_hardware at serving shapes (qwen2's 12 heads of 128, a 2048-token
# prefill, 8 requests of 1024 tokens in 64-token pages)
CALIB_SHAPES = dict(seq=2048, heads=12, head_dim=128, batch=8, page_size=64,
                    pages_per_seq=16, repeats=5)
CALIB_GRID = dict(decode_batches=(1, 4, 8), chunk_sizes=(128, 256, 512),
                  heads=12, head_dim=128, page_size=64, pages_per_seq=16,
                  repeats=5)
FRACTION_LIMIT = 1.05


def _unclamped(cal, hw) -> dict:
    """Each fraction the calibration measured, before its clamp to 1."""
    peak = hw.peak_flops
    out = {"attn_prefill_mfu": cal.prefill_flops / (cal.prefill_seconds * peak),
           "attn_decode_mfu": cal.decode_flops / (cal.decode_seconds * peak),
           "bw_eff": cal.decode_bytes / (cal.decode_seconds * hw.hbm_bw)}
    if cal.gemm_prefill_seconds:
        out |= {
            "gemm_prefill_mfu": cal.gemm_prefill_flops
            / (cal.gemm_prefill_seconds * peak),
            "gemm_decode_mfu": cal.gemm_decode_flops
            / (cal.gemm_decode_seconds * peak),
            "mfu_prefill": (cal.prefill_flops + cal.gemm_prefill_flops)
            / ((cal.prefill_seconds + cal.gemm_prefill_seconds) * peak),
            "mfu_decode": (cal.decode_flops + cal.gemm_decode_flops)
            / ((cal.decode_seconds + cal.gemm_decode_seconds) * peak)}
    return out


def phase_calibrate(card: str, profiled: list) -> None:
    """``perf.calibrate`` on the card through the hand-written kernels: the
    measured spec with and without the GEMM pass, the γ grid (solved
    against the GEMM-blended measured spec, as CalibratedRooflineBackend
    does), then the cost model's iteration times for the profile phase's
    plans under H100's assumed fractions and under each measured spec (γ
    table attached), beside what the profile phase measured."""
    modules = (chunked_prefill, paged_attention)
    before = {m: dict(m.launches_by_variant) for m in modules}
    specs = {}
    for gemm in (True, False):
        hw, cal = calibrate_hardware(H100, gemm=gemm, **CALIB_SHAPES)
        fracs = _unclamped(cal, H100)
        key = "measured_gemm" if gemm else "measured_attention"
        specs[key] = hw
        say("calibrate", spec=key, device=repr(cal.device),
            mfu_prefill=f"{hw.mfu_prefill:.6f}",
            mfu_decode=f"{hw.mfu_decode:.6f}", bw_eff=f"{hw.bw_eff:.6f}",
            attn_prefill_ms=f"{cal.prefill_seconds * 1e3:.4f}",
            attn_decode_ms=f"{cal.decode_seconds * 1e3:.4f}",
            gemm_prefill_ms=f"{cal.gemm_prefill_seconds * 1e3:.4f}",
            gemm_decode_ms=f"{cal.gemm_decode_seconds * 1e3:.4f}",
            unclamped={k: f"{v:.6f}" for k, v in fracs.items()},
            card=repr(card))
        check(all(v <= FRACTION_LIMIT for v in fracs.values()),
              f"calibrate: a measured fraction exceeds {FRACTION_LIMIT}: "
              f"{fracs}")
    table, icl = calibrate_interference(specs["measured_gemm"], **CALIB_GRID)
    say("calibrate", gamma=[list(r) for r in table.gamma],
        decode_batches=icl.decode_batches, chunks=icl.chunk_sizes,
        pure_prefill_ms=[round(t * 1e3, 4) for t in icl.pure_prefill_s],
        pure_decode_ms=[round(t * 1e3, 4) for t in icl.pure_decode_s],
        mixed_ms=[[round(t * 1e3, 4) for t in r] for r in icl.mixed_s],
        card=repr(card))
    for m, was in before.items():
        rose = {v: m.launches_by_variant[v] - n for v, n in was.items()}
        check(rose["tensor_core"] > 0,
              f"calibrate: {m.__name__} did not launch its tensor-core "
              f"kernel {rose}")
        say("calibrate", kernel=m.__name__.rsplit(".", 1)[-1],
            launches=rose)
    specs = {k: dataclasses.replace(hw, interference=table)
             for k, hw in specs.items()}
    for key, hw in specs.items():
        say("calibrate", measured_spec=key, spec=repr(hw))
    memory = float(torch.cuda.get_device_properties(DEV).total_memory)
    cfg = get_config(ARCH)
    costs = {k: CostModel(cfg, WorkerSpec(tp=1, hw=dataclasses.replace(
        hw, hbm_bytes=memory)), page_size=16)
        for k, hw in ({"h100_assumed": H100} | specs).items()}
    for label, plan, wall, dev in profiled:
        predicted = {k: 1e3 * c.iteration_time(
            plan.n_decode, plan.sum_ctx, plan.prefill_tokens,
            plan.prefill_ctx_offset) for k, c in costs.items()}
        say("calibrate", iteration=repr(label), wall_ms=f"{wall:.3f}",
            device_ms=f"{dev:.3f}" if dev else "not-measured",
            **{f"predicted_ms_{k}": f"{v:.3f}" for k, v in predicted.items()},
            card=repr(card))


class _ConfigChanges:
    """Inside this block ``repro_torch.configs.get_config(arch)`` returns
    the config with ``changes`` (``dataclasses.replace``), as the JAX
    ``launch/hillclimb.py`` varies a config; the serve CLI, like the JAX
    one, has no flag for them (the fp8 cache)."""

    def __init__(self, arch: str, changes: dict):
        self.arch, self.changes = arch, changes

    def __enter__(self):
        self.saved = configs.get_config
        configs.get_config = lambda name: dataclasses.replace(
            self.saved(name), **(self.changes if name == self.arch else {}))

    def __exit__(self, *exc):
        configs.get_config = self.saved


# the explicit SLO class every serve phase serves (below), and the slots of
# each worker's cache (launch/serve.py's ClusterRealExecutors)
SERVE_CLASS = SLOClass(name="chat", ttft=5.0, tpot=0.5)
SERVE_SLOTS = 8


def _scenario_csv(phase: str, scenario: str, rate: float, duration: float,
                  seed: int) -> tuple:
    """``scenario``'s trace (the launcher's ``--scenario`` draw: the same
    component names, so the same arrivals and lengths) under
    ``SERVE_CLASS``, written as a Mooncake-schema CSV with its
    ``slo_class`` column. The launcher refuses ``--slo-classes`` beside
    ``--scenario`` (as the JAX one does), so a phase replays the scenario's
    trace with ``--trace-csv`` under the class. Returns (path, requests)."""
    base = get_scenario(scenario)
    comps = tuple(dataclasses.replace(c, slo=SERVE_CLASS)
                  for c in base.components)
    reqs = Scenario(base.name, comps).generate(rate, duration, None,
                                               seed=seed)
    path = _dist_dir(phase) / f"{scenario}.csv"
    save_csv(str(path), reqs)
    return path, reqs


class _Windows:
    """Counts the calls of the two attention kernels' launchers given the
    sliding ``window``: eager calls, and calls that a CUDA graph captures
    (whose replays launch the captured window)."""

    def __init__(self, window: int):
        self.window = window
        self.calls = {"chunked_prefill": 0, "paged_attention": 0}

    def _spy(self, name: str, fn):
        def run(*args, window=None, **kwargs):
            if window == self.window:
                self.calls[name] += 1
            return fn(*args, window=window, **kwargs)
        return run

    def __enter__(self):
        self.saved = (chunked_prefill.chunked_prefill_attention,
                      paged_attention.paged_attention)
        chunked_prefill.chunked_prefill_attention = self._spy(
            "chunked_prefill", self.saved[0])
        paged_attention.paged_attention = self._spy("paged_attention",
                                                    self.saved[1])
        return self

    def __exit__(self, *exc):
        (chunked_prefill.chunked_prefill_attention,
         paged_attention.paged_attention) = self.saved


def _cache_bytes_per_token(cfg) -> int:
    """K and V of every layer for one token, in the model's dtype."""
    return cfg.num_layers * 2 * cfg.num_kv_heads * cfg.head_dim \
        * torch.empty((), dtype=cfg.dtype).element_size()


def phase_serve(card: str, phase: str, arch: str, kernels: dict,
                main_variants: dict, changes: Optional[dict] = None,
                traffic: Optional[dict] = None) -> dict:
    """``repro_torch.launch.serve`` on full-width ``arch`` (with config
    ``changes``); every kernel's launch count is zeroed just before and
    ``kernels``' read just after (a graph replay adds what its capture
    counted). Each of ``main_variants`` (module name -> its device kernel
    variants) must have launched, and no other variant of that module.
    ``traffic`` changes the run's flags (``rate``, ``max_len``,
    ``max_prompt``, ``max_output``) and its ``scenario`` (replayed by
    ``_scenario_csv``); with ``past`` (gemma2's window) at least half the
    finished requests must reach a length past it, and both attention
    kernels must be given it as their window."""
    # Explicit SLOs: the trace's default limits are 5x the light-load
    # latency under the H100 cost model with its assumed fractions, which
    # this card's host-bound iterations do not meet; with no slack the
    # toggle (rightly) rides no prefill on a decode batch, and the run
    # would not exercise the mixed iterations the paper is about. Outputs
    # of up to 128 tokens: with graphed steps (about 6 ms a decode) 32
    # tokens left one or two of the 10 arrivals inside another request's
    # decode, so a prefill rode on a decode batch in 1-2 iterations only.
    traffic = traffic or {}
    rate, seed, duration = traffic.get("rate", 1.5), 1, 5.0
    max_len = traffic.get("max_len", MAX_LEN)
    max_prompt = traffic.get("max_prompt", 512)
    max_output = traffic.get("max_output", 128)
    c = SERVE_CLASS
    argv = ["--mode", "real", "--arch", arch, "--size", "full",
            "--policy", "tropical", "--workers", "2", "--rate", str(rate),
            "--duration", "5", "--seed", str(seed), "--max-len", str(max_len),
            "--max-prompt", str(max_prompt), "--max-output", str(max_output),
            "--slo-classes", f"{c.name}:ttft={c.ttft:g},tpot={c.tpot:g}",
            "--json"]
    trace = stated = None
    if "scenario" in traffic:
        path, trace = _scenario_csv(phase, traffic["scenario"], rate,
                                    duration, seed)
        argv += ["--trace-csv", str(path)]
        cfg = dataclasses.replace(get_config(arch), **(changes or {}))
        per_token = _cache_bytes_per_token(cfg)
        stated = SERVE_SLOTS * per_token * max_len
        say(phase, scenario=traffic["scenario"], requests=len(trace),
            prompts_capped=",".join(str(min(r.prompt_len, max_prompt))
                                    for r in trace),
            cache_bytes_per_token=per_token,
            slot_gb=f"{per_token * max_len / 1e9:.3f}",
            cache_gb_a_worker=f"{stated / 1e9:.3f}",
            slots_a_worker=SERVE_SLOTS, workers=2)
    for module in ops.COUNTED:
        module.launches = 0
        for v in getattr(module, "launches_by_variant", {}):
            module.launches_by_variant[v] = 0
    t0 = time.perf_counter()
    changes = changes or {}
    windows = _Windows(traffic["past"]) if "past" in traffic else None
    with _ConfigChanges(arch, changes), \
            (windows or contextlib.nullcontext()):
        row, backend = serve.run(argv)
    wall = time.perf_counter() - t0
    graphs = backend.execs.kernels
    launches = {name: module.launches for name, module in kernels.items()}
    variants = {name: dict(module.launches_by_variant)
                for name, module in kernels.items()
                if hasattr(module, "launches_by_variant")}
    generated = sum(len(g) for e in backend.execs.execs.values()
                    for g in e.generated.values())
    say(phase, arch=arch, n_finished=row["n_finished"], n_total=row["n_total"],
        ttft_p90_s=f"{row['ttft_p90']:.4f}", tpot_p90_s=f"{row['tpot_p90']:.5f}",
        iterations=backend.iterations,
        mixed_iterations=backend.mixed_iterations,
        tokens_generated=generated,
        busy_s=f"{backend.busy_seconds:.3f}",
        tokens_per_busy_s=f"{generated / backend.busy_seconds:.1f}",
        wall_s=f"{wall:.2f}", card=repr(card))
    caches = {str(e.cache["k"].dtype).split(".")[-1]
              for e in backend.execs.execs.values() if "k" in e.cache}
    if graphs is not None:
        say(phase, graph_captures=graphs.captures,
            capture_s=f"{graphs.capture_seconds:.3f}",
            pool_mb=f"{graphs.pool_bytes() / 2**20:.1f}", kv_cache=caches)
        check(graphs.graphed and graphs.captures > 0,
              f"{phase}: the dense fast path captured no graph")
    if changes.get("kv_cache_quant"):
        check(caches == {"float8_e4m3fn"}, f"{phase}: caches {caches}")
    say(phase, launches=launches, by_variant=variants,
        fused=dict(fused.launches_by_variant))
    cfg = dataclasses.replace(get_config(arch), **changes)
    forwards = _check_fused_launches(phase, cfg)
    if "moe_experts" in variants:
        # every MoE layer of every forward (a replay adds its capture's)
        # through the four passes, a chunk of tokens each a pass
        by = variants["moe_experts"]
        check(len(set(by.values())) == 1
              and by["lists"] >= forwards * cfg.num_layers,
              f"{phase}: routed expert passes {by} over {forwards} forwards "
              f"of {cfg.num_layers} MoE layers")
    check(row["n_total"] > 0 and row["n_finished"] == row["n_total"],
          f"{phase}: not every request finished")
    if "scenario" not in traffic:
        # the mooncake-like traffic rides prefills on decode batches (see
        # the SLO note above); the long-context phase checks the window,
        # and its 6k-token prompts at rate 1.0 may find no slack to ride on
        check(backend.mixed_iterations >= 1, f"{phase}: no mixed iteration")
    check(all(n > 0 for n in launches.values()),
          f"{phase}: a kernel was never launched on the main path {launches}")
    for name, wanted in main_variants.items():
        check(all(variants[name][v] > 0 for v in wanted),
              f"{phase}: a {name} variant of {wanted} was never launched on "
              f"the main path {variants}")
        check(all(n == 0 for v, n in variants[name].items()
                  if v not in wanted),
              f"{phase}: {name} launched a variant outside {wanted} on the "
              f"main path {variants}")
    for lat in (row["ttft_avg"], row["tpot_avg"]):
        check(math.isfinite(lat) and lat > 0, f"{phase}: bad latency")
    if "past" in traffic:
        _check_past(phase, traffic, trace, backend, windows, stated)
    del backend, graphs
    torch.cuda.empty_cache()
    return launches | {f"{name}.{v}": n for name, by in variants.items()
                       for v, n in by.items()}


def _check_fused_launches(phase: str, cfg) -> Optional[int]:
    """The fused passes a serve phase launched (zeroed with the other
    counted kernels before the run), and the forwards they make (None
    where they count none). Every forward of a dense, MoE or VLM
    model launches, a layer, its two norms (four with gemma2's
    post-norms), one attention pass and one gated activation (arctic's
    dense residual MLP; the experts keep the plain ops), then the final
    norm: the counts are the same whole multiple of those, in the
    variants of the config's cache dtype and activation and no others.
    zamba2's mamba blocks add norms of their own: there each pass must
    have launched. rwkv6 keeps its LayerNorms."""
    if cfg.use_layernorm or cfg.family not in ("dense", "moe", "vlm",
                                               "hybrid"):
        return None
    by = dict(fused.launches_by_variant)
    rope_v = "rope_cache_write_e4m3" if cfg.kv_cache_quant \
        else "rope_cache_write"
    gated_v = f"gated_{cfg.mlp_activation}"
    norms = by.pop("add_rms_norm") + by.pop("rms_norm")
    rope, gated = by.pop(rope_v), by.pop(gated_v)
    check(norms > 0 and rope > 0 and (gated > 0 or not cfg.mlp_gated)
          and not any(by.values()),
          f"{phase}: fused launches {dict(fused.launches_by_variant)}: "
          f"the passes did not run on the main path, or another variant did")
    if cfg.family == "hybrid":
        return None
    n, left = divmod(rope, cfg.num_layers)
    per_norms = (4 if cfg.use_post_norms else 2) * cfg.num_layers + 1
    per_gated = cfg.num_layers if cfg.mlp_gated and (
        not cfg.is_moe or cfg.moe_dense_residual_ff) else 0
    check(left == 0 and norms == n * per_norms and gated == n * per_gated,
          f"{phase}: fused launches {dict(fused.launches_by_variant)} are "
          f"not a whole number of forwards of {per_norms} norms, "
          f"{cfg.num_layers} attention passes and {per_gated} activations")
    say(phase, fused_forwards=n, fused_per_forward=per_norms
        + cfg.num_layers + per_gated)
    return n


QUICKSTART_ARCHS = (ARCH, GEMMA2, RWKV, ARCTIC, KIMI)
# the kernels each quickstart must launch (SMOKE configs are f32: the
# attention kernels' CUDA-core variants; rwkv6 both WKV kernels; the MoE
# models the routed experts' f32 passes, at d_ff 96 (arctic) and 64 (kimi))
_ATTENTION_F32 = {"chunked_prefill": ("cuda_core",),
                  "paged_attention": ("cuda_core",)}
QUICKSTART_KERNELS = {
    ARCH: _ATTENTION_F32,
    GEMMA2: _ATTENTION_F32,
    RWKV: {"wkv6": ("chunk", "decode")},
    ARCTIC: _ATTENTION_F32 | {"moe_experts": tuple(moe_experts.KERNELS)},
    KIMI: _ATTENTION_F32 | {"moe_experts": tuple(moe_experts.KERNELS)},
}


def phase_quickstart() -> None:
    """The port's quickstart (``repro_torch.examples.quickstart``, the
    counterpart of examples/quickstart.py) on the card for each of
    ``QUICKSTART_ARCHS`` at SMOKE size: 2 prompts of 12 tokens prefilled,
    8 greedy decode steps, 3 AdamW steps. Launch counts are zeroed just
    before each run and read just after: the kernels of
    ``QUICKSTART_KERNELS`` and no other variant. Then the same weights
    (the quickstart's seeded generator) and prompts through the plain
    versions on the card, fed the quickstart's tokens: every step's logits
    held to the kernels' (relative L2, ``MODEL_TOL`` f32)."""
    for arch in QUICKSTART_ARCHS:
        _zero_counts()
        out = quickstart.main([arch, "--device", "cuda"])
        counts = _counts()
        cfg = configs.get_smoke(arch)
        api = model_api.build(cfg)
        params = api.init(torch.Generator(device=DEV).manual_seed(0))
        inputs, lengths = quickstart.prompt_inputs(
            cfg, torch.Generator(device=DEV).manual_seed(1))
        with _PlainKernels():
            plain, _ = quickstart.generate(api, params, inputs, lengths,
                                           forced=out["tokens"][:, :-1])
        rel = max(_rel_l2(g, w) for g, w in zip(out["logits"], plain))
        say("quickstart", arch=arch, tokens=out["tokens"].tolist(),
            losses=",".join(f"{x:.4f}" for x in out["losses"]),
            launches=counts, logits_rel_l2_vs_plain=f"{rel:.3e}",
            tol=MODEL_TOL[cfg.dtype])
        for name, wanted in QUICKSTART_KERNELS[arch].items():
            check(all(counts[name][v] > 0 for v in wanted)
                  and all(n == 0 for v, n in counts[name].items()
                          if v not in wanted),
                  f"quickstart: {arch}: {name} launched {counts[name]}, "
                  f"want {wanted} only")
        check(all(torch.isfinite(g).all().item() for g in out["logits"])
              and all(math.isfinite(x) for x in out["losses"]),
              f"quickstart: {arch}: non-finite logits or losses")
        check(rel <= MODEL_TOL[cfg.dtype], f"quickstart: {arch}: logits "
              f"{rel:.3e} (relative L2) from the plain versions'")


def _check_past(phase: str, traffic: dict, trace: list, backend,
                windows: _Windows, stated: int) -> None:
    """The serve phase's requests past ``traffic["past"]`` tokens and the
    windows its attention kernels were given; each worker's cache is the
    ``stated`` size."""
    past, execs = traffic["past"], backend.execs.execs.values()
    reached = [min(r.prompt_len, traffic["max_prompt"])
               + max(len(e.generated.get(r.rid, ())) for e in execs)
               for r in trace]
    beyond = sum(n > past for n in reached)
    caches = [sum(t.numel() * t.element_size() for t in (e.cache["k"],
                                                         e.cache["v"]))
              for e in execs]
    say(phase, lengths_reached=",".join(map(str, reached)),
        past_window=f"{beyond}/{len(reached)}", window=past,
        windowed_calls=windows.calls,
        cache_gb_by_worker=",".join(f"{b / 1e9:.3f}" for b in caches))
    check(2 * beyond >= len(reached), f"{phase}: {beyond} of "
          f"{len(reached)} requests reached a length past {past}")
    check(all(n > 0 for n in windows.calls.values()),
          f"{phase}: an attention kernel was never given the window {past}: "
          f"{windows.calls}")
    check(all(b == stated for b in caches), f"{phase}: caches of {caches} "
          f"bytes, {stated} stated")


# ---------------------------------------------------------------- training

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_TIMED_FROM = 8, 512, 20, 5
TRAIN_OPT = optimizer.AdamWConfig(lr=1e-3, warmup_steps=5)
# a step's measured peak memory against the dry-run's prediction: within
# 10% of the predicted transient (dryrun_check: or 64 MiB, the larger)
STEP_MEM_TOL, STEP_MEM_FLOOR = 0.10, 64 * 2**20
# dryrun_check: the bytes the step itself allocates (peak - start) against
# the trace's high-water mark, within 1% + 1 MiB (the allocator's 512-byte
# rounding of a few hundred blocks, an op's own workspace): the start
# holds the cuBLAS workspace that the absolute check's floor absorbs
OWN_MEM_TOL, OWN_MEM_FLOOR = 0.01, 2**20
# the plain attention's ops in a training step: its products (the only
# batched matrix products of a dense model) and its softmax, forward and
# backward (the rest of it, the mask and the casts, counts as elementwise)
ATTENTION_OPS = ("aten::bmm", "aten::_softmax", "aten::_softmax_backward_data")


def _train_prediction() -> dict:
    """The dry-run's record of the train phase's step (full-width qwen2-1.5b,
    ``TRAIN_BATCH`` x ``TRAIN_SEQ``, its remat policy) traced as rank 0 of a
    fake group of 1 on a 1 x 1 mesh: meta DTensors, nothing on the card.
    AdamW's hyperparameters are scalars that change no buffer, FLOP or
    collective of the trace, so the default config traces the step that
    ``TRAIN_OPT`` runs."""
    dryrun.fake_group(1)
    try:
        mesh = mesh_launch.make_mesh((1, 1), ("data", "model"), "cuda")
        rec = dryrun.run_cell(
            ARCH, "train_check", "1x1", EP_DIR, force=True, write=False,
            shape=dict(kind="train", seq=TRAIN_SEQ, batch=TRAIN_BATCH),
            mesh=mesh, cfg=get_config(ARCH))
    finally:
        dryrun.release_group()
    check(rec["status"] == "ok", f"train: the dry-run's trace of the step: "
          f"{rec.get('error')}")
    return rec


def _check_train_memory(peak: int) -> None:
    """The phase's measured peak (from its reset before step 0) against the
    dry-run's predicted peak of the step, within 10% of the predicted
    transient."""
    rec = _train_prediction()
    mem = rec["memory"]
    want, temps = rec["bytes_per_device_incl_cpu_temps"], \
        mem["temp_size_in_bytes"]
    say("train", peak_bytes=peak, predicted_peak_bytes=int(want),
        predicted_start_bytes=int(sum(mem["arguments"].values())),
        predicted_temp_bytes=int(temps),
        peak_minus_predicted_gb=f"{(peak - want) / 1e9:.3f}",
        share_of_predicted_transient=f"{(peak - want) / temps:.4f}",
        peak_at=mem["peak_at"], trace_s=rec["lower_s"])
    check(abs(peak - want) <= STEP_MEM_TOL * temps,
          f"train: peak {peak} bytes, the dry-run's {want:.0f} (tolerance "
          f"{STEP_MEM_TOL * temps:.0f})")


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _train_parts(api, params, state, batch, profiled: bool) -> tuple:
    """One step of make_train_step's three parts, the forward (the loss),
    the backward (autograd.grad) and the optimizer (apply_updates), with
    the card synchronised between them: ({part: wall ms}, or with
    ``profiled`` {part: ``_profiled``'s (wall, kernels, events)}, the new
    params)."""
    res = {}
    live = optimizer.tree_map(lambda p: p.detach().requires_grad_(), params)

    def update():
        it = iter(res["grads"])
        res["new"] = optimizer.apply_updates(
            params, optimizer.tree_map(lambda _: next(it), params), state,
            TRAIN_OPT)[0]

    parts = {"forward": lambda: res.update(loss=api.loss(live, batch)),
             "backward": lambda: res.update(grads=torch.autograd.grad(
                 res["loss"], optimizer.leaves(live))),
             "optimizer": update}
    out = {}
    for name, fn in parts.items():
        if profiled:
            out[name] = _profiled(fn)
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
    return out, res["new"]


def phase_train(card: str) -> None:
    """Full-width qwen2-1.5b trained through the port's entry points (see
    the module docstring)."""
    cfg = get_config(ARCH)
    api = model_api.build(cfg)
    params = api.init(torch.Generator(device=DEV).manual_seed(0))
    n_params = sum(p.numel() for p in _leaves(params))
    data = SyntheticLM(cfg, DataConfig(batch=TRAIN_BATCH, seq=TRAIN_SEQ), DEV)
    state = optimizer.init_state(params)
    step_fn = optimizer.make_train_step(api.loss, TRAIN_OPT)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tally = ops.LaunchTally()

    def step0():
        loss, grads = optimizer.loss_and_grads(api.loss, params,
                                               data.batch_at(0))
        bad = [("/".join(k), g.abs().max().item())
               for k, g in _leaf_items(grads)
               if not (torch.isfinite(g).all() and g.abs().max() > 0)]
        check(not bad, f"train: step 0 gradients not finite or all zero: "
              f"{bad}")
        return (loss,) + optimizer.apply_updates(params, grads, state,
                                                 TRAIN_OPT)

    losses, times = [], []
    for i in range(TRAIN_STEPS):
        batch = data.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            loss, params, state = tally.record(step0)
        else:
            params, state, loss = tally.record(
                lambda: step_fn(params, state, batch))
        losses.append(float(loss))
        times.append((time.perf_counter() - t0) * 1e3)
        check(all(n == 0 for n, _ in tally.counts),
              f"train: step {i} launched kernels {tally.counts}")
    peak = torch.cuda.max_memory_allocated()
    step_ms = statistics.median(times[TRAIN_TIMED_FROM:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # 6 N T with N every parameter (the embedding's included)
    peak_share = 6 * n_params * tokens / (step_ms * 1e-3) \
        / PEAK_FLOPS[cfg.dtype]
    say("train", arch=ARCH, params_b=f"{n_params / 1e9:.4f}",
        tokens_per_step=tokens, steps=TRAIN_STEPS,
        loss_first=f"{losses[0]:.4f}", loss_last=f"{losses[-1]:.4f}",
        losses=",".join(f"{x:.3f}" for x in losses),
        step_ms=f"{step_ms:.3f}",
        step_ms_min_max=f"{min(times[TRAIN_TIMED_FROM:]):.3f}/"
                        f"{max(times[TRAIN_TIMED_FROM:]):.3f}",
        tokens_per_s=f"{tokens / step_ms * 1e3:.1f}",
        share_of_peak=f"{peak_share:.4f}",
        peak_memory_gb=f"{peak / 1e9:.2f}", card=repr(card))
    check(all(math.isfinite(x) for x in losses), "train: non-finite loss")
    check(losses[-1] < losses[0], f"train: the loss did not fall "
          f"({losses[0]:.4f} -> {losses[-1]:.4f})")
    _check_train_memory(peak)

    # the same steps under remat "full" (only the blocks' inputs kept)
    full_step = optimizer.make_train_step(model_api.build(
        dataclasses.replace(cfg, remat_policy="full")).loss, TRAIN_OPT)
    full_ms = []
    for i in range(TRAIN_STEPS, TRAIN_STEPS + 4):
        batch = data.batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, _ = full_step(params, state, batch)
        torch.cuda.synchronize()
        full_ms.append((time.perf_counter() - t0) * 1e3)
    say("train", remat_full_step_ms=f"{statistics.median(full_ms[1:]):.3f}",
        remat_dots_step_ms=f"{step_ms:.3f}", card=repr(card))

    walls, params = _train_parts(api, params, state,
                                 data.batch_at(TRAIN_STEPS), False)
    profiled, params = _train_parts(api, params, state,
                                    data.batch_at(TRAIN_STEPS + 1), True)
    kernels = [k for _, ks, _ in profiled.values() for k in ks]
    device = {name: _device_ms(ks) for name, (_, ks, _) in profiled.items()}
    total = sum(device.values())
    gemm = _device_ms(kernels, _is_gemm)
    attention = sum(_device_us(e) for _, _, events in profiled.values()
                    for e in events if e.key in ATTENTION_OPS) / 1e3
    say("train", **{f"{k}_wall_ms": f"{v:.3f}" for k, v in walls.items()},
        **{f"{k}_device_ms": f"{v:.3f}" for k, v in device.items()},
        **{f"{k}_idle_share": f"{max(0.0, 1 - device[k] / v):.3f}"
           for k, v in walls.items()},
        gemm_ms=f"{gemm:.3f}", gemm_share=f"{gemm / total:.3f}",
        plain_attention_ms=f"{attention:.3f}",
        plain_attention_share=f"{attention / total:.3f}", card=repr(card))
    top = {}
    for k in kernels:
        top[k.key] = top.get(k.key, 0.0) + _device_us(k) / 1e3
    for name, ms in sorted(top.items(), key=lambda kv: -kv[1])[:12]:
        say("train", kernel=name[:90].replace(" ", ""), device_ms=f"{ms:.3f}",
            share=f"{ms / total:.3f}")

    # a hand-written kernel on the trained weights: the tensor-core prefill
    rows, n = 2, 256
    tokens_in = data.batch_at(TRAIN_STEPS + 2)["tokens"][:rows, :n]
    out = []
    lengths = torch.tensor([n, 200], dtype=torch.int32, device=DEV)
    with torch.no_grad():
        want = transformer.forward_train(params, tokens_in, cfg)
        want = want[torch.arange(rows, device=DEV), lengths.long() - 1]
        _zero_counts()
        _expect_variant("tensor_core", lambda: out.append(api.prefill(
            params, api.init_cache(rows, n, DEV), tokens_in, lengths)[0]),
            chunked_prefill)
    rel = _rel_l2(out[0], want)
    say("train", prefill_after_training_rel_l2=f"{rel:.3e}",
        tol=MODEL_TOL[cfg.dtype],
        prefill_launches=dict(chunked_prefill.launches_by_variant))
    check(chunked_prefill.launches_by_variant["tensor_core"] > 0,
          "train: the prefill launched no tensor-core kernel")
    check(bool(torch.isfinite(out[0]).all()) and rel <= MODEL_TOL[cfg.dtype],
          f"train: prefill logits on the trained weights differ from "
          f"forward_train's by {rel:.3e} (relative L2)")


TRAIN_FAMILIES = (("qwen2-1.5b", 32), ("gemma2-2b", 32), ("arctic-480b", 32),
                  ("paligemma-3b", 32), ("rwkv6-7b", 64), ("rwkv6-7b", 40),
                  ("zamba2-2.7b", 64), ("zamba2-2.7b", 40),
                  ("whisper-medium", 64))
# relative L2 of the card's loss and of each gradient leaf against the
# CPU's, the latter against the larger of the leaf's norm and GRAD_FLOOR of
# the whole gradient's (whisper's key biases have an analytically zero
# gradient: both devices leave rounding noise there)
TRAIN_TOL, GRAD_FLOOR = 1e-4, 1e-4


def _grad_errors(got, want) -> tuple:
    """(worst relative L2 over the leaves, its leaf) of the card's grads
    against the CPU's."""
    total = math.sqrt(sum(float(w.float().square().sum())
                          for _, w in _leaf_items(want)))
    want = dict(_leaf_items(want))
    worst, where = 0.0, None
    for key, g in _leaf_items(got):
        w = want[key].float()
        rel = ((g.float().cpu() - w).norm()
               / max(w.norm().item(), GRAD_FLOOR * total)).item()
        if rel >= worst:
            worst, where = rel, "/".join(key)
    return worst, where


def _refusal_inputs():
    """Tiny CUDA inputs of the three kernel ops, q (or r) requiring grad."""
    def rnd(*shape):
        return torch.randn(shape, device=DEV)
    q = rnd(1, 4, 2, 16).requires_grad_()
    return {
        "chunked_prefill_op": lambda: ops.chunked_prefill_op(
            q, rnd(1, 8, 1, 16), rnd(1, 8, 1, 16),
            torch.zeros(1, dtype=torch.int32, device=DEV)),
        "paged_attention_op": lambda: ops.paged_attention_op(
            q[:, 0], rnd(2, 4, 1, 16), rnd(2, 4, 1, 16),
            torch.tensor([[0, 1]], dtype=torch.int32, device=DEV),
            torch.tensor([5], dtype=torch.int32, device=DEV)),
        "wkv6_op": lambda: ops.wkv6_op(
            rnd(1, 3, 1, 64).requires_grad_(), rnd(1, 3, 1, 64),
            rnd(1, 3, 1, 64), torch.rand((1, 3, 1, 64), device=DEV),
            rnd(1, 64), torch.zeros(1, 1, 64, 64, device=DEV), "chunked")}


def phase_train_families() -> None:
    """Every family's SMOKE loss and gradients, card against CPU; the ops'
    refusals on the card; a restart from a checkpoint (module docstring)."""
    for arch, seq in TRAIN_FAMILIES:
        cfg = configs.get_smoke(arch)
        api = model_api.build(cfg)
        params = api.init(torch.Generator().manual_seed(0))
        on_card = optimizer.tree_map(lambda t: t.to(DEV), params)
        out = {}
        for dev, p in (("cpu", params), ("card", on_card)):
            batch = SyntheticLM(cfg, DataConfig(batch=2, seq=seq),
                                "cpu" if dev == "cpu" else DEV).batch_at(0)
            with _Routes() as routes:
                out[dev] = optimizer.loss_and_grads(api.loss, p, batch)
            out[dev] += ([r.cpu() for r in routes.ids],)
        (l_cpu, g_cpu, r_cpu), (l_dev, g_dev, r_dev) = out["cpu"], out["card"]
        flips = sum(int((a.sort(-1)[0] != b.sort(-1)[0]).any(-1).sum())
                    for a, b in zip(r_cpu, r_dev))
        loss_rel = abs(l_dev.item() - l_cpu.item()) / abs(l_cpu.item())
        worst, where = _grad_errors(g_dev, g_cpu)
        say("train_families", arch=arch, seq=seq,
            loss_cpu=f"{l_cpu.item():.6f}", loss_card=f"{l_dev.item():.6f}",
            loss_rel=f"{loss_rel:.2e}", worst_grad_rel_l2=f"{worst:.2e}",
            worst_leaf=where, route_calls=len(r_dev), route_flips=flips)
        check(flips == 0, f"train_families {arch}: {flips} routes differ "
              "between the card and the CPU")
        check(loss_rel <= TRAIN_TOL and worst <= TRAIN_TOL,
              f"train_families {arch} S {seq}: loss {loss_rel:.2e}, "
              f"gradient {worst:.2e} at {where} (relative L2)")

    for name, call in _refusal_inputs().items():
        try:
            call()
        except ValueError as e:
            check("requires grad" in str(e), f"{name}: {e}")
        else:
            raise AssertionError(f"{name}: took a CUDA input that requires "
                                 "grad")
    say("train_families", ops_refuse_grad="chunked_prefill_op,"
        "paged_attention_op,wkv6_op")

    # restart at step 3 from a checkpoint on the card == 6 steps in a row
    cfg = configs.get_smoke(ARCH)
    api = model_api.build(cfg)
    step = optimizer.make_train_step(api.loss, optimizer.AdamWConfig(
        lr=3e-3, warmup_steps=5))
    data = SyntheticLM(cfg, DataConfig(batch=4, seq=32), DEV)

    def fresh():
        p = api.init(torch.Generator(device=DEV).manual_seed(0))
        return p, optimizer.init_state(p)

    def run(p, s, steps):
        for i in steps:
            p, s, _ = step(p, s, data.batch_at(i))
        return p, s

    p, s = run(*fresh(), range(6))
    ckpt_dir = Path(__file__).resolve().parent / "build" / "train_ckpt"
    try:
        p2, s2 = run(*fresh(), range(3))
        checkpoint.save(ckpt_dir, 3, {"params": p2, "state": s2})
        target = dict(zip(("params", "state"), fresh()))
        tree = checkpoint.restore(ckpt_dir, checkpoint.latest_step(ckpt_dir),
                                  target, DEV)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    p2, s2 = run(tree["params"], tree["state"], range(3, 6))
    same = all(torch.equal(a, b) for a, b in zip(_leaves(p), _leaves(p2)))
    say("train_families", restart_at_3_bit_equal=same)
    check(same, "train_families: the run restarted from its checkpoint "
          "left the uninterrupted one")


# --------------------------------------------------------- multi-device

# The multi-device phases: four ranks on the one card, each its own
# process (NCCL refuses two ranks on one device), under gloo, which stages
# CUDA tensors through the host for its collectives; NCCL at world size 1
# in this process. The ranks start through launch.dist (a FileStore under
# build/, which git ignores) and write their results beside it.
EP_WORLD = 4
EP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_dist"
EP_SEED = 0
EP_PREFILL = (8, 256)              # rows x tokens through the MoE layer
EP_DECODE = 8                      # decode tokens (one a row)
EP_LAYER_MODES = {"allgather": dict(ep_mode="allgather"), "alltoall": {},
                  "fused": dict(fused_a2a=True)}
EP_REPS = 3
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")
GLOO = "gloo over the host, 4 ranks on one card (not a measure of NCCL)"


def _dist_dir(phase: str) -> Path:
    d = EP_DIR / phase
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    return d


def _spawn(fn, root: Path, *args) -> list:
    """``fn(rank, root, *args)`` in ``EP_WORLD`` gloo ranks; each rank's
    ``rank<r>.pt``."""
    dist_launch.spawn(fn, EP_WORLD, backend="gloo",
                      init_method=f"file://{root}/store",
                      args=(str(root),) + args)
    return [torch.load(root / f"rank{r}.pt") for r in range(EP_WORLD)]


def _rank_setup():
    """A rank's card and mesh: the (1, 4) worker mesh, experts over both
    axes and the batch over 'data' (the JAX dry-run's ``_ep_for``)."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_launch.make_worker_mesh(EP_WORLD)
    return mesh, sharding.make_rules(mesh)


def _ep_info(mesh, rules, **kw) -> moe.EPInfo:
    return moe.EPInfo(mesh=mesh, ep_axes=rules.ep_axes,
                      batch_axes=rules.batch_axes, **kw)


def _own_experts(info: moe.EPInfo, cfg) -> range:
    _, l_e = moe.ep_padded_experts(cfg.num_experts, info.n_devices)
    c = info.coord(info.ep_axes)
    return range(c * l_e, (c + 1) * l_e)


def _router(cfg, stack: int = 0) -> torch.Tensor:
    return _dense_init(torch.Generator(device=DEV).manual_seed(EP_SEED + 1),
                       (cfg.d_model, cfg.num_experts), torch.float32,
                       stack=stack)


def _ep_layer(cfg, experts: range) -> dict:
    """arctic's MoE layer: the router and the tables of ``experts``, each
    expert from its own seeded generator (``moe.init_experts``)."""
    return {"router": _router(cfg)} | moe.init_experts(cfg, experts,
                                                       EP_SEED, DEV)


def _ep_inputs(cfg) -> dict:
    gen = torch.Generator().manual_seed(EP_SEED + 2)
    rows, n = EP_PREFILL
    return {"prefill": torch.randn((rows, n, cfg.d_model), generator=gen)
            .to(cfg.dtype).to(DEV),
            "decode": torch.randn((EP_DECODE, 1, cfg.d_model), generator=gen)
            .to(cfg.dtype).to(DEV)}


class _Drops:
    """Inside this block every ``models.moe._dispatch_indices`` call keeps
    its dropped mask."""

    def __enter__(self):
        self.saved, self.masks = moe._dispatch_indices, []

        def recorded(*args):
            slot, dropped = self.saved(*args)
            self.masks.append(dropped)
            return slot, dropped

        moe._dispatch_indices = recorded
        return self

    def __exit__(self, *exc):
        moe._dispatch_indices = self.saved


def _dist_ms(fn, reps: int = EP_REPS) -> float:
    """Median wall ms of ``fn`` across the group: every rank starts after a
    barrier and the time ends at the barrier after the slowest rank."""
    times = []
    for _ in range(reps):
        tdist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        tdist.barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _layer_runs(p, xs, cfg, infos) -> dict:
    """Each (mode, input): the output, the dropped masks and routes of its
    call (host copies) and its ms."""
    out = {}
    for mode, info in infos.items():
        for key, x in xs.items():
            with _Drops() as drops, _Routes() as routes:
                y = moe.apply_moe_ep(p, x, cfg, info)
            torch.cuda.synchronize()
            out[mode, key] = {
                "y": y.cpu(), "dropped": [m.cpu() for m in drops.masks],
                "ids": [i.cpu() for i in routes.ids],
                "ms": _dist_ms(lambda: moe.apply_moe_ep(p, x, cfg, info))}
    return out


def _moe_ep_rank(rank: int, root: str) -> None:
    mesh, rules = _rank_setup()
    cfg = get_config(ARCTIC)
    infos = {mode: _ep_info(mesh, rules, **kw)
             for mode, kw in EP_LAYER_MODES.items()}
    info = infos["alltoall"]
    p = _ep_layer(cfg, _own_experts(info, cfg))
    runs = _layer_runs(p, _ep_inputs(cfg), cfg, infos)
    torch.save({"runs": runs, "model": info.coord((info.seq_split_axis,)),
                "expert_bytes": sum(p[k].numel() * p[k].element_size()
                                    for k in EXPERT_LEAVES),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9},
               Path(root) / f"rank{rank}.pt")


def _chunk_rows(runs_by_rank: list, field: str, models: list):
    """A per-chunk record (the ranks' routes or dropped masks, one tensor
    per call) joined in seq-split order: one tensor per call."""
    order = sorted(range(len(models)), key=lambda r: models[r])
    calls = len(runs_by_rank[0][field])
    return [torch.cat([runs_by_rank[r][field][c] for r in order])
            for c in range(calls)]


def _held_rows(y, want, ids, want_ids, dropped, k: int):
    """Rows whose token kept every assignment and its reference route;
    the relative L2 error over them, and the counts."""
    t = want.shape[0]
    lost = dropped.view(-1, k)[:t].any(-1)
    flipped = (ids[:t].sort(-1)[0] != want_ids.sort(-1)[0]).any(-1)
    keep = ~(lost | flipped)
    rel = ((y[keep].float() - want[keep].float()).norm()
           / want[keep].float().norm()).item()
    return rel, int(dropped[:t * k].sum()), int(lost.sum()), \
        int(flipped.sum()), int(keep.sum())


def _nccl_world_one(p, xs, cfg, root: Path) -> dict:
    """The layer through an NCCL group of world size 1 on this process
    (all 128 experts local): each mode's output, drops, routes and ms."""
    dist_launch.init("nccl", 0, 1, f"file://{root}/nccl_store")
    try:
        mesh = mesh_launch.make_host_mesh()
        rules = sharding.make_rules(mesh)
        infos = {m: _ep_info(mesh, rules, **EP_LAYER_MODES[m])
                 for m in ("allgather", "alltoall")}
        return _layer_runs(p, xs, cfg, infos)
    finally:
        tdist.destroy_process_group()


def phase_moe_ep() -> None:
    """arctic-480b's MoE layer at full width (d_model 7168, 128 experts of
    d_ff 4864, top-2, bf16: 13.39 B expert parameters, 26.8 GB) split over
    the (1, 4) worker mesh, 32 experts (6.7 GB) a rank, on 8 x 256 prefill
    tokens and an 8-token decode. First the single-process
    ``apply_moe_reference`` on all 128 experts (outputs kept on the host),
    then the same weights through an NCCL group of world size 1, the
    weights freed; then 4 gloo ranks, each drawing only its own experts.
    allgather is held to the reference (``MODEL_TOL``), alltoall on the
    tokens that kept every assignment and their route (drops reported),
    fused_a2a bit-equal to the per-axis composition; ms per layer per
    mode (gloo over the host), each rank's peak memory."""
    cfg = get_config(ARCTIC)
    root = _dist_dir("moe_ep")
    xs = _ep_inputs(cfg)
    p = _ep_layer(cfg, range(cfg.num_experts))
    want, want_ids, ref_ms = {}, {}, {}
    for key, x in xs.items():
        with _Routes() as routes:
            want[key] = moe.apply_moe_reference(p, x, cfg)
        want_ids[key] = routes.ids[0]
        ref_ms[key] = time_ms(lambda: moe.apply_moe_reference(p, x, cfg),
                              reps=3)
    nccl = _nccl_world_one(p, xs, cfg, root)
    want = {k: v.cpu() for k, v in want.items()}
    want_ids = {k: v.cpu() for k, v in want_ids.items()}
    expert_gb = sum(p[k].numel() * p[k].element_size()
                    for k in EXPERT_LEAVES) / 1e9
    del p
    _release()
    say("moe_ep", expert_params_gb=f"{expert_gb:.2f}",
        reference_ms=json.dumps({k: round(v, 3) for k, v in ref_ms.items()}))
    tol, k = MODEL_TOL[torch.bfloat16], cfg.top_k
    for (mode, key), r in nccl.items():
        y, want_y = (t.reshape(-1, cfg.d_model) for t in (r["y"], want[key]))
        if mode == "allgather":
            held = (_rel_l2(y, want_y), 0, 0, 0, want_y.shape[0])
        else:
            held = _held_rows(y, want_y, r["ids"][0], want_ids[key],
                              r["dropped"][0], k)
        say("moe_ep", group="nccl world size 1", mode=mode, input=key,
            ms_per_layer=f"{r['ms']:.3f}", rel_l2=f"{held[0]:.3e}",
            dropped_assignments=held[1], tokens_held=held[4])
        check(held[0] <= tol, f"moe_ep: nccl {mode} {key} differs from the "
              f"reference by {held[0]:.3e} (relative L2)")

    ranks = _spawn(_moe_ep_rank, root)
    models = [r["model"] for r in ranks]
    for key in xs:
        want_y = want[key].reshape(-1, cfg.d_model)
        for mode in EP_LAYER_MODES:
            runs = [r["runs"][mode, key] for r in ranks]
            ys = [run["y"] for run in runs]
            check(all(torch.equal(y, ys[0]) for y in ys),
                  f"moe_ep: {mode} {key}: the ranks' outputs differ")
            y = ys[0].reshape(-1, cfg.d_model)
            if mode == "allgather":
                rel = _rel_l2(y, want_y)
                held = (rel, 0, 0, int((runs[0]["ids"][0].sort(-1)[0]
                                        != want_ids[key].sort(-1)[0])
                                       .any(-1).sum()), want_y.shape[0])
            else:
                held = _held_rows(y, want_y,
                                  _chunk_rows(runs, "ids", models)[0],
                                  want_ids[key],
                                  _chunk_rows(runs, "dropped", models)[0], k)
            say("moe_ep", group=repr(GLOO), mode=mode, input=key,
                ms_per_layer=f"{runs[0]['ms']:.3f}",
                rel_l2_held=f"{held[0]:.3e}", tol=tol,
                dropped_assignments=held[1], tokens_dropped=held[2],
                routes_differing=held[3],
                tokens_held=f"{held[4]}/{want_y.shape[0]}")
            check(held[4] > 0 and held[0] <= tol,
                  f"moe_ep: {mode} {key}: {held[0]:.3e} from the reference "
                  f"over {held[4]} tokens (relative L2)")
        fused = [r["runs"]["fused", key]["y"] for r in ranks]
        per_axis = [r["runs"]["alltoall", key]["y"] for r in ranks]
        check(all(torch.equal(a, b) for a, b in zip(fused, per_axis)),
              f"moe_ep: {key}: fused_a2a differs from the per-axis "
              "all-to-alls")
    say("moe_ep", fused_a2a_bit_equal=True,
        rank_expert_gb=json.dumps([round(r["expert_bytes"] / 1e9, 2)
                                   for r in ranks]),
        rank_peak_gb=json.dumps([round(r["peak_gb"], 2) for r in ranks]))


# arctic at full width through the model with ep: 2 of its 35 layers (13.4
# GB of experts a rank, 15.2 GB with the replicated weights); prefill in
# allgather mode (no drops), decode in alltoall mode (1 token a rank: a
# bucket of 4 slots cannot overflow)
MOE_EP_ROWS, MOE_EP_PROMPT, MOE_EP_STEPS, MOE_EP_LEN = 4, 256, 4, 512


def _ep_model(cfg, experts: range) -> dict:
    """arctic's weights with only ``experts`` in the expert tables: the
    replicated ones from ``api.init`` of a one-expert config (the same on
    every rank), the router and experts as in ``_ep_layer``."""
    base = dataclasses.replace(cfg, num_experts=1)
    params = model_api.build(base).init(
        torch.Generator(device=DEV).manual_seed(EP_SEED))
    tables = params["blocks"]["moe"]
    for k in EXPERT_LEAVES:
        del tables[k]
    tables["router"] = _router(cfg, stack=cfg.num_layers)
    tables.update(moe.init_experts(cfg, experts, EP_SEED, DEV,
                                   stack=cfg.num_layers))
    return params


def _ep_prompt(cfg):
    prompt = torch.as_tensor(np.random.default_rng(EP_SEED).integers(
        0, cfg.vocab_size, (MOE_EP_ROWS, MOE_EP_PROMPT)), dtype=torch.int32,
        device=DEV)
    lengths = torch.full((MOE_EP_ROWS,), MOE_EP_PROMPT, dtype=torch.int32,
                         device=DEV)
    return prompt, lengths


def _ep_generate(api, params, cfg, eps=(None, None), tokens_in=None):
    """api.prefill of the prompt, then ``MOE_EP_STEPS`` decode steps
    (teacher-forced by ``tokens_in``): the logits and tokens, and the
    prefill's and the decode steps' wall ms."""
    prompt, lengths = _ep_prompt(cfg)
    cache = api.init_cache(MOE_EP_ROWS, MOE_EP_LEN, DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = api.prefill(params, cache, prompt, lengths, ep=eps[0])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    outs, toks = [logits], []
    for step in range(MOE_EP_STEPS):
        tok = logits.argmax(-1).to(torch.int32) if tokens_in is None \
            else tokens_in[step].to(DEV)
        toks.append(tok)
        logits, cache = api.decode(params, cache, tok, lengths, ep=eps[1])
        outs.append(logits)
        lengths = lengths + 1
    torch.cuda.synchronize()
    ms = ((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3 / MOE_EP_STEPS)
    return outs, toks, ms


def _model_moe_ep_rank(rank: int, root: str) -> None:
    mesh, rules = _rank_setup()
    cfg = dataclasses.replace(get_config(ARCTIC), **MOE_CUTS[ARCTIC])
    eps = (_ep_info(mesh, rules, ep_mode="allgather"),
           _ep_info(mesh, rules))
    api = model_api.build(cfg)
    params = _ep_model(cfg, _own_experts(eps[1], cfg))
    toks = torch.load(Path(root) / "tokens.pt")
    _zero_counts()
    with _Routes() as routes:
        outs, _, ms = _ep_generate(api, params, cfg, eps, toks)
    torch.cuda.synchronize()
    counts = _counts()
    torch.save({"logits": [o.cpu() for o in outs],
                "ids": [i.cpu() for i in routes.ids], "counts": counts,
                "model": eps[1].coord((eps[1].seq_split_axis,)),
                "ms": ms, "bytes": _bytes(params),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9},
               Path(root) / f"rank{rank}.pt")


def phase_model_moe_ep() -> None:
    """arctic-480b at full width, 2 of 35 layers, through api.prefill (4
    rows of 256 tokens) and 4 api.decode steps with ``ep`` over 4 gloo
    ranks on the (1, 4) worker mesh, each rank holding its 32 experts a
    layer and running attention through the kernels (both launch in every
    rank, tensor-core variants only). First a single-process run of the
    same weights (all 128 experts, 54.9 GB), routes kept, then freed; the
    ranks are teacher-forced with its tokens and their logits held on the
    outputs whose token kept its routes (``MODEL_TOL``), as model_moe
    holds them."""
    cfg = dataclasses.replace(get_config(ARCTIC), **MOE_CUTS[ARCTIC])
    root = _dist_dir("model_moe_ep")
    api = model_api.build(cfg)
    params = _ep_model(cfg, range(cfg.num_experts))
    full_gb = _bytes(params) / 1e9
    with _Routes() as routes:
        want, toks, ref_ms = _ep_generate(api, params, cfg)
    want_ids = [i.cpu() for i in routes.ids]
    want = [w.cpu() for w in want]
    torch.save([t.cpu() for t in toks], root / "tokens.pt")
    del params
    _release()
    ranks = _spawn(_model_moe_ep_rank, root)
    models = [r["model"] for r in ranks]
    layers = cfg.num_layers
    # the ranks' routes: the prefill's (allgather: every token on every
    # rank) from rank 0, each decode step's joined from the ranks' chunks
    got_ids = ranks[0]["ids"][:layers] + _chunk_rows(
        [{"ids": r["ids"][layers:]} for r in ranks], "ids", models)
    widths = [MOE_EP_PROMPT] + [1] * MOE_EP_STEPS
    flips, keep = _route_flips([i.to(DEV) for i in got_ids],
                               [i.to(DEV) for i in want_ids], MOE_EP_ROWS,
                               widths, layers)
    rel, held = _held_logit_error([g.to(DEV) for g in ranks[0]["logits"]],
                                  [w.to(DEV) for w in want], keep)
    spread = max((a - b).abs().max().item() for r in ranks[1:]
                 for a, b in zip(r["logits"], ranks[0]["logits"]))
    for r, out in enumerate(ranks):
        c = out["counts"]
        say("model_moe_ep", rank=r, chunked_prefill=c["chunked_prefill"],
            paged_attention=c["paged_attention"],
            weights_gb=f"{out['bytes'] / 1e9:.2f}",
            peak_gb=f"{out['peak_gb']:.2f}",
            prefill_ms=f"{out['ms'][0]:.1f}",
            decode_ms_per_step=f"{out['ms'][1]:.1f}")
        for name in ("chunked_prefill", "paged_attention"):
            got = c[name]
            check(got["tensor_core"] > 0
                  and sum(got.values()) == got["tensor_core"],
                  f"model_moe_ep: rank {r}: {name} launched {got}, want "
                  "its tensor_core variant only")
    finite = all(torch.isfinite(g).all().item() for g in ranks[0]["logits"])
    say("model_moe_ep", arch=ARCTIC, layers=layers, cut="2 of 35 layers",
        single_process_gb=f"{full_gb:.1f}", transport=repr(GLOO),
        single_process_prefill_ms=f"{ref_ms[0]:.1f}",
        single_process_decode_ms_per_step=f"{ref_ms[1]:.1f}",
        routes=MOE_EP_ROWS * sum(widths) * layers, routes_differing=flips,
        outputs_held=f"{held}/{MOE_EP_ROWS * len(widths)}",
        logits_rel_l2_held=f"{rel:.3e}", tol=MODEL_TOL[torch.bfloat16],
        ranks_max_abs_spread=f"{spread:.3e}")
    check(finite, "model_moe_ep: non-finite logits")
    check(held > 0, "model_moe_ep: every output's route flipped")
    check(rel <= MODEL_TOL[torch.bfloat16], f"model_moe_ep: logits of rows "
          f"whose routes agree differ by {rel:.3e} (relative L2)")


def _shard_restore_rank(rank: int, root: str) -> None:
    mesh, rules = _rank_setup()
    cfg = get_config(ARCH)
    target = model_api.build(cfg).init(MetaGenerator())
    specs = sharding.param_specs(cfg, target, rules)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = checkpoint.restore(Path(root) / "ckpt", 0, target, DEV,
                             shardings=specs, mesh=mesh)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    full = checkpoint.restore(Path(root) / "ckpt", 0, target, "cpu")
    coords = {a: mesh.get_local_rank(a) for a in mesh.mesh_dim_names}
    flat_got, flat_full, flat_spec = (dict(_leaf_items(t))
                                      for t in (got, full, specs))
    differ, local, sharded = [], 0, 0
    for key, dt in flat_got.items():
        want = flat_full[key][sharding.local_slices(
            tuple(dt.shape), flat_spec[key], mesh, coords)].contiguous()
        mine = dt.to_local().cpu().contiguous()
        if not torch.equal(mine.view(torch.uint8), want.view(torch.uint8)):
            differ.append("/".join(key))
        local += mine.numel() * mine.element_size()
        sharded += mine.numel() < flat_full[key].numel()
    table = ("embed", "table")
    placed = distribute_tensor(flat_full[table].to(DEV), mesh,
                               sharding.to_placements(flat_spec[table], mesh),
                               src_data_rank=None)
    torch.save({"differ": differ, "local_bytes": local, "sharded": sharded,
                "leaves": len(flat_got), "seconds": seconds,
                "distribute_same": torch.equal(
                    placed.to_local(), flat_got[table].to_local())},
               Path(root) / f"rank{rank}.pt")


def phase_shard_restore() -> None:
    """Full-width qwen2-1.5b (bf16, random weights from a seed) saved by
    ``train.checkpoint.save``, then restored on 4 gloo ranks under
    ``param_specs`` for the (1, 4) worker mesh, each rank reading only its
    slices (``restore(shardings=, mesh=)``): every rank's local shard of
    every leaf equals that slice of the saved tensor byte for byte, and
    ``distribute_tensor(src_data_rank=None)`` of the whole embedding on
    the card slices it the same way; the local bytes a rank holds against
    the replicated size."""
    cfg = get_config(ARCH)
    root = _dist_dir("shard_restore")
    params = model_api.build(cfg).init(
        torch.Generator(device=DEV).manual_seed(EP_SEED))
    full = _bytes(params)
    t0 = time.perf_counter()
    checkpoint.save(root / "ckpt", 0, params)
    save_s = time.perf_counter() - t0
    del params
    _release()
    ranks = _spawn(_shard_restore_rank, root)
    for r, out in enumerate(ranks):
        say("shard_restore", rank=r, local_gb=f"{out['local_bytes'] / 1e9:.3f}",
            replicated_gb=f"{full / 1e9:.3f}",
            share=f"{out['local_bytes'] / full:.3f}",
            leaves_sharded=f"{out['sharded']}/{out['leaves']}",
            restore_s=f"{out['seconds']:.2f}", save_s=f"{save_s:.2f}",
            distribute_same=out["distribute_same"])
        check(not out["differ"], f"shard_restore: rank {r}: {out['differ']} "
              "differ from their slices of the saved tensors")
        check(out["distribute_same"], f"shard_restore: rank {r}: "
              "distribute_tensor slices the embedding otherwise")
        check(out["local_bytes"] < full, f"shard_restore: rank {r} holds "
              "the whole model")


# ------------------------------------------------------------- dry-run

# one full-width cell a family, traced on the host on the 16 x 16 mesh
DRYRUN_CELLS = (("qwen2-1.5b", "decode_32k"), ("arctic-480b", "decode_32k"),
                ("rwkv6-7b", "long_500k"), ("zamba2-2.7b", "prefill_32k"),
                ("whisper-medium", "prefill_32k"),
                ("paligemma-3b", "train_4k"))


def phase_dryrun() -> None:
    """The port's dry-run (``launch.dryrun.run_cell``) of one cell a family
    at full width on the ``single`` mesh: this process as rank 0 of a fake
    group of 256, parameters, cache and inputs meta DTensors, nothing on
    the card. Every cell must end ``ok``; each prints its bytes a device,
    dot FLOPs, collective wire bytes, dominant roofline term (H100 peaks)
    and trace seconds."""
    try:
        for arch, shape in DRYRUN_CELLS:
            rec = dryrun.run_cell(arch, shape, "single", EP_DIR, force=True,
                                  write=False)
            check(rec["status"] == "ok", f"dryrun: {arch} {shape}: "
                  f"{rec.get('error')}")
            say("dryrun", arch=arch, shape=shape,
                bytes_per_device=f"{rec['bytes_per_device']:.6e}",
                dot_flops=f"{rec['cost']['dot_flops']:.6e}",
                wire_total=f"{rec['collectives']['wire_total']:.6e}",
                dominant=rec["roofline"]["dominant"],
                param_collectives=sum(rec["param_collectives"].values()),
                trace_s=rec["lower_s"])
    finally:
        dryrun.release_group()


# dryrun_check: (arch, config changes, prefill (rows, tokens), decode steps,
# cache rows, EP modes of the prefill and the decode)
CHECK_CELLS = {
    "qwen2": (ARCH, {}, (4, 1024), 8, 1088, None),
    "arctic": (ARCTIC, MOE_CUTS[ARCTIC], (4, 256), 4, 320,
               ("allgather", "alltoall")),
}
MEM_TOL = 0.02
QWEN2_SHARD_GB = 0.805           # shard_restore's measured local bytes a rank


def _check_shapes(name: str) -> tuple:
    _, _, (rows, n), steps, cache_len, _ = CHECK_CELLS[name]
    return (dict(kind="prefill", seq=n, batch=rows, cache_len=cache_len),
            dict(kind="decode", seq=cache_len, batch=rows))


def _check_cfg(name: str):
    arch, cut = CHECK_CELLS[name][:2]
    return dataclasses.replace(get_config(arch), **cut)


def _check_eps(name: str, mesh, rules):
    """The prefill's and the decode's EPInfo (None for a dense model)."""
    modes = CHECK_CELLS[name][5]
    if modes is None:
        return None, None
    cf = _check_cfg(name).moe_capacity_factor
    return tuple(_ep_info(mesh, rules, capacity_factor=cf, ep_mode=m)
                 for m in modes)


def _check_weights(name: str, experts: Optional[range] = None) -> dict:
    cfg = _check_cfg(name)
    if cfg.is_moe:
        return _ep_model(cfg, experts if experts is not None
                         else range(cfg.num_experts))
    return model_api.build(cfg).init(
        torch.Generator(device=DEV).manual_seed(EP_SEED))


def _check_prompt(name: str):
    cfg = _check_cfg(name)
    rows, n = CHECK_CELLS[name][2]
    prompt = torch.as_tensor(np.random.default_rng(EP_SEED).integers(
        0, cfg.vocab_size, (rows, n)), dtype=torch.int32, device=DEV)
    return prompt, torch.full((rows,), n, dtype=torch.int32, device=DEV)


def _place_tree(tree, specs, mesh, shapes=None):
    """``models.tp.place`` of a tree of whole tensors; a leaf shaped
    otherwise than its ``shapes`` twin is already this rank's shard (an
    expert table of its own experts) and is wrapped as it is."""
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh,
                               None if shapes is None else shapes[k])
                for k, v in tree.items()}
    if shapes is not None and tuple(shapes.shape) != tuple(tree.shape):
        return DTensor.from_local(
            tree, mesh, sharding.to_placements(specs, mesh),
            run_check=False, shape=shapes.shape, stride=shapes.stride())
    return tp.place(tree, specs, mesh)


_FUNCTIONAL = ("all_reduce", "all_gather_into_tensor",
               "reduce_scatter_tensor", "all_to_all_single")


class _HostStaged(hloanalysis.LocalOps):
    """Every functional collective a rank issues on CUDA tensors (DTensor's
    redistributions, the ``local_map`` regions' gathers) runs on host
    copies: gloo's all-gather into a CUDA tensor crashes the process
    (SIGSEGV, torch 2.11), while the EP path's ``torch.distributed`` calls
    already stage their CUDA tensors through the host. Entered outside
    ``StepCost``, which then counts the op on the rank's CUDA tensors as
    the trace counts it on meta ones."""

    def local_op(self, func, args, kwargs):
        if func.namespace == "_c10d_functional" and \
                func._schema.name.split("::")[-1] in _FUNCTIONAL and \
                args[0].is_cuda:
            host = func(args[0].cpu(), *args[1:], **kwargs)
            host = torch.ops._c10d_functional.wait_tensor(host)
            return host.to(args[0].device)
        return func(*args, **kwargs)


def _dryrun_check_rank(rank: int, root: str, name: str) -> None:
    with _HostStaged():
        _dryrun_check_run(rank, root, name)


def _dryrun_check_run(rank: int, root: str, name: str) -> None:
    """One rank of the sharded run: its weights, cache and inputs placed
    as DTensors under the specs, the memory they take, then the prefill
    and the decode steps under ``StepCost`` (the prefill and the first
    decode step counted, the rest timed) with the kernels' launches
    counted."""
    mesh, rules = _rank_setup()
    cfg = _check_cfg(name)
    api = model_api.build(cfg)
    eps = _check_eps(name, mesh, rules)
    steps, cache_len = CHECK_CELLS[name][3:5]
    rows = CHECK_CELLS[name][2][0]
    toks = torch.load(Path(root) / "tokens.pt")
    shapes = api.init(MetaGenerator())
    pspecs = sharding.param_specs(cfg, shapes, rules)
    base = torch.cuda.memory_allocated()
    experts = _own_experts(eps[1], cfg) if cfg.is_moe else None
    params = _place_tree(_check_weights(name, experts), pspecs, mesh,
                         shapes if cfg.is_moe else None)
    _release()
    cache = api.init_cache(rows, cache_len, DEV)
    cspecs = sharding.cache_specs(cfg, rules, rows, cache)
    cache = _place_tree(cache, cspecs, mesh)
    prompt, lengths = _check_prompt(name)
    io = sharding.io_specs(cfg, rules, rows)
    place = lambda t, key: tp.place(t, io[key] if t.dim() == len(io[key])  # noqa: E731
                                    else sharding.spec(io[key][0]), mesh)
    inputs = {"tokens": place(prompt, "tokens"),
              "lengths": place(lengths, "lengths")}
    _release()
    placed = torch.cuda.memory_allocated() - base
    logits_spec = sharding.spec(sharding.batch_spec(rules, rows), None)
    p_bytes = float(tp.local_bytes(params))
    c_bytes = float(tp.local_bytes(cache))

    def step(fn, *args):
        logits, out_cache = fn(params, cache, *args)
        return (tp.respec(logits, logits_spec, mesh),
                tp.respec(out_cache, cspecs, mesh))

    _zero_counts()
    counted, outs = {}, []
    with _Routes() as routes:
        with hloanalysis.StepCost(params=params) as cost, tp.step_context():
            logits, cache = step(lambda p, c, t, n: api.prefill(
                p, c, t, n, ep=eps[0]), inputs["tokens"], inputs["lengths"])
        counted["prefill"] = cost
        outs.append(logits.full_tensor().cpu())
        pos = lengths.clone()
        dec_ms = []
        for i in range(steps):
            tok = place(toks[i].to(DEV), "lengths")
            n = place(pos, "lengths")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                with hloanalysis.StepCost(params=params) as cost, \
                        tp.step_context():
                    logits, cache = step(lambda p, c, t, n: api.decode(
                        p, c, t, n, ep=eps[1]), tok, n)
                counted["decode"] = cost
            else:
                with tp.step_context():
                    logits, cache = step(lambda p, c, t, n: api.decode(
                        p, c, t, n, ep=eps[1]), tok, n)
                torch.cuda.synchronize()
                dec_ms.append((time.perf_counter() - t0) * 1e3)
            outs.append(logits.full_tensor().cpu())
            pos = pos + 1
    torch.cuda.synchronize()
    launches = _counts()
    # the steps' peak memory, after the warm-up above (one-time allocations,
    # the cuBLAS workspace among them, fall before it): one prefill and one
    # decode step, each from a peak reset just before it
    del logits
    tok, n = place(toks[0].to(DEV), "lengths"), place(pos, "lengths")
    runs = {"prefill": (lambda p, c, t, n: api.prefill(p, c, t, n, ep=eps[0]),
                        inputs["tokens"], inputs["lengths"]),
            "decode": (lambda p, c, t, n: api.decode(p, c, t, n, ep=eps[1]),
                       tok, n)}
    step_memory = {}
    for kind, (fn, *args) in runs.items():
        gc.collect()
        torch.cuda.synchronize()
        start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with tp.step_context():
            out = step(fn, *args)
        torch.cuda.synchronize()
        step_memory[kind] = {"start": start,
                             "peak": torch.cuda.max_memory_allocated()}
        del out
    torch.save({
        "placed_bytes": placed, "param_bytes": p_bytes, "cache_bytes": c_bytes,
        "step_memory": step_memory,
        "cost": {k: {"flops": c.result()["flops"],
                     "kernel_op_flops": dict(c.op_flops),
                     "collectives": c.result()["collectives"],
                     "param_counts": dict(c.param_counts),
                     "kernel_calls": c.kernel_calls}
                 for k, c in counted.items()},
        "logits": outs, "launches": launches,
        "ids": [i.cpu() for i in routes.ids],
        "model": eps[1].coord((eps[1].seq_split_axis,)) if eps[1] else 0,
        "decode_ms": statistics.median(dec_ms) if dec_ms else None,
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9},
        Path(root) / f"rank{rank}.pt")


def _predict(name: str) -> dict:
    """The trace of the check's prefill and decode cells on a fake group
    of 4 with the worker mesh's shape (meta DTensors, nothing on the
    card)."""
    dryrun.fake_group(EP_WORLD)
    try:
        mesh = mesh_launch.make_mesh((1, EP_WORLD), ("data", "model"), "cuda")
        rules = sharding.make_rules(mesh)
        eps = _check_eps(name, mesh, rules)
        out = {}
        for (kind, shape), ep in zip(zip(("prefill", "decode"),
                                         _check_shapes(name)), eps):
            rec = dryrun.run_cell(CHECK_CELLS[name][0], f"check_{kind}",
                                  "1x4", EP_DIR, force=True, write=False,
                                  shape=shape, mesh=mesh,
                                  cfg=_check_cfg(name),
                                  ep_fn=lambda _, ep=ep: ep)
            check(rec["status"] == "ok", f"dryrun_check: trace of {name} "
                  f"{kind}: {rec.get('error')}")
            out[kind] = rec
        return out
    finally:
        dryrun.release_group()


def _check_step_memory(name: str, rank: int, kind: str, got: dict,
                       rec: dict) -> None:
    """One rank's measured step peak (``torch.cuda.max_memory_allocated``
    from a reset just before the step) against the trace's predicted peak
    (``bytes_per_device_incl_cpu_temps``: the arguments' bytes plus the
    high-water mark of the step's buffers), and the bytes the step itself
    allocated (peak - start) against that high-water mark."""
    mem = rec["memory"]
    want, temps = rec["bytes_per_device_incl_cpu_temps"], \
        mem["temp_size_in_bytes"]
    tol = max(STEP_MEM_TOL * temps, STEP_MEM_FLOOR)
    own = mem["step_allocated_peak_bytes"]
    own_tol = OWN_MEM_TOL * own + OWN_MEM_FLOOR
    say("dryrun_check", model=name, rank=rank, step=kind,
        start_bytes=got["start"],
        predicted_start_bytes=int(sum(mem["arguments"].values())),
        peak_bytes=got["peak"], predicted_peak_bytes=int(want),
        measured_transient_bytes=got["peak"] - got["start"],
        predicted_step_allocated_bytes=int(mem["step_allocated_peak_bytes"]),
        predicted_temp_bytes=int(temps), tol_bytes=int(tol),
        own_tol_bytes=int(own_tol), peak_at=mem["peak_at"])
    check(abs(got["peak"] - want) <= tol,
          f"dryrun_check: {name} rank {rank} {kind}: step peak "
          f"{got['peak']} bytes, the trace's {want:.0f} (tolerance "
          f"{tol:.0f})")
    check(abs(got["peak"] - got["start"] - own) <= own_tol,
          f"dryrun_check: {name} rank {rank} {kind}: the step allocated "
          f"{got['peak'] - got['start']} bytes at its peak, the trace "
          f"{own:.0f} (tolerance {own_tol:.0f})")


def _check_one(name: str) -> None:
    cfg = _check_cfg(name)
    rows, n = CHECK_CELLS[name][2]
    steps, cache_len = CHECK_CELLS[name][3:5]
    pred = _predict(name)
    for kind, rec in pred.items():
        say("dryrun_check", model=name, predicted=kind,
            bytes_per_device=f"{rec['bytes_per_device']:.6e}",
            arguments=rec["memory"]["arguments"],
            dot_flops=f"{rec['cost']['dot_flops']:.6e}",
            wire_total=f"{rec['collectives']['wire_total']:.6e}",
            counts=rec["collective_counts"], trace_s=rec["lower_s"])
    # the single-process run of the same weights, then freed
    root = _dist_dir(f"dryrun_check_{name}")
    api = model_api.build(cfg)
    params = _check_weights(name)
    prompt, lengths = _check_prompt(name)
    cache = api.init_cache(rows, cache_len, DEV)
    with _Routes() as routes:
        want, toks, _ = _generate(api, params, cache, prompt, lengths,
                                  steps)
    want_ids = [i.cpu() for i in routes.ids]
    want = [w.float().cpu() for w in want]
    torch.save([t.cpu() for t in toks], root / "tokens.pt")
    del params, cache
    _release()
    ranks = _spawn(_dryrun_check_rank, root, name)
    for r, out in enumerate(ranks):
        mem = pred["prefill"]["memory"]
        want_args = mem["argument_size_in_bytes"]
        got = out["placed_bytes"]
        say("dryrun_check", model=name, rank=r,
            placed_bytes=got, predicted_arguments=want_args,
            param_gb=f"{out['param_bytes'] / 1e9:.4f}",
            cache_gb=f"{out['cache_bytes'] / 1e9:.4f}",
            peak_gb=f"{out['peak_gb']:.2f}",
            decode_ms_per_step=f"{out['decode_ms']:.1f}",
            transport=repr(GLOO))
        check(abs(got - want_args) <= MEM_TOL * want_args,
              f"dryrun_check: {name} rank {r}: {got} bytes placed, the "
              f"trace's arguments {want_args}")
        check(out["param_bytes"] == mem["arguments"]["params"]
              and out["cache_bytes"] == mem["arguments"]["cache"],
              f"dryrun_check: {name} rank {r}: local params / cache bytes "
              f"{out['param_bytes']} / {out['cache_bytes']} against the "
              f"trace's {mem['arguments']}")
        if name == "qwen2":
            check(abs(out["param_bytes"] / 1e9 - QWEN2_SHARD_GB) < 0.0005,
                  f"dryrun_check: qwen2's parameters take "
                  f"{out['param_bytes'] / 1e9:.4f} GB a rank, shard_restore "
                  f"measured {QWEN2_SHARD_GB}")
        for kind, rec in pred.items():
            c = out["cost"][kind]
            check(sum(c["param_counts"].values()) == 0,
                  f"dryrun_check: {name} rank {r} {kind}: collectives on a "
                  f"parameter {c['param_counts']}")
            check(c["flops"] == rec["cost"]["dot_flops"],
                  f"dryrun_check: {name} rank {r} {kind}: {c['flops']} dot "
                  f"FLOPs, the trace's {rec['cost']['dot_flops']}")
            coll = {k: v for k, v in c["collectives"].items()
                    if k != "counts"}
            check(c["collectives"]["counts"] == rec["collective_counts"]
                  and coll == rec["collectives"],
                  f"dryrun_check: {name} rank {r} {kind}: collectives "
                  f"{c['collectives']} against the trace's "
                  f"{rec['collectives']} {rec['collective_counts']}")
            say("dryrun_check", model=name, rank=r, step=kind,
                dot_flops=f"{c['flops']:.6e}",
                wire_total=f"{c['collectives']['wire_total']:.6e}",
                counts=c["collectives"]["counts"], matches_trace=True,
                kernel_calls=sorted({str(k) for k in c["kernel_calls"]}))
        for kind, rec in pred.items():
            _check_step_memory(name, r, kind, out["step_memory"][kind], rec)
        for kname in ("chunked_prefill", "paged_attention"):
            got = out["launches"][kname]
            check(got["tensor_core"] > 0
                  and sum(got.values()) == got["tensor_core"],
                  f"dryrun_check: {name} rank {r}: {kname} launched {got}, "
                  "want its tensor_core variant only")
    got = [g.to(DEV) for g in ranks[0]["logits"]]
    wanted = [w.to(DEV) for w in want]
    if cfg.is_moe:
        layers = cfg.num_layers
        models = [r["model"] for r in ranks]
        got_ids = ranks[0]["ids"][:layers] + _chunk_rows(
            [{"ids": r["ids"][layers:]} for r in ranks], "ids", models)
        widths = [n] + [1] * steps
        flips, keep = _route_flips([i.to(DEV) for i in got_ids],
                                   [i.to(DEV) for i in want_ids], rows,
                                   widths, layers)
        rel, held = _held_logit_error(got, wanted, keep)
        say("dryrun_check", model=name, routes_differing=flips,
            outputs_held=f"{held}/{rows * len(widths)}")
        check(held > 0, "dryrun_check: every output's route flipped")
    else:
        rel = max(((g - w).norm() / w.norm()).item()
                  for g, w in zip(got, wanted))
    spread = max((a - b).abs().max().item() for r in ranks[1:]
                 for a, b in zip(r["logits"], ranks[0]["logits"]))
    say("dryrun_check", model=name, logits_rel_l2=f"{rel:.3e}",
        tol=MODEL_TOL[torch.bfloat16], ranks_max_abs_spread=f"{spread:.3e}")
    check(all(torch.isfinite(g).all().item() for g in got),
          f"dryrun_check: {name}: non-finite logits")
    check(rel <= MODEL_TOL[torch.bfloat16], f"dryrun_check: {name}: logits "
          f"differ from the single-process run by {rel:.3e} (relative L2)")


def phase_dryrun_check() -> None:
    """The trace's prediction against a real sharded run: 4 gloo ranks on
    the one card, CUDA DTensors on the (1, 4) worker mesh. Full-width
    qwen2-1.5b (a prefill of 4 rows x 1024 tokens, 8 decode steps; its 12
    query heads split 3 a rank over the one KV head they read, the KV
    cache split along its rows) and arctic-480b cut to 2 of 35 layers
    (4 x 256, 4 decode steps; heads split 14 / 2 a rank, experts 32 a
    rank). Each is first traced (``_predict``) and run single-process
    (freed before the ranks start). Each rank must place the bytes the
    trace's arguments reckon (within ``MEM_TOL``; qwen2's parameters at
    shard_restore's 0.805 GB), count the trace's dot FLOPs and its
    collectives by kind, count and bytes exactly, take no collective on a
    parameter, launch the tensor-core attention kernels only, and give the
    single-process logits (``MODEL_TOL``; arctic on the outputs whose
    routes agree)."""
    for name in CHECK_CELLS:
        _check_one(name)
        _release()


# the stateful families' serve phases: eager, host-bound steps, where host
# work a change adds shows first (``kernel_ab.py --serve`` runs these)
STATEFUL_SERVES = ("serve_rwkv", "serve_zamba2")


def serve_table() -> tuple:
    """Every serve phase, in order: (phase, arch, kernels, the launch
    variants each kernel must show[, config changes]), ``phase_serve``'s
    arguments after the card."""
    attention = {"chunked_prefill": chunked_prefill,
                 "paged_attention": paged_attention}
    tensor_cores = dict.fromkeys(attention, ("tensor_core",))
    tensor_cores_e4m3 = dict.fromkeys(attention, ("tensor_core_e4m3",))
    fp8 = {"kv_cache_quant": True}
    return (
        ("serve", ARCH, attention, tensor_cores),
        ("serve_rwkv", RWKV, {"wkv6": wkv6}, {"wkv6": ("chunk", "decode")}),
        ("serve_gemma2", GEMMA2, attention, tensor_cores),
        ("serve_fp8", ARCH, attention, tensor_cores_e4m3, fp8),
        ("serve_gemma2_fp8", GEMMA2, attention, tensor_cores_e4m3, fp8),
        ("serve_moe", ARCTIC, attention | {"moe_experts": moe_experts},
         tensor_cores | {"moe_experts": tuple(moe_experts.KERNELS)},
         MOE_CUTS[ARCTIC]),
        ("serve_vlm", PALIGEMMA, attention, tensor_cores),
        ("serve_zamba2", ZAMBA2, attention, tensor_cores),
        # gemma2 past its 4096-token window on the serve path: long-context
        # traffic into slots of 8192 tokens (26 layers x K and V x 4 KV
        # heads x 256 x 2 bytes = 106,496 bytes a token, 0.872 GB a slot,
        # 6.98 GB for a worker's 8 slots)
        ("serve_gemma2_long", GEMMA2, attention, tensor_cores, None,
         {"scenario": "longctx", "rate": 1.0, "max_len": 8192,
          "max_prompt": 6144, "max_output": 128, "past": 4096}))


def run_phase(name: str, fn, *args):
    """``fn(*args)``, a line with the phase's seconds, then what the phase
    left freed (``_release``)."""
    t0 = time.perf_counter()
    out = fn(*args)
    say(name, phase_seconds=f"{time.perf_counter() - t0:.1f}")
    _release()
    return out


def main() -> None:
    t0 = time.perf_counter()
    card = phase_device()
    run_phase("build", phase_build)
    records = run_phase("kernels", phase_kernels, card)
    run_phase("model", phase_model)
    run_phase("model_rwkv", phase_model_rwkv)
    run_phase("model_gemma2", phase_model, "model_gemma2")
    run_phase("model_fp8", phase_model, "model_fp8")
    run_phase("model_moe", phase_model_moe)
    vlm_launches = run_phase("model_vlm", phase_model_vlm)
    run_phase("model_zamba2", phase_model_zamba2)
    whisper_launches = run_phase("model_whisper", phase_model_whisper)
    ring_records, ring_launches = run_phase("model_ring", phase_model_ring,
                                            card)
    store_records, store_launches = run_phase("paged_store",
                                              phase_paged_store, card)
    records |= ring_records | store_records
    run_phase("executor", phase_executor, card)
    run_phase("executor_rwkv", phase_executor_stateful, card, RWKV,
              "executor_rwkv", (wkv6,))
    run_phase("executor_zamba2", phase_executor_stateful, card, ZAMBA2,
              "executor_zamba2", (chunked_prefill, paged_attention))
    run_phase("graphs", phase_graphs, card, ARCH)
    run_phase("graphs_gemma2", phase_graphs, card, GEMMA2)
    fp8 = {"kv_cache_quant": True}
    profiled = run_phase("profile", phase_profile, card)
    run_phase("profile_gemma2", phase_profile, card, GEMMA2,
              "profile_gemma2")
    run_phase("profile_fp8", phase_profile, card, ARCH, "profile_fp8", fp8)
    run_phase("profile_moe", phase_profile, card, ARCTIC, "profile_moe",
              MOE_CUTS[ARCTIC])
    run_phase("profile_zamba2", phase_profile_stateful, card, ZAMBA2,
              "profile_zamba2")
    run_phase("calibrate", phase_calibrate, card, profiled)
    launches = {"model_ring": ring_launches, "paged_store": store_launches,
                "model_vlm": vlm_launches, "model_whisper": whisper_launches}
    for phase, *args in serve_table():
        launches[phase] = run_phase(phase, phase_serve, card, phase, *args)
    run_phase("quickstart", phase_quickstart)
    run_phase("train", phase_train, card)
    run_phase("train_families", phase_train_families)
    run_phase("moe_ep", phase_moe_ep)
    run_phase("model_moe_ep", phase_model_moe_ep)
    run_phase("shard_restore", phase_shard_restore)
    run_phase("dryrun", phase_dryrun)
    run_phase("dryrun_check", phase_dryrun_check)
    # a record's launches: its device kernel's on its main path (the e4m3
    # records' on the same path with the fp8 cache)
    main = {"chunked_prefill": ("serve", "chunked_prefill.tensor_core"),
            "paged_attention": ("serve", "paged_attention.tensor_core"),
            "paged_attention_1slot": ("serve", "paged_attention.tensor_core"),
            "wkv6": ("serve_rwkv", "wkv6.chunk"),
            "wkv6_decode": ("serve_rwkv", "wkv6.decode"),
            "chunked_prefill_gemma2": ("serve_gemma2",
                                       "chunked_prefill.tensor_core"),
            "paged_attention_gemma2": ("serve_gemma2",
                                       "paged_attention.tensor_core"),
            "paged_attention_gemma2_long": ("serve_gemma2",
                                            "paged_attention.tensor_core")}
    main |= {f"{name}_e4m3": (f"{phase}_fp8", f"{key}_e4m3")
             for name, (phase, key) in main.items() if "wkv6" not in name}
    # the ring's and the store's records: their own phases' decode runs
    for name, phase in (("paged_attention_ring", "model_ring"),
                        ("paged_attention_store", "paged_store")):
        main[name] = (phase, "paged_attention.tensor_core")
        main[f"{name}_e4m3"] = (phase, "paged_attention.tensor_core_e4m3")
    # arctic's and paligemma's decode on their serve paths; paligemma's
    # prefix prefill in model_vlm (the serve path prefills text only)
    main |= {"paged_attention_arctic": ("serve_moe",
                                        "paged_attention.tensor_core"),
             "paged_attention_paligemma": ("serve_vlm",
                                           "paged_attention.tensor_core"),
             "chunked_prefill_paligemma": ("model_vlm",
                                           "chunked_prefill.tensor_core")}
    # zamba2's shared attention on its serve path (the tensor-core
    # variants at D = 80); whisper's decoder decode in model_whisper (the
    # executors refuse encdec, as the JAX executor cannot serve it)
    main |= {"chunked_prefill_zamba2": ("serve_zamba2",
                                        "chunked_prefill.tensor_core"),
             "paged_attention_zamba2": ("serve_zamba2",
                                        "paged_attention.tensor_core"),
             "paged_attention_whisper": ("model_whisper",
                                         "paged_attention.tensor_core")}
    kernels = []
    for name, r in records.items():
        phase, key = main[name]
        kernels.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "variant")} | {
            "launches": launches[phase][key], "launches_in": phase,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "shape": r["shape"]} | {
            k: r[k] for k in ("library_note", "widen_ms", "splits")
            if k in r})
    print(json.dumps({"kernels": kernels}))
    say("done", seconds=f"{time.perf_counter() - t0:.1f}")
    print(f"nvidia-smi: {smi()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
