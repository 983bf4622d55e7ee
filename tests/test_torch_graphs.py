"""PyTorch port, the executor's CUDA graphs and what they rest on, on the
CPU: the step-wide rope and block tables give logits bit-equal to the
per-layer recompute; per-layer parameter views are built once per params
object; the launch accounting that replays add to the wrappers' counts,
checked with stand-in counters; and the graphed executor's bookkeeping
(one graph per cache and key, captured at warmup or at first use,
replayed in another order) with a stand-in for ``torch.cuda``'s capture
that runs the step, against the eager executor's token streams. The
graphs themselves run on the card (``chip_smoke.py``'s ``graphs``
phase)."""
import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serving import executor as texec  # noqa: E402
from repro_torch.serving.engine import IterationPlan  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402


# ------------------------------------------------- step-wide tables


def _per_layer_run(params, cache, x, cfg, *, positions, mask,
                   cache_positions, lengths=None):
    """The blocks as before the step-wide tables: each layer's attention
    computes its own rope tables (for q and for k) and block table."""
    for i, window in enumerate(T.layer_windows_py(cfg)):
        x, _ = T._block_fn(
            T._layer(params["blocks"], i), x, cfg, positions=positions,
            mask=mask, window=window, kv=(cache["k"][i], cache["v"][i]),
            cache_positions=cache_positions, lengths=lengths)
    return x


def _old_prefill_chunk(params, cache, chunk, starts, cfg, take):
    x = TL.embed(params["embed"], chunk, cfg)
    sc = x.shape[1]
    positions = starts.long()[:, None] + torch.arange(sc)[None]
    x = _per_layer_run(params, cache, x, cfg, positions=positions,
                       mask=TL.MaskSpec("chunk"), cache_positions=starts,
                       lengths=starts)
    return T._last_logits(params, x, (take.long() - 1).clamp(0, sc - 1), cfg)


def _old_decode(params, cache, tokens, lengths, cfg):
    x = TL.embed(params["embed"], tokens[:, None], cfg)
    x = _per_layer_run(params, cache, x, cfg, positions=lengths.long()[:, None],
                       mask=TL.MaskSpec("lengths"), cache_positions=lengths,
                       lengths=lengths)
    x = TL.apply_norm(params["final_norm"], x, cfg)
    return TL.unembed(params["embed"], x, cfg)[:, 0]


@pytest.mark.parametrize("arch,dtype,fp8", [
    ("qwen2-1.5b", torch.float32, False),
    ("qwen2-1.5b", torch.bfloat16, False),
    ("gemma2-2b", torch.float32, False),
    ("qwen2-1.5b", torch.bfloat16, True)])
def test_step_tables_give_bit_equal_logits(arch, dtype, fp8):
    """``prefill_chunk`` and ``decode`` (rope tables built once a step,
    the decode's block table once, per-layer views once per params object)
    against the per-layer recompute: logits and caches bit for bit."""
    cfg = dataclasses.replace(get_smoke(arch), dtype=dtype,
                              kv_cache_quant=fp8)
    api = tapi.build(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    b, max_len = 2, 32
    new, old = (api.init_cache(b, max_len, "cpu") for _ in range(2))
    chunk = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, 12))
                             .astype(np.int32))
    starts = torch.tensor([0, 3], dtype=torch.int32)
    take = torch.tensor([12, 9], dtype=torch.int32)
    got, _ = api.prefill_chunk(api.prepare(params), new, chunk, starts,
                               take=take)
    want = _old_prefill_chunk(params, old, chunk, starts, cfg, take)
    assert torch.equal(got, want)
    lengths = starts + take
    for _ in range(3):
        tok = got.argmax(-1).to(torch.int32)
        got, _ = api.decode(params, new, tok, lengths)
        want = _old_decode(params, old, tok, lengths, cfg)
        assert torch.equal(got, want)
        lengths = lengths + 1
    for k in ("k", "v"):
        assert torch.equal(new[k].view(torch.uint8), old[k].view(torch.uint8))


def test_layer_views_are_built_once_per_params_object():
    cfg = get_smoke("qwen2-1.5b")
    api = tapi.build(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    prepared = api.prepare(params)
    assert api.prepare(prepared) is prepared and "layers" not in params
    layers = prepared["layers"]
    assert len(layers) == cfg.num_layers
    wq = params["blocks"]["attn"]["wq"]
    for i, lp in enumerate(layers):
        assert lp["attn"]["wq"].data_ptr() == wq[i].data_ptr()
    execs = ClusterRealExecutors(cfg, 2, max_len=64, warmup=False,
                                 device="cpu", params=params)
    assert all(e.params is execs.params for e in execs.execs.values())
    assert execs.params["layers"] is not None


# ------------------------------------------------------- launch accounting


def _counter(**variants):
    return SimpleNamespace(launches=sum(variants.values()),
                           launches_by_variant=dict(variants))


def _launch(module, variant, n=1):
    module.launches += n
    module.launches_by_variant[variant] += n


def test_launch_tally_adds_a_capture_per_replay():
    """What the calls inside ``record`` counted is taken back off the
    counters (a capture launches nothing) and added once per replay, per
    variant; counts made outside stay as they were."""
    pre = _counter(cuda_core=2, tensor_core=5)
    dec = _counter(cuda_core=0, tensor_core=1)
    wkv = _counter(chunk=4, decode=0)
    tally = ops.LaunchTally((pre, dec, wkv))

    def step():
        _launch(pre, "tensor_core")
        for _ in range(28):
            _launch(dec, "tensor_core")
        return "out"

    assert tally.record(step) == "out"
    assert (pre.launches, dec.launches, wkv.launches) == (7, 1, 4)
    assert pre.launches_by_variant == {"cuda_core": 2, "tensor_core": 5}
    for _ in range(3):
        tally.replay()
    _launch(pre, "cuda_core", 2)               # an eager launch in between
    tally.replay()
    assert pre.launches_by_variant == {"cuda_core": 4, "tensor_core": 9}
    assert dec.launches_by_variant == {"cuda_core": 0,
                                       "tensor_core": 1 + 4 * 28}
    assert (pre.launches, dec.launches, wkv.launches) == (13, 113, 4)
    assert wkv.launches_by_variant == {"chunk": 4, "decode": 0}


def test_launch_tally_counts_the_wrapper_modules_by_default():
    assert ops.LaunchTally().modules == ops.COUNTED
    for m in ops.COUNTED:
        assert isinstance(m.launches, int)
        assert set(m.launches_by_variant) == set(m.KERNELS)


# ----------------------------------------------------- graphed executor


def _req(rid, prompt_len):
    return Request(rid=rid, arrival_time=0.0, prompt_len=prompt_len,
                   output_len=8, slo=SLOSpec(ttft=30.0, tpot=5.0))


def _plan(prefill=(), decode=()):
    pp = [(r, int(t)) for r, t in prefill]
    dr = list(decode)
    return IterationPlan(
        decode_reqs=dr, prefill_parts=pp, n_decode=len(dr),
        sum_ctx=float(sum(r.prompt_len for r in dr)),
        prefill_tokens=int(sum(t for _, t in pp)),
        prefill_ctx_offset=0.0, exclusive_prefill=not dr)


def _drive(execs):
    """tests/test_torch_executor.py's workload: multi-chunk, 2-row and
    left-padded buckets, mixed iterations, a migration, decode on both
    workers."""
    e0, e1 = execs.execs[0], execs.execs[1]
    a, b, c, d = _req(0, 24), _req(1, 40), _req(2, 16), _req(3, 33)

    def step(ex, **kw):
        plan = _plan(**kw)
        ex.run_plan(plan)
        for r, t in plan.prefill_parts:
            r.prefilled_tokens += t

    step(e0, prefill=[(a, 16)])
    step(e0, prefill=[(a, 8), (b, 24)])
    step(e0, prefill=[(b, 16)], decode=[a])
    step(e1, prefill=[(d, 33)])
    step(e0, decode=[a, b])
    execs.migrate(b, 0, 1)
    step(e0, prefill=[(c, 16)], decode=[a])
    step(e1, decode=[b, d])
    step(e1, decode=[d, b])
    step(e0, decode=[c, a])
    return {0: list(e0.generated[0]), 1: list(e1.generated[1]),
            2: list(e0.generated[2]), 3: list(e1.generated[3])}


def _cluster(fp8=False):
    cfg = dataclasses.replace(get_smoke("qwen2-1.5b"), kv_cache_quant=fp8)
    params = tapi.build(cfg).init(torch.Generator().manual_seed(0))
    return ClusterRealExecutors(cfg, 2, max_slots=4, max_len=64,
                                warmup=False, device="cpu", params=params)


class _StandInCapture:
    """``capture_cuda_graph`` for the CPU: runs the step at capture and
    again, into the same output, at each replay; records the pools and
    the order of captures and replays."""

    def __init__(self):
        self.pools, self.events = [], []

    def __call__(self, fn, pool):
        self.pools.append(pool)
        out = fn()
        n = len(self.pools)
        self.events.append(("capture", n))

        def replay():
            self.events.append(("replay", n))
            out.copy_(fn())

        return replay, out


@pytest.mark.parametrize("fp8", [False, True])
def test_graphed_executor_replays_one_graph_per_cache_and_key(monkeypatch,
                                                              fp8):
    want = _drive(_cluster(fp8))                 # the eager CPU path
    stand_in = _StandInCapture()
    monkeypatch.setattr(texec, "capture_cuda_graph", stand_in)
    execs = _cluster(fp8)
    k = execs.kernels
    assert not k.graphed and k.captures == 0
    k.graphed, k._pool = True, ("pool", 1)       # as on a CUDA device
    k.warmup(execs.params, [e.cache for e in execs.execs.values()])
    n_buckets = len(k.buckets)
    assert (k.prefill_traces, k.decode_traces) == (2 * n_buckets, 2)
    for e in execs.execs.values():             # zeroed after the captures
        assert not e.cache["k"].view(torch.uint8).any()
    warm_events = len(stand_in.events)
    got = _drive(execs)
    assert got == want
    # keys first used in the drive: worker 0's (32, 2) two-row bucket
    assert (k.prefill_traces, k.decode_traces) == (2 * n_buckets + 1, 2)
    assert set(stand_in.pools) == {("pool", 1)}
    keys = {gk[1:] for gk in k._graphs}
    assert len(keys) == k.captures
    assert {gk[3] for gk in k._graphs if gk[1] == execs.execs[0]
            .cache["k"].data_ptr()} >= {("decode",), ("prefill", 32, 2)}
    captured = [n for kind, n in stand_in.events if kind == "capture"]
    first = list(dict.fromkeys(n for kind, n in stand_in.events[warm_events:]
                               if kind == "replay"))
    assert first != sorted(first)              # not in capture order
    assert set(first) <= set(captured)


def test_capture_runs_with_the_garbage_collector_off(monkeypatch):
    """A collection during a capture could destroy another graph, which a
    capturing stream does not permit: ``capture_cuda_graph`` turns the
    collector off around it (checked with stand-ins for torch.cuda's graph
    and capture context)."""
    import contextlib
    import gc

    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda g, pool: contextlib.nullcontext())
    assert gc.isenabled()
    replay, out = texec.capture_cuda_graph(gc.isenabled, "pool")
    assert out is False and gc.isenabled()
    with pytest.raises(ZeroDivisionError):
        texec.capture_cuda_graph(lambda: 1 / 0, "pool")
    assert gc.isenabled()


def test_cpu_executor_runs_eagerly_and_captures_nothing(monkeypatch):
    monkeypatch.setattr(texec, "capture_cuda_graph",
                        lambda fn, pool: pytest.fail("captured on the CPU"))
    execs = _cluster()
    k = execs.kernels
    k.warmup(execs.params, [e.cache for e in execs.execs.values()])
    _drive(execs)
    assert not k.graphed and k.captures == 0 and not k._graphs
    assert k.input_shapes(("prefill", 64, 4)) == [(4, 64), (4,), (4,), (4,)]
    assert k.input_shapes(("decode",)) == [(4,), (4,)]
