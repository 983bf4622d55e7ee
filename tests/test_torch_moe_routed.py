"""PyTorch port, the routed expert products' arithmetic on the CPU
(``kernels/moe_experts.py``'s plain versions in ``kernels/ref.py``, the
kernels themselves in ``test_torch_moe_routed_card.py``): the lists (each
held expert's count and offset, the held picks of the live rows in (expert,
token) order, each pick's place); the plain op equal to the dense dispatch
(``moe._expert_sum``) with every row live and exactly 0 on the rows that are
not; what the kernels take (the SMOKE configurations' f32 and narrow widths
among it); ``apply_moe_reference`` taking the op wherever no gradient is
tracked, on the CPU too, and the dense dispatch with gradients elsewhere;
and the executor, whose steps mark the rows a request reads, serving the
same tokens with that mask as with every row live."""
import dataclasses
import re
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.core.request import Request, SLOSpec
from repro_torch.kernels import cost, moe_experts, ops, ref
from repro_torch.models import api as tapi
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.layers import ExpertShare, ModelConfig
from repro_torch.serving.engine import IterationPlan
from repro_torch.serving.executor import ClusterRealExecutors

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from servebench import weights  # noqa: E402
from servebench.cells import Config  # noqa: E402

D, F, GROUP = 32, 16, 1 << 25

# (experts the router scores, held tables, first held id, top-k)
SHARES = {"arctic_like": (32, 8, 8, 2), "whole": (8, 8, 0, 2),
          "kimi_like": (48, 16, 32, 8)}


def _routes(t, router, k, seed):
    """Gates (T, k) f32 and k distinct ids (T, k) a token, as a top-k
    gives them."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.rand((t, router), generator=g).argsort(-1)[:, :k]
    gates = torch.softmax(torch.randn((t, k), generator=g), -1)
    return gates, ids


def _tables(n, seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return tuple((torch.randn(s, generator=g) * 0.3).to(dtype)
                 for s in ((n, D, F), (n, D, F), (n, F, D)))


@pytest.mark.parametrize("live_share", [1.0, 0.6, 0.0])
@pytest.mark.parametrize("share", sorted(SHARES))
def test_lists_sort_the_live_held_picks_by_expert_then_token(share,
                                                             live_share):
    router, held, first, k = SHARES[share]
    t = 37
    _, ids = _routes(t, router, k, seed=1)
    live = torch.rand(t, generator=torch.Generator().manual_seed(2)) \
        < live_share
    counts, offsets, tok, place = ref.moe_lists(ids, live, first, held)
    local = ids - first
    mine = (local >= 0) & (local < held) & live[:, None]
    assert counts.tolist() == [int((local[mine] == e).sum())
                               for e in range(held)]
    assert offsets.tolist() == [int(counts[:e].sum()) for e in range(held)]
    assert tok.numel() == int(mine.sum())
    for e in range(held):
        seg = tok[offsets[e]:offsets[e] + counts[e]].tolist()
        assert seg == sorted(seg) and len(set(seg)) == len(seg)
        assert all(bool((ids[s] == first + e).any()) for s in seg)
    place = place.reshape(t, k)
    assert torch.equal(place >= 0, mine)
    for tt, j in mine.nonzero().tolist():
        p = int(place[tt, j])
        assert int(tok[p]) == tt
        e = int((offsets <= p).nonzero().max())     # the segment holding p
        assert int(ids[tt, j]) == first + e
    assert (place[~live] == -1).all()


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("share", sorted(SHARES))
def test_plain_op_is_the_dense_dispatch_and_zero_where_not_live(share, dtype,
                                                                act):
    router, held, first, k = SHARES[share]
    t = 23
    tabs = _tables(held, 3, dtype)
    x = torch.randn((t, D), generator=torch.Generator().manual_seed(4)) \
        .to(dtype)
    gates, ids = _routes(t, router, k, seed=5)
    cfg = ModelConfig(name="t", family="moe", num_layers=1, d_model=D,
                      num_heads=1, num_kv_heads=1, head_dim=D, d_ff=F,
                      vocab_size=8, num_experts=held, top_k=k,
                      mlp_activation=act, dtype=dtype)
    combine = TM.held_combine(gates, ids, range(first, first + held))
    dense = TM._expert_sum(x, *tabs, combine, held, cfg).to(dtype)
    every = ops.moe_experts_op(x, *tabs, gates, ids, None, first, router,
                               act, GROUP)
    assert torch.equal(every, dense)
    live = torch.arange(t) % 3 != 1
    some = ops.moe_experts_op(x, *tabs, gates, ids, live, first, router, act,
                              GROUP)
    assert torch.equal(some[live], dense[live])
    assert torch.equal(some[~live], torch.zeros_like(some[~live]))


def test_the_op_refuses_inputs_that_require_grad_and_reports_its_cost(
        monkeypatch):
    tabs = _tables(4, 6)
    x = torch.randn((5, D), requires_grad=True)
    gates, ids = _routes(5, 4, 2, seed=7)
    with pytest.raises(ValueError, match="requires grad"):
        ops.moe_experts_op(x, *tabs, gates, ids, None, 0, 4, "silu", GROUP)
    seen = []
    monkeypatch.setattr(cost, "LISTENERS", [type("L", (), {
        "add_op": staticmethod(lambda *a: seen.append(a[:3]))})()])
    ops.moe_experts_op(x.detach(), *tabs, gates, ids, None, 0, 4, "silu",
                       GROUP)
    table_bytes = 3 * 4 * D * F * 4
    assert seen == [("moe_experts", 6.0 * 5 * 4 * D * F,
                     table_bytes + 2 * 5 * D * 4)]
    with pytest.raises(ValueError, match="activation"):
        moe_experts.check_moe_experts(x.detach(), *tabs, gates, ids, None,
                                      "relu")
    narrow = (torch.zeros(4, D, 12), torch.zeros(4, D, 12),
              torch.zeros(4, 12, D))
    with pytest.raises(ValueError, match="multiples"):
        moe_experts.check_moe_experts(x.detach().bfloat16(),
                                      *(w.bfloat16() for w in narrow), gates,
                                      ids, None, "silu")
    with pytest.raises(ValueError, match="not supported"):
        moe_experts.check_moe_experts(x.detach().half(),
                                      *(w.half() for w in tabs), gates, ids,
                                      None, "silu")


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t"])
def test_the_kernels_take_the_smoke_configs(arch, dtype):
    """The SMOKE configurations serve on the card through the kernels: f32
    (their own dtype) at any width, bf16 at widths in 16-byte rows
    (arctic's d_ff 96, kimi's 64)."""
    cfg = configs.get_smoke(arch)
    dtype = dtype or cfg.dtype
    d, f, n, k = cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.top_k
    tabs = (torch.zeros(n, d, f, dtype=dtype), torch.zeros(n, d, f,
                                                           dtype=dtype),
            torch.zeros(n, f, d, dtype=dtype))
    gates, ids = _routes(6, n, k, seed=12)
    code = moe_experts.check_moe_experts(
        torch.zeros(6, d, dtype=dtype), *tabs, gates, ids,
        torch.ones(6, dtype=torch.bool), cfg.mlp_activation)
    assert code == {torch.float32: 0, torch.bfloat16: 1}[dtype]


def test_exported_kernel_names_are_the_sources_kernels():
    """The names chip_smoke.py's profile matches device time by are the
    ``__global__`` functions of ``csrc/moe_experts.cu``, one a pass."""
    src = moe_experts.LIB.source.read_text()
    kernels = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
        src))
    assert set(moe_experts.KERNELS.values()) == kernels
    assert moe_experts.launches_by_variant.keys() == \
        moe_experts.KERNELS.keys()
    assert moe_experts in ops.COUNTED


# (tokens, top-k, experts the router picks among, BN): arctic's decode and
# prefill (the held 32 are a quarter of the 128, each as loaded), kimi's
# decode, a whole table set
@pytest.mark.parametrize("tokens,k,experts,want", [
    (64, 2, 128, 8), (64, 8, 384, 8), (512, 2, 128, 16), (128, 2, 32, 16),
    (2048, 2, 128, 64), (1, 2, 128, 8)])
def test_the_token_tile_follows_the_mean_load(tokens, k, experts, want):
    assert moe_experts.token_tile(tokens, k, experts) == want


def _tiny_share(first=8, held=8):
    cfg = ModelConfig(name="tiny-moe", family="moe", num_layers=1, d_model=D,
                      num_heads=4, num_kv_heads=2, head_dim=8, d_ff=F,
                      vocab_size=64, num_experts=held, top_k=2,
                      moe_dense_residual_ff=24, norm_eps=1e-5,
                      tie_embeddings=False, dtype=torch.float32)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return ExpertShare(**fields, routed_experts=32, first_expert=first)


def test_apply_moe_reference_routes_only_without_gradients(monkeypatch):
    cfg = _tiny_share()
    params = tapi.build(cfg).init(torch.Generator().manual_seed(8))
    moe = TT.with_layer_views(params)["layers"][0]["moe"]
    x = torch.randn((2, 5, D), generator=torch.Generator().manual_seed(9))
    calls = []
    real_op, real_sum = ops.moe_experts_op, TM._expert_sum
    monkeypatch.setattr(ops, "moe_experts_op",
                        lambda *a: (calls.append("routed"), real_op(*a))[1])
    monkeypatch.setattr(TM, "_expert_sum",
                        lambda *a: (calls.append("dense"), real_sum(*a))[1])
    with torch.no_grad():
        routed = TM.apply_moe_reference(moe, x, cfg)
    trained = {k: v.detach().clone().requires_grad_() for k, v in moe.items()}
    dense = TM.apply_moe_reference(trained, x, cfg)
    assert calls == ["routed", "dense"]
    dense.square().sum().backward()
    assert all(trained[k].grad is not None and trained[k].grad.abs().sum() > 0
               for k in ("router", "w_gate", "w_up", "w_down"))
    assert torch.equal(routed, dense.detach())


def test_a_probe_mask_of_the_wrong_rows_raises():
    cfg = _tiny_share()
    params = tapi.build(cfg).init(torch.Generator().manual_seed(8))
    moe = TT.with_layer_views(params)["layers"][0]["moe"]
    with TM.probe(live=torch.ones(3, dtype=torch.bool)), \
            pytest.raises(ValueError, match="live mask"):
        TM.apply_moe_reference(moe, torch.zeros((2, 5, D)), cfg)


ARCTIC = {"name": "tiny-arctic-routed", "arch": "arctic",
          "num_hidden_layers": 2, "hidden_size": 64,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "intermediate_size": 32, "vocab_size": 512, "rope_theta": 10000.0,
          "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
          "torch_dtype": "float32", "hidden_act": "silu",
          "num_local_experts": 16, "held_experts": 8,
          "held_expert_first": 4, "num_experts_per_tok": 2,
          "parallel_attn_mlp_res": True, "residual_mlp_ffn_dim": 64}


def _req(rid, prompt_len):
    return Request(rid=rid, arrival_time=0.0, prompt_len=prompt_len,
                   output_len=16, slo=SLOSpec(ttft=30.0, tpot=5.0))


def _plan(prefill=(), decode=()):
    pp = [(r, int(t)) for r, t in prefill]
    dr = list(decode)
    return IterationPlan(
        decode_reqs=dr, prefill_parts=pp, n_decode=len(dr),
        sum_ctx=float(sum(r.prompt_len for r in dr)),
        prefill_tokens=int(sum(t for _, t in pp)),
        prefill_ctx_offset=0.0, exclusive_prefill=not dr)


def _serve(masked: bool, monkeypatch):
    """Tokens of a held-share cluster's iterations: prefills of 3 parts (a
    4th row repeats row 0), chunked and mixed, then decodes of 3 of 8
    slots, the routed op's plain version taking each step's live mask, or
    (``masked`` False) every row; and the (live, rows) of each mask."""
    seen = []
    real = ops.moe_experts_op

    def op(*a):
        seen.append((int(a[6].sum()), a[6].numel()))
        return real(*a) if masked else real(*a[:6], None, *a[7:])

    monkeypatch.setattr(ops, "moe_experts_op", op)
    config = Config(ARCTIC)
    params = weights.make(config.layout(), 11, "cpu")
    execs = ClusterRealExecutors(config.port_config(), 1, max_slots=8,
                                 max_len=64, warmup=False, device="cpu",
                                 params=params)
    backend = execs.as_backend()
    a, b, c = _req(0, 20), _req(1, 9), _req(2, 40)
    plans = [_plan(prefill=[(a, 20), (b, 9), (c, 24)]),
             _plan(prefill=[(c, 16)], decode=[a, b])]
    plans += [_plan(decode=[a, b, c])] * 4
    for plan in plans:
        backend.run_iteration(type("W", (), {"wid": 0})(), plan)
        for r, t in plan.prefill_parts:
            r.prefilled_tokens += t
    e = execs.execs[0]
    monkeypatch.undo()
    return [e.generated[r] for r in range(3)], seen


def test_the_executor_serves_the_same_tokens_with_the_live_mask(monkeypatch):
    masked, seen = _serve(True, monkeypatch)
    every, _ = _serve(False, monkeypatch)
    assert masked == every and all(len(g) == 6 for g in masked[:2])
    # each layer of each step took a mask; the prefill's 4 rows of 32 hold
    # 20 + 9 + 24 taken positions and row 0's 20 again; decodes 3 of 8
    assert (20 + 9 + 24 + 20, 4 * 32) in seen and (3, 8) in seen
