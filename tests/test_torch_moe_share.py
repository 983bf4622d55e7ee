"""PyTorch port, a share of the experts on one card (``layers.ExpertShare``,
``moe.apply_moe_reference`` over held tables): the shares of a layer add
up to the uncut layer, in the port and in the benchmark's plain reference
(``servebench/reference/arctic.py``); the port's held-share model is that
reference's, prefill then decode through the cache; holding every expert
changes nothing; and the MoE counts the executor returns with its tokens
(``moe.Probe``) are exact."""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.request import Request, SLOSpec
from repro_torch.models import api as tapi
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.layers import ExpertShare, ModelConfig
from repro_torch.serving import executor as texec
from repro_torch.serving.engine import IterationPlan
from repro_torch.serving.executor import ClusterRealExecutors

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from servebench import weights  # noqa: E402
from servebench.cells import Config  # noqa: E402
from servebench.reference import arctic as ref  # noqa: E402
from servebench.reference import llama as llama_ref  # noqa: E402

E, K, D, F = 8, 2, 32, 16
SHARES = 4
TOL = dict(rtol=1e-5, atol=1e-5)
# a logit held where every routing margin at its position is at least this
# (ROADMAP, "Near-ties"): f32 on the CPU moves a router logit by ~1e-6
ROUTE_MARGIN = 1e-4
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)


def _whole(**kw) -> ModelConfig:
    base = dict(name="tiny-moe", family="moe", num_layers=2, d_model=D,
                num_heads=4, num_kv_heads=2, head_dim=8, d_ff=F,
                vocab_size=64, num_experts=E, top_k=K,
                moe_dense_residual_ff=24, norm_eps=1e-5,
                tie_embeddings=False, dtype=torch.float32)
    base.update(kw)
    return ModelConfig(**base)


def _share(cfg: ModelConfig, first: int, n: int) -> ExpertShare:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["num_experts"] = n
    return ExpertShare(**fields, routed_experts=cfg.num_experts,
                       first_expert=first)


def _cut(moe: dict, held: range, axis: int = 0) -> dict:
    """The whole MoE weights cut to the experts ``held`` (along ``axis``:
    1 for a stack of layers)."""
    return {k: v if k == "router" else v.narrow(axis, held.start, len(held))
            for k, v in moe.items()}


def _layer_params(cfg, seed=0):
    return tapi.build(cfg).init(torch.Generator().manual_seed(seed))


def _layer0(params):
    return TT.with_layer_views(params)["layers"][0]


def _shares(cfg):
    n = cfg.num_experts // SHARES
    return [_share(cfg, i * n, n) for i in range(SHARES)]


# ------------------------------------------------------- the shares add up


def test_port_layer_shares_add_up_to_the_uncut_moe():
    cfg = _whole()
    moe = _layer0(_layer_params(cfg))["moe"]
    x = torch.randn(3, 5, D, generator=torch.Generator().manual_seed(1))
    whole = TM.apply_moe_reference(moe, x, cfg)
    parts = [TM.apply_moe_reference(_cut(moe, s.expert_ids), x, s)
             for s in _shares(cfg)]
    assert torch.allclose(sum(parts), whole, **TOL)
    assert all(p.abs().max() > 0 for p in parts)


def test_port_block_shares_add_up_with_attention_and_mlp_once():
    """Each share's block: the stream, attention and the residual MLP once
    in each, and its own experts' part; their parts (each less the block
    with no expert part) add up to the uncut block."""
    cfg = _whole(num_layers=1)
    params = _layer_params(cfg)
    x = torch.randn(2, 6, D, generator=torch.Generator().manual_seed(2))
    pos = torch.arange(6)[None].expand(2, 6)

    def block(c, moe):
        p = dict(params, blocks=dict(params["blocks"], moe=moe))
        cache = tapi.build(c).init_cache(2, 16, "cpu")
        out, pending = TT._run_blocks(
            p, x, c, positions=pos, mask=TT.MaskSpec("causal"), cache=cache,
            cache_positions=torch.zeros(2, dtype=torch.int32))
        return out if pending is None else out + pending

    moe = params["blocks"]["moe"]
    base = block(cfg, dict(moe, w_down=torch.zeros_like(moe["w_down"])))
    parts = [block(s, _cut(moe, s.expert_ids, axis=1)) - base
             for s in _shares(cfg)]
    assert torch.allclose(base + sum(parts), block(cfg, moe), **TOL)
    assert all(p.abs().max() > 0 for p in parts)


def _ref_arch(first, n):
    return ref.Arch(layers=1, d_model=D, heads=4, kv_heads=2, head_dim=8,
                    d_ff=F, vocab=64, rope_theta=1e4, norm_eps=1e-5,
                    experts=n, top_k=K, dense_residual_ff=24, routed=E,
                    first=first)


def test_reference_shares_add_up_to_the_uncut_moe():
    g = torch.Generator().manual_seed(3)
    p = {"router": torch.randn(1, D, E, generator=g),
         "w_gate": torch.randn(1, E, D, F, generator=g),
         "w_up": torch.randn(1, E, D, F, generator=g),
         "w_down": torch.randn(1, E, F, D, generator=g)}
    x = torch.randn(9, D, generator=g)
    whole_arch = llama_ref.Arch(layers=1, d_model=D, heads=4, kv_heads=2,
                                head_dim=8, d_ff=F, vocab=64,
                                rope_theta=1e4, norm_eps=1e-5, experts=E,
                                top_k=K, dense_residual_ff=24)
    ops = llama_ref._Ops("f32")
    whole, margin = llama_ref._moe(ops, p, 0, x, whole_arch)
    n = E // SHARES
    total = torch.zeros_like(x)
    for i in range(SHARES):
        held = {k: v if k == "router" else v[:, i * n:(i + 1) * n]
                for k, v in p.items()}
        part, m = ref._moe(ops, held, 0, x, _ref_arch(i * n, n))
        assert torch.equal(m, margin)
        total += part
    assert torch.allclose(total, whole, **TOL)


# ------------------------------------------------ the port and the reference


ARCTIC = {"name": "tiny-arctic-share", "arch": "arctic",
          "num_hidden_layers": 2, "hidden_size": 64,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "intermediate_size": 32, "vocab_size": 512, "rope_theta": 10000.0,
          "rms_norm_eps": 1e-5, "tie_word_embeddings": False,
          "torch_dtype": "float32", "hidden_act": "silu",
          "num_local_experts": 16, "held_experts": 4,
          "num_experts_per_tok": 2, "parallel_attn_mlp_res": True,
          "residual_mlp_ffn_dim": 64}


@pytest.mark.parametrize("first", [0, 8, 12])
def test_port_held_share_matches_the_reference(first):
    config = Config(dict(ARCTIC, held_expert_first=first))
    params = weights.make(config.layout(), 11 + first, "cpu")
    cfg = config.port_config()
    assert isinstance(cfg, ExpertShare)
    assert cfg.expert_ids == range(first, first + 4)
    assert params["blocks"]["moe"]["router"].shape == (2, 64, 16)
    assert params["blocks"]["moe"]["w_gate"].shape == (2, 4, 64, 32)
    api = tapi.build(cfg)
    prepared = api.prepare(params)
    n, steps = 19, 6
    prompt = np.random.default_rng(first).integers(0, 512, n)
    cache = api.init_cache(1, 64, "cpu")
    logits, cache = api.prefill(
        prepared, cache, torch.as_tensor(prompt[None], dtype=torch.int32),
        torch.tensor([n], dtype=torch.int32))
    port, served = [logits[0]], [int(logits[0].argmax())]
    for step in range(steps):
        logits, cache = api.decode(
            prepared, cache, torch.tensor([served[-1]], dtype=torch.int32),
            torch.tensor([n + step], dtype=torch.int32))
        port.append(logits[0])
        served.append(int(logits[0].argmax()))
    seq = torch.as_tensor(np.concatenate([prompt, served[:-1]]))
    margins: list = []
    (want,) = ref.logits(params, ref.arch(config.raw), [seq], [n - 1],
                         margins=margins)
    keep = margins[0] >= ROUTE_MARGIN
    assert keep.sum() >= len(keep) - 1
    got = torch.stack(port)
    assert torch.allclose(got[keep], want[keep], **LOGIT_TOL)
    # the share is the whole model whose absent experts give nothing (the
    # same routes), and not the whole model with experts in their place
    whole = dict(config.raw, held_expert_first=0)

    def whole_logits(others):
        return llama_ref.logits(_grown(params, first, others),
                                llama_ref.arch(whole), [seq], [n - 1])[0]
    assert torch.allclose(whole_logits(0.0), want, **TOL)
    assert (whole_logits(1.0) - want).abs().max() > 1e-3


def _grown(params, first, others: float):
    """``params`` with the held tables at their ids in tables of all 16
    experts, the other experts' tables ``others`` times random ones."""
    moe = params["blocks"]["moe"]
    g = torch.Generator().manual_seed(7)
    grown = dict(moe)
    for k in ("w_gate", "w_up", "w_down"):
        v = moe[k]
        t = torch.randn((v.shape[0], 16) + tuple(v.shape[2:]), generator=g,
                        dtype=v.dtype) * v.std() * others
        t[:, first:first + 4] = v
        grown[k] = t
    return dict(params, blocks=dict(params["blocks"], moe=grown))


# ------------------------------------------------- holding every expert


def _apply_moe_reference_before(params, x, cfg):
    """``moe.apply_moe_reference`` as it was before shares: the combine by
    a scatter-add over every physical expert."""
    b, s, d = x.shape
    e_phys = params["w_gate"].shape[0]
    xt = x.reshape(b * s, d)
    gates, ids = TM.route(params["router"], xt, cfg.top_k, e_phys)
    combine = torch.zeros((xt.shape[0], e_phys), dtype=torch.float32)
    combine.scatter_add_(1, ids, gates)
    out = TM._expert_sum(xt, params["w_gate"], params["w_up"],
                         params["w_down"], combine, cfg.num_experts, cfg)
    return out.to(x.dtype).reshape(b, s, d) + TM._shared_expert(params, x,
                                                                cfg)


@pytest.mark.parametrize("kw", [{}, {"expert_pad_to": 6},
                                {"dtype": torch.bfloat16},
                                {"num_shared_experts": 1}])
def test_every_expert_held_is_bit_for_bit_the_old_layer(kw):
    cfg = _whole(**kw)
    moe = _layer0(_layer_params(cfg))["moe"]
    x = torch.randn(2, 7, D, generator=torch.Generator().manual_seed(4)) \
        .to(cfg.dtype)
    before = _apply_moe_reference_before(moe, x, cfg)
    assert torch.equal(TM.apply_moe_reference(moe, x, cfg), before)
    assert torch.equal(TM.apply_moe(moe, x, cfg), before)
    if not kw.get("expert_pad_to"):
        share = _share(cfg, 0, E)
        assert (share.router_width, share.expert_ids) == (E, range(E))
        assert torch.equal(TM.apply_moe_reference(moe, x, share), before)


def test_share_init_draws_the_held_tables_and_a_whole_router():
    cfg = _share(_whole(), 2, 3)
    p = TM.init_moe(torch.Generator().manual_seed(0), cfg, stack=2)
    assert p["router"].shape == (2, D, E) and p["router"].dtype == \
        torch.float32
    assert p["w_gate"].shape == (2, 3, D, F)
    whole = TM.init_experts(_whole(), range(E), 5, "cpu", stack=2)
    mine = TM.init_experts(cfg, cfg.expert_ids, 5, "cpu", stack=2)
    for k in ("w_gate", "w_up", "w_down"):
        assert torch.equal(mine[k], whole[k][:, 2:5])
    assert TM.whole_experts(cfg) == E
    with pytest.raises(ValueError):
        _share(_whole(), 6, 3)
    with pytest.raises(ValueError):
        TM.apply_moe(p, torch.zeros(1, 1, D), cfg, ep=object())


# ----------------------------------------------------------- the counts


def test_probe_counts_a_hand_built_routing_exactly():
    pr = TM.Probe()
    # held experts 4..7 of 8; token 3 is not live
    ids = torch.tensor([[4, 0], [5, 4], [1, 2], [7, 6], [3, 0]])
    pr.routes.append((ids, range(4, 8)))
    pr.routes.append((torch.tensor([[0, 1]] * 5), range(4, 8)))
    live = torch.tensor([True, True, True, False, True])
    got = pr.counts(live).reshape(2, 3).tolist()
    # layer 0: held 4, 5, 4 -> 3 assignments, experts {4, 5}; 4 live x 2
    assert got == [[3, 2, 8], [0, 0, 8]]


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


def test_executor_counts_ride_with_the_tokens_in_one_transfer(monkeypatch):
    """A held-share cluster's steps append each MoE layer's counts to
    their tokens: one host transfer an iteration, the tokens those of a
    cluster that counts nothing, and the counts those of the routes the
    layers took over the live tokens."""
    calls = []
    real = texec._to_host
    monkeypatch.setattr(texec, "_to_host",
                        lambda t: (calls.append(1), real(t))[1])
    config = Config(dict(ARCTIC, held_expert_first=4))
    params = weights.make(config.layout(), 3, "cpu")
    cfg = config.port_config()
    execs = ClusterRealExecutors(cfg, 1, max_slots=4, max_len=64,
                                 warmup=False, device="cpu", params=params)
    backend = execs.as_backend()
    routes = []
    orig = TM.Probe.counts
    monkeypatch.setattr(TM.Probe, "counts", lambda self, live: (
        routes.append(([ids for ids, _ in self.routes], live)),
        orig(self, live))[1])
    e = execs.execs[0]
    a, b = _req(0, 20), _req(1, 9)
    plans = [_plan(prefill=[(a, 20), (b, 9)]), _plan(decode=[a, b]),
             _plan(decode=[a])]
    for plan in plans:
        backend.run_iteration(type("W", (), {"wid": 0})(), plan)
        for r, t in plan.prefill_parts:
            r.prefilled_tokens += t
    assert len(calls) == 3 and len(backend.moe_counts) == 3
    assert backend.moe_expert_seconds == 0.0          # nothing timed here
    # the same tokens as a run that routes through the port's plain path
    assert [len(e.generated[0]), len(e.generated[1])] == [3, 2]
    for (layer_ids, live), counts in zip(routes, backend.moe_counts):
        assert counts.shape == (cfg.num_layers, 3)
        for ids, (held, touched, total) in zip(layer_ids, counts):
            ids = ids[live]
            mine = ids[(ids >= 4) & (ids < 8)]
            assert held == mine.numel() and total == ids.numel()
            assert touched == len(set(mine.tolist()))
    # the prefill's live tokens: 20 + 9 of its 2 rows of 32 (no repeated
    # row); the decodes': the slots that hold a request
    assert [int(c[0, 2]) for c in backend.moe_counts] == [2 * 29, 4, 4]
