"""Rank bodies for the tensor-parallel tests (``tests/test_torch_tp.py``):
each family's SMOKE model (its weights converted from the JAX package's
init, read from ``<arch>.pt``) with its parameters, cache and inputs
placed as DTensors under the sharding rules' specs, run as gloo CPU ranks
started by ``repro_torch.launch.dist.spawn``. Imports torch and the port
only."""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.launch import mesh as tmesh
from repro_torch.launch.hloanalysis import StepCost
from repro_torch.models import api as tapi
from repro_torch.models import sharding as TS
from repro_torch.models import tp
from repro_torch.models.moe import EPInfo
from repro_torch.train import optimizer as topt

MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# arch -> config changes; "gqa": qwen2 with 8 query heads over 2 KV heads,
# so that on 1 x 4 the query heads split and the KV heads do not;
# "whole_vocab": qwen2 with a vocabulary that neither model axis divides,
# so that it stays whole on each rank (``tp.xent``'s plain-ops branch)
ARCHS = {
    "qwen2-1.5b": {},
    "gqa": {"num_heads": 8, "num_kv_heads": 2},
    "whole_vocab": {"vocab_size": 513},
    "gemma2-2b": {},
    "arctic-480b": {"expert_pad_to": 4},
    "rwkv6-7b": {},
    "zamba2-2.7b": {},
    "paligemma-3b": {},
    "whisper-medium": {},
}
ROWS, PROMPT, MAX_LEN, ENC_LEN, STEPS = 4, 8, 16, 16, 4


# the variants above and the SMOKE config each changes
BASE = {"gqa": "qwen2-1.5b", "whole_vocab": "qwen2-1.5b"}


def config(arch: str):
    return dataclasses.replace(get_smoke(BASE.get(arch, arch)), **ARCHS[arch])


def inputs(cfg) -> dict:
    """The run's inputs, from a seed, the same on every rank."""
    rng = np.random.default_rng(3)
    ints = lambda *s: torch.from_numpy(  # noqa: E731
        rng.integers(0, cfg.vocab_size, s).astype(np.int64))
    out = {"tokens": ints(ROWS, PROMPT), "labels": ints(ROWS, PROMPT),
           "decode": ints(STEPS, ROWS)}
    full = cfg.family in ("rwkv", "hybrid")
    lengths = [PROMPT] * ROWS if full else [PROMPT, 5, PROMPT, 3]
    if cfg.family == "vlm":
        out["prefix_embeds"] = torch.from_numpy(rng.normal(
            size=(ROWS, cfg.num_patches, cfg.vision_feature_dim)).astype(
                np.float32))
        lengths = [cfg.num_patches + n for n in lengths]
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.normal(
            size=(ROWS, ENC_LEN, cfg.d_model)).astype(np.float32))
    out["lengths"] = torch.tensor(lengths, dtype=torch.int32)
    return out


def model_inputs(cfg, batch):
    if cfg.family == "vlm":
        return {"tokens": batch["tokens"],
                "prefix_embeds": batch["prefix_embeds"]}
    if cfg.family == "encdec":
        return {"frames": batch["frames"], "tokens": batch["tokens"]}
    return batch["tokens"]


def train_batch(cfg, batch) -> dict:
    keys = ["tokens", "labels"] + [k for k in ("prefix_embeds", "frames")
                                   if k in batch]
    return {k: batch[k] for k in keys}


def run(api, params, batch, cache, ep=None, place=lambda k, t: t):
    """Prefill, then ``STEPS`` teacher-forced decode steps: the logits."""
    cfg = api.cfg
    inp = model_inputs(cfg, batch)
    if isinstance(inp, dict):
        inp = {k: place(k, v) for k, v in inp.items()}
    else:
        inp = place("tokens", inp)
    lengths = batch["lengths"]
    logits = [api.prefill(params, cache, inp, place("lengths", lengths),
                          ep=ep)[0]]
    pos = lengths.clone()
    for tok in batch["decode"]:
        logits.append(api.decode(params, cache, place("lengths", tok),
                                 place("lengths", pos), ep=ep)[0])
        pos = pos + 1
    return logits


def cache_for(api, cfg, device="cpu"):
    if cfg.family == "encdec":
        return api.init_cache(ROWS, MAX_LEN, device, enc_len=ENC_LEN)
    return api.init_cache(ROWS, MAX_LEN, device)


def _full(x):
    return x.full_tensor() if tp.is_dt(x) else x


# the archs whose AdamW step also runs sharded (ZeRO-1 state)
ZERO1 = ("qwen2-1.5b", "arctic-480b")


def _zero1_step(api, params, specs, mesh, place, batch, ep) -> dict:
    """One ``make_train_step`` on DTensor parameters and ZeRO-1 state
    (``optimizer.state_specs``: each state leaf also split over 'data'),
    the new parameters gathered back to their specs, counted."""
    cfg = api.cfg
    zero = mesh.size(mesh.mesh_dim_names.index("data"))
    ospecs = topt.state_specs(specs, params, zero_size=zero)
    P = tp.place(params, specs, mesh)
    S = tp.place(topt.init_state(params), ospecs, mesh)
    step = topt.make_train_step(lambda p, b: api.loss(p, b, ep=ep))
    b = {k: place(k, v) for k, v in train_batch(cfg, batch).items()}
    with StepCost(params=P) as cost, tp.step_context():
        new, S, loss = step(P, S, b)
        before = dict(cost.counts)
        new = tp.respec(new, specs, mesh)
    return {"params": topt.tree_map(lambda t: _full(t).detach(), new),
            "loss": _full(loss).detach(),
            "gather": {k: cost.counts[k] - before[k] for k in before},
            "param_counts_before_gather": dict(cost.param_counts)}


def tp_rank(rank: int, root: str, mesh_name: str, archs: list) -> None:
    """Each arch on the named mesh: the prefill's and decodes' logits, the
    loss and every gradient (gathered whole), the collectives counted with
    the parameters watched, and the shapes each kernel op saw."""
    root = Path(root)
    mesh = tmesh.make_mesh(MESHES[mesh_name], ("data", "model"), "cpu")
    rules = TS.make_rules(mesh)
    out = {}
    for arch in archs:
        cfg = config(arch)
        api = tapi.build(cfg)
        params = torch.load(root / f"{arch}.pt")
        specs = TS.param_specs(cfg, params, rules)
        P = tp.place(params, specs, mesh)
        batch = inputs(cfg)
        cache = cache_for(api, cfg)
        C = tp.place(cache, TS.cache_specs(cfg, rules, ROWS, cache), mesh)
        io = TS.io_specs(cfg, rules, ROWS)
        ep = EPInfo(mesh=mesh, ep_axes=("data", "model"),
                    batch_axes=rules.batch_axes,
                    capacity_factor=8.0) if cfg.is_moe else None

        def place(key, t):
            s = io[key] if t.dim() == len(io[key]) else \
                TS.spec(io[key][0], *([None] * (t.dim() - 1)))
            return tp.place(t, s, mesh)

        with StepCost(params=P) as serve_cost, tp.step_context():
            logits = run(api, P, batch, C, ep=ep, place=place)
        with StepCost(params=P) as train_cost, tp.step_context():
            loss, grads = topt.loss_and_grads(
                lambda p, b: api.loss(p, b, ep=ep), P,
                {k: place(k, v) for k, v in train_batch(cfg, batch).items()})
        if arch in ZERO1:
            out[arch + "/zero1"] = _zero1_step(api, params, specs, mesh,
                                                place, batch, ep)
        out[arch] = {
            "logits": [_full(x).detach() for x in logits],
            "loss": _full(loss).detach(),
            "grads": topt.tree_map(lambda g: _full(g).detach(), grads),
            "param_counts": {"serve": serve_cost.param_counts,
                             "train": train_cost.param_counts},
            "counts": {"serve": serve_cost.counts,
                       "train": train_cost.counts},
            "kernel_calls": serve_cost.kernel_calls,
        }
    torch.save(out, root / f"{mesh_name}_rank{rank}.pt")
