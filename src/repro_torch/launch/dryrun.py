"""Multi-pod dry-run: trace every (architecture x input-shape x mesh) cell
as rank 0 of a fake process group and record its memory, dot FLOPs,
collectives and roofline, with no device.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
cell for 512 forced host devices and reads XLA's analyses. Here one
process is rank 0 of a fake group of 256 (``single``, 16 x 16) or 512
(``multi``, 2 x 16 x 16) ranks (``fake_group``: ``FakeStore`` and the
"fake" backend, whose collectives move nothing). Parameters, cache,
optimizer state and inputs are DTensors under the sharding rules' specs
whose local shards are meta tensors (``models.tp.place``); the step
runs on them once (``models.tp``: DTensor propagation for the dense ops,
``local_map`` regions for the kernels, the MoE body and the rest), and
``launch.hloanalysis.StepCost`` counts rank 0's local dot FLOPs and its
collectives. The kernel ops take their shape-only path on meta tensors
and report the dense attention count the JAX dry-run records.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both        # full sweep
Results: experiments/dryrun/<arch>__<shape>__<mesh>.json, JAX's keys where
a counterpart exists. ``memory`` is reckoned from the local shard bytes
of rank 0's inputs (``argument_size_in_bytes``), outputs
(``output_size_in_bytes``: the logits under their output spec and the
cache, or the parameters, optimizer state and loss) and donated buffers
(``alias_size_in_bytes``: the cache, or the parameters and state), as
XLA reckons them: an argument no op of the step reads is not counted
(nor aliased when donated: rwkv6's decode never reads ``lengths``,
whisper's prefill overwrites its cross K/V), and the outputs count the
table of 8-byte buffer pointers of the step's output tuple, one a leaf.
``bytes_per_device`` is that steady state, arguments + outputs - aliased.

``bytes_per_device_incl_cpu_temps`` is rank 0's predicted peak during the
step, the number a card measures: the local bytes of every argument the
rank holds at the step's start (params, cache or optimizer state, inputs)
plus the high-water mark of the buffers the step allocates
(``memory.step_allocated_peak_bytes``, ``launch.memory.LiveBytes``,
counted in the same trace as the FLOPs; where it fell:
``memory.peak_at``). ``memory.temp_size_in_bytes`` is the difference, what
the step needs beyond its steady state. It is the port's own count of live
buffers, not XLA-CPU's buffer assignment (which JAX's record holds, f32
upcasts of bf16 dot operands included). ``memory.gathered_cache_bytes``,
a row-split cache's gathered layer, is one part of the step's high-water
mark, and so of the temps unless the step's outputs (which
``bytes_per_device`` counts) come after the peak and outweigh the rest of
it (a decode's logits beside a short cache).

``roofline`` is priced on ``perf.cards.H100``. The keys with no
counterpart are null and listed under ``not_counted``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import math
import time
import traceback
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs
from repro_torch.launch import hloanalysis
from repro_torch.launch.memory import LiveBytes
from repro_torch.launch.mesh import make_production_mesh, production_shape
from repro_torch.models import api as model_api
from repro_torch.models import sharding
from repro_torch.models import tp
from repro_torch.models.layers import MetaGenerator
from repro_torch.models.moe import EPInfo
from repro_torch.train import optimizer

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# long_500k needs sub-quadratic context handling
LONG_OK = {"rwkv6-7b", "zamba2-2.7b", "gemma2-2b",
           "rwkv6_7b", "zamba2_2_7b", "gemma2_2b"}
ASSIGNED = [a for a in list_archs() if a != "internlm20b"]

WHISPER_DEC_TRAIN = 512     # decoder tokens for encdec train cells
WHISPER_DEC_PREFILL = 64
WHISPER_ENC_DECODE = 1504   # encoder frames backing a decode-cell cross-KV

NOT_COUNTED = {
    "cost.xla_cpu_flops_raw": "XLA-CPU's cost analysis; there is no XLA",
    "cost.xla_cpu_bytes_raw": "XLA-CPU's cost analysis; there is no XLA",
    "memory.generated_code_size_in_bytes": "nothing is compiled",
    "compile_s": "nothing is compiled (lower_s is the trace)",
}


def _dryrun_cfg(cfg, kind: str):
    """Dry-run variant, as JAX's: ``scan_layers`` kept as a field (the
    port's layers are a Python loop either way), 1024-row query chunks,
    MoE expert tables padded to divide the 512-rank EP group."""
    return dataclasses.replace(
        cfg, scan_layers=True, attn_unroll_chunks=False, attn_q_chunk=1024,
        expert_pad_to=512 if cfg.is_moe else 0)


def _meta(shape, dtype):
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg, shape_name: str, rules, shape: Optional[dict] = None):
    """Meta stand-ins + specs for every model input (the batch, or the
    prefill / decode arguments in order)."""
    info = shape or SHAPES[shape_name]
    kind, seq, batch = info["kind"], info["seq"], info["batch"]
    b = sharding.batch_spec(rules, batch)
    i32, bf16 = torch.int32, cfg.dtype
    sp = sharding.spec

    if kind == "train":
        if cfg.family == "encdec":
            d = info.get("dec_len", WHISPER_DEC_TRAIN)
            return ({"frames": _meta((batch, seq, cfg.d_model), bf16),
                     "tokens": _meta((batch, d), i32),
                     "labels": _meta((batch, d), i32)},
                    {"frames": sp(b, None, None), "tokens": sp(b, None),
                     "labels": sp(b, None)})
        if cfg.family == "vlm":
            txt = seq - cfg.num_patches
            return ({"tokens": _meta((batch, txt), i32),
                     "labels": _meta((batch, txt), i32),
                     "prefix_embeds": _meta(
                         (batch, cfg.num_patches, cfg.vision_feature_dim),
                         bf16)},
                    {"tokens": sp(b, None), "labels": sp(b, None),
                     "prefix_embeds": sp(b, None, None)})
        return ({"tokens": _meta((batch, seq), i32),
                 "labels": _meta((batch, seq), i32)},
                {"tokens": sp(b, None), "labels": sp(b, None)})

    lengths, lspec = _meta((batch,), i32), sp(b)
    if kind == "prefill":
        if cfg.family == "encdec":
            dec = info.get("dec_len", WHISPER_DEC_PREFILL)
            return ({"frames": _meta((batch, seq, cfg.d_model), bf16),
                     "tokens": _meta((batch, dec), i32),
                     "lengths": lengths},
                    {"frames": sp(b, None, None), "tokens": sp(b, None),
                     "lengths": lspec})
        if cfg.family == "vlm":
            return ({"tokens": _meta((batch, seq - cfg.num_patches), i32),
                     "prefix_embeds": _meta(
                         (batch, cfg.num_patches, cfg.vision_feature_dim),
                         bf16),
                     "lengths": lengths},
                    {"tokens": sp(b, None),
                     "prefix_embeds": sp(b, None, None), "lengths": lspec})
        return ({"tokens": _meta((batch, seq), i32), "lengths": lengths},
                {"tokens": sp(b, None), "lengths": lspec})
    return ({"tokens": _meta((batch,), i32), "lengths": lengths},
            {"tokens": sp(b), "lengths": lspec})


def _cache_for(cfg, api, shape_name: str, rules,
               shape: Optional[dict] = None):
    """The cache's meta tree and specs (None for a train cell); a shape's
    ``cache_len`` (default its ``seq``) sets the cache's rows."""
    info = shape or SHAPES[shape_name]
    kind, seq, batch = info["kind"], info["seq"], info["batch"]
    if kind == "train":
        return None, None
    if cfg.family == "encdec":
        if kind == "prefill":
            dec = info.get("dec_len", WHISPER_DEC_PREFILL)
            tree = api.init_cache(batch, 2 * dec, "meta", enc_len=seq)
        else:
            tree = api.init_cache(batch, seq, "meta",
                                  enc_len=info.get("enc_len",
                                                   WHISPER_ENC_DECODE))
    else:
        tree = api.init_cache(batch, info.get("cache_len", seq), "meta")
    return tree, sharding.cache_specs(cfg, rules, batch, tree)


def _ep_for(cfg, mesh, rules):
    if not cfg.is_moe:
        return None
    return EPInfo(mesh=mesh, ep_axes=tuple(mesh.mesh_dim_names),
                  batch_axes=rules.batch_axes,
                  capacity_factor=cfg.moe_capacity_factor)


def build_step(cfg, api, kind: str, mesh, rules, ep=None):
    """The step a cell traces, on DTensors. A train step is
    ``optimizer.make_train_step``'s (loss, gradients, AdamW on the ZeRO-1
    state); a prefill or decode step is the api's entry point."""
    if kind == "train":
        return optimizer.make_train_step(
            lambda p, b: api.loss(p, b, ep=ep))
    if kind == "prefill":
        if cfg.family == "encdec":
            def step(params, cache, frames, tokens, lengths):
                return api.prefill(params, cache,
                                   {"frames": frames, "tokens": tokens},
                                   lengths, ep=ep)
        elif cfg.family == "vlm":
            def step(params, cache, tokens, prefix_embeds, lengths):
                return api.prefill(params, cache,
                                   {"tokens": tokens,
                                    "prefix_embeds": prefix_embeds},
                                   lengths, ep=ep)
        else:
            def step(params, cache, tokens, lengths):
                return api.prefill(params, cache, tokens, lengths, ep=ep)
        return step

    def step(params, cache, tokens, lengths):
        return api.decode(params, cache, tokens, lengths, ep=ep)
    return step


# ---------------------------------------------------------------------------
# the fake group
# ---------------------------------------------------------------------------


def fake_group(world_size: int) -> None:
    """This process as rank 0 of a fake process group of ``world_size``
    ranks (``FakeStore``, the "fake" backend: collectives complete at once
    and move nothing). An existing fake group of another size is replaced;
    a real one raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("fake_group: a real process group is up")
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def release_group() -> None:
    """Take down the fake group, if one is up."""
    if dist.is_initialized() and dist.get_backend() == "fake":
        dist.destroy_process_group()


def production_mesh(mesh_kind: str):
    """The ``single`` or ``multi`` mesh over a fake group of its size."""
    multi = mesh_kind == "multi"
    fake_group(math.prod(production_shape(multi_pod=multi).axis_sizes))
    return make_production_mesh(multi_pod=multi, device_type="cpu")


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------


def _local_bytes(tree) -> float:
    return float(tp.local_bytes(tree))


def _gathered_cache(cache) -> float:
    """One layer's K and V (the ``k`` / ``v`` leaves, (L, B, S, Hkv, D))
    as a rank holds them once ``tp.cache_attention`` has gathered a cache
    that the rules split along its rows: the largest transient of such a
    step, which the trace does not count. 0 where no cache is row-split."""
    total = 0.0
    for name in ("k", "v"):
        t = cache.get(name) if isinstance(cache, dict) else None
        if not tp.is_dt(t):
            continue
        n = math.prod(t.device_mesh.size(i)
                      for i, p in enumerate(t.placements) if p.is_shard(2))
        if n > 1:
            total += _local_bytes(t) / t.shape[0] * n
    return total


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return [] if tree is None else [tree]


# XLA's output size counts its output tuple's table of buffer pointers
TUPLE_POINTER_BYTES = 8


def _unread(cost, leaves) -> float:
    """Bytes of the local shards of ``leaves`` that no op of the step read
    (XLA leaves an argument it never reads out of its sizes)."""
    local = [t._local_tensor for t in leaves]
    return float(sum(t.numel() * t.element_size() for t in local
                     if t not in cost.seen))


def _materialized(tree, fn):
    """``tree`` with ``fn`` applied to every leaf (as it is if ``fn`` is
    None)."""
    if fn is None or tree is None:
        return tree
    if isinstance(tree, dict):
        return {k: _materialized(v, fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_materialized(v, fn) for v in tree)
    return fn(tree)


def trace_cell(cfg, shape: dict, mesh, ep_fn=None,
               materialize=None) -> dict:
    """Trace one cell on ``mesh`` (over a fake group, or a real one with
    meta shards): the step's StepCost, the memory reckoning (the steady
    state, and the high-water mark of the buffers the step allocates,
    ``launch.memory.LiveBytes``) and the trace's seconds. ``ep_fn(ep) ->
    ep`` changes the EPInfo (hillclimb). ``materialize`` (a meta tensor -> a
    tensor of its shape and dtype on a device) runs the step on real
    tensors instead of meta ones, as the tests do on the CPU."""
    kind, seq, batch = shape["kind"], shape["seq"], shape["batch"]
    rules = sharding.make_rules(mesh)
    api = model_api.build(cfg)
    ep = _ep_for(cfg, mesh, rules)
    if ep_fn is not None:
        ep = ep_fn(ep)
    t0 = time.time()
    real = functools.partial(_materialized, fn=materialize)
    params_shape = api.init(MetaGenerator())
    pspecs = sharding.param_specs(cfg, params_shape, rules)
    params = tp.place(real(params_shape), pspecs, mesh)
    ins, ispecs = input_specs(cfg, "", rules, shape)
    inputs = tp.place(real(ins), ispecs, mesh)
    step = build_step(cfg, api, kind, mesh, rules, ep)
    live = LiveBytes(params=params)
    cost = hloanalysis.StepCost(params=params, memory=live)
    zero1 = None
    gathered = 0.0
    if kind == "train":
        state_shape = optimizer.init_state(params_shape)
        zero = mesh.size(mesh.mesh_dim_names.index("data"))
        ospecs = optimizer.state_specs(pspecs, params_shape, zero_size=zero)
        state = tp.place(real(state_shape), ospecs, mesh)
        parts = {"params": _local_bytes(params), "state": _local_bytes(state),
                 "inputs": _local_bytes(inputs)}
        args = sum(parts.values())
        donated = _leaves((params, state))
        read_from = donated + _leaves(inputs)
        with cost, tp.step_context():
            new_params, new_state, loss = step(params, state, inputs)
            before = dict(cost.counts)
            new_params = tp.respec(new_params, pspecs, mesh)
        zero1 = {k: cost.counts[k] - before[k] for k in cost.counts}
        out_leaves = _leaves((new_params, new_state, loss))
        alias = _local_bytes(params) + _local_bytes(state)
    else:
        cache_shape, cspecs = _cache_for(cfg, api, "", rules, shape)
        cache = tp.place(real(cache_shape), cspecs, mesh)
        gathered = _gathered_cache(cache)
        order = list(ins)
        parts = {"params": _local_bytes(params), "cache": _local_bytes(cache),
                 "inputs": _local_bytes(inputs)}
        args = sum(parts.values())
        donated = _leaves(cache)      # the step replaces some in the dict
        read_from = _leaves(params) + donated + _leaves(inputs)
        alias = _local_bytes(cache)
        logits_spec = sharding.spec(sharding.batch_spec(rules, batch), None)
        with cost, tp.step_context():
            logits, cache = step(params, cache, *[inputs[k] for k in order])
            logits = tp.respec(logits, logits_spec, mesh)
            cache = tp.respec(cache, cspecs, mesh)
        out_leaves = _leaves((logits, cache))
    lower_s = time.time() - t0
    n_out = len(out_leaves)
    return {"cost": cost, "args": args - _unread(cost, read_from),
            "outs": _local_bytes(out_leaves) + TUPLE_POINTER_BYTES * n_out,
            "alias": alias - _unread(cost, donated),
            "parts": parts, "n_out": n_out, "lower_s": lower_s,
            "zero1": zero1, "gathered_cache": gathered,
            "live": live, "n_devices": int(mesh.size())}


def _dec_len(cfg, shape):
    if shape["kind"] == "train":
        return shape.get("dec_len", WHISPER_DEC_TRAIN)
    return shape.get("dec_len", WHISPER_DEC_PREFILL)


def record(cfg, shape: dict, tr: dict) -> dict:
    """JAX's record keys from a ``trace_cell`` result."""
    cost = tr["cost"]
    mc = cost.result()
    coll = mc["collectives"]
    dot = {"flops": mc["flops"], "bytes": mc["bytes"]}
    resident = tr["args"] + tr["outs"] - tr["alias"]
    live = tr["live"]
    peak = sum(tr["parts"].values()) + live.peak
    mflops = hloanalysis.model_flops(cfg, shape["kind"], shape["batch"],
                                     shape["seq"], _dec_len(cfg, shape))
    rl = hloanalysis.roofline(dot, resident, coll, mflops, tr["n_devices"])
    return {
        "status": "ok", "lower_s": round(tr["lower_s"], 2),
        "compile_s": None, "n_devices": tr["n_devices"],
        "memory": {"argument_size_in_bytes": tr["args"],
                   "output_size_in_bytes": tr["outs"],
                   "temp_size_in_bytes": peak - resident,
                   "alias_size_in_bytes": tr["alias"],
                   "generated_code_size_in_bytes": None,
                   "arguments": tr["parts"], "output_leaves": tr["n_out"],
                   "gathered_cache_bytes": tr["gathered_cache"],
                   "step_allocated_peak_bytes": live.peak,
                   "peak_at": live.peak_at},
        "cost": {"xla_cpu_flops_raw": None, "xla_cpu_bytes_raw": None,
                 "dot_flops": dot["flops"], "dot_bytes": dot["bytes"],
                 "n_corrected_loops": 0,
                 "kernel_op_flops": dict(cost.op_flops)},
        "collectives": {k: v for k, v in coll.items() if k != "counts"},
        "collective_counts": coll["counts"],
        "param_collectives": dict(cost.param_counts),
        "zero1_gather_counts": tr["zero1"],
        "model_flops_total": mflops,
        "roofline": rl.row(),
        "bytes_per_device": float(resident),
        "bytes_per_device_incl_cpu_temps": peak,
        "not_counted": dict(NOT_COUNTED),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, outdir: Path,
             force: bool = False, *, shape: Optional[dict] = None,
             mesh=None, cfg=None, ep_fn=None, write: bool = True) -> dict:
    """One cell's record (read back from ``outdir`` unless ``force``).
    ``shape`` (a dict as ``SHAPES``' entries), ``mesh`` (a DeviceMesh over
    a group already up) and ``cfg`` (a config to trace as it is) override
    the names, for a small cell; the names keep JAX's meaning."""
    out_path = Path(outdir) / f"{arch}__{shape_name}__{mesh_kind}.json"
    if write and out_path.exists() and not force:
        return json.loads(out_path.read_text())
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "status": "error"}
    if shape is None and shape_name == "long_500k" and arch not in LONG_OK:
        rec["status"] = "skipped"
        rec["reason"] = ("pure full-attention arch: 512k KV on every layer; "
                         "sub-quadratic archs only")
        if write:
            out_path.write_text(json.dumps(rec, indent=1))
        return rec
    shape = shape or SHAPES[shape_name]
    try:
        if cfg is None:
            cfg = _dryrun_cfg(get_config(arch), shape["kind"])
        if mesh is None:
            mesh = production_mesh(mesh_kind)
        rec.update(record(cfg, shape, trace_cell(cfg, shape, mesh, ep_fn)))
        print(f"[dryrun] {arch} {shape_name} {mesh_kind}: OK "
              f"trace={rec['lower_s']}s "
              f"dotflops/dev={rec['cost']['dot_flops']:.3e} "
              f"coll={rec['collectives']['wire_total']:.3e}B "
              f"dom={rec['roofline']['dominant']} "
              f"rf={rec['roofline']['roofline_fraction']:.3f} "
              f"mem/dev={rec['bytes_per_device'] / 1e9:.2f}GB "
              f"peak/dev="
              f"{rec['bytes_per_device_incl_cpu_temps'] / 1e9:.2f}GB "
              f"gathered_kv/layer="
              f"{rec['memory']['gathered_cache_bytes'] / 1e9:.3f}GB",
              flush=True)
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {arch} {shape_name} {mesh_kind}: "
              f"FAIL {rec['error'][:200]}", flush=True)
    if write:
        out_path.write_text(json.dumps(rec, indent=1))
    gc.collect()
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args()

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_fail = n_skip = 0
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                rec = run_cell(arch, shape, mk, outdir, force=args.force)
                n_ok += rec["status"] == "ok"
                n_fail += rec["status"] == "error"
                n_skip += rec["status"] == "skipped"
    print(f"[dryrun] done: {n_ok} ok, {n_fail} failed, {n_skip} skipped")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
