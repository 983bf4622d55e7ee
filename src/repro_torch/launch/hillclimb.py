"""Perf hillclimb harness: re-trace one dry-run cell under a named variant
and report the roofline terms against the baseline.

Counterpart of ``repro/launch/hillclimb.py``, built from
``launch.dryrun``'s pieces (the cell is traced as rank 0 of a fake group,
on meta DTensors, and priced on ``perf.cards.H100``).

  python -m repro_torch.launch.hillclimb --arch kimi-k2-1t --shape decode_32k \\
      --variant ep_floor1

Variants are (ModelConfig, EPInfo) transformations, each encoding one
hypothesis. Results: experiments/perf/<arch>__<shape>__<variant>.json,
the JAX record's keys (``compile_s`` null: nothing is compiled;
``lower_s`` is the trace), with the cell's collective counts, dot FLOPs
and argument bytes beside them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import traceback
from pathlib import Path
from typing import Optional

from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.models import sharding


# --------------------------------------------------------------- variants

def v_baseline(cfg, ep):
    return cfg, ep


def v_kv_fp8(cfg, ep):
    """Hypothesis: decode is memory-bound on KV reads; fp8 storage halves
    cache bytes -> memory term ~/2 where KV >> weights."""
    return dataclasses.replace(cfg, kv_cache_quant=True), ep


def v_window_cache(cfg, ep):
    """Hypothesis (gemma2): local layers only ever attend within the
    window; a window-sized ring cache removes (S-W)/S of their KV reads
    and memory (a per-layer cache: layers not stacked)."""
    return dataclasses.replace(cfg, window_sized_cache=True,
                               scan_layers=False), ep


def v_kv_fp8_window(cfg, ep):
    cfg, ep = v_kv_fp8(cfg, ep)
    return v_window_cache(cfg, ep)


def v_ep_floor1(cfg, ep):
    """Hypothesis (MoE decode): with T_loc*k << E_pad, the capacity floor
    of 4 pads the all_to_all buffers and expert GEMMs 4x; floor 1 cuts EP
    compute and collective bytes ~4x at identical routing semantics."""
    return cfg, dataclasses.replace(ep, capacity_floor=1)


def v_ep_cf1(cfg, ep):
    """Capacity factor 2 -> 1.25: less padding at slightly higher drop
    risk (train-side lever)."""
    return cfg, dataclasses.replace(ep, capacity_factor=1.25)


def v_ep_fused_a2a(cfg, ep):
    """Hypothesis: the per-axis all_to_all composition moves the dispatch
    buffer once per mesh axis (2x on a 2-axis EP group); a single fused
    all_to_all halves EP wire bytes."""
    return cfg, dataclasses.replace(ep, fused_a2a=True)


def v_ep_cf1_fused(cfg, ep):
    cfg, ep = v_ep_cf1(cfg, ep)
    return v_ep_fused_a2a(cfg, ep)


def v_ep_train_best(cfg, ep):
    """Stacked winners for MoE train: cf 1.25 + fused a2a + no remat."""
    cfg, ep = v_ep_cf1_fused(cfg, ep)
    return v_remat_none(cfg, ep)


def v_ep_allgather(cfg, ep):
    """Hypothesis (MoE decode): with T_global tokens << N*C padded slots,
    all_to_all routing is the wrong algorithm: broadcast all tokens
    (O(T*d)), compute local experts masked, sum the contributions
    (O(T*d))."""
    return cfg, dataclasses.replace(ep, ep_mode="allgather")


def v_remat_none(cfg, ep):
    """Hypothesis (train): a remat that recomputes products in the bwd
    pays for them again; disabling remat trades memory for compute. The
    port's "dots" already keeps every product, so against it the variant
    moves no dot FLOPs, only the saved activations."""
    return dataclasses.replace(cfg, remat_policy="none"), ep


VARIANTS = {
    "baseline": v_baseline,
    "kv_fp8": v_kv_fp8,
    "window_cache": v_window_cache,
    "kv_fp8_window": v_kv_fp8_window,
    "ep_floor1": v_ep_floor1,
    "ep_cf1": v_ep_cf1,
    "ep_fused_a2a": v_ep_fused_a2a,
    "ep_cf1_fused": v_ep_cf1_fused,
    "ep_train_best": v_ep_train_best,
    "ep_allgather": v_ep_allgather,
    "remat_none": v_remat_none,
}


def run_variant(arch: str, shape_name: str, variant: str,
                outdir: Path = Path("experiments/perf"),
                mesh_kind: str = "single", *, shape: Optional[dict] = None,
                mesh=None, cfg=None, write: bool = True) -> dict:
    """One variant's record. ``shape``, ``mesh`` and ``cfg`` override the
    names as in ``dryrun.run_cell`` (the variant applies to ``cfg``)."""
    out_path = Path(outdir) / f"{arch}__{shape_name}__{variant}.json"
    shape = shape or dryrun.SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "variant": variant,
           "status": "error"}
    try:
        base = cfg if cfg is not None else dryrun._dryrun_cfg(
            get_config(arch), shape["kind"])
        mesh = mesh if mesh is not None else dryrun.production_mesh(
            mesh_kind)
        ep0 = dryrun._ep_for(base, mesh, sharding.make_rules(mesh))
        vcfg, ep = VARIANTS[variant](base, ep0)
        full = dryrun.record(vcfg, shape, dryrun.trace_cell(
            vcfg, shape, mesh, ep_fn=lambda _: ep))
        rl = full["roofline"]
        rec.update(status="ok", compile_s=None, lower_s=full["lower_s"],
                   roofline=rl, bytes_per_device=full["bytes_per_device"],
                   collectives={"wire_total":
                                full["collectives"]["wire_total"],
                                "total": full["collectives"]["total"]},
                   collective_counts=full["collective_counts"],
                   collective_bytes={k: full["collectives"][k] for k in
                                     full["collective_counts"]},
                   dot_flops=full["cost"]["dot_flops"],
                   arguments=full["memory"]["arguments"],
                   not_counted={"compile_s": "nothing is compiled "
                                "(lower_s is the trace)"})
        step = max(rl["compute_s"], rl["memory_s"], rl["collective_s"])
        print(f"[hillclimb] {arch} {shape_name} {variant}: "
              f"step={step * 1e3:.2f}ms dom={rl['dominant']} "
              f"c/m/coll={rl['compute_s'] * 1e3:.2f}/"
              f"{rl['memory_s'] * 1e3:.2f}/{rl['collective_s'] * 1e3:.2f}ms "
              f"rf={rl['roofline_fraction']:.3f} "
              f"mem={rec['bytes_per_device'] / 1e9:.2f}GB", flush=True)
    except Exception as e:  # noqa: BLE001
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-3000:]
        print(f"[hillclimb] {arch} {shape_name} {variant}: FAIL "
              f"{rec['error'][:200]}", flush=True)
    if write:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", required=True,
                    help=",".join(VARIANTS) + " (comma-separated ok)")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    for v in args.variant.split(","):
        run_variant(args.arch, args.shape, v, mesh_kind=args.mesh)


if __name__ == "__main__":
    main()
