"""Mooncake-schema CSV round-tripping.

Base schema (what the public Mooncake trace ships): ``timestamp_ms,
input_length,output_length``. Multi-tenant traces append an optional
``slo_class`` column; single-class traces keep the exact legacy 3-column
layout so files written before the workload package load byte-identically.

``load_csv`` is deliberately forgiving about the things real trace dumps
get wrong — header case/whitespace/BOM, alias column names from other
serving repos (``input_tokens``/``prompt_len``/…), blank trailing lines —
and deliberately strict about the things that silently corrupt an
experiment: missing columns and negative/non-numeric lengths raise
``ValueError`` naming the file, row and field.
"""
from __future__ import annotations

import csv
import dataclasses
from typing import Optional, Sequence

from repro_torch.core.metrics import derive_slos
from repro_torch.core.request import Request, SLOClass

# canonical column -> accepted header aliases (lower-cased, stripped)
_ALIASES = {
    "timestamp_ms": ("timestamp_ms", "timestamp", "arrival_ms", "time_ms",
                     "arrival_time_ms"),
    "input_length": ("input_length", "input_tokens", "prompt_len",
                     "prompt_tokens", "input"),
    "output_length": ("output_length", "output_tokens", "output_len",
                      "generation_tokens", "output"),
    "slo_class": ("slo_class", "class", "tenant", "priority"),
}


def _resolve_header(fieldnames: Sequence[str], path: str) -> dict:
    norm = {}
    for raw in fieldnames or ():
        key = (raw or "").strip().lstrip("\ufeff").strip().lower()
        norm.setdefault(key, raw)
    colmap = {}
    for canon, aliases in _ALIASES.items():
        for a in aliases:
            if a in norm:
                colmap[canon] = norm[a]
                break
    missing = [c for c in ("timestamp_ms", "input_length", "output_length")
               if c not in colmap]
    if missing:
        raise ValueError(
            f"{path}: trace CSV is missing required column(s) {missing}; "
            f"got header {list(fieldnames or ())!r} (accepted aliases: "
            + ", ".join(f"{c}={list(_ALIASES[c])}" for c in missing) + ")")
    return colmap


def _field(row: dict, colmap: dict, canon: str, rownum: int, path: str,
           minimum: int = 0) -> int:
    raw = (row.get(colmap[canon]) or "").strip()
    try:
        val = int(float(raw))
    except ValueError:
        raise ValueError(
            f"{path}:{rownum}: column {canon!r} must be a number, "
            f"got {raw!r}") from None
    if val < minimum:
        raise ValueError(
            f"{path}:{rownum}: column {canon!r} must be >= {minimum}, "
            f"got {val}")
    return val


def save_csv(path: str, requests: Sequence[Request]) -> None:
    """Write the Mooncake schema; the ``slo_class`` column appears only
    when some request carries a non-default class (legacy files stay
    byte-identical)."""
    with_class = any(r.slo.name != "default" for r in requests)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        header = ["timestamp_ms", "input_length", "output_length"]
        if with_class:
            header.append("slo_class")
        w.writerow(header)
        for r in requests:
            row = [int(r.arrival_time * 1000), r.prompt_len, r.output_len]
            if with_class:
                row.append(r.slo.name)
            w.writerow(row)


def load_csv(path: str, cost_model, slo_scale=(5.0, 5.0),
             classes: Optional[dict[str, SLOClass]] = None) -> list[Request]:
    """Load a Mooncake-schema trace into Request objects.

    ``classes`` maps ``slo_class`` column values to SLOClass objects
    (unknown/absent names fall back to per-request derived SLOs carrying
    the class name, so a real multi-tenant dump still splits in the
    per-class metrics even before its SLO tiers are configured)."""
    reqs: list[Request] = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        colmap = _resolve_header(reader.fieldnames, path)
        rid = 0
        for rownum, row in enumerate(reader, start=2):
            if not any((v or "").strip() for v in row.values()):
                continue                      # blank / trailing line
            ts = _field(row, colmap, "timestamp_ms", rownum, path)
            pl = _field(row, colmap, "input_length", rownum, path, minimum=1)
            ol = _field(row, colmap, "output_length", rownum, path, minimum=1)
            cname = "default"
            if "slo_class" in colmap:
                cname = (row.get(colmap["slo_class"]) or "").strip() \
                    or "default"
            if classes is not None and cname in classes:
                slo = classes[cname]
            else:
                slo = derive_slos(cost_model, pl, *slo_scale)
                if cname != "default":
                    slo = dataclasses.replace(slo, name=cname)
            reqs.append(Request(rid=rid, arrival_time=ts / 1000.0,
                                prompt_len=pl, output_len=ol, slo=slo))
            rid += 1
    return reqs
