"""Every cell, configuration, mix and metric ``BENCHMARK.json`` names loads
by its name from a file of its own, and every entry keeps the keys, names,
units and limits that the benchmark's readers rely on."""
import json
import re
from pathlib import Path

import pytest

from servebench import traffic
from servebench.cells import Cell, Config
from servebench.metrics import reader

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert (ROOT / BENCH["command"][1]).is_file()
    assert all((ROOT / p).is_dir() for p in BENCH["paths"])


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_loads_by_name(c):
    assert NAME.match(c["name"])
    cfg = Config.load(c["name"])
    assert cfg.name == c["name"]
    assert cfg.arch.vocab(cfg.raw) > 0 and cfg.reference.arch(cfg.raw)
    assert Path(c["file"]) == Path("servebench/configs") / f"{c['name']}.json"
    assert cfg.raw["reduced"] == c["reduced"]
    assert cfg.raw["source"] == c["source"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for key in c["reduced"]:
        assert not key.endswith(("_dim", "_rank", "_size")) and \
            "head" not in key and "expert" not in key


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_loads_by_name(w):
    cell = Cell.load(w["name"])
    assert cell.config.name == w["config"] and cell.mix.name == w["traffic"]
    assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["name"])
    assert traffic.Mix.load(w["traffic"]).name == w["traffic"]
    for key in ("rate", "slots", "max_len", "workers", "offer_share"):
        assert cell.raw[key] > 0
    assert cell.mix.prompt["max"] + cell.mix.output["max"] <= cell.max_len
    slo = cell.raw["slo"]
    assert all(isinstance(slo[k], (int, float)) for k in slo)
    assert cell.correct["widest_gap"] > 0


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_keys(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        e2e = {x["name"] for x in BENCH["end_to_end"]}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_a_reader(m):
    assert callable(reader(m["name"]))


def test_one_layer_one_name():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
