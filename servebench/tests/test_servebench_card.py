"""On the card, at each cell's own size: the port's widest gap within the
cell's limit, and the e4m3 control's past it. Run there with
``python -m pytest -q -m card servebench/tests`` (several minutes a cell);
without a card they skip."""
import gc
import json
from pathlib import Path

import pytest
import torch

from servebench import check, serve, traffic, weights
from servebench.cells import Cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_the_port_passes(card, name):
    from repro_torch.kernels import build, chunked_prefill, paged_attention
    build.build_all([chunked_prefill.LIB, paged_attention.LIB])
    c = Cell.load(name)
    seed = 424242
    params = weights.make(c.config.layout(), seed, card)
    port = serve.Port(c, params, card)
    port.warm()
    arrivals = traffic.generate(c.mix, seed, c.rate,
                                serve.offered_horizon(20.0))
    win = serve.run_window(port, c, arrivals, 20.0)
    items = check.sample(win, port, c, seed)
    del win
    port.free()
    try:
        got = check.gaps(params, c.config, items, card,
                         route_margin=c.correct.get("route_margin", 0.0),
                         control=True)
    finally:
        del params
        gc.collect()
        torch.cuda.empty_cache()
    limit = c.correct["widest_gap"]
    assert got["widest_gap"] <= limit < got["control_widest_gap"]
