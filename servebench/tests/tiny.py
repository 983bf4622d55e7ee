"""A cell small enough for the CPU: the benchmark's path end to end at
tiny widths, for the tests."""
from servebench import traffic
from servebench.archs.llama import TINY
from servebench.cells import Cell, Config

DENSE, MOE, TIED = TINY
MIX = traffic.Mix("tiny", {"body_median": 40, "body_sigma": 0.6,
                           "tail_frac": 0.1, "tail_median": 90,
                           "tail_sigma": 0.2, "min": 8, "max": 96},
                  {"median": 12, "sigma": 0.5, "min": 4, "max": 24},
                  {"window_s": 1.0, "shape": 2.0, "block_s": 4.0})


def cell(config=DENSE, dtype="float32", **changes) -> Cell:
    raw = {"name": "tiny.cell", "config": config["name"], "traffic": "tiny",
           "policy": "tropical", "workers": 2, "slots": 4, "max_len": 128,
           "offer_share": 0.75, "rate": 3.0,
           "slo": {"ttft_a_s": 2.0, "ttft_b_s_per_token": 0.01,
                   "tpot_s": 0.5},
           "correct": {"widest_gap": 1e-3, "sample_tokens": 64,
                       "sample_requests": 4}}
    raw.update(changes)
    return Cell(raw, Config(dict(config, torch_dtype=dtype)), MIX)
