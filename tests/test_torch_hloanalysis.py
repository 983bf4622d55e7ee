"""PyTorch port, ``launch/hloanalysis.py`` against the JAX package's: the
arithmetic (``model_flops`` for every architecture and shape at full
config, ``roofline`` rows on the same inputs and peaks,
``collective_record`` against ``collective_bytes`` on one HLO line per
kind and group size), and ``StepCost``'s per-rank counts on a sharded MLP
worked out by hand (a fake group of 4 in a subprocess)."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import hloanalysis as JH  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.launch import hloanalysis as TH  # noqa: E402

SHAPES = {"train_4k": ("train", 4096, 256), "prefill_32k": ("prefill",
                                                            32768, 32),
          "decode_32k": ("decode", 32768, 128),
          "long_500k": ("decode", 524288, 1)}
DEC_LEN = {"train": 512, "prefill": 64, "decode": 64}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_equal_jax(arch, shape):
    kind, seq, batch = SHAPES[shape]
    got = TH.model_flops(get_config(arch), kind, batch, seq, DEC_LEN[kind])
    want = JH.model_flops(jax_config(arch), kind, batch, seq, DEC_LEN[kind])
    assert got == want


# (dot flops, dot bytes, resident bytes, wire bytes, model flops, devices)
ROOFLINE_INPUTS = [
    (4.895e10, 1.2e9, 9.57e8, 7.05e9, 1.1167e12, 256),
    (2.333e14, 4.1e11, 6.6e8, 3.3e10, 1.082e16, 256),
    (1e12, 3e12, 5e12, 0.0, 4e14, 512),
    (0.0, 0.0, 1e6, 1e3, 0.0, 8),
]


@pytest.mark.parametrize("inputs", ROOFLINE_INPUTS)
def test_roofline_rows_equal_jax_on_its_peaks(inputs):
    flops, dbytes, resident, wire, mflops, n = inputs
    dot = {"flops": flops, "bytes": dbytes}
    coll = {"wire_total": wire, "total": wire}
    want = JH.roofline(dot, resident, coll, mflops, n).row()
    got = TH.roofline(dot, resident, coll, mflops, n,
                      peaks=(JH.PEAK_FLOPS, JH.HBM_BW, JH.ICI_BW)).row()
    assert got == want


def test_roofline_fraction_divides_by_its_own_peak():
    dot = {"flops": 1e12, "bytes": 1e9}
    rl = TH.roofline(dot, 0.0, {"wire_total": 0.0}, 8e11, 1)
    peak = TH.h100_peaks()[0]
    assert rl.peak_flops == peak
    assert rl.roofline_fraction == pytest.approx(8e11 / peak / rl.step_s)
    assert rl.dominant == "compute"


KINDS = {"all-gather": "all-gather", "reduce-scatter": "reduce-scatter",
         "all-reduce": "all-reduce", "all-to-all": "all-to-all",
         "collective-permute": "collective-permute"}


@pytest.mark.parametrize("n", [1, 4, 16])
@pytest.mark.parametrize("kind", list(KINDS))
def test_collective_record_equals_collective_bytes(kind, n):
    groups = "{{" + ",".join(str(i) for i in range(n)) + "}}"
    line = (f"  %op.1 = bf16[8,128,1536]{{2,1,0}} {kind}(%p.0), "
            f"replica_groups={groups}")
    want = JH.collective_bytes(line)
    result = 8 * 128 * 1536 * 2
    operand, wire = TH.collective_record(kind, result, n)
    assert want["counts"][kind] == 1
    assert want[kind] == operand
    assert want["wire"][kind] == wire


HAND_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import dryrun, hloanalysis
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tp

    dryrun.fake_group(4)
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    mk = lambda shape, spec: tp.place(  # noqa: E731
        torch.empty(shape, dtype=torch.bfloat16, device="meta"), spec, mesh)
    x = mk((8, 16, 64), (("data",), None, None))
    w_up = mk((64, 128), (None, "model"))
    w_down = mk((128, 64), ("model", None))
    with hloanalysis.StepCost(params={"u": w_up, "d": w_down}) as cost, \\
            tp.step_context():
        y = tp.rows_layout((x @ w_up) @ w_down, x)
    json.dump({"result": cost.result(), "param": cost.param_counts,
               "records": cost.records,
               "placements": [str(p) for p in y.placements]},
              open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def hand_cell(tmp_path_factory):
    out = tmp_path_factory.mktemp("hand") / "cost.json"
    env = dict(os.environ)
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", HAND_SCRIPT, str(out)],
                         capture_output=True, text=True, timeout=300,
                         env=env)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(out.read_text())


def test_step_cost_counts_rank_local_products(hand_cell):
    """x (8, 16, 64) over a column-parallel (64, 128) and a row-parallel
    (128, 64) weight on a 1 x 4 mesh: each rank multiplies (128, 64) by
    its (64, 32) and (128, 32) by its (32, 64) (the global products'
    FLOPs over 4), and the partial sum is all-reduced once."""
    r = hand_cell["result"]
    t = 8 * 16
    assert r["flops"] == 2.0 * t * 64 * 32 + 2.0 * t * 32 * 64
    assert r["bytes"] == 2.0 * (t * 64 + 64 * 32 + t * 32) \
        + 2.0 * (t * 32 + 32 * 64 + t * 64)
    coll = r["collectives"]
    assert coll["counts"] == {"all-reduce": 1, "all-gather": 0,
                              "reduce-scatter": 0, "all-to-all": 0,
                              "collective-permute": 0}
    out_bytes = t * 64 * 2
    assert coll["all-reduce"] == out_bytes
    assert coll["wire"]["all-reduce"] == int(2 * out_bytes * 3 / 4)
    assert hand_cell["records"] == [["all-reduce", out_bytes, 4,
                                     "_c10d_functional"]]
    assert hand_cell["placements"] == ["S(0)", "R"]


def test_step_cost_sees_no_parameter_moved(hand_cell):
    assert sum(hand_cell["param"].values()) == 0
