"""PyTorch port, the dry-run's transient memory (``launch/memory.py``,
``memory.temp_size_in_bytes`` and ``bytes_per_device_incl_cpu_temps`` of
``launch/dryrun.py``'s records).

* Hand-worked cells on a fake group of 2 (a (1, 2) mesh): a two-layer MLP
  (its forward, and a train step's forward and backward) and one attention
  layer over a cache that the rules split along its rows; the live set at
  the high-water mark is worked out below.
* Row-split cells: the temps are at least the gathered layer of the cache
  (``memory.gathered_cache_bytes``), and grow with the batch.
* The count on meta tensors equals the same count of the same SMOKE step
  run on real CPU tensors on a group of 1 (the kernel ops counted as the
  card's kernels allocate: their outputs only).
* Every family's SMOKE prefill, decode and train cell on the (2, 4) mesh
  of 8 has its temps, its peak and where it fell. JAX's
  ``temp_size_in_bytes`` of the cells that ``tests/test_torch_dryrun.py``
  compiles stands beside the port's there (``TEMP_RATIOS``).

The fake group is process-global, so each script runs in a subprocess;
the three run side by side.
"""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
FAMILIES = ("qwen2-1.5b", "arctic-480b", "rwkv6-7b", "zamba2-2.7b",
            "whisper-medium", "paligemma-3b", "gemma2-2b")
SHAPES = {"train": dict(kind="train", seq=16, batch=8),
          "prefill": dict(kind="prefill", seq=32, batch=8),
          "decode": dict(kind="decode", seq=32, batch=8)}
REAL = [("qwen2-1.5b", "train"), ("qwen2-1.5b", "prefill"),
        ("qwen2-1.5b", "decode"), ("zamba2-2.7b", "prefill")]

HAND_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun, hloanalysis
    from repro_torch.launch.memory import LiveBytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import tp
    from repro_torch.models.layers import MaskSpec

    out = {}
    dryrun.fake_group(2)
    mesh = make_mesh((1, 2), ("data", "model"), "cpu")

    def mk(shape, spec, dtype=torch.bfloat16):
        return tp.place(torch.empty(shape, dtype=dtype, device="meta"),
                        spec, mesh)

    def counted(fn):
        live = LiveBytes()
        with hloanalysis.StepCost(memory=live), tp.step_context():
            result = fn()     # held while the live bytes are read
        return {"peak": live.peak, "live_after": live.live,
                "peak_at": live.peak_at, "returned": result is not None}

    x = mk((128, 64), (None, None))
    w1 = mk((64, 256), (None, "model"))
    w2 = mk((256, 64), ("model", None))
    out["mlp_prefill"] = counted(
        lambda: tp.rows_layout(torch.relu(x @ w1) @ w2, x))

    def train():
        p = [w1.detach().requires_grad_(), w2.detach().requires_grad_()]
        y = tp.rows_layout(torch.relu(x @ p[0]) @ p[1], x)
        loss = y.float().square().mean()
        torch.autograd.grad(loss, p)
    out["mlp_train"] = counted(train)

    b, s, smax, hq, hkv, d = 2, 16, 64, 2, 1, 64
    q = mk((b, s, hq, d), (None, None, "model", None))
    k = mk((b, s, hkv, d), (None, None, None, None))
    v = mk((b, s, hkv, d), (None, None, None, None))
    kc = mk((b, smax, hkv, d), (None, "model", None, None))
    vc = mk((b, smax, hkv, d), (None, "model", None, None))
    pos = mk((b,), (None,), torch.int32)
    out["attention_prefill"] = counted(lambda: tp.cache_attention(
        q, k, v, kc, vc, cache_positions=pos, lengths=None,
        mask=MaskSpec("causal"), softcap=None))

    # row-split SMOKE cells on the (2, 4) mesh at two batches
    dryrun.fake_group(8)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    for kind in ("prefill", "decode"):
        cfg = dryrun._dryrun_cfg(get_smoke("qwen2-1.5b"), kind)
        for batch in (8, 16):
            rec = dryrun.run_cell(
                "qwen2", kind, "2x4", ".", write=False, cfg=cfg, mesh=mesh,
                shape=dict(kind=kind, seq=32, batch=batch))
            out[f"rows_{kind}_{batch}"] = rec
    json.dump(out, open(sys.argv[1], "w"))
""")

FAMILY_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    shapes, archs = json.loads(sys.argv[2]), json.loads(sys.argv[3])
    dryrun.fake_group(8)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    out = {}
    for arch in archs:
        for kind, shape in shapes.items():
            cfg = dryrun._dryrun_cfg(get_smoke(arch), kind)
            cfg = dataclasses.replace(cfg,
                                      expert_pad_to=8 if cfg.is_moe else 0)
            out[f"{arch}|{kind}"] = dryrun.run_cell(
                arch, kind, "2x4", ".", shape=shape, mesh=mesh, cfg=cfg,
                write=False)
    json.dump(out, open(sys.argv[1], "w"))
""")

REAL_SCRIPT = textwrap.dedent("""
    import functools, json, sys
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import cost as kernel_cost, ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    def as_the_kernel(op):
        # on the CPU the kernel ops run their plain versions, whose
        # intermediates the card's kernels do not allocate: run them
        # uncounted, then count their outputs, as the card's allocate
        @functools.wraps(op)
        def run(*args, **kwargs):
            cost = kernel_cost.LISTENERS[-1]
            live, cost.memory = cost.memory, None
            try:
                out = op(*args, **kwargs)
            finally:
                cost.memory = live
            live.op(torch.ops.aten.empty.memory_format, (), {}, out)
            return out
        return run

    for name in ("chunked_prefill_op", "paged_attention_op", "wkv6_op"):
        setattr(ops, name, as_the_kernel(getattr(ops, name)))
    shapes, cells = json.loads(sys.argv[2]), json.loads(sys.argv[3])
    dryrun.fake_group(1)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    zeros = lambda t: torch.zeros(t.shape, dtype=t.dtype)  # noqa: E731
    out = {}
    for arch, kind in cells:
        cfg = dryrun._dryrun_cfg(get_smoke(arch), kind)
        runs = [dryrun.trace_cell(cfg, shapes[kind], mesh, materialize=m)
                for m in (None, zeros)]
        out[f"{arch}|{kind}"] = [
            {"peak": r["live"].peak, "peak_at": r["live"].peak_at}
            for r in runs]
    json.dump(out, open(sys.argv[1], "w"))
""")


def _start(script, out, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    return subprocess.Popen([sys.executable, "-c", script, str(out), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun_memory")
    procs = {
        "hand": _start(HAND_SCRIPT, root / "hand.json"),
        "families": _start(FAMILY_SCRIPT, root / "families.json",
                           json.dumps(SHAPES), json.dumps(FAMILIES)),
        "real": _start(REAL_SCRIPT, root / "real.json", json.dumps(SHAPES),
                       json.dumps(REAL))}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: {err[-3000:]}"
    return {name: json.loads((root / f"{name}.json").read_text())
            for name in procs}


BF16 = 2


def test_mlp_prefill_peak_is_the_hidden_layer_twice(runs):
    """x (128, 64) replicated; w1 (64, 256) split by columns and w2 (256,
    64) by rows over 2 ranks. A rank computes h = x @ w1 (128, 128) and
    relu(h) (128, 128); h is freed once relu returns, before the second
    product (128, 64) and the all-reduce of its partial sum (128, 64), so
    the high-water mark is {h, relu(h)} at the relu."""
    got = runs["hand"]["mlp_prefill"]
    h = 128 * 128 * BF16
    assert got["peak"] == 2 * h
    assert got["peak_at"] == {"op": "aten.relu.default", "layer": None,
                              "backward": False}
    assert got["live_after"] == 128 * 64 * BF16   # y, reduced, returned


def test_mlp_train_peak_is_in_the_backward_of_the_square(runs):
    """The train step: loss = mean(float(y) ** 2), gradients of w1 and w2.
    After the forward a rank holds relu(h) (saved by relu and by the
    second product, 32 KiB), y (bf16, 16 KiB), float(y) (f32, 32 KiB,
    saved by the square), the loss (4 B) (the square's output is freed:
    mean's backward needs only its shape). The backward seeds a 4-byte
    one, expands and divides it to (128, 64) f32, then the square's
    backward, grad * (2 * y.pow(1)), allocates y.pow(1), 2 * it and the
    product, each (128, 64) f32: that product is the high-water mark,
    before any of the three is freed."""
    got = runs["hand"]["mlp_train"]
    f32 = 128 * 64 * 4
    saved = 128 * 128 * BF16 + 128 * 64 * BF16 + f32 + 4
    backward = 4 + f32 + 3 * f32
    assert got["peak"] == saved + backward
    assert got["peak_at"] == {"op": "aten.mul.Tensor", "layer": None,
                              "backward": True}


def test_attention_over_row_split_cache_peak_is_the_gathered_layer(runs):
    """q (2, 16, 2, 64) split by heads; the cache (2, 64, 1, 64), one KV
    head, split by rows: a rank writes its 32 rows of K and of V in place
    (at most 16,992 B of temporaries: the 16-token window it picks and the
    `where` over its rows, 8 KiB each, beside the indices), then gathers
    each whole. funcol gathers along dim 0 and moves the rows to dim 1
    with a cat, so gathering V holds the gathered K, V's all-gather result
    and the gathered V at once: 3 x (2, 64, 1, 64) bf16, at V's cat. The
    kernel op's output (2, 16, 1, 64) comes after the all-gather result is
    freed."""
    got = runs["hand"]["attention_prefill"]
    layer = 2 * 64 * 1 * 64 * BF16
    assert got["peak"] == 3 * layer
    assert got["peak_at"] == {"op": "aten.cat.default", "layer": None,
                              "backward": False}
    assert got["live_after"] == 2 * 16 * 1 * 64 * BF16


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_row_split_temps_hold_the_gathered_cache_and_grow_with_batch(
        runs, kind):
    small = runs["hand"][f"rows_{kind}_8"]
    large = runs["hand"][f"rows_{kind}_16"]
    for rec in (small, large):
        mem = rec["memory"]
        assert rec["status"] == "ok"
        assert mem["gathered_cache_bytes"] > 0
        assert mem["step_allocated_peak_bytes"] \
            >= mem["temp_size_in_bytes"] >= mem["gathered_cache_bytes"]
        assert rec["bytes_per_device_incl_cpu_temps"] \
            == rec["bytes_per_device"] + mem["temp_size_in_bytes"]
    assert large["memory"]["temp_size_in_bytes"] \
        > small["memory"]["temp_size_in_bytes"]
    assert large["memory"]["gathered_cache_bytes"] \
        == 2 * small["memory"]["gathered_cache_bytes"]


@pytest.mark.parametrize("cell", [f"{a}|{k}" for a, k in REAL])
def test_meta_count_equals_the_count_on_real_cpu_tensors(runs, cell):
    meta, real = runs["real"][cell]
    assert meta["peak"] == real["peak"] > 0
    assert meta["peak_at"] == real["peak_at"]


@pytest.mark.parametrize("kind", list(SHAPES))
@pytest.mark.parametrize("arch", FAMILIES)
def test_every_family_cell_has_its_temps(runs, arch, kind):
    rec = runs["families"][f"{arch}|{kind}"]
    assert rec["status"] == "ok", rec.get("traceback")
    mem = rec["memory"]
    assert mem["temp_size_in_bytes"] is not None
    assert mem["step_allocated_peak_bytes"] > 0
    assert rec["bytes_per_device_incl_cpu_temps"] \
        == rec["bytes_per_device"] + mem["temp_size_in_bytes"]
    assert rec["bytes_per_device_incl_cpu_temps"] \
        == sum(mem["arguments"].values()) + mem["step_allocated_peak_bytes"]
    assert mem["peak_at"]["op"]
    assert mem["peak_at"]["backward"] in (True, False)
    assert not {"memory.temp_size_in_bytes",
                "bytes_per_device_incl_cpu_temps"} & set(rec["not_counted"])
