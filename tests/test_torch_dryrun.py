"""PyTorch port, the dry-run (``launch/dryrun.py``) and the hillclimb
(``launch/hillclimb.py``) against the JAX package's.

* Specs: for every architecture the dry-run sweeps, every shape and both
  production meshes (no devices: each package's ``AbstractMesh``), the
  inputs' shapes, dtypes and specs, the cache's tree and specs and the
  dry-run config's fields equal JAX's.
* Traces against compiles on a small forced mesh: a JAX subprocess with 8
  forced host devices compiles SMOKE cells on a (2, 4) ``("data",
  "model")`` mesh (JAX's own ``input_specs``, ``_cache_for``,
  ``build_step``, ``memory_analysis`` and ``module_cost``; the shapes are
  set in the subprocess, JAX's ``SHAPES`` in its file is not edited); a
  port subprocess traces the same cells with ``run_cell`` as rank 0 of a
  fake group of 8. Experts are padded to the mesh's 8 in both.
  ``bytes_per_device`` and ``model_flops_total`` are equal; dot FLOPs and
  collectives are equal or differ as
  ``DOT_DIFFS`` / ``COLL_DIFFS`` name, each with its cause and its ratio
  held; the EP all-to-all volumes of the serving cells are equal. The
  port's ``temp_size_in_bytes`` (its own count of live buffers) stands
  beside XLA's, each ratio held in ``TEMP_RATIOS`` with its cause.
* One full-width cell (qwen2-1.5b decode_32k on the 16 x 16 mesh) ends ok
  and its ``bytes_per_device`` is the local shard bytes the specs give
  (and the output tuple's pointers);
  full-width kernel-op shapes on the (1, 4) worker mesh are ones the
  tensor-core kernels take.
* Each hillclimb variant moves the field its hypothesis names.
"""
import json
import math
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import dryrun as JD  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import sharding as JS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as TD  # noqa: E402
from repro_torch.launch import hillclimb as TH  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import sharding as TS  # noqa: E402
from repro_torch.models.layers import MetaGenerator  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
SPEC_CASES = [(a, s, m) for a in TD.ASSIGNED for s in TD.SHAPES
              for m in MESHES]
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32,
          jnp.dtype(jnp.float8_e4m3fn): torch.float8_e4m3fn}


def _rules(mesh):
    shape, names = MESHES[mesh]
    return (JS.make_rules(JAbstractMesh(shape, names)),
            TS.make_rules(tmesh.AbstractMesh(shape, names)))


def _jax_leaves(tree, specs):
    """{"a/b": (shape, dtype, spec)} of a JAX tree and its spec tree."""
    flat = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        keys = "/".join(str(p.key) if hasattr(p, "key") else f"[{p.idx}]"
                        for p in path)
        flat[keys] = tuple(s)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = "/".join(str(p.key) if hasattr(p, "key") else f"[{p.idx}]"
                        for p in path)
        out[keys] = (tuple(leaf.shape), DTYPES[jnp.dtype(leaf.dtype)],
                     flat[keys])
    return out


def _port_leaves(tree, specs, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out |= _port_leaves(tree[k], specs[k],
                                f"{prefix}/{k}".lstrip("/"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, (t, s) in enumerate(zip(tree, specs)):
            out |= _port_leaves(t, s, f"{prefix}/[{i}]")
        return out
    return {prefix: (tuple(tree.shape), tree.dtype, tuple(specs))}


@pytest.mark.parametrize("arch,shape,mesh", SPEC_CASES)
def test_inputs_cache_and_config_equal_jax(arch, shape, mesh):
    kind = TD.SHAPES[shape]["kind"]
    jcfg = JD._dryrun_cfg(jax_config(arch), kind)
    tcfg = TD._dryrun_cfg(get_config(arch), kind)
    for f in ("scan_layers", "attn_unroll_chunks", "attn_q_chunk",
              "expert_pad_to"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert TD.SHAPES == JD.SHAPES and set(TD.ASSIGNED) == set(JD.ASSIGNED)
    jr, tr = _rules(mesh)
    jins, jspecs = JD.input_specs(jcfg, shape, jr)
    tins, tspecs = TD.input_specs(tcfg, shape, tr)
    assert _port_leaves(tins, tspecs) == _jax_leaves(jins, jspecs)
    jtree, jc = JD._cache_for(jcfg, japi.build(jcfg), shape, jr)
    ttree, tc = TD._cache_for(tcfg, tapi.build(tcfg), shape, tr)
    if jtree is None:
        assert ttree is None and tc is None
        return
    assert _port_leaves(ttree, tc) == _jax_leaves(jtree, jc)


# ------------------------------------------------------- 8 forced devices

SMALL = {"t_train": dict(kind="train", seq=64, batch=8),
         "t_prefill": dict(kind="prefill", seq=128, batch=8),
         "t_decode": dict(kind="decode", seq=128, batch=8)}
CELLS = [("qwen2-1.5b", "t_train"), ("qwen2-1.5b", "t_prefill"),
         ("qwen2-1.5b", "t_decode"), ("gemma2-2b", "t_decode"),
         ("arctic-480b", "t_prefill"), ("arctic-480b", "t_decode"),
         ("arctic-480b", "t_train"), ("rwkv6-7b", "t_decode"),
         ("zamba2-2.7b", "t_prefill"), ("whisper-medium", "t_prefill"),
         ("paligemma-3b", "t_train")]
KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

CAUSES = {
    "gathered_cache": (
        "the KV heads do not divide the model axis, so the rules split the "
        "cache along its rows: the port gathers it whole for the kernel "
        "and every model rank attends over every row (and the gathers are "
        "all-gathers), where GSPMD splits the keys over the model axis "
        "and reduces the partial softmax sums"),
    "replicated_heads": (
        "a head count that does not divide the model axis leaves those "
        "weights replicated (rwkv6's and mamba2's 2 heads of 64, and "
        "rwkv6's LoRA, mixing and receptance weights, which the rules "
        "replicate): the port computes their products on every model "
        "rank over replicated activations, where GSPMD splits the work "
        "along another dim (the sequence, or the head dim) over the model "
        "axis and reshards with all-to-all / collective-permute"),
    "megatron": (
        "DTensor reduces a row-parallel product's partial sum where it "
        "meets the residual stream (one all-reduce a sublayer, and one "
        "for the vocabulary-split embedding) and a replicated weight's "
        "gradient where it is used; XLA fuses, moves and resizes its "
        "reductions (it reduces some in f32, some after a reshape)"),
    "zero1": (
        "ZeRO-1: the port reduce-scatters each gradient that is a partial "
        "sum over the data axis onto the rank's slice of the optimizer "
        "state; XLA all-reduces and slices, or reshards with "
        "all-to-all / collective-permute"),
    "remat": (
        "the port's \"dots\" remat keeps every matrix product, the "
        "attention's batched ones too, so its backward recomputes none; "
        "JAX's dots_with_no_batch_dims_saveable keeps only the unbatched "
        "ones and recomputes the attention's scores and weighted sums"),
    "xla_a2a": (
        "XLA merges the EP body's per-axis all-to-all pair into one op "
        "(the volume is the same) and, in training, keeps the forward's "
        "exchanges for the backward where the port's remat recomputes "
        "them and its final gather's adjoint is an all-to-all"),
}
# cell -> (port dot FLOPs / JAX dot FLOPs, cause); cells absent are equal
DOT_DIFFS = {
    "qwen2-1.5b|t_prefill": (2.4104683195592287, "gathered_cache"),
    "qwen2-1.5b|t_decode": (1.3870967741935485, "gathered_cache"),
    "arctic-480b|t_prefill": (1.101159114857745, "gathered_cache"),
    "qwen2-1.5b|t_train": (0.9292035398230089, "remat"),
    "arctic-480b|t_train": (0.8812301166489925, ("replicated_heads", "remat")),
    "rwkv6-7b|t_decode": (1.8804347826086956, "replicated_heads"),
    "zamba2-2.7b|t_prefill": (1.6236054022313564, "replicated_heads"),
    "paligemma-3b|t_train": (0.9771784232365145,
                             ("replicated_heads", "remat")),
}
# cell -> kind -> (JAX count, port count, JAX operand bytes, port operand
# bytes, cause); kinds absent are equal
COLL_DIFFS = {
    "qwen2-1.5b|t_train": {
        "all-reduce": (12, 22, 2048972, 1454024, "megatron"),
        "all-gather": (15, 14, 335808, 334784, "zero1"),
        "reduce-scatter": (0, 14, 0, 669568, "zero1"),
        "all-to-all": (1, 0, 98304, 0, "zero1"),
        "collective-permute": (1, 0, 1024, 0, "zero1")},
    "qwen2-1.5b|t_prefill": {
        "all-reduce": (1, 5, 1536, 983040, "megatron"),
        "all-gather": (7, 9, 403456, 133120, "gathered_cache")},
    "qwen2-1.5b|t_decode": {
        "all-reduce": (5, 5, 14592, 7680, "gathered_cache"),
        "all-gather": (1, 9, 2048, 133120, "gathered_cache")},
    "gemma2-2b|t_decode": {
        "all-reduce": (7, 9, 17920, 9216, "gathered_cache"),
        "all-gather": (3, 9, 5120, 133120, "gathered_cache")},
    "arctic-480b|t_prefill": {
        "all-reduce": (2, 5, 263168, 655360, "megatron"),
        "all-gather": (8, 7, 247808, 133120, "gathered_cache"),
        "all-to-all": (4, 8, 1048576, 1048576, "xla_a2a")},
    "arctic-480b|t_decode": {
        "all-reduce": (7, 5, 9472, 5120, "gathered_cache"),
        "all-gather": (4, 7, 4096, 68096, "gathered_cache"),
        "all-to-all": (4, 8, 65536, 65536, "xla_a2a")},
    "arctic-480b|t_train": {
        "all-reduce": (19, 25, 1356128, 939656, "megatron"),
        "all-gather": (22, 16, 128640, 127616, "zero1"),
        "reduce-scatter": (1, 12, 131072, 124160, "zero1"),
        "all-to-all": (13, 26, 1638400, 1703936, "xla_a2a"),
        "collective-permute": (1, 0, 1024, 0, "zero1")},
    "rwkv6-7b|t_decode": {
        "all-reduce": (10, 7, 28416, 14336, "replicated_heads"),
        "all-gather": (12, 19, 308228, 11264, "replicated_heads"),
        "all-to-all": (1, 0, 2048, 0, "replicated_heads"),
        "collective-permute": (1, 0, 512, 0, "replicated_heads")},
    "zamba2-2.7b|t_prefill": {
        "all-reduce": (15, 19, 1724416, 1716224, "megatron"),
        "all-gather": (7, 7, 280576, 395264, "replicated_heads")},
    "whisper-medium|t_prefill": {
        "all-reduce": (6, 16, 1441792, 1441792, "megatron")},
    "paligemma-3b|t_train": {
        "all-reduce": (15, 28, 1358284, 1119752, "megatron"),
        "all-gather": (13, 12, 85760, 84864, "zero1"),
        "reduce-scatter": (0, 13, 0, 177920, "zero1"),
        "all-to-all": (1, 0, 57344, 0, "zero1"),
        "collective-permute": (4, 0, 19328, 0, "zero1")},
}

# the port's transient bytes (memory.temp_size_in_bytes, its own count of
# live buffers, launch/memory.py) beside XLA's buffer assignment's
TEMP_CAUSES = {
    "kernel": (
        "the port's kernel ops (attention, WKV6) allocate their outputs "
        "only, and a decode's peak is the gathered layer of a row-split "
        "cache (or rwkv6's new WKV state), where XLA's jnp forms hold "
        "their intermediates (attention scores and weights, the WKV outer "
        "products)"),
    "eager": (
        "PyTorch runs op by op: each elementwise op's output (rope tables, "
        "norms, residual adds, gates, the MoE dispatch and the SSD's chunk "
        "products, whisper's sinusoids and its cross K/V stacked from "
        "per-layer pieces) is a buffer of its own, alive until Python "
        "drops it, where XLA fuses elementwise chains into the loops that "
        "consume them and reuses buffers by liveness"),
    "remat": (
        "the port's \"dots\" remat keeps the attention's batched products "
        "for the backward too (scores and weighted sums), which JAX's "
        "dots_with_no_batch_dims_saveable recomputes"),
}
# cell -> (port temps / JAX temp_size_in_bytes, causes)
TEMP_RATIOS = {
    "qwen2-1.5b|t_train": (1.2912256192089988, ("remat", "eager")),
    "qwen2-1.5b|t_prefill": (1.1663694189974738, ("eager",)),
    "qwen2-1.5b|t_decode": (0.6117508930578801, ("kernel",)),
    "gemma2-2b|t_decode": (0.9153204398938187, ("kernel",)),
    "arctic-480b|t_prefill": (1.9213638856363664, ("eager",)),
    "arctic-480b|t_decode": (0.8688937686741783, ("kernel",)),
    "arctic-480b|t_train": (1.1715183903251143, ("remat", "eager")),
    "rwkv6-7b|t_decode": (0.5191995233968805, ("kernel",)),
    "zamba2-2.7b|t_prefill": (2.58793897882939, ("eager",)),
    "whisper-medium|t_prefill": (5.013265528616545, ("eager",)),
    "paligemma-3b|t_train": (1.2375185187124063, ("remat", "eager")),
}

JAX_SCRIPT = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    assert len(jax.devices()) == 8   # before the dry-run module's import
    import dataclasses
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.configs import get_smoke
    from repro.launch import dryrun, hloanalysis
    from repro.models import api as model_api, sharding
    from repro.train import optimizer

    shapes, cells = json.loads(sys.argv[2]), json.loads(sys.argv[3])
    dryrun.SHAPES.update(shapes)
    mesh = compat.make_mesh((2, 4), ("data", "model"),
                            axis_types=(compat.AxisType.Auto,) * 2)
    compat.set_mesh(mesh)
    rules = sharding.make_rules(mesh)
    out = {}
    for arch, shape in cells:
        info = dryrun.SHAPES[shape]
        kind, seq, batch = info["kind"], info["seq"], info["batch"]
        cfg = dryrun._dryrun_cfg(get_smoke(arch), kind)
        cfg = dataclasses.replace(cfg, expert_pad_to=8 if cfg.is_moe else 0)
        api = model_api.build(cfg)
        pshape = jax.eval_shape(lambda: api.init(jax.random.PRNGKey(0)))
        pspecs = sharding.param_specs(cfg, pshape, rules)
        ins, ispecs = dryrun.input_specs(cfg, shape, rules)
        step = dryrun.build_step(cfg, api, kind, mesh, rules)
        if kind == "train":
            oshape = jax.eval_shape(optimizer.init_state, pshape)
            ospecs = optimizer.state_specs(pspecs, pshape, zero_size=2)
            lowered = jax.jit(step, in_shardings=(pspecs, ospecs, ispecs),
                              out_shardings=(pspecs, ospecs, P()),
                              donate_argnums=(0, 1)).lower(pshape, oshape,
                                                           ins)
        else:
            cshape, cspecs = dryrun._cache_for(cfg, api, shape, rules)
            order = list(ins)
            lowered = jax.jit(
                step, in_shardings=(pspecs, cspecs) + tuple(
                    ispecs[k] for k in order),
                out_shardings=(P(sharding.batch_spec(rules, batch), None),
                               cspecs),
                donate_argnums=(1,)).lower(pshape, cshape,
                                           *[ins[k] for k in order])
        compiled = lowered.compile()
        mem = compiled.memory_analysis()
        mc = hloanalysis.module_cost(compiled.as_text())
        dec = dryrun.WHISPER_DEC_TRAIN if kind == "train" \\
            else dryrun.WHISPER_DEC_PREFILL
        out[f"{arch}|{shape}"] = {
            "args": mem.argument_size_in_bytes,
            "outs": mem.output_size_in_bytes,
            "alias": mem.alias_size_in_bytes,
            "temps": mem.temp_size_in_bytes,
            "model_flops_total": hloanalysis.model_flops(cfg, kind, batch,
                                                         seq, dec),
            "dot_flops": mc["flops"],
            "collectives": {k: mc["collectives"][k]
                            for k in mc["collectives"]["counts"]},
            "counts": mc["collectives"]["counts"]}
    json.dump(out, open(sys.argv[1], "w"))
""")

PORT_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch.mesh import make_mesh

    shapes, cells = json.loads(sys.argv[2]), json.loads(sys.argv[3])
    out = {"cells": {}, "hill": {}, "kernels": {}}
    # the small cells, rank 0 of a fake group of 8 on (2, 4)
    dryrun.fake_group(8)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")

    def smoke(arch, kind):
        cfg = dryrun._dryrun_cfg(get_smoke(arch), kind)
        return dataclasses.replace(cfg, expert_pad_to=8 if cfg.is_moe
                                   else 0)

    for arch, shape in cells:
        rec = dryrun.run_cell(arch, shape, "2x4", ".", shape=shapes[shape],
                              mesh=mesh, cfg=smoke(arch,
                                                   shapes[shape]["kind"]),
                              write=False)
        assert rec["status"] == "ok", rec.get("traceback")
        out["cells"][f"{arch}|{shape}"] = rec
    # hillclimb: each variant on a SMOKE cell
    bf16 = dataclasses.replace(smoke("qwen2-1.5b", "decode"),
                               dtype=torch.bfloat16)
    runs = [("qwen2", "t_decode", v, bf16) for v in ("baseline", "kv_fp8")]
    runs += [("gemma2", "t_decode", v, smoke("gemma2-2b", "decode"))
             for v in ("baseline", "window_cache", "kv_fp8_window")]
    runs += [("arctic", s, v, smoke("arctic-480b", shapes[s]["kind"]))
             for s in ("t_decode", "t_train")
             for v in ("baseline", "ep_floor1", "ep_cf1", "ep_fused_a2a",
                       "ep_cf1_fused", "ep_allgather", "remat_none",
                       "ep_train_best")]
    runs += [("qwen2", "t_train", v, smoke("qwen2-1.5b", "train"))
             for v in ("baseline", "remat_none")]
    for name, shape, v, cfg in runs:
        out["hill"][f"{name}|{shape}|{v}"] = hillclimb.run_variant(
            name, shape, v, shape=shapes[shape], mesh=mesh, cfg=cfg,
            write=False)
    full = dataclasses.replace(smoke("qwen2-1.5b", "train"),
                               remat_policy="full")
    out["hill"]["qwen2|t_train|remat_full"] = hillclimb.run_variant(
        "qwen2", "t_train", "baseline", shape=shapes["t_train"], mesh=mesh,
        cfg=full, write=False)
    out["cells"]["qwen2-1.5b|t_decode|run_cell"] = dryrun.run_cell(
        "qwen2", "t_decode", "2x4", ".", shape=shapes["t_decode"],
        mesh=mesh, cfg=bf16, write=False)
    # full width on the (1, 4) worker mesh: what the kernel ops are given
    dryrun.fake_group(4)
    mesh = make_mesh((1, 4), ("data", "model"), "cpu")
    for arch, cut in (("qwen2-1.5b", {}), ("arctic-480b",
                                           {"num_layers": 2})):
        cfg = dataclasses.replace(get_config(arch), **cut)
        for kind, shape in (("prefill", dict(kind="prefill", seq=1024,
                                             batch=4, cache_len=1088)),
                            ("decode", dict(kind="decode", seq=1088,
                                            batch=4))):
            tr = dryrun.trace_cell(cfg, shape, mesh)
            out["kernels"][f"{arch}|{kind}"] = sorted(
                set(tr["cost"].kernel_calls))
    # one full-width cell on the 16 x 16 mesh
    out["full"] = dryrun.run_cell("qwen2-1.5b", "decode_32k", "single", ".",
                                  force=True, write=False)
    json.dump(out, open(sys.argv[1], "w"))
""")


def _subprocess(script, out, *args):
    env = dict(os.environ)
    src = str(ROOT / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", script, str(out), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    root = tmp_path_factory.mktemp("dryrun")
    args = (json.dumps(SMALL), json.dumps(CELLS))
    procs = {"jax": _subprocess(JAX_SCRIPT, root / "jax.json", *args),
             "port": _subprocess(PORT_SCRIPT, root / "port.json", *args)}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: {err[-3000:]}"
    return (json.loads((root / "jax.json").read_text()),
            json.loads((root / "port.json").read_text()))


CELL_KEYS = [f"{a}|{s}" for a, s in CELLS]


@pytest.mark.parametrize("cell", CELL_KEYS)
def test_bytes_per_device_equal_jax(traced, cell):
    """Exactly, and each of the three sizes it is made of (reckoned as XLA
    reckons them: rwkv6's decode never reads ``lengths``, whisper's
    prefill overwrites the donated cross K/V, and every output leaf has
    an 8-byte pointer in the output tuple)."""
    jax_out, port = traced
    want, got = jax_out[cell], port["cells"][cell]
    mem = got["memory"]
    assert mem["argument_size_in_bytes"] == want["args"]
    assert mem["output_size_in_bytes"] == want["outs"]
    assert mem["alias_size_in_bytes"] == want["alias"]
    assert got["bytes_per_device"] \
        == want["args"] + want["outs"] - want["alias"]
    assert got["model_flops_total"] == want["model_flops_total"]
    assert got["status"] == "ok" and got["n_devices"] == 8


@pytest.mark.parametrize("cell", CELL_KEYS)
def test_dot_flops_equal_jax_or_named(traced, cell):
    jax_out, port = traced
    want = jax_out[cell]["dot_flops"]
    got = port["cells"][cell]["cost"]["dot_flops"]
    if cell not in DOT_DIFFS:
        assert got == want
        return
    ratio, causes = DOT_DIFFS[cell]
    causes = (causes,) if isinstance(causes, str) else causes
    assert all(c in CAUSES for c in causes)
    assert got / want == pytest.approx(ratio, rel=1e-9)


@pytest.mark.parametrize("cell", CELL_KEYS)
def test_collectives_equal_jax_or_named(traced, cell):
    jax_out, port = traced
    want, got = jax_out[cell], port["cells"][cell]
    diffs = COLL_DIFFS.get(cell, {})
    for kind in KINDS:
        jc, pc = want["counts"][kind], got["collective_counts"][kind]
        jb, pb = want["collectives"][kind], got["collectives"][kind]
        if kind not in diffs:
            assert (pc, pb) == (jc, jb), kind
            continue
        *numbers, cause = diffs[kind]
        assert cause in CAUSES
        assert (jc, pc, jb, pb) == tuple(numbers), kind
    assert sum(got["param_collectives"].values()) == 0


@pytest.mark.parametrize("cell", CELL_KEYS)
def test_temps_beside_jax_with_their_causes(traced, cell):
    """The port's ``temp_size_in_bytes`` is its own count of live buffers,
    not XLA's buffer assignment: each cell's ratio to JAX's is held, with
    its cause. The count itself is held by hand-worked cells in
    ``tests/test_torch_dryrun_memory.py``."""
    jax_out, port = traced
    got = port["cells"][cell]
    ratio, causes = TEMP_RATIOS[cell]
    assert all(c in TEMP_CAUSES for c in causes)
    assert got["memory"]["temp_size_in_bytes"] / jax_out[cell]["temps"] \
        == pytest.approx(ratio, rel=1e-9)
    assert got["bytes_per_device_incl_cpu_temps"] == got["bytes_per_device"] \
        + got["memory"]["temp_size_in_bytes"]


@pytest.mark.parametrize("cell", ["arctic-480b|t_prefill",
                                  "arctic-480b|t_decode"])
def test_ep_all_to_all_volume_equal_jax(traced, cell):
    """Both packages issue the EP exchanges explicitly: the same volume,
    the port in twice as many ops (one per mesh axis, which XLA pairs)."""
    jax_out, port = traced
    got = port["cells"][cell]
    assert got["collectives"]["all-to-all"] \
        == jax_out[cell]["collectives"]["all-to-all"] > 0
    assert got["collective_counts"]["all-to-all"] \
        == 2 * jax_out[cell]["counts"]["all-to-all"]


def test_train_cells_gather_the_zero1_state_back(traced):
    _, port = traced
    for cell in ("qwen2-1.5b|t_train", "arctic-480b|t_train",
                 "paligemma-3b|t_train"):
        rec = port["cells"][cell]
        assert rec["zero1_gather_counts"]["all-gather"] > 0
        assert sum(rec["param_collectives"].values()) == 0


# ------------------------------------------------------- full width


def _local_bytes(shape, spec, sizes, dtype) -> int:
    n = 1
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        parts = math.prod(sizes[a] for a in axes)
        assert d % parts == 0
        n *= d // parts
    return n * torch.empty((), dtype=dtype).element_size()


def test_full_width_cell_bytes_are_the_local_shards(traced):
    """qwen2-1.5b decode_32k on 16 x 16: parameters, cache, inputs and the
    (rows, vocab) f32 logits, each leaf's local shard under its spec."""
    _, port = traced
    rec = port["full"]
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    cfg = TD._dryrun_cfg(get_config("qwen2-1.5b"), "decode")
    rules = TS.make_rules(tmesh.AbstractMesh((16, 16), ("data", "model")))
    sizes = rules.sizes
    api = tapi.build(cfg)
    params = api.init(MetaGenerator())
    leaves = _port_leaves(params, TS.param_specs(cfg, params, rules))
    cache = api.init_cache(128, 32768, "meta")
    leaves |= {f"cache/{k}": v for k, v in _port_leaves(
        cache, TS.cache_specs(cfg, rules, 128, cache)).items()}
    total = sum(_local_bytes(s, sp, sizes, dt)
                for s, dt, sp in leaves.values())
    b = TS.batch_spec(rules, 128)
    total += 2 * _local_bytes((128,), (b,), sizes, torch.int32)
    total += _local_bytes((128, cfg.vocab_size), (b, None), sizes,
                          torch.float32)
    total += TD.TUPLE_POINTER_BYTES * 3          # logits, k, v
    assert rec["bytes_per_device"] == total
    assert sum(rec["param_collectives"].values()) == 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")


def test_full_width_gathered_cache_is_one_layer_of_kv(traced):
    """qwen2-1.5b decode_32k on 16 x 16: the rules split its cache (2 KV
    heads) along the rows, so a rank gathers one layer's K and V whole:
    its 8 rows x 32768 tokens x 2 heads x 128, bf16, twice."""
    _, port = traced
    mem = port["full"]["memory"]
    assert mem["gathered_cache_bytes"] == 2 * 8 * 32768 * 2 * 128 * 2


@pytest.mark.parametrize("cell", CELL_KEYS)
def test_gathered_cache_where_the_gathered_cache_is_named(traced, cell):
    """A cell gathers a cache exactly where its collectives name the
    gathered cache as a cause."""
    _, port = traced
    got = port["cells"][cell]["memory"]["gathered_cache_bytes"]
    named = any(d[-1] == "gathered_cache"
                for d in COLL_DIFFS.get(cell, {}).values())
    assert (got > 0) == named


TENSOR_CORE_D = (64, 80, 128, 256)


@pytest.mark.parametrize("cell,hq,hkv", [("qwen2-1.5b|prefill", 3, 1),
                                         ("qwen2-1.5b|decode", 3, 1),
                                         ("arctic-480b|prefill", 14, 2),
                                         ("arctic-480b|decode", 14, 2)])
def test_full_width_kernel_shapes_suit_the_tensor_cores(traced, cell, hq,
                                                        hkv):
    """On the (1, 4) worker mesh each rank's kernel op gets bf16 at a
    tensor-core head dim and the local group: qwen2's 12 query heads 3 a
    rank over the one (gathered) KV head they read (G = 3), arctic's 56 /
    8 heads 14 / 2 a rank (G = 7)."""
    _, port = traced
    calls = port["kernels"][cell]
    assert len(calls) == 1
    name, q, kv, qdt, kvdt = calls[0]
    assert qdt == kvdt == "torch.bfloat16"
    assert q[-1] == kv[-1] and q[-1] in TENSOR_CORE_D
    assert q[-2] == hq and kv[-2] == hkv
    assert name == ("chunked_prefill" if cell.endswith("prefill")
                    else "paged_attention")


# ------------------------------------------------------- hillclimb


def _hill(port, key):
    rec = port["hill"][key]
    assert rec["status"] == "ok", rec.get("error")
    return rec


def test_hillclimb_baseline_is_run_cell(traced):
    _, port = traced
    base = _hill(port, "qwen2|t_decode|baseline")
    cell = port["cells"]["qwen2-1.5b|t_decode|run_cell"]
    assert base["bytes_per_device"] == cell["bytes_per_device"]
    assert base["roofline"] == cell["roofline"]
    assert base["collectives"]["wire_total"] \
        == cell["collectives"]["wire_total"]
    assert set(TH.VARIANTS) >= {"kv_fp8", "window_cache", "ep_floor1",
                                "ep_cf1", "ep_fused_a2a", "ep_cf1_fused",
                                "ep_allgather", "remat_none",
                                "ep_train_best"}


def test_kv_fp8_halves_the_cache(traced):
    _, port = traced
    base = _hill(port, "qwen2|t_decode|baseline")["arguments"]["cache"]
    assert _hill(port, "qwen2|t_decode|kv_fp8")["arguments"]["cache"] \
        == base / 2


def test_window_cache_shrinks_the_local_layers_to_the_window(traced):
    """gemma2 SMOKE (4 layers, window 8) at 128 rows: the two local layers
    keep 8 rows each."""
    _, port = traced
    base = _hill(port, "gemma2|t_decode|baseline")["arguments"]["cache"]
    ring = _hill(port, "gemma2|t_decode|window_cache")["arguments"]["cache"]
    assert ring == base * (2 * 128 + 2 * 8) / (4 * 128)
    both = _hill(port, "gemma2|t_decode|kv_fp8_window")["arguments"]
    assert both["cache"] == ring / 4        # f32 SMOKE -> e4m3


def test_ep_fused_a2a_halves_the_all_to_all_count(traced):
    """The dispatch and return exchanges go from one per mesh axis to one;
    in training each layer's final gather also has an all-to-all adjoint,
    which stays."""
    _, port = traced
    layers = 2                                    # arctic SMOKE
    for shape, adjoints in (("t_decode", 0), ("t_train", layers)):
        base = _hill(port, f"arctic|{shape}|baseline")
        fused = _hill(port, f"arctic|{shape}|ep_fused_a2a")
        assert 2 * (fused["collective_counts"]["all-to-all"] - adjoints) \
            == base["collective_counts"]["all-to-all"] - adjoints > 0


def test_ep_allgather_trades_all_to_all_for_gathers_and_sums(traced):
    _, port = traced
    base = _hill(port, "arctic|t_decode|baseline")
    ag = _hill(port, "arctic|t_decode|ep_allgather")
    assert base["collective_bytes"]["all-to-all"] > 0
    assert ag["collective_bytes"]["all-to-all"] == 0
    assert ag["collective_bytes"]["all-gather"] \
        > base["collective_bytes"]["all-gather"]
    assert ag["collective_bytes"]["all-reduce"] \
        > base["collective_bytes"]["all-reduce"]


def test_ep_floor1_and_ep_cf1_shrink_the_buffers(traced):
    _, port = traced
    dec = _hill(port, "arctic|t_decode|baseline")["collective_bytes"]
    assert _hill(port, "arctic|t_decode|ep_floor1")["collective_bytes"][
        "all-to-all"] < dec["all-to-all"]
    train = _hill(port, "arctic|t_train|baseline")
    cf1 = _hill(port, "arctic|t_train|ep_cf1")
    assert cf1["collective_bytes"]["all-to-all"] \
        < train["collective_bytes"]["all-to-all"]
    assert cf1["dot_flops"] < train["dot_flops"]
    both = _hill(port, "arctic|t_train|ep_cf1_fused")
    assert both["collective_counts"]["all-to-all"] \
        < cf1["collective_counts"]["all-to-all"]


def test_remat_none_lowers_train_flops(traced):
    """No remat lowers the train FLOPs below a remat that recomputes the
    products ("full"). The port's "dots" keeps every product (the "remat"
    cause above), so its backward recomputes none and ``remat_none`` gives
    its FLOPs; what it drops is the saved non-product activations, which
    the dry-run does not count."""
    _, port = traced
    full = _hill(port, "qwen2|t_train|remat_full")["dot_flops"]
    for name in ("qwen2", "arctic"):
        base = _hill(port, f"{name}|t_train|baseline")["dot_flops"]
        none = _hill(port, f"{name}|t_train|remat_none")["dot_flops"]
        assert none == base
    assert _hill(port, "qwen2|t_train|remat_none")["dot_flops"] < full
    best = _hill(port, "arctic|t_train|ep_train_best")["dot_flops"]
    assert best < _hill(port, "arctic|t_train|remat_none")["dot_flops"]


# ------------------------------------------------------- records


def test_failed_cell_records_the_error_and_the_sweep_fails(monkeypatch,
                                                           tmp_path):
    """A cell that raises records status "error" with its traceback, as
    JAX's does, and ``main`` returns 1 when any cell failed; a pure
    full-attention arch skips long_500k."""
    def boom(*a, **k):
        raise RuntimeError("no strategy")
    monkeypatch.setattr(TD, "trace_cell", boom)
    monkeypatch.setattr(TD, "production_mesh", lambda kind: None)
    rec = TD.run_cell("qwen2-1.5b", "decode_32k", "single", tmp_path)
    assert rec["status"] == "error" and "no strategy" in rec["error"]
    assert "Traceback" in rec["traceback"]
    assert json.loads((tmp_path / "qwen2-1.5b__decode_32k__single.json")
                      .read_text())["status"] == "error"
    skip = TD.run_cell("qwen2-1.5b", "long_500k", "single", tmp_path)
    assert skip["status"] == "skipped"
    monkeypatch.setattr(sys, "argv", ["dryrun", "--arch", "qwen2-1.5b",
                                      "--shape", "train_4k", "--out",
                                      str(tmp_path)])
    assert TD.main() == 1
