"""Name the owners of a deepseek-7b decode step's kernels on the card.

    python3 step_owners.py [tree ...]

For each tree (a checkout's root; default: this one), in a process of its
own: full-width deepseek-7b with the benchmark's configuration and weights
(``servebench/``), 16 slots of 1024 at length 200. One eager decode step
runs under ``torch.profiler`` with the model's functions wrapped in
``record_function`` ranges, and each kernel is put down to the innermost
range that launched it (a graph replay names no owner); then the same step
as the executor's CUDA graph replay: its kernels counted in one profiled
replay, the device time of 50 replays back to back (CUDA events), and the
launch counts of the wrappers in ``ops.COUNTED``. Needs a CUDA card.
"""
import collections
import functools
import json
import os
import subprocess
import sys

# (module, functions) whose calls become the owner ranges; a name a tree
# lacks is left out
WRAPPED = {
    "repro_torch.models.layers": [
        "rms_norm", "apply_norm", "add_norm", "rotate", "_cache_write",
        "to_e4m3", "_activate", "apply_mlp", "embed", "unembed", "_project",
        "_out_project", "compute_kv", "_decode_attention", "rope_tables",
        "decode_block_table", "apply_attention"],
    "repro_torch.models.transformer": ["_block_fn", "_run_blocks", "decode"],
    "repro_torch.kernels.ops": [
        "paged_attention_op", "chunked_prefill_op", "add_rms_norm_op",
        "rope_cache_write_op", "gated_act_op"]}
SLOTS_LENGTH = 200
REPLAYS = 50


def _wrap(mod, name, record_function):
    fn = getattr(mod, name)

    @functools.wraps(fn)
    def inner(*a, **k):
        with record_function("owner:" + name):
            return fn(*a, **k)
    setattr(mod, name, inner)


def _owners(prof) -> tuple:
    """{owner: [kernels, device us, Counter of ATen ops]}, kernels, us."""
    owners = collections.defaultdict(lambda: [0, 0.0, collections.Counter()])
    total_k, total_us = 0, 0.0
    for e in prof.events():
        if not getattr(e, "kernels", None):
            continue
        p, owner = e, "(none)"
        while p is not None:
            if p.name.startswith("owner:"):
                owner = p.name[6:]
                break
            p = p.cpu_parent
        for k in e.kernels:
            o = owners[owner]
            o[0] += 1
            o[1] += k.duration
            o[2][e.name] += 1
            total_k += 1
            total_us += k.duration
    return owners, total_k, total_us


def one(root: str) -> None:
    sys.path[:0] = [os.path.join(root, "src"), root]
    import importlib

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from servebench import cells, weights
    from repro_torch.kernels import ops
    from repro_torch.models import api as model_api
    from repro_torch.serving.executor import ExecutorKernels

    for mod_name, names in WRAPPED.items():
        mod = importlib.import_module(mod_name)
        for name in names:
            if hasattr(mod, name):
                _wrap(mod, name, record_function)
    dev = torch.device("cuda")
    cell = cells.Cell.load("deepseek-7b.short")
    cfg = cell.config.port_config()
    api = model_api.build(cfg)
    params = api.prepare(weights.make(cell.config.shape(), 2147483123, dev,
                                      cfg.dtype))
    cache = api.init_cache(cell.slots, cell.max_len, dev)
    b = cell.slots
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.full((b,), SLOTS_LENGTH, dtype=torch.int32, device=dev)

    def step():
        logits, _ = api.decode(params, cache, tokens, lengths)
        return logits.argmax(dim=-1).to(torch.int32)

    with torch.no_grad():
        for _ in range(3):
            step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    owners, total_k, total_us = _owners(prof)
    print(f"[owners] tree={root} eager decode step: {total_k} kernels, "
          f"{total_us / 1e3:.4f} ms device")
    for name, (n, us, by) in sorted(owners.items(), key=lambda kv: -kv[1][1]):
        top = ", ".join(f"{op} x{c}" for op, c in by.most_common(6))
        print(f"[owners]   {name:22s} kernels={n:5d} "
              f"device_ms={us / 1e3:.4f}  ({top})")

    graphs = ExecutorKernels(api, b, cell.max_len, dev)
    flat = torch.cat([tokens, lengths])
    with torch.no_grad():
        for _ in range(3):
            graphs.step(params, cache, ("decode",), flat)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graphs.step(params, cache, ("decode",), flat)
            torch.cuda.synchronize()
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        by_name = collections.Counter()
        for e in kernels:
            by_name[e.name[:60]] += e.time_range.end - e.time_range.start
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPLAYS):
            graphs.step(params, cache, ("decode",), flat)
        end.record()
        torch.cuda.synchronize()
    print(f"[owners] tree={root} graphed decode replay: {len(kernels)} "
          f"kernels, {sum(by_name.values()) / 1e3:.4f} ms summed kernel "
          f"time; {start.elapsed_time(end) / REPLAYS:.4f} ms a replay back "
          f"to back ({REPLAYS} replays)")
    for name, us in by_name.most_common(12):
        print(f"[owners]   replay {name:60s} {us / 1e3:.4f} ms")
    print("[owners] counted launches:", json.dumps(
        {m.__name__.rsplit(".", 1)[-1]: dict(m.launches_by_variant)
         for m in ops.COUNTED}))


def main(argv) -> None:
    if argv[:1] == ["--one"]:
        one(os.path.abspath(argv[1]))
        return
    for tree in argv or ["."]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)


if __name__ == "__main__":
    main(sys.argv[1:])
