"""Time the kernels of this tree and of another checkout in turns on one
card, every tree under this tree's timer.

    git archive <commit> | tar -x -C build/other     # where git is
    python3 kernel_ab.py build/other

Runs other, this, this, other. Each run is a fresh process that imports
that tree's ``chip_smoke.py``, replaces its ``time_ms`` with this tree's
(the function's source and nothing else), and runs its device, build and
kernels phases; then it times, with this tree's ``_time_decode`` on that
tree's decode kernel, each of this tree's ``DECODE_TIMED`` shapes that the
tree's own kernels phase did not time, and each ``PROBE_DECODE`` shape.
Both trees' kernels phases time zamba2's D = 80 rows
(``chunked_prefill_zamba2``, ``paged_attention_zamba2``). Prints each
run's ``timed=`` lines, then one JSON line: per timed shape, each tree's
two times and the ratio
of their medians (this / other). Exits non-zero if any run fails.

    python3 kernel_ab.py --serve build/other
    python3 kernel_ab.py --train build/other

run a phase A/B instead, other, this, this, other, other, this, each
tree's own phase code: ``--serve`` the stateful families' serve phases
(chip_smoke's ``STATEFUL_SERVES``, with this tree's ``serve_table``, the
phases' arguments: eager, host-bound steps, where host work a change adds
shows first), keyed by phase, their TPOT P90 s; ``--train`` the ``train``
phase (full-width qwen2-1.5b), its ``step_ms`` and
``backward_device_ms``. Prints one JSON line: per key, each tree's three
values, their median and spread (largest over smallest, less 1), and the
ratio of the medians (this / other).
"""
from __future__ import annotations

import ast
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
TIMED = re.compile(r"\[kernels\] timed=(\S+) shape='([^']*)' ms=(\S+) "
                   r"plain_ms=(\S+) bound_ms=(\S+)")
CHILD = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke as c
exec({timer!r}, c.__dict__)
card = c.phase_device()
c.phase_build()
have = {{r["shape"] for r in c.phase_kernels(card).values()}}
gen = c.torch.Generator(device=c.DEV).manual_seed(1)
for key, lengths, shape in c.DECODE_TIMED:
    if shape not in have:
        c._say_timed(c._time_decode(gen, key, lengths, shape), card)
for key, lengths, shape, heads in {probe!r}:
    c._say_timed(c._time_decode(gen, key, lengths, shape, **heads), card)
"""
# decode shapes timed on both trees beside the kernels phases': zamba2's
# step of 8 slots with 16 query heads a KV head (Hq = 512 over its 32): the
# same K/V bytes as its G = 1, sixteen times the products, so a kernel whose
# time does not follow G spends it on rows G does not fill
PROBE_DECODE = (
    ("paged_attention_zamba2_g16", (300, 420, 96, 512, 280, 333, 64, 450),
     "slots=8 max_len=1024 page=64 lengths~300 Hq=512 Hkv=32 D=80 bf16",
     dict(hq=512, hkv=32, d=80)),
)
SHARED = ("time_ms", "DECODE_TIMED", "_time_decode", "_decode_record",
          "_say_timed")
# the serve phases' arguments, this tree's, given to both trees
SERVE_SHARED = ("serve_table", "STATEFUL_SERVES")
# --serve / --train: three runs a tree, in turns
PHASE_ORDER = ("other", "this", "this", "other", "other", "this")


def source_of(names: tuple) -> str:
    """This tree's ``chip_smoke.py`` functions and constants ``names``, as
    source."""
    src = (HERE / "chip_smoke.py").read_text()
    nodes = [n for n in ast.parse(src).body
             if isinstance(n, ast.FunctionDef) and n.name in names
             or isinstance(n, ast.Assign)
             and getattr(n.targets[0], "id", None) in names]
    return "\n\n".join(ast.get_source_segment(src, n) for n in nodes)


def run(root: Path) -> dict:
    """One tree's kernels phase: {shape: (name, ms)}."""
    proc = subprocess.run(
        [sys.executable, "-c", CHILD.format(root=str(root),
                                            timer=source_of(SHARED),
                                            probe=PROBE_DECODE)],
        cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"kernel_ab: the run in {root} failed\n"
                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    found = {}
    for line in proc.stdout.splitlines():
        m = TIMED.search(line)
        if m:
            print(f"[{root.name}] {line}", flush=True)
            found[m.group(2)] = (m.group(1), float(m.group(3)))
    if not found:
        sys.exit(f"kernel_ab: no timed line from {root}")
    return found


PHASE_CHILD = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke as c
exec({table!r}, c.__dict__)
card = c.phase_device()
c.phase_build()
{body}
"""
# flag -> (what the child runs after the build, the (key, value) pairs its
# lines give, how many keys a run must give)
PHASE_MODES = {
    "--serve": ("for phase, *args in c.serve_table():\n"
                "    if phase in c.STATEFUL_SERVES:\n"
                "        c.phase_serve(card, phase, *args)",
                re.compile(r"\[(serve_\w+)\] arch=.* tpot_p90_s=(\S+)"), 2),
    "--train": ("c.phase_train(card)",
                re.compile(r"\b(step_ms|backward_device_ms)=(\S+)"), 2),
}


def phase_run(root: Path, mode: str) -> dict:
    """One tree's run of ``mode``'s phases: {key: value}."""
    body, pattern, n_keys = PHASE_MODES[mode]
    proc = subprocess.run(
        [sys.executable, "-c",
         PHASE_CHILD.format(root=str(root), table=source_of(SERVE_SHARED),
                            body=body)],
        cwd=root, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.exit(f"kernel_ab: the {mode} run in {root} failed\n"
                 f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    found = {}
    for line in proc.stdout.splitlines():
        hits = list(pattern.finditer(line))
        if hits:
            print(f"[{root.name}] {line}", flush=True)
        for m in hits:
            found[m.group(1)] = float(m.group(2))
    if len(found) != n_keys:
        sys.exit(f"kernel_ab: {mode} values missing from {root}: {found}")
    return found


def main() -> None:
    mode = sys.argv[1] if sys.argv[1:2] and sys.argv[1] in PHASE_MODES \
        else None
    if mode:
        del sys.argv[1]
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    other = Path(sys.argv[1]).resolve()
    if mode:
        runs = {"other": [], "this": []}
        for tree in PHASE_ORDER:
            runs[tree].append(phase_run(HERE if tree == "this" else other,
                                        mode))
        rows = []
        for key in runs["this"][0]:
            row = {"key": key}
            for tree in ("this", "other"):
                got = [r[key] for r in runs[tree]]
                row[tree] = got
                row[f"{tree}_median"] = statistics.median(got)
                row[f"{tree}_spread"] = max(got) / min(got) - 1
            row["ratio"] = row["this_median"] / row["other_median"]
            rows.append(row)
        print(json.dumps({"phase_ab": mode, "rows": rows,
                          "other": str(other)}))
        return
    if not (other / "chip_smoke.py").exists():
        sys.exit(f"kernel_ab: {other} holds no chip_smoke.py")
    runs = {"other": [], "this": []}
    for tree, root in (("other", other), ("this", HERE), ("this", HERE),
                       ("other", other)):
        runs[tree].append(run(root))
    rows = []
    for shape in runs["this"][0]:
        if not all(shape in r for rs in runs.values() for r in rs):
            continue
        ms = {t: [r[shape][1] for r in rs] for t, rs in runs.items()}
        rows.append({"name": runs["this"][0][shape][0], "shape": shape,
                     "this_ms": ms["this"], "other_ms": ms["other"],
                     "ratio": statistics.median(ms["this"])
                     / statistics.median(ms["other"])})
    print(json.dumps({"kernel_ab": rows, "other": str(other)}))


if __name__ == "__main__":
    main()
