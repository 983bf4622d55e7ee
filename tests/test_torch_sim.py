"""PyTorch port, the serve CLI's sim mode and the config registry: the
port's ``launch.serve.main([... "--mode", "sim", "--json"])`` prints the
same row as the JAX launcher's, key for key (NaN where JAX has NaN), for
each backend and workload flag and for all 11 architectures of the JAX
registry; the five configs this slice adds equal JAX's field by field;
sim mode touches no device; and ``--trace-csv`` replays in real mode too,
at the port's prompt and output caps."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.configs import list_archs as jax_archs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.serving.executor import refuse_encdec  # noqa: E402

CLASSES = "chat:ttft=1.0,tpot=0.05,weight=2,frac=0.6;batch:scale=8"
# every architecture of the JAX registry, by the name its launcher takes
ARCH_NAMES = ["gemma2-2b", "qwen2-1.5b", "deepseek-7b", "stablelm-1.6b",
              "arctic-480b", "kimi-k2-1t", "rwkv6-7b", "paligemma-3b",
              "zamba2-2.7b", "whisper-medium", "internlm-20b"]
NEW_ARCHS = ["arctic-480b", "kimi-k2-1t-a32b", "paligemma-3b",
             "zamba2-2.7b", "whisper-medium"]


def _csv(path, classes=False, n=12):
    rng = np.random.default_rng(7)
    rows = ["timestamp_ms,input_length,output_length"
            + (",slo_class" if classes else "")]
    t = 0.0
    for i in range(n):
        t += float(rng.exponential(400.0))
        row = f"{t:.1f},{int(rng.integers(50, 3000))}," \
              f"{int(rng.integers(5, 300))}"
        rows.append(row + ((",chat" if i % 3 else ",batch")
                           if classes else ""))
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _rows(argv, capsys):
    """The JSON each launcher prints for ``argv``, as printed (NaN
    included), and the port's row."""
    jserve.main(argv)
    want = capsys.readouterr().out
    row = tserve.main(argv)
    got = capsys.readouterr().out
    return json.loads(got), json.loads(want), got, want, row


SIM = ["--mode", "sim", "--duration", "12", "--workers", "3", "--rate",
       "1.5", "--json"]
FLAGS = {
    "cost-model": [],
    "trace-replay": ["--backend", "trace-replay"],
    "slo-classes": ["--slo-classes", CLASSES],
    "slo-classes-trace-replay": ["--slo-classes", CLASSES, "--backend",
                                 "trace-replay"],
    "fail-worker": ["--fail-worker", "1"],
    "reference": ["--reference"],
    "profile": ["--profile"],
    "scenario": ["--scenario", "bursty"],
    "tropical++-tp4": ["--policy", "tropical++", "--tp", "4"],
}


@pytest.mark.parametrize("flags", list(FLAGS.values()), ids=list(FLAGS))
def test_sim_row_equals_jax(flags, capsys):
    got, want, got_s, want_s, row = _rows(SIM + flags, capsys)
    assert got_s == want_s
    assert got["mode"] == "sim" and got["n_total"] > 0
    assert got["n_finished"] == got["n_total"]
    assert row["backend"] == (flags[flags.index("--backend") + 1]
                              if "--backend" in flags else "cost-model")


@pytest.mark.parametrize("backend", ["cost-model", "trace-replay"])
@pytest.mark.parametrize("classes", [False, True], ids=["plain", "classes"])
def test_sim_trace_csv_row_equals_jax(backend, classes, tmp_path, capsys):
    path = _csv(tmp_path / "trace.csv", classes)
    argv = SIM + ["--trace-csv", path, "--backend", backend]
    if classes:
        argv += ["--slo-classes", CLASSES]
    got, want, got_s, want_s, _ = _rows(argv, capsys)
    assert got_s == want_s
    assert got["scenario"] == "trace-csv" and got["n_total"] == 12
    if classes:
        assert set(got["per_class"]) == {"chat", "batch"}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_sim_runs_every_architecture_as_jax(arch, capsys):
    assert sorted(configs.list_archs()) == sorted(jax_archs())
    argv = ["--mode", "sim", "--arch", arch, "--duration", "6",
            "--workers", "2", "--json"]
    got, want, got_s, want_s, _ = _rows(argv, capsys)
    assert got_s == want_s
    assert got["arch"] == jax_config(arch).name and got["n_total"] > 0


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_configs_match_the_jax_package(arch):
    """CONFIG and SMOKE field by field, dtype by name; the model API
    builds every family (moe and vlm, and hybrid and encdec, ported since);
    the executors refuse encdec, naming ROADMAP.md, as the JAX executor
    cannot serve it."""
    import jax.numpy as jnp
    for get_t, get_j in ((configs.get_config, jax_config),
                         (configs.get_smoke, jax_smoke)):
        t, j = get_t(arch), get_j(arch)
        assert set(t.__dataclass_fields__) == set(j.__dataclass_fields__)
        for field in j.__dataclass_fields__:
            if field != "dtype":
                assert getattr(t, field) == getattr(j, field), field
        assert str(t.dtype).split(".")[-1] == jnp.dtype(j.dtype).name
        assert t.family in ("moe", "vlm", "hybrid", "encdec")
        assert tapi.build(t).cfg is t
        if t.family == "encdec":
            with pytest.raises(NotImplementedError,
                               match=rf"{t.family}.*ROADMAP\.md"):
                refuse_encdec(t)


def test_sim_mode_touches_no_device(monkeypatch, capsys):
    """``--device cuda`` without a card raises in real mode only."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    row = tserve.main(SIM + ["--device", "cuda"])
    capsys.readouterr()
    assert row["n_finished"] == row["n_total"] > 0
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--mode", "real", "--device", "cuda", "--duration",
                     "2"])


def test_trace_replay_refused_in_real_mode(capsys):
    for main in (jserve.main, tserve.main):
        with pytest.raises(SystemExit):
            main(["--mode", "real", "--backend", "trace-replay"])
    assert "trace-replay" in capsys.readouterr().err


def test_real_mode_replays_a_trace_csv_at_the_caps(tmp_path, capsys):
    path = _csv(tmp_path / "trace.csv", n=4)
    row, backend = tserve.run([
        "--mode", "real", "--device", "cpu", "--arch", "qwen2-1.5b",
        "--workers", "2", "--duration", "4", "--trace-csv", path,
        "--max-len", "64", "--max-prompt", "24", "--max-output", "6",
        "--json"])
    assert row["scenario"] == "trace-csv" and row["backend"] == "real-torch"
    assert row["n_total"] == 4 and row["n_finished"] == 4
    generated = [len(g) for e in backend.execs.execs.values()
                 for g in e.generated.values()]
    assert max(generated) <= 6 and backend.iterations > 0
    prompts = [len(p) for e in backend.execs.execs.values()
               for p in e.prompts.values()]
    assert max(prompts) <= 24
