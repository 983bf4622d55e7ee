"""PyTorch port, the examples (``src/repro_torch/examples/``) against the
JAX package's (``examples/``).

* ``quickstart.main`` runs on the CPU for every architecture, encdec and
  VLM included, and refuses to run without a card unless asked for the
  CPU.
* qwen2: given JAX's initial parameters (``convert.params_from_jax``) and
  JAX's prompt, the port's prefill logits and its decode logits, fed
  JAX's greedy tokens, are within 1e-4 of the JAX script's, and its 3
  training losses within 1e-5 (relative) of JAX's (f32 SMOKE config).
* ``serve_cluster`` and ``slack_multiplexing`` (numpy only, pinned copies)
  print what the JAX package's print.
"""
import contextlib
import importlib.util
import io
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train.data import DataConfig as JDataConfig  # noqa: E402
from repro.train.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.configs import get_smoke, list_archs  # noqa: E402
from repro_torch.examples import quickstart  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """SMOKE models are a few hundred small ops a step: one intra-op thread
    runs them as fast as many, and does not spin against the other test
    workers' threads on a shared CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", list_archs())
def test_quickstart_runs_on_the_cpu(arch, capsys):
    out = quickstart.main([arch, "--device", "cpu"])
    cfg = get_smoke(arch)
    assert len(out["logits"]) == quickstart.STEPS + 1
    for logits in out["logits"]:
        assert logits.shape == (quickstart.BATCH, cfg.vocab_size)
        assert torch.isfinite(logits).all()
    assert out["tokens"].shape == (quickstart.BATCH, quickstart.STEPS + 1)
    assert len(out["losses"]) == quickstart.TRAIN_STEPS
    assert all(np.isfinite(out["losses"]))
    assert "generated:" in capsys.readouterr().out


def test_quickstart_needs_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main(["qwen2-1.5b"])


def _jax_quickstart(arch):
    """The JAX script's serve and train parts (``examples/quickstart.py``):
    its parameters, prompt, prefill and decode logits, greedy tokens and
    losses."""
    cfg = jax_smoke(arch)
    api = japi.build(cfg)
    params = api.init(jax.random.PRNGKey(0))
    prompt = jax.random.randint(jax.random.PRNGKey(1), (2, 12), 0,
                                cfg.vocab_size)
    cache = api.init_cache(2, 32)
    lengths = jnp.full((2,), 12, jnp.int32)
    logits, cache = api.prefill(params, cache, prompt, lengths)
    out, tokens = [logits], [jnp.argmax(logits, -1)]
    for _ in range(8):
        logits, cache = api.decode(params, cache,
                                   tokens[-1].astype(jnp.int32), lengths)
        lengths = lengths + 1
        out.append(logits)
        tokens.append(jnp.argmax(logits, -1))
    data = JSyntheticLM(cfg, JDataConfig(batch=2, seq=16))
    step = jax.jit(jopt.make_train_step(lambda p, b: api.loss(p, b)))
    state = jopt.init_state(params)
    trained, losses = params, []
    for i in range(3):
        trained, state, loss = step(trained, state, data.batch_at(i))
        losses.append(float(loss))
    return params, prompt, out, np.stack([np.asarray(t) for t in tokens],
                                         1), losses


@pytest.fixture(scope="module")
def qwen2_both():
    arch = "qwen2-1.5b"
    jp, prompt, jlogits, jtokens, jlosses = _jax_quickstart(arch)
    cfg = get_smoke(arch)
    api = tapi.build(cfg)
    params = params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tprompt = torch.from_numpy(np.array(prompt, np.int32))
    lengths = torch.full((2,), 12, dtype=torch.int32)
    forced = torch.from_numpy(jtokens.astype(np.int32))
    tlogits, _ = quickstart.generate(api, params, tprompt, lengths,
                                     forced=forced)
    tlosses = quickstart.train(api, params, cfg, "cpu")
    return (jlogits, jlosses), (tlogits, tlosses)


@pytest.mark.parametrize("step", range(quickstart.STEPS + 1),
                         ids=lambda i: "prefill" if i == 0 else f"decode{i}")
def test_quickstart_logits_equal_jax(qwen2_both, step):
    (jlogits, _), (tlogits, _) = qwen2_both
    np.testing.assert_allclose(tlogits[step].numpy(),
                               np.asarray(jlogits[step]), atol=1e-4,
                               rtol=0)


def test_quickstart_losses_equal_jax(qwen2_both):
    (_, jlosses), (_, tlosses) = qwen2_both
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5)
    assert quickstart.TRAIN_STEPS == len(jlosses)


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,argv", [
    ("serve_cluster", ["--duration", "8"]),
    ("slack_multiplexing", None)])
def test_numpy_examples_print_what_jax_prints(name, argv):
    """Each copy (``repro.`` -> ``repro_torch.``) prints the JAX package's
    lines exactly: the same simulator, cost model and trace."""
    printed = []
    for path in (ROOT / "examples" / f"{name}.py",
                 ROOT / "src" / "repro_torch" / "examples" / f"{name}.py"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _load(path, f"_example_{name}_{len(printed)}").main(argv)
        printed.append(buf.getvalue())
    assert printed[0] == printed[1]
    assert printed[0].strip()
