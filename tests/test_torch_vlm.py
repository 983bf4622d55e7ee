"""PyTorch port, VLM prefix: paligemma SMOKE's prefill with projected patch
features (``prefix_embeds``) and the decode after it against the JAX model
(f32, atol = rtol = 1e-4), the ``lengths`` contract (it counts the prefix
rows, P + S, as in JAX), the prefix projected and not scaled by
sqrt(d_model), and the executor serving the vlm family text-only as the
JAX executor does."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke as jax_smoke  # noqa: E402
from repro.core.request import Request as JRequest  # noqa: E402
from repro.core.request import SLOSpec as JSLOSpec  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serving.engine import IterationPlan as JPlan  # noqa: E402
from repro.serving.executor import \
    ClusterRealExecutors as JaxCluster  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.request import Request, SLOSpec  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import IterationPlan  # noqa: E402
from repro_torch.serving.executor import ClusterRealExecutors  # noqa: E402
from test_torch_executor import _drive  # noqa: E402

ARCH = "paligemma-3b"
TOL = dict(rtol=1e-4, atol=1e-4)
S = 12          # text tokens after the SMOKE config's 8 patches


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jax_smoke(ARCH), get_smoke(ARCH)
    jm, tm = japi.build(jcfg), tapi.build(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(0)
    inputs = {
        "tokens": rng.integers(0, jcfg.vocab_size, size=(2, S)).astype(
            np.int32),
        "prefix_embeds": rng.normal(size=(2, jcfg.num_patches,
                                          jcfg.vision_feature_dim)).astype(
            np.float32)}
    return jcfg, tcfg, jm, tm, jp, tp, inputs


def _both_prefill(models, lengths, max_len=40):
    jcfg, tcfg, jm, tm, jp, tp, inputs = models
    jl, jc = jm.prefill(jp, jm.init_cache(2, max_len), inputs, lengths)
    tl, tc = tm.prefill(tp, tm.init_cache(2, max_len, "cpu"),
                        {k: _t(v) for k, v in inputs.items()}, _t(lengths))
    return jl, jc, tl, tc


def test_prefix_is_projected_and_not_scaled(models):
    """``_embed_inputs``: the patches through ``vision_proj`` (unscaled)
    before the text embeddings (scaled by sqrt(d_model)), as JAX's."""
    jcfg, tcfg, jm, tm, jp, tp, inputs = models
    got = TT._embed_inputs(tp, _t(inputs["tokens"]), tcfg,
                           _t(inputs["prefix_embeds"]))
    want = JT._embed_inputs(jp, inputs["tokens"], jcfg,
                            inputs["prefix_embeds"])
    assert tuple(got.shape) == (2, jcfg.num_patches + S, jcfg.d_model)
    _close(got, want)
    _close(got[:, :jcfg.num_patches],
           inputs["prefix_embeds"] @ np.asarray(jp["vision_proj"]))


def test_prefill_then_decode_match_jax(models):
    """Prefill with the prefix and lengths = P + S (a second row shorter:
    P + S - 4), then decode steps fed JAX's greedy tokens: the logits and
    the caches within 1e-4; the prefill's logits are those of the last real
    row of the whole sequence."""
    jcfg, *_ = models
    p = jcfg.num_patches
    lengths = np.array([p + S, p + S - 4], np.int32)
    jl, jc, tl, tc = _both_prefill(models, lengths)
    _close(tl, jl)
    pos = lengths
    jm, jp, tm, tp = models[2], models[4], models[3], models[5]
    for _ in range(4):
        tok = np.asarray(jnp.argmax(jl, -1), np.int32)
        jl, jc = jm.decode(jp, jc, tok, pos)
        tl, tc = tm.decode(tp, tc, _t(tok), _t(pos))
        _close(tl, jl)
        pos = pos + 1
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])


def test_lengths_counting_text_only_picks_the_same_row_as_jax(models):
    """lengths = S (as tests/test_archs_smoke.py passes it) selects row
    S - 1 of the whole sequence, inside the prefix here, in both packages:
    the contract is JAX's, whatever the caller meant."""
    jcfg, *_ = models
    lengths = np.array([S, S], np.int32)
    jl, _, tl, _ = _both_prefill(models, lengths)
    _close(tl, jl)
    full, _, _, _ = _both_prefill(models, lengths + jcfg.num_patches)
    assert np.abs(np.asarray(jl) - np.asarray(full)).max() > 1e-2


@pytest.mark.parametrize("batched", [True, False])
def test_drive_token_streams_equal_jax(batched):
    """The executor serves the vlm family text-only (no prefix), on the
    fast path when batched, with the JAX executor's token streams."""
    jax_execs = JaxCluster(jax_smoke(ARCH), 2, max_slots=4, max_len=64,
                           batched=batched, warmup=False)
    want = _drive(jax_execs, (JRequest, JSLOSpec), JPlan)
    jp = japi.build(jax_smoke(ARCH)).init(jax.random.PRNGKey(0))
    port = ClusterRealExecutors(
        get_smoke(ARCH), 2, max_slots=4, max_len=64, batched=batched,
        warmup=False, device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, jp),
                               get_smoke(ARCH), "cpu"))
    got = _drive(port, (Request, SLOSpec), IterationPlan)
    assert port.execs[0].fast == batched
    assert got == want
