"""What moving the ``llama`` architecture behind ``servebench/archs`` must
not move, held bit for bit to numbers recorded before the move
(``pinned.py``): a seed's weights, the reference's f32 and e4m3 logits and
its routing margins, and the recorder's calls for fixed plans."""
import types

import numpy as np
import pytest
import torch

import pinned
from servebench import serve, weights
from servebench.cells import Config
from tiny import DENSE, MOE, TIED

CONFIGS = {"tiny-dense": DENSE, "tiny-moe": MOE, "tiny-tied": TIED}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", CONFIGS)
def test_weights_are_the_parents(name, dtype):
    c = Config(dict(CONFIGS[name], torch_dtype=dtype))
    got = {k: float(v.double().sum())
           for k, v in _flat(weights.make(c.layout(), 3, "cpu")).items()}
    assert list(got.items()) == list(pinned.WEIGHTS[f"{name}/{dtype}"].items())


@pytest.mark.parametrize("precision", ["f32", "e4m3"])
@pytest.mark.parametrize("name", CONFIGS)
def test_reference_is_the_parents(name, precision):
    c = Config(dict(CONFIGS[name], torch_dtype="float32"))
    params = weights.make(c.layout(), 5, "cpu")
    rng = np.random.default_rng(1)
    seqs = [torch.as_tensor(rng.integers(0, 512, n)) for n in (23, 17)]
    margins: list = []
    got = c.reference.logits(params, c.reference.arch(c.raw), seqs, [20, 10],
                             precision, margins=margins)
    key = f"{name}/{precision}"
    assert [[float(r) for r in x.double().sum(dim=-1)] for x in got] == \
        pinned.LOGITS[key]
    assert [[int(i) for i in x.argmax(dim=-1)] for x in got] == \
        pinned.LOGITS[key + "/argmax"]
    # a dense model routes nothing: no margins, every position kept
    assert [[float(v) for v in m] for m in margins] == \
        pinned.MARGINS.get(key, [])


def _req(rid, prompt):
    return types.SimpleNamespace(rid=rid, prompt_len=prompt)


PLANS = {
    "mixed": ([(_req(1, 40), 0, 40), (_req(3, 70), 0, 32),
               (_req(2, 100), 64, 36), (_req(4, 10), 0, 10)],
              [(7, 5), (8, 130), (9, 77)]),
    "prefill": ([(_req(5, 500), 448, 52), (_req(6, 31), 0, 31)], []),
    "decode": ([], [(7, 1), (8, 1023), (9, 400), (10, 2)]),
}


def recorded(config, parts, decoding) -> list:
    """The recorder's calls for one iteration of ``parts`` ``(request,
    start, take)`` and decoding ``(rid, length)`` rows, on an executor of
    1024-token slots whose buckets are 32, 64 and 128."""
    e = types.SimpleNamespace(
        kernels=types.SimpleNamespace(
            bucket_for=lambda take: 32 if take <= 32 else
            64 if take <= 64 else 128),
        lengths=np.array([n for _, n in decoding] + [0], dtype=np.int32),
        slot_of={rid: i for i, (rid, _) in enumerate(decoding)},
        max_len=1024)
    rec = serve.Recorder(None, types.SimpleNamespace(execs={0: e}), config,
                         None, record=True)
    rec._count(0, types.SimpleNamespace(
        decode_reqs=[_req(rid, 0) for rid, _ in decoding]), parts)
    return [list(c) for c in rec.calls]


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("name", [*CONFIGS, "deepseek-7b",
                                  "arctic-480b-2l"])
def test_recorded_calls_are_the_parents(name, plan):
    c = Config(CONFIGS[name]) if name in CONFIGS else Config.load(name)
    assert recorded(c, *PLANS[plan]) == pinned.CALLS[f"{name}/{plan}"]
