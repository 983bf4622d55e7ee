"""PyTorch port, the routed expert products on the card
(``kernels/moe_experts.py``, ``csrc/moe_experts.cu``): the lists pass equal
to ``ref.moe_lists``; the routed products against their plain version
(``ref.moe_experts_ref``, the dense dispatch with the rows that are not live
zeroed) at arctic's widths, a decode step's 64 rows with 0, 1, about 12 and
all 32 held experts touched (stale rows that are not live among them) and
prefill steps of 128, 512 and 2048 tokens, at kimi's widths (top-8 of
384, d_ff 2048), both activations, and at the SMOKE configurations' narrow
widths in f32 and bf16 (tiles past d_ff and d_model); a capture into a CUDA
graph replayed under changed routes; a step that touches no expert against
one that touches all 32; and the port's serve launcher on arctic's and
kimi's SMOKE configurations (f32) through the routed passes.

These tests need a CUDA card and skip without one (the ``card`` marker);
run them there with ``python -m pytest -q -m card tests``. They import no
JAX."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import moe_experts, ref  # noqa: E402

pytestmark = pytest.mark.card

# (d_model, d_ff, experts the router scores, held tables, top-k): arctic's
# card of 4-way expert parallelism, and a share of kimi's experts
ARCTIC = (7168, 4864, 128, 32, 2)
KIMI = (7168, 2048, 384, 48, 8)
GROUP = 1 << 25          # models.moe.GROUP_ELEMENTS
# The products' f32 sums run in another order than cuBLAS's, and g, u, h
# and y round to bf16 where the plain ops round them, so an element near a
# rounding boundary differs by one unit (2^-8 relative) there and moves what
# it feeds: the whole within one unit of its norm, an element within four
# units of the output's largest
REL_L2 = 2.0 ** -8
MAX_ABS = 2.0 ** -6
# f32: the same products on the CUDA cores, f32 FMAs in another order than
# cuBLAS's f32 product (TF32 off), so a few units of f32 rounding (2^-24) a
# sum over K of up to a few hundred terms
TOL = {torch.bfloat16: (REL_L2, MAX_ABS), torch.float32: (1e-5, 1e-5)}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tables(card, widths, seed=0):
    """The held tables in bf16 with the model's scales (1/sqrt of the
    router's width for gate and up, 1/sqrt(d_ff) for down), drawn an
    expert at a time."""
    d, f, router, held, _ = widths
    gen = torch.Generator(device=card).manual_seed(seed)
    out = []
    for shape, std in (((d, f), router ** -0.5), ((d, f), router ** -0.5),
                       ((f, d), f ** -0.5)):
        t = torch.empty((held,) + shape, dtype=torch.bfloat16, device=card)
        for e in range(held):
            t[e] = torch.randn(shape, generator=gen, device=card) * std
        out.append(t)
    return tuple(out)


@pytest.fixture(scope="module")
def arctic(card):
    tabs = _tables(card, ARCTIC)
    yield tabs
    del tabs
    torch.cuda.empty_cache()


@pytest.fixture(scope="module")
def kimi(card):
    tabs = _tables(card, KIMI, seed=1)
    yield tabs
    del tabs
    torch.cuda.empty_cache()


def _routes(card, t, widths, seed, pool=None):
    """Gates f32 and ids (T, k) as ``moe.route`` gives them (ids a slice
    of a wider sort's output, so rows with a stride): k distinct ids a
    token from ``pool`` (default: every expert the router scores)."""
    _, _, router, _, k = widths
    gen = torch.Generator(device=card).manual_seed(seed)
    pool = torch.arange(router, device=card) if pool is None else pool
    keys = torch.rand((t, pool.numel()), generator=gen, device=card)
    order = keys.argsort(dim=-1)
    wide = pool[order]                                  # (T, len(pool))
    ids = wide[:, :k]
    gates = torch.softmax(torch.randn((t, k), generator=gen, device=card), -1)
    return gates, ids


def _x(card, t, d, seed, dtype=torch.bfloat16):
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randn((t, d), generator=gen, device=card).to(dtype)


def _held_rows(ids, live, first, held):
    mine = ((ids >= first) & (ids < first + held)).any(-1)
    return mine if live is None else mine & live


def _check(x, tabs, gates, ids, live, first, experts, act):
    got = moe_experts.moe_experts(x, *tabs, gates, ids, live, first, experts,
                                  act, GROUP)
    want = ref.moe_experts_ref(x, *tabs, gates, ids, live, first, act, GROUP)
    torch.cuda.synchronize()
    rows = _held_rows(ids, live, first, tabs[0].shape[0])
    assert torch.equal(got[~rows], torch.zeros_like(got[~rows]))
    if rows.any():
        g, w = got[rows].float(), want[rows].float()
        rel = ((g - w).norm() / w.norm()).item()
        worst = ((g - w).abs().max() / w.abs().max()).item()
        rel_tol, abs_tol = TOL[x.dtype]
        assert rel <= rel_tol and worst <= abs_tol, (rel, worst)
    return got


@pytest.mark.parametrize("live_share", [1.0, 0.5])
@pytest.mark.parametrize("widths,t", [(ARCTIC, 64), (ARCTIC, 512),
                                      (KIMI, 64), (KIMI, 300)])
def test_lists_equal_the_plain_lists(card, widths, t, live_share):
    _, _, router, held, _ = widths
    _, ids = _routes(card, t, widths, seed=t)
    live = torch.rand(t, device=card) < live_share
    first = router - held if widths is KIMI else 0
    got = moe_experts.lists(ids, live, first, held)
    want = ref.moe_lists(ids.cpu(), live.cpu(), first, held)
    n = int(want[0].sum())
    for a, b in zip(got[:2] + (got[2][:n], got[3]), want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("touched", ["none", "one", "some", "all"])
def test_arctic_decode_rows(card, arctic, touched, act):
    """A decode step's 64 slots; in "some", half the slots hold no request
    and their stale rows pick held experts."""
    t, (d, _, router, held, _) = 64, ARCTIC
    x = _x(card, t, d, seed=3)
    live = None
    if touched == "none":
        gates, ids = _routes(card, t, ARCTIC, 4,
                             pool=torch.arange(held, router, device=card))
    elif touched == "one":
        gates, ids = _routes(card, t, ARCTIC, 5,
                             pool=torch.arange(held, router, device=card))
        ids = torch.stack([torch.full_like(ids[:, 0], 3), ids[:, 1]], -1)
    elif touched == "some":
        gates, ids = _routes(card, t, ARCTIC, 6)
        live = torch.arange(t, device=card) % 2 == 0
        ids[~live] = torch.tensor([0, 1], device=card)     # stale rows
    else:
        gates, ids = _routes(card, t, ARCTIC, 7,
                             pool=torch.arange(held, device=card))
        ids[:held // 2] = torch.arange(held, device=card).reshape(-1, 2)
    _check(x, arctic, gates, ids, live, 0, router, act)
    counts = moe_experts.lists(ids.contiguous(), live, 0, held)[0]
    expect = {"none": 0, "one": 1, "all": held}.get(touched)
    if expect is not None:
        assert int((counts > 0).sum()) == expect


@pytest.mark.parametrize("t", [128, 512, 2048])
def test_arctic_prefill_tokens(card, arctic, t):
    """A prefill step: rows of 128 tokens, each live up to its take."""
    d, router = ARCTIC[0], ARCTIC[2]
    x = _x(card, t, d, seed=t)
    gates, ids = _routes(card, t, ARCTIC, seed=t + 1)
    cols = torch.arange(t, device=card) % 128
    takes = torch.randint(1, 129, (t // 128,), device=card)
    live = cols < takes.repeat_interleave(128)
    _check(x, arctic, gates, ids, live, 0, router, "silu")


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("t", [64, 512])
def test_kimi_widths(card, kimi, t, act):
    """kimi's widths, top-8 of 384, the share of the last 48 experts."""
    d, _, router, held, _ = KIMI
    x = _x(card, t, d, seed=t)
    gates, ids = _routes(card, t, KIMI, seed=t + 2)
    live = torch.arange(t, device=card) % 3 != 0
    _check(x, kimi, gates, ids, live, router - held, router, act)


def test_a_captured_graph_replays_under_changed_routes(card, arctic):
    t, (d, _, router, held, k) = 64, ARCTIC
    x = _x(card, t, d, seed=9)
    gates, ids = _routes(card, t, ARCTIC, seed=10)
    live = torch.ones(t, dtype=torch.bool, device=card)
    ids = ids.contiguous()
    moe_experts.moe_experts(x, *arctic, gates, ids, live, 0, router, "silu",
                            GROUP)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = moe_experts.moe_experts(x, *arctic, gates, ids, live, 0,
                                      router, "silu", GROUP)
    for seed in (11, 12, 13):
        g2, i2 = _routes(card, t, ARCTIC, seed)
        gates.copy_(g2)
        ids.copy_(i2)
        x.copy_(_x(card, t, d, seed))
        live.copy_(torch.arange(t, device=card) % (seed - 9) != 0)
        graph.replay()
        want = moe_experts.moe_experts(x, *arctic, gates, ids, live, 0,
                                       router, "silu", GROUP)
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def _ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def test_a_step_that_touches_no_expert_reads_no_table(card, arctic):
    t, (d, _, router, held, _) = 64, ARCTIC
    x = _x(card, t, d, seed=14)
    outside = _routes(card, t, ARCTIC, 15,
                      pool=torch.arange(held, router, device=card))
    inside = _routes(card, t, ARCTIC, 16, pool=torch.arange(held,
                                                            device=card))
    times = [_ms(lambda: moe_experts.moe_experts(x, *arctic, *r, None, 0,
                                                 router, "silu", GROUP))
             for r in (outside, inside)]
    # all 32 tables are 6.7 GB, about 2 ms at the card's 3.35 TB/s
    assert times[0] < 0.1 * times[1], times


# (d_model, d_ff, experts the router scores, held tables, top-k): arctic's
# and kimi's SMOKE widths (d_ff 96: a 64-column tile and a half one; 64),
# and widths in 16-byte rows past every tile (d_model 72, d_ff 200)
NARROW = [(64, 96, 8, 8, 2), (64, 64, 8, 8, 2), (72, 200, 16, 6, 2)]


def _small_tables(card, widths, dtype, seed):
    d, f, router, held, _ = widths
    gen = torch.Generator(device=card).manual_seed(seed)
    return tuple((torch.randn((held,) + shape, generator=gen, device=card)
                  * std).to(dtype)
                 for shape, std in (((d, f), router ** -0.5),
                                    ((d, f), router ** -0.5),
                                    ((f, d), f ** -0.5)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", NARROW)
@pytest.mark.parametrize("t", [6, 40])
def test_narrow_widths_in_f32_and_bf16(card, widths, dtype, act, t):
    """The SMOKE configurations' shapes: f32 on the CUDA cores, bf16 on the
    tensor cores with the last column and depth tiles partly past the
    tables; a share (the last ``held`` of the router's experts)."""
    d, _, router, held, _ = widths
    tabs = _small_tables(card, widths, dtype, seed=t)
    x = _x(card, t, d, seed=t + 1, dtype=dtype)
    gates, ids = _routes(card, t, widths, seed=t + 2)
    live = torch.arange(t, device=card) % 4 != 3
    _check(x, tabs, gates, ids, live, router - held, router, act)
    _check(x, tabs, gates, ids, None, router - held, router, act)


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t"])
def test_serve_runs_the_moe_smoke_configs_through_the_routed_passes(card,
                                                                    arch):
    """``repro_torch.launch.serve --mode real --arch <moe>`` at its
    defaults (SMOKE size, f32, the card): every request finishes, and
    every pass of the routed experts launched, as many of each."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    for m in ops.COUNTED:
        m.launches_by_variant.update(dict.fromkeys(m.launches_by_variant, 0))
    row = serve.main(["--mode", "real", "--arch", arch, "--rate", "4",
                      "--duration", "3", "--workers", "2"])
    by = dict(moe_experts.launches_by_variant)
    assert row["n_total"] > 0 and row["n_finished"] == row["n_total"], row
    assert len(set(by.values())) == 1 and by["lists"] > 0, by
