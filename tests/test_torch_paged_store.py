"""PyTorch port, the paged KV store (``serving/paged_store.py``) against
the JAX package's ``PagedKVStore``: the port of
``tests/test_kvcache.py``'s store tests (round trip through
``gather_dense``, bit-equal in f32; the paged-decode op over the
allocator's block tables against the JAX kernel in interpret mode at
rtol = atol = 2e-5; pool exhaustion), ragged interleaved writes whose
pools equal JAX's page for page, and an e4m3 pool whose bytes equal JAX's,
NaN above 464 included."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.paged_attention import paged_attention  # noqa: E402
from repro.serving.kvcache import PagedKVStore as JStore  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.paged_store import PagedKVStore  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)


def _both(*shape, dtype="float32"):
    jdt = {"float32": jnp.float32, "e4m3": jnp.float8_e4m3fn}[dtype]
    tdt = {"float32": torch.float32, "e4m3": torch.float8_e4m3fn}[dtype]
    return JStore.create(*shape, dtype=jdt), \
        PagedKVStore.create(*shape, dtype=tdt, device="cpu")


def _bytes(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def test_paged_store_roundtrip_and_kernel():
    """tests/test_kvcache.py's round trip: two requests (37 and 21
    tokens) written at once; ``gather_dense`` gives back what was written,
    bit for bit, and the decode op over the allocator's tables (with -1
    past each request's pages) equals the JAX kernel's and the oracle's."""
    L, n_pages, ps, hkv, d = 2, 12, 16, 2, 64
    jstore, store = _both(L, n_pages, ps, hkv, d)
    rng = np.random.default_rng(0)
    lengths = [37, 21]
    for rid, ln in enumerate(lengths):
        k = rng.normal(size=(L, ln, hkv, d)).astype(np.float32)
        v = rng.normal(size=(L, ln, hkv, d)).astype(np.float32)
        jstore.write_tokens(rid, 0, jnp.asarray(k), jnp.asarray(v))
        store.write_tokens(rid, 0, torch.from_numpy(k), torch.from_numpy(v))
        gk, gv = store.gather_dense(rid, ln)
        np.testing.assert_array_equal(gk.numpy(), k)
        np.testing.assert_array_equal(gv.numpy(), v)
    np.testing.assert_array_equal(store.k_pages.numpy(),
                                  np.asarray(jstore.k_pages))
    np.testing.assert_array_equal(store.v_pages.numpy(),
                                  np.asarray(jstore.v_pages))

    max_pages = 4
    bt = np.stack([store.allocator.table(r, max_pages) for r in (0, 1)])
    assert (bt == -1).any()
    q = rng.normal(size=(2, 4, d)).astype(np.float32)      # Hq=4, G=2
    lens = np.asarray(lengths, np.int32)
    want = paged_attention(jnp.asarray(q), jstore.k_pages[0],
                           jstore.v_pages[0], jnp.asarray(bt),
                           jnp.asarray(lens), interpret=True)
    oracle = jref.paged_attention_ref(jnp.asarray(q), jstore.k_pages[0],
                                      jstore.v_pages[0],
                                      jnp.asarray(np.maximum(bt, 0)),
                                      jnp.asarray(lens))
    got = ops.paged_attention_op(torch.from_numpy(q), store.k_pages[0],
                                 store.v_pages[0], torch.from_numpy(bt),
                                 torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


def test_ragged_interleaved_writes_scatter_pages_as_jax():
    """Four requests written in ragged pieces, round robin, one released
    half way and its pages reused: the allocator's tables and both pools
    equal JAX's, and every layer's decode over the scattered pages equals
    the JAX kernel in interpret mode."""
    L, n_pages, ps, hkv, d = 3, 40, 8, 2, 32
    jstore, store = _both(L, n_pages, ps, hkv, d)
    rng = np.random.default_rng(1)
    total = {0: 45, 1: 70, 2: 9, 3: 33, 9: 30}
    done = dict.fromkeys(total, 0)
    order = [9, 0, 1, 2, 3, 0, 1, 9, 3, 0, 1, 2, 1, 3, 0, 1]
    for step, rid in enumerate(order):
        if step == 8:                      # rid 9 leaves; its pages return
            jstore.allocator.release(9)
            store.allocator.release(9)
            del done[9]
        if rid not in done:
            continue
        t = min(int(rng.integers(1, 20)), total[rid] - done[rid])
        if t == 0:
            continue
        k = rng.normal(size=(L, t, hkv, d)).astype(np.float32)
        v = rng.normal(size=(L, t, hkv, d)).astype(np.float32)
        jstore.write_tokens(rid, done[rid], jnp.asarray(k), jnp.asarray(v))
        store.write_tokens(rid, done[rid], torch.from_numpy(k),
                           torch.from_numpy(v))
        done[rid] += t
    rids = sorted(done)
    assert store.allocator.allocated == jstore.allocator.allocated
    pages = [p for r in rids for p in store.allocator.allocated[r]]
    assert pages != sorted(pages)          # the pages are scattered
    np.testing.assert_array_equal(store.k_pages.numpy(),
                                  np.asarray(jstore.k_pages))
    np.testing.assert_array_equal(store.v_pages.numpy(),
                                  np.asarray(jstore.v_pages))

    max_pages = max(len(store.allocator.allocated[r]) for r in rids) + 1
    bt = np.stack([store.allocator.table(r, max_pages) for r in rids])
    lens = np.asarray([done[r] for r in rids], np.int32)
    q = rng.normal(size=(len(rids), 4, d)).astype(np.float32)
    for layer in range(L):
        want = paged_attention(jnp.asarray(q), jstore.k_pages[layer],
                               jstore.v_pages[layer], jnp.asarray(bt),
                               jnp.asarray(lens), interpret=True)
        got = ops.paged_attention_op(torch.from_numpy(q),
                                     store.k_pages[layer],
                                     store.v_pages[layer],
                                     torch.from_numpy(bt),
                                     torch.from_numpy(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for i, r in enumerate(rids):
            gk, _ = store.gather_dense(r, done[r])
            np.testing.assert_array_equal(
                gk[layer].numpy(), store.k_pages[layer][
                    torch.from_numpy(bt[i].clip(0))].reshape(
                        -1, hkv, d)[:done[r]].numpy())


def test_e4m3_pool_bytes_equal_jax():
    """An e4m3 pool takes JAX's cast: the same bytes for values across
    e4m3's range, NaN (sign kept) above 464 where torch would saturate;
    K/V already in e4m3 are stored as they are."""
    L, n_pages, ps, hkv, d = 2, 6, 4, 1, 8
    jstore, store = _both(L, n_pages, ps, hkv, d, dtype="e4m3")
    rng = np.random.default_rng(2)
    k = (rng.normal(size=(L, 13, hkv, d)) * 200).astype(np.float32)
    v = (rng.normal(size=(L, 13, hkv, d)) * 3).astype(np.float32)
    k[0, 0, 0, :4] = [465.0, -470.0, 464.0, 1e6]
    e4m3 = jnp.float8_e4m3fn               # JAX's pool takes e4m3 K/V
    jstore.write_tokens(5, 2, jnp.asarray(k).astype(e4m3),
                        jnp.asarray(v).astype(e4m3))
    store.write_tokens(5, 2, torch.from_numpy(k), torch.from_numpy(v))
    assert (np.abs(k) > 464).sum() > 4
    np.testing.assert_array_equal(_bytes(store.k_pages),
                                  _bytes(jstore.k_pages))
    np.testing.assert_array_equal(_bytes(store.v_pages),
                                  _bytes(jstore.v_pages))
    gk, _ = store.gather_dense(5, 15)
    assert torch.isnan(gk[0, 2, 0, [0, 1, 3]].float()).all()
    assert gk[0, 2, 0, 2].float().item() == 448.0
    again = PagedKVStore.create(L, n_pages, ps, hkv, d,
                                dtype=torch.float8_e4m3fn, device="cpu")
    k8 = torch.from_numpy(np.array(jnp.asarray(k).astype(e4m3))
                          .view(np.uint8)).view(torch.float8_e4m3fn)
    again.write_tokens(5, 2, k8, k8)
    np.testing.assert_array_equal(_bytes(again.k_pages),
                                  _bytes(jstore.k_pages))


def test_pool_exhaustion_raises():
    """tests/test_kvcache.py's: 17 tokens do not fit 2 pages of 8, in the
    JAX store or the port's; nor does a new request once the pool is
    full."""
    jstore, store = _both(1, 2, 8, 1, 8)
    k = np.zeros((1, 17, 1, 8), np.float32)
    with pytest.raises(MemoryError):
        jstore.write_tokens(0, 0, jnp.asarray(k), jnp.asarray(k))
    with pytest.raises(MemoryError):
        store.write_tokens(0, 0, torch.from_numpy(k), torch.from_numpy(k))
    full = torch.ones(1, 16, 1, 8)
    store.write_tokens(0, 0, full, full)
    with pytest.raises(MemoryError):
        store.write_tokens(1, 0, full[:, :1], full[:, :1])
