"""The yardstick's operation and byte counts against hand counts: the
card's peaks, and the ``llama`` architecture's counts."""
import pytest

from servebench import cost
from servebench.archs import llama

S = llama.Shape(layers=2, d_model=8, heads=2, kv_heads=1, head_dim=4,
               d_ff=16, vocab=10)


def test_prefill_call_counts_causally():
    # 2 queries at positions 0, 1: 1 + 2 keys; q and out 2*2*4 elements
    # each, K and V 2 rows of 1 head of 4
    assert llama.prefill_call(S, [(0, 2)]) == (4 * 2 * 4 * 3, 64 + 32)
    # a part starting at 5: keys 6 + 7
    f, b = llama.prefill_call(S, [(0, 2), (5, 2)])
    assert f == 4 * 2 * 4 * (3 + 13)
    assert b == 2 * 64 + 32 + 2 * 7 * 4 * 2


def test_prefill_call_counts_only_the_parts_queries():
    # one query at position 5, whatever bucket the executor pads it to:
    # 6 keys; its q and out, and K and V of 6 rows
    assert llama.prefill_call(S, [(5, 1)]) == (4 * 2 * 4 * 6,
                                              2 * 1 * 2 * 4 * 2
                                              + 2 * 6 * 4 * 2)


def test_decode_call_reads_each_rows_keys():
    f, b = llama.decode_call(S, [3, 1], table_cols=2)
    assert f == 4 * 2 * 4 * 4
    assert b == 2 * 2 * 2 * 4 * 2 + 2 * 4 * 1 * 4 * 2 + 4 * 2 * 3


def test_model_flops():
    assert llama.layer_params(S) == 8 * 4 * 4 + 2 * 4 * 8 + 3 * 8 * 16
    moe = llama.Shape(layers=2, d_model=8, heads=2, kv_heads=1, head_dim=4,
                     d_ff=16, vocab=10, experts=4, top_k=2,
                     dense_residual_ff=16)
    assert llama.layer_params(moe) == 192 + 8 * 4 + 2 * 3 * 8 * 16 \
        + 3 * 8 * 16
    assert llama.token_flops(S, 5, True) == 2 * (2 * 576 + 4 * 2 * 4 * 5) \
        + 2 * 8 * 10
    assert llama.chunk_flops(S, 3, 2, True) == \
        2 * (2 * 576 * 2 + 4 * 2 * 4 * 9) + 160
    assert llama.chunk_flops(S, 3, 2, False) == \
        llama.chunk_flops(S, 3, 2, True) - 160


def test_bound_is_the_slower_of_compute_and_bandwidth():
    assert cost.bound_s(989e12, 0) == pytest.approx(1.0)
    assert cost.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
