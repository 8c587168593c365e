"""The flash forward's persistent schedule, on the CPU.

``ops/attention.py::flash_plan`` mirrors csrc/flash.cu's ``make_walk``
(the card test ``test_torch_cuda.py::test_flash_plan_matches_the_kernel``
holds the two together): every (batch·head, q tile) item once in the
walk, batch·heads in chunks whose K and V fit in half the L2, heaviest
first by live kv tiles within a chunk, the counts following the JAX
op's ``_tile_live`` algebra.
"""

import pytest

from lua_mapreduce_tpu.ops.attention import _tile_live
from lua_mapreduce_tpu_torch.ops.attention import (FLASH_BQ, FLASH_ORDER_MAX,
                                                   flash_items, flash_kv_tile,
                                                   flash_plan)

H100_L2 = 50 * 2 ** 20
# (B, L, H, H_kv, D, causal, window, q_offset, SMs, L2 bytes): the serving
# prefill and the LM step (their K and V past half the L2: chunks of
# batch·heads), GQA, ragged L, L below a tile, windows with and without an
# offset (the banded ring's hops), d = 128's 64-key tiles, fewer items
# than SMs, a small L2 (chunks of one batch·head and ragged last chunks)
CASES = [(4, 3968, 16, 16, 64, True, 0, 0, 132, H100_L2),
         (8, 2048, 16, 16, 64, True, 0, 0, 132, H100_L2),
         (8, 2048, 16, 4, 64, True, 0, 0, 132, H100_L2),
         (2, 300, 4, 4, 64, True, 0, 0, 132, H100_L2),
         (1, 50, 2, 2, 64, True, 0, 0, 132, H100_L2),
         (3, 1000, 2, 2, 64, False, 0, 0, 132, H100_L2),
         (4, 3968, 16, 16, 64, True, 512, 0, 132, H100_L2),
         (2, 700, 4, 4, 64, True, 200, 150, 132, H100_L2),
         (1, 2000, 2, 2, 64, True, 96, 1500, 7, H100_L2),
         (2, 900, 4, 2, 128, True, 0, 0, 132, H100_L2),
         (1, 520, 4, 2, 128, True, 96, 40, 16, H100_L2),
         (5, 1300, 3, 3, 64, True, 0, 0, 64, 2 ** 20),
         (3, 2000, 5, 5, 64, True, 0, 0, 132, 3 * 2 ** 20)]


ARGS = "b,l,h,hkv,d,causal,window,q_offset,sms,l2"


@pytest.mark.parametrize(ARGS, CASES)
def test_every_item_is_walked_exactly_once(b, l, h, hkv, d, causal, window,
                                           q_offset, sms, l2):
    plan = flash_plan(b, l, h, hkv, d, causal, window, q_offset, sms, l2)
    nq = -(-l // FLASH_BQ)
    assert plan.grid == min(nq * b * h, sms)
    assert sorted(flash_items(plan, b * h)) == [
        (bh, q) for bh in range(b * h) for q in range(nq)]


@pytest.mark.parametrize(ARGS, CASES)
def test_the_order_is_heaviest_first(b, l, h, hkv, d, causal, window,
                                     q_offset, sms, l2):
    """Within each chunk of batch·heads the items go heaviest first (the
    walk's ranks, the chunk's batch·heads fastest), and a chunk's K and V
    fit in half the L2 unless it is a single batch·head."""
    plan = flash_plan(b, l, h, hkv, d, causal, window, q_offset, sms, l2)
    assert sorted(plan.order) == list(range(len(plan.live)))
    keys = [(plan.live[q], q) for q in plan.order]
    assert keys == sorted(keys, reverse=True)
    kv = l * d * 4 // (h // hkv)
    assert plan.chunk == 1 or plan.chunk * kv <= l2 // 2
    assert plan.chunk == b * h or (plan.chunk + 1) * kv > l2 // 2
    seq = flash_items(plan, b * h)
    for (bh0, q0), (bh1, q1) in zip(seq, seq[1:]):
        if bh0 // plan.chunk == bh1 // plan.chunk:
            assert plan.live[q1] <= plan.live[q0]
        else:
            assert bh1 // plan.chunk == bh0 // plan.chunk + 1


@pytest.mark.parametrize(ARGS, CASES)
def test_live_tiles_follow_the_jax_tile_live_algebra(b, l, h, hkv, d, causal,
                                                     window, q_offset, sms,
                                                     l2):
    plan = flash_plan(b, l, h, hkv, d, causal, window, q_offset, sms, l2)
    bk = flash_kv_tile(d)
    assert plan.kv_tile == bk
    n_kv = -(-l // bk)
    for qi, live in enumerate(plan.live):
        want = 0
        for ki in range(n_kv):
            cond = _tile_live(qi, ki, FLASH_BQ, bk, causal, window, q_offset)
            want += 1 if cond is None else int(bool(cond))
        assert live == want, (qi, live, want)


def test_past_the_order_table_tiles_go_in_descending_order():
    l = (FLASH_ORDER_MAX + 3) * FLASH_BQ
    plan = flash_plan(1, l, 1, 1, 64, True, 0, 0, 132, H100_L2)
    assert plan.order == tuple(range(FLASH_ORDER_MAX + 2, -1, -1))
    small = flash_plan(1, FLASH_ORDER_MAX * FLASH_BQ, 1, 1, 64, True, 64,
                       5000, 132, H100_L2)
    keys = [(small.live[q], q) for q in small.order]
    assert keys == sorted(keys, reverse=True)


def test_a_balanced_walk_at_the_serving_shape():
    """The blocks taking items from the counter as they free up (a
    simulation: an item costs its live kv tiles plus one for its q tile
    and epilogue) end within 2% of one another at the serving prefill's
    1,984 items on 132 SMs, its batch·heads in chunks of 25 (1 MB of K
    and V each in 25 MB)."""
    import heapq
    plan = flash_plan(4, 3968, 16, 16, 64, True, 0, 0, 132, H100_L2)
    assert plan.chunk == 25
    free = [(0, g) for g in range(plan.grid)]
    for _, q in flash_items(plan, 64):
        t, g = heapq.heappop(free)
        heapq.heappush(free, (t + plan.live[q] + 1, g))
    ends = [t for t, _ in free]
    total = sum(plan.live[q] + 1 for _, q in flash_items(plan, 64))
    assert max(ends) <= 1.02 * total / plan.grid
