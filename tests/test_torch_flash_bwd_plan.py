"""The one-pass flash backward's persistent schedule, on the CPU.

``ops/attention.py::flash_bwd_plan`` / ``flash_bwd_steps`` mirror
csrc/flash_bwd.cu's ``opk::make_walk`` and its consumers' step loop (the
card test ``test_torch_cuda.py::test_flash_bwd_plan_matches_the_kernel``
holds the plan to the kernel's): every (batch·kv head, key tile) item
once in the walk; each q tile's dq partials come from the key tiles the
JAX op's ``_tile_live`` / ``_q_clamp`` / ``_kv_clamp`` algebra makes
live, summed last key tile first, each partial counted so that its
successor waits for it; and every item a step waits on comes earlier in
the walk, so blocks taking items in walk order never wait on one that no
running block holds — with fewer SMs than items and with one.
"""

import pytest

from lua_mapreduce_tpu.ops.attention import _kv_clamp, _q_clamp, _tile_live
from lua_mapreduce_tpu_torch.ops.attention import (
    FLASH_BWD_BK, FLASH_BWD_BQ, flash_bwd_items, flash_bwd_key_tiles,
    flash_bwd_plan, flash_bwd_q_tile_written, flash_bwd_q_tiles,
    flash_bwd_steps)

H100_L2 = 50 * 2 ** 20
# (B, L, H, H_kv, causal, window, q_offset, SMs, L2 bytes): the LM step
# (its q, do, K and V past half the L2: chunks of batch·kv heads) and its
# GQA 4:1 form, GQA 8:1, ragged L, L below a tile, no mask, windows with
# and without an offset (the banded ring's hops, some key tiles wholly
# behind the window), fewer SMs than items, one SM, a small L2 (chunks
# of one batch·kv head and ragged last chunks)
CASES = [(8, 2048, 16, 16, True, 0, 0, 132, H100_L2),
         (8, 2048, 16, 4, True, 0, 0, 132, H100_L2),
         (2, 300, 8, 1, True, 0, 0, 132, H100_L2),
         (2, 200, 4, 4, True, 0, 0, 7, H100_L2),
         (1, 50, 2, 2, True, 0, 0, 132, H100_L2),
         (2, 96, 4, 4, False, 0, 0, 3, H100_L2),
         (8, 2048, 16, 16, True, 512, 0, 132, H100_L2),
         (2, 300, 4, 2, True, 37, 0, 5, H100_L2),
         (2, 700, 4, 2, True, 200, 150, 1, H100_L2),
         (1, 2000, 2, 2, True, 96, 1500, 7, H100_L2),
         (2, 257, 4, 4, True, 70, 130, 1, H100_L2),
         (2, 40, 2, 2, True, 8, 44, 132, H100_L2),
         (5, 1300, 3, 3, True, 0, 0, 16, 2 ** 20),
         (3, 1000, 4, 2, True, 0, 0, 132, 3 * 2 ** 20)]
ARGS = "b,l,h,hkv,causal,window,q_offset,sms,l2"


def _live(qt, kt, causal, window, q_offset):
    live = _tile_live(qt, kt, FLASH_BWD_BQ, FLASH_BWD_BK, causal, window,
                      q_offset)
    return True if live is None else bool(live)


@pytest.mark.parametrize(ARGS, CASES)
def test_every_item_is_walked_exactly_once(b, l, h, hkv, causal, window,
                                           q_offset, sms, l2):
    plan = flash_bwd_plan(b, l, h, hkv, sms, l2)
    nk = -(-l // FLASH_BWD_BK)
    assert plan.nk == nk and plan.grid == min(nk * b * hkv, sms)
    # a chunk's q, do, K and V fit in half the L2, unless it is one
    # batch·kv head
    nbytes = (2 * (h // hkv) + 2) * l * 64 * 2
    assert plan.chunk == 1 or plan.chunk * nbytes <= l2 // 2
    items = flash_bwd_items(plan, b * hkv)
    assert sorted(items) == [(x, kt) for x in range(b * hkv)
                             for kt in range(nk)]
    # within a chunk the key tiles go last first
    for i in range(1, len(items)):
        (x0, k0), (x1, k1) = items[i - 1], items[i]
        if x0 // plan.chunk == x1 // plan.chunk:
            assert k1 <= k0


@pytest.mark.parametrize("causal,window,q_offset",
                         [(False, 0, 0), (True, 0, 0), (True, 37, 0),
                          (True, 70, 130), (True, 96, 1500), (True, 8, 44),
                          (True, 300, 20)])
@pytest.mark.parametrize("l", [40, 300, 2000])
def test_the_tile_ranges_are_the_jax_ops_live_tiles(causal, window,
                                                    q_offset, l):
    """Key tile kt's q tiles and q tile qt's key tiles are the live
    (q tile, key tile) pairs of ``_tile_live``, and on them the JAX op's
    ``_q_clamp`` and ``_kv_clamp`` are the identity."""
    nq, nk = -(-l // FLASH_BWD_BQ), -(-l // FLASH_BWD_BK)
    live = {(qt, kt) for qt in range(nq) for kt in range(nk)
            if _live(qt, kt, causal, window, q_offset)}
    kw = dict(block_q=FLASH_BWD_BQ, block_k=FLASH_BWD_BK, causal=causal,
              window=window, q_offset=q_offset)
    for kt in range(nk):
        lo, hi = flash_bwd_q_tiles(kt, l, causal, window, q_offset)
        assert set(range(lo, hi + 1)) == {q for q, k in live if k == kt}
    for qt in range(nq):
        lo, hi = flash_bwd_key_tiles(qt, l, causal, window, q_offset)
        assert set(range(lo, hi + 1)) == {k for q, k in live if q == qt}
    for qt, kt in sorted(live)[::7]:
        assert int(_q_clamp(qt, kt, n_q=nq, **kw)) == qt
        assert int(_kv_clamp(qt, kt, n_kv=nk, **kw)) == kt


@pytest.mark.parametrize(ARGS, CASES)
def test_each_q_tile_sums_its_live_key_tiles_last_first(
        b, l, h, hkv, causal, window, q_offset, sms, l2):
    """Walking the steps in walk order, each q tile's partials come from
    its live key tiles in descending order, the i-th waiting for i
    partials before it and leaving i + 1, the last leaving 0."""
    plan = flash_bwd_plan(b, l, h, hkv, sms, l2)
    nq, group = -(-l // FLASH_BWD_BQ), h // hkv
    adds = {}
    for (bhk, kt), steps in flash_bwd_steps(plan, b, l, h, hkv, causal,
                                            window, q_offset):
        lo, hi = flash_bwd_q_tiles(kt, l, causal, window, q_offset)
        assert len(steps) == max(hi - lo + 1, 0) * group
        for idx, before, after in steps:
            bh, qt = divmod(idx, nq)
            assert bh // h == bhk // hkv and (bh % h) // group == bhk % hkv
            adds.setdefault(idx, []).append((kt, before, after))
    for idx in range(b * h * nq):
        qt = idx % nq
        want = sorted((kt for kt in range(-(-l // FLASH_BWD_BK))
                       if _live(qt, kt, causal, window, q_offset)),
                      reverse=True)
        got = sorted(adds.get(idx, []), key=lambda a: a[1])
        assert [kt for kt, _, _ in got] == want
        assert [x for _, x, _ in got] == list(range(len(want)))
        assert [y for _, _, y in got] == list(range(1, len(want))) + [0] * (
            len(want) > 0)


@pytest.mark.parametrize(ARGS, CASES)
def test_the_pre_pass_zeroes_exactly_the_q_tiles_no_step_writes(
        b, l, h, hkv, causal, window, q_offset, sms, l2):
    """A q tile's dq is written by its last step (the one leaving the
    count at 0) if it has any, and such a step exists exactly where the
    JAX op's algebra makes some key tile live for it; the rows' pre-pass
    zeroes the others (``flash_bwd_q_tile_written``, csrc/flash_bwd.cu's
    ``dq_written``)."""
    plan = flash_bwd_plan(b, l, h, hkv, sms, l2)
    nq, nk = -(-l // FLASH_BWD_BQ), -(-l // FLASH_BWD_BK)
    written = {idx for _, steps in flash_bwd_steps(
        plan, b, l, h, hkv, causal, window, q_offset)
        for idx, _, after in steps if after == 0}
    for idx in range(b * h * nq):
        qt = idx % nq
        mirror = flash_bwd_q_tile_written(qt, l, causal, window, q_offset)
        assert (idx in written) == mirror
        assert mirror == any(_live(qt, kt, causal, window, q_offset)
                             for kt in range(nk))


@pytest.mark.parametrize(ARGS, CASES)
def test_every_awaited_item_comes_earlier_in_the_walk(
        b, l, h, hkv, causal, window, q_offset, sms, l2):
    """A step that waits for partials waits for items of later key tiles
    of its own batch·kv head, each earlier in the walk: the wait graph
    points only backwards, so it has no cycle."""
    plan = flash_bwd_plan(b, l, h, hkv, sms, l2)
    walk = flash_bwd_steps(plan, b, l, h, hkv, causal, window, q_offset)
    where = {item: i for i, (item, _) in enumerate(walk)}
    nq = -(-l // FLASH_BWD_BQ)
    for i, ((bhk, kt), steps) in enumerate(walk):
        for idx, before, _ in steps:
            qt = idx % nq
            _, klast = flash_bwd_key_tiles(qt, l, causal, window, q_offset)
            assert before == klast - kt
            for k in range(kt + 1, klast + 1):
                assert where[(bhk, k)] < i


@pytest.mark.parametrize(ARGS, CASES)
def test_blocks_taking_items_in_walk_order_never_wait_forever(
        b, l, h, hkv, causal, window, q_offset, sms, l2):
    """``plan.grid`` blocks take items in walk order, one at a time, and
    run their steps in order; a step's add waits until its q tile's
    count equals the partials before it. Every round some block moves
    until all items are done, every count ends at 0, and each q tile's
    sum is taken in the one order the counts allow."""
    plan = flash_bwd_plan(b, l, h, hkv, sms, l2)
    walk = flash_bwd_steps(plan, b, l, h, hkv, causal, window, q_offset)
    counts = [0] * (b * h * -(-l // FLASH_BWD_BQ))
    blocks, taken, done = [None] * plan.grid, 0, 0
    while done < len(walk):
        moved = False
        for i, blk in enumerate(blocks):
            if blk is None:
                if taken < len(walk):
                    blocks[i], taken, moved = [taken, 0], taken + 1, True
                continue
            steps = walk[blk[0]][1]
            if blk[1] == len(steps):
                blocks[i], done, moved = None, done + 1, True
                continue
            idx, before, after = steps[blk[1]]
            if counts[idx] == before:
                counts[idx], blk[1], moved = after, blk[1] + 1, True
        assert moved, "no block can move: a wait that never ends"
    assert not any(counts)
