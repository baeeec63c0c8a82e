"""The bf16 flash forward's tile schedule against the plain version's mask.

``flash_attention.forward_tile_schedule`` mirrors, for given shapes, what
``flash_fwd_wgmma_kernel`` does per block: the K/V tiles each group of 64
queries visits and which of them take the masked path. Here it is held
against a brute-force mask built as ``sdpa_reference`` builds it
(``tril(s_k - s_q)``, causal bottom-right; ``kernels/attention.py``):

- a mask-free tile holds no masked pair and no row or key out of range;
- a tile a group skips holds no visible pair of its rows;
- a row that sees no key (causal, ``s_q > s_k``) visits every tile, so
  its output is the mean of v as in the plain version;
- the items cover every query once, in units of two query blocks whose
  work is equal for a square causal shape of whole items.

And the float32 programs' launch plans (``analysis.kernelcheck.flash_plan``,
held equal to the C launch code on the card): the backward is two
launches, a prep kernel and one fused pass whose key blocks walk query
tiles that cover every visible (query, key) pair once and add into ``dq``
as a declared accumulation; the forward's blocks cover every query once.

No card is needed: the schedule is a function of the shapes alone.
"""
import pytest
import torch

from paddle_tpu_torch.analysis import kernelcheck as kc
from paddle_tpu_torch.kernels import flash_attention as fa

SHAPES = [  # (s_q, s_k, causal): the schedule does not depend on head_dim
    (1024, 1024, True), (1000, 1000, True), (200, 333, True),
    (150, 70, True), (65, 63, True), (256, 640, True), (384, 384, False),
    (130, 70, False), (1, 1, True), (1, 200, True), (4096, 4096, True),
    (640, 640, True)]
IDS = ["train", "tail-1000", "rect-tail", "rows-see-no-key",
       "tail-rows-see-no-key", "splash-offset", "noncausal",
       "noncausal-rect", "one-by-one", "one-query", "splash-route",
       "odd-item-count"]


def _visible(s_q, s_k, causal):
    """[s_q, s_k] bool, True = the pair is visible (sdpa_reference's)."""
    if not causal:
        return torch.ones(s_q, s_k, dtype=torch.bool)
    return torch.ones(s_q, s_k, dtype=torch.bool).tril(s_k - s_q)


def _groups(s_q, s_k, causal):
    """(group rows below s_q, visited tiles, all tile starts) per group."""
    keys = fa.FWD_KEY_TILE
    starts = list(range(0, s_k, keys))
    for block in fa.forward_tile_schedule(s_q, s_k, causal):
        for grp in block.groups:
            assert len(grp.tiles) <= block.n_tiles
            rows = range(grp.r0, min(grp.r0 + fa.FWD_GROUP_ROWS, s_q))
            yield grp, rows, keys, starts


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_units_cover_every_query_in_balanced_pairs(shape):
    s_q, s_k, causal = shape
    blocks = fa.forward_tile_schedule(s_q, s_k, causal)
    rows = [r for b in blocks for g in b.groups
            for r in range(g.r0, min(g.r0 + fa.FWD_GROUP_ROWS, s_q))]
    assert sorted(rows) == list(range(s_q))
    rows_per_item = fa.FWD_ITEM_ROWS
    n_qblocks = -(-s_q // rows_per_item)
    units = {}
    for b in blocks:
        units.setdefault(b.unit, []).append(b)
    assert sorted(units) == list(range((n_qblocks + 1) // 2))
    for p, items in units.items():
        # the i-th query block from the end, then the i-th from the start
        assert [b.q0 // rows_per_item for b in items] == sorted(
            {n_qblocks - 1 - p, p}, reverse=True)
    if causal and s_q == s_k and s_q % rows_per_item == 0:
        # every unit of two the same work (an odd count's middle: half)
        work = {sum(b.n_tiles for b in items)
                for items in units.values() if len(items) == 2}
        assert len(work) <= 1
    for b in blocks:  # the producer loads the tiles its groups visit
        assert b.n_tiles == max(len(g.tiles) for g in b.groups)
        for g in b.groups:
            assert [j0 for j0, _ in g.tiles] == [
                i * fa.FWD_KEY_TILE for i in range(len(g.tiles))]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_mask_free_tiles_hold_no_masked_pair(shape):
    s_q, s_k, causal = shape
    vis = _visible(s_q, s_k, causal)
    for grp, rows, keys, _ in _groups(s_q, s_k, causal):
        for j0, masked in grp.tiles:
            if masked:
                continue
            # every row of the group and every key of the tile in range
            assert grp.r0 + fa.FWD_GROUP_ROWS <= s_q and j0 + keys <= s_k
            assert bool(vis[grp.r0:grp.r0 + fa.FWD_GROUP_ROWS,
                            j0:j0 + keys].all()), (grp.r0, j0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_skipped_tiles_hold_no_visible_pair(shape):
    s_q, s_k, causal = shape
    vis = _visible(s_q, s_k, causal)
    for grp, rows, keys, starts in _groups(s_q, s_k, causal):
        visited = {j0 for j0, _ in grp.tiles}
        for j0 in starts:
            if j0 not in visited and len(rows):
                assert not bool(vis[rows.start:rows.stop,
                                    j0:j0 + keys].any()), (grp.r0, j0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_rows_that_see_no_key_visit_every_tile(shape):
    s_q, s_k, causal = shape
    vis = _visible(s_q, s_k, causal)
    blind = ~vis.any(dim=1)
    assert bool(blind.any()) == (causal and s_q > s_k)
    for grp, rows, keys, starts in _groups(s_q, s_k, causal):
        if any(bool(blind[r]) for r in rows):
            assert [j0 for j0, _ in grp.tiles] == starts
            assert all(masked for _, masked in grp.tiles)


def _fp32_plan(s_q, s_k, causal, backward, d=64):
    return kc.flash_plan(b=2, h=3, s_q=s_q, s_k=s_k, d=d, dtype="fp32",
                         causal=causal, backward=backward)


@pytest.mark.parametrize("d", [64, 128])
def test_fp32_backward_is_a_prep_and_one_fused_pass(d):
    prep, fused = _fp32_plan(1024, 1024, True, True, d)
    assert prep.kernel == f"flash_bwd_prep_fp32_kernel<{d}>"
    assert fused.kernel == f"flash_bwd_tf32_kernel<{d}>"
    assert fused.grid == (1024 // 64, 3, 2) and fused.threads == 256
    outs = {o.name: o for o in fused.outputs}
    assert set(outs) == {"dk_dv", "dq"}
    # every key block adds its part of dq into the query tiles it walks
    assert outs["dq"].accumulates and outs["dq"].n_tiles is None
    assert not outs["dk_dv"].accumulates


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_fp32_backward_key_blocks_cover_every_visible_pair_once(shape):
    s_q, s_k, causal = shape
    _, fused = _fp32_plan(s_q, s_k, causal, True)
    vis = _visible(s_q, s_k, causal)
    n_qt, n_kt = -(-s_q // 64), -(-s_k // 64)
    dq = next(o for o in fused.outputs if o.name == "dq")
    dkdv = next(o for o in fused.outputs if o.name == "dk_dv")
    owners = {}
    for kt in range(n_kt):  # (batch, head) (0, 0)
        point = (kt, 0, 0)
        (own,) = dkdv.tiles(point)
        owners.setdefault(own, []).append(kt)
        walked = list(dq.tiles(point))
        assert len(walked) == len(set(walked))  # each query tile once
        keys = slice(64 * kt, min(64 * kt + 64, s_k))
        for qt in range(n_qt):
            rows = slice(64 * qt, min(64 * qt + 64, s_q))
            if bool(vis[rows, keys].any()):
                assert qt in walked, (kt, qt)
        # a row that sees no key attends every key: every tile walks it
        if causal and s_q > s_k:
            assert walked == list(range(n_qt))
    # every key block is one block's, so a visible pair is summed once
    assert all(len(v) == 1 for v in owners.values())
    assert len(owners) == n_kt


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_fp32_forward_blocks_cover_every_query_once(shape):
    s_q, s_k, causal = shape
    (lc,) = _fp32_plan(s_q, s_k, causal, False)
    assert lc.kernel == "flash_fwd_tf32_kernel<64>" and lc.threads == 256
    n_qb = -(-s_q // 128)
    assert lc.grid == (n_qb, 3, 2)
    rows = []
    for x in range(n_qb):  # (batch, head) (0, 0): heaviest block first
        (blk,) = lc.outputs[0].tiles((x, 0, 0))
        rows += range(128 * blk, min(128 * blk + 128, s_q))
    assert sorted(rows) == list(range(s_q))
    assert lc.outputs[0].tiles((0, 0, 0)) == (n_qb - 1,)
