"""The launch plan of the flash_decode split pass (``launch_plan``), held on
the CPU: the kernel itself runs only on the card, but how it is cut into
blocks — and so which invariants the card tests rest on — is plain Python.

Imports only ``repro_torch.kernels.flash_decode`` (no card, no nvcc)."""
import pytest
import torch

from repro_torch.kernels.flash_decode import (CROSS_ROWS, HEAD_DIMS, MAX_SMEM, MMA_ROWS,
                                              RING_CHUNK, RING_MAX_SPLIT, RING_ROWS,
                                              RING_SLICES, SPLIT_LEN, TILE, cross_plan,
                                              cross_split_len, launch_plan, ring_slices_bytes,
                                              ring_split_len)

# (q dtype, K/V dtype) pairs the kernel is instantiated for
TYPES = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.int8),
         (torch.float32, torch.float32), (torch.float32, torch.int8)]
ROWS = [1, 6, 24, 27, 88, 128, 129, 200, 260, 340]


@pytest.mark.parametrize("q_dtype,kv_dtype", TYPES)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_nsplit_depends_on_s_alone(dh, q_dtype, kv_dtype):
    for S in (1, 127, 128, 129, 1152, 1280, 5000):
        want = -(-S // SPLIT_LEN)
        assert {launch_plan(r, S, dh, q_dtype, kv_dtype).nsplit for r in ROWS} == {want}


@pytest.mark.parametrize("q_dtype,kv_dtype", TYPES)
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_plan_fits_the_card_and_tiles_rows(dh, q_dtype, kv_dtype):
    """Every window up to (4,4,4)'s 340 rows per KV head: the block's shared
    bytes fit the H100's 232 448, its rows are all G·T or a multiple of 16,
    and its row blocks cover the rows with no block left empty."""
    for rows in range(1, 341):
        p = launch_plan(rows, 1152, dh, q_dtype, kv_dtype)
        assert 0 < p.smem <= MAX_SMEM
        assert p.rows_per_block == rows or p.rows_per_block % TILE == 0
        blocks = -(-rows // p.rows_per_block)
        assert (blocks - 1) * p.rows_per_block < rows <= blocks * p.rows_per_block
        assert p.threads % 32 == 0 and 128 <= p.threads <= 256
        assert p.stages >= 1


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_tensor_core_plan_holds_a_kv_head_in_one_block(dh, kv_dtype):
    """bf16 queries: G·T ≤ 128 rows take exactly one row block, one warp per
    16-row tile (at least 4 warps), and a ring of K/V chunks; wider
    windows take ⌈G·T/128⌉ row blocks."""
    for rows in range(1, 341):
        p = launch_plan(rows, 1152, dh, torch.bfloat16, kv_dtype)
        blocks = -(-rows // p.rows_per_block)
        if rows <= MMA_ROWS:
            assert p.rows_per_block == rows and blocks == 1
        else:
            assert blocks == -(-rows // MMA_ROWS) and p.rows_per_block <= MMA_ROWS
        assert p.threads == 32 * max(4, -(-p.rows_per_block // TILE))
        assert 2 <= p.stages <= SPLIT_LEN // 32


def test_plan_at_the_7b_windows():
    """The 7B shapes (G 4, dh 128): chain T 6 and the (3,2,1,1) tree in one
    block of 4 and 6 warps; (4,4,4) and (64,) in three row blocks."""
    bf16, i8 = torch.bfloat16, torch.int8
    assert launch_plan(24, 1152, 128, bf16, bf16)[:3] == (24, 32 * 272 + 3 * 2 * 32 * 272, 3)
    assert launch_plan(88, 1152, 128, bf16, i8).threads == 192
    assert launch_plan(340, 1280, 128, bf16, bf16).rows_per_block == 128
    assert launch_plan(260, 1280, 128, bf16, bf16).rows_per_block == 96


RING_S = (136, 144, 192, 1152, 2176, 4096, 4224, 6272, 8320, 16512)
SM_SMEM = 233472           # shared memory of one H100 SM; each block reserves 1 KB of it


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_ring_split_and_slices_depend_on_s_and_dh_alone(dh, kv_dtype):
    """The ring body's split length, split count and key slices follow S
    (and dh) alone — never T, G·T or B (B is no argument of the plan) — so
    a row sums its keys in the same order whatever window it sits in."""
    for S in RING_S:
        plans = [launch_plan(rows, S, dh, torch.bfloat16, kv_dtype, ring=True)
                 for rows in ROWS + [g * t for g in (1, 3, 4, 8) for t in range(1, 8)]]
        assert {(p.split_len, p.nsplit, p.slices) for p in plans} == {
            (ring_split_len(S), -(-S // ring_split_len(S)), RING_SLICES)}
        split = ring_split_len(S)
        assert split % RING_CHUNK == 0 and SPLIT_LEN <= split <= 512
    # 16 splits or more from 2048 slots on: B 1 at 8 KV heads fills the SMs;
    # the 7B's 4224-slot ring in 16 splits of 17 chunks
    assert all(-(-S // ring_split_len(S)) >= 16 for S in RING_S if S >= 2048)
    assert (ring_split_len(4224), -(-4224 // ring_split_len(4224))) == (272, 16)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.int8])
@pytest.mark.parametrize("dh", [64, 80, 128, 160])
def test_ring_plan_fits_the_card(dh, kv_dtype):
    """The ring body's block fits the H100's shared memory at every window
    up to 24 rows per KV head and beyond (row blocks of at most RING_ROWS),
    two blocks per SM up to dh 128 (each block also holds 16 static bytes
    and the 1 KB the card reserves), with one warp per (16-row tile, key
    slice); its fold's accumulators and its merge's per-split sums fit in
    the slots they reuse."""
    for rows in range(1, 97):
        p = launch_plan(rows, 4224, dh, torch.bfloat16, kv_dtype, ring=True)
        assert 0 < p.smem <= MAX_SMEM
        assert p.rows_per_block <= RING_ROWS
        assert p.rows_per_block == rows or p.rows_per_block % TILE == 0
        blocks = -(-rows // p.rows_per_block)
        assert (blocks - 1) * p.rows_per_block < rows <= blocks * p.rows_per_block
        assert p.threads == 32 * RING_SLICES * -(-p.rows_per_block // TILE)
        rp = -(-p.rows_per_block // TILE) * TILE
        slots = ring_slices_bytes(dh, kv_dtype == torch.int8)
        assert slots <= p.smem - rp * (2 * dh + 16)
        # the fold's accumulators, m, l and weights; the merge's m, l per split
        assert 4 * (RING_SLICES * rp * (dh + 8) + 3 * RING_SLICES * RING_ROWS) <= slots
        assert 4 * (2 * p.nsplit + 1) * RING_ROWS <= slots
        if dh <= 128:
            assert 2 * (p.smem + 16 + 1024) <= SM_SMEM


@pytest.mark.parametrize("q_dtype,kv_dtype", TYPES)
def test_non_ring_plans_are_unchanged_by_the_ring_body(q_dtype, kv_dtype):
    """A chain, tree or paged read (and an f32 cross read) keeps 128-key
    splits and its plan; an f32 ring keeps the f32 body's plan (128-key
    splits)."""
    for dh in HEAD_DIMS:
        for rows in ROWS:
            for S in (128, 1152, 4224):
                p = launch_plan(rows, S, dh, q_dtype, kv_dtype)
                assert (p.split_len, p.slices, p.nsplit) == (SPLIT_LEN, 1, -(-S // SPLIT_LEN))
                if q_dtype == torch.float32:
                    assert launch_plan(rows, S, dh, q_dtype, kv_dtype, ring=True) == p


CROSS_S = (1, 8, 16, 40, 100, 127, 128, 200, 255, 256, 500, 511, 512, 1000, 1500, 1600,
           2047, 2048, 2049, 3000, 8192)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_cross_split_and_slices_depend_on_s_and_dh_alone(dh):
    """The cross read's split length, split count and key slices follow S
    (and dh) alone: the same for every B (no argument of the plan), T and
    G, so a row sums its keys in the same order whatever window and batch
    it sits in."""
    for S in CROSS_S:
        plans = [cross_plan(g * t, S, dh) for g in (1, 2, 3, 4, 8, 16) for t in (1, 2, 5, 6, 22, 64)]
        split = cross_split_len(S)
        assert {(p.split_len, p.nsplit, p.slices, p.stages) for p in plans} == {
            (split, -(-S // split), RING_SLICES, plans[0].stages)}
        assert split % RING_CHUNK == 0 and split <= RING_MAX_SPLIT
        # every split holds keys: no block of the grid idles
        assert (-(-S // split) - 1) * split < S <= -(-S // split) * split


def test_cross_splits_at_the_families_shapes():
    """Whisper's 1500 frames and vision's 1600 image tokens: four splits of
    whole 16-key chunks, so B 4 runs 4·12·4 = 192 and 4·8·4 = 128 blocks,
    one round on the 132 SMs; short S take one split."""
    assert (cross_split_len(1500), -(-1500 // cross_split_len(1500))) == (384, 4)
    assert (cross_split_len(1600), -(-1600 // cross_split_len(1600))) == (400, 4)
    assert cross_split_len(100) == 112 and cross_split_len(300) == 160
    p = cross_plan(48, 1600, 128)                     # vision: 64/8 heads, T 6
    assert (p.rows_per_block, p.threads) == (48, 32 * RING_SLICES * 3)
    p = cross_plan(6, 1500, 64)                       # whisper: 12/12 heads, T 6
    assert (p.rows_per_block, p.threads) == (6, 32 * RING_SLICES)


@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_cross_plan_fits_the_card_and_tiles_rows(dh):
    """Up to CROSS_ROWS rows (32 at dh 160) share one block, so vision's 48
    rows per KV head read K/V once; a training window spreads over row
    blocks that cover its rows; the block fits the card's shared memory."""
    cap = CROSS_ROWS if dh <= 128 else RING_ROWS
    for rows in list(range(1, 130)) + [512, 1024, 2048]:
        p = cross_plan(rows, 1600, dh)
        assert 0 < p.smem <= MAX_SMEM
        blocks = -(-rows // p.rows_per_block)
        if rows <= cap:
            assert p.rows_per_block == rows and blocks == 1
        else:
            assert p.rows_per_block % TILE == 0 and p.rows_per_block <= cap
        assert (blocks - 1) * p.rows_per_block < rows <= blocks * p.rows_per_block
        assert p.threads == 32 * RING_SLICES * -(-p.rows_per_block // TILE)
