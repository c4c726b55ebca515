"""The launch plan of the flash_decode split pass (``launch_plan``), held on
the CPU: the kernel itself runs only on the card, but how it is cut into
blocks — and so which invariants the card tests rest on — is plain Python.

Imports only ``repro_torch.kernels.flash_decode`` (no card, no nvcc)."""
import pytest
import torch

from repro_torch.kernels.flash_decode import (HEAD_DIMS, MAX_SMEM, MMA_ROWS, SPLIT_LEN, TILE,
                                              launch_plan)

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
