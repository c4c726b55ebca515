"""The card GEMMs' launch plans (``kernels/int8_matmul.gemm_plan``,
``kernels/int4_matmul.gemm_plan``) on the CPU.

The plan is pure Python chosen from the shapes alone, so what the kernel
will be asked to do is held here without a card: the regime from M alone,
a ``wgmma`` width that s8 takes and that covers M, a K split over a
thread-block cluster that covers K, shared memory within the block's
227 KB, and no split at ``lm_head``.  The shapes are the 7B model's
linears at vanilla (M 4), chain (24), paged chain (48), tree (88), paged
tree (176) and prefill (4092) rows, and the reduced config's.
"""
import pytest

from repro_torch.configs import get_config
from repro_torch.kernels.int4_matmul import K_ALIGN as INT4_K_ALIGN
from repro_torch.kernels.int4_matmul import gemm_plan as int4_plan
from repro_torch.kernels.int8_matmul import (KT, MAX_CLUSTER, S8_WIDTHS, SMALL_M,
                                             SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVE,
                                             gemm_plan)

_7B = get_config("quasar-paper-7b")
_RED = get_config("smollm-135m").reduced()


def _linears(cfg):
    """(name, K, N) of every quantized linear of a decoder layer and lm_head."""
    kv = cfg.num_kv_heads * cfg.head_dim
    return [("q/o", cfg.d_model, cfg.num_heads * cfg.head_dim), ("k/v", cfg.d_model, kv),
            ("gate/up", cfg.d_model, cfg.d_ff), ("down", cfg.d_ff, cfg.d_model),
            ("lm_head", cfg.d_model, cfg.vocab_size)]


def _check(m, k, n, name):
    p = gemm_plan(m, n, k)
    ktiles = -(-k // KT)
    # the regime follows M alone
    assert p.regime == ("swap" if m <= SMALL_M else "tiled")
    assert p.width in S8_WIDTHS
    if p.regime == "swap":
        assert m <= p.width                                  # all M rows in one wgmma N
        assert p.tile_n in (64, 128)
    else:
        assert (p.tile_n, p.width, p.cluster) == (256, 256, 1)
    # the cluster's K split covers K, every block with at least one K step
    assert p.cluster in (1, 2, 4, 8) and p.cluster <= MAX_CLUSTER
    per = -(-ktiles // p.cluster)
    assert (p.cluster - 1) * per < ktiles <= p.cluster * per
    # shared memory: the ring, and the int32 partial sums of a split
    a_rows = p.tile_n if p.regime == "swap" else 128
    ring = p.stages * (a_rows + p.width) * KT
    assert p.stages >= 2
    assert SMEM_RESERVE + ring <= p.smem <= SMEM_PER_BLOCK
    if p.cluster > 1:
        assert SMEM_RESERVE + 4 * 2 * p.tile_n * (p.width // 2) <= p.smem
        # a split only while the grid fits on the card at once
        per_sm = SMEM_PER_SM // (p.smem + 1024)
        assert -(-n // p.tile_n) * p.cluster <= 132 * per_sm
    if name == "lm_head":
        assert p.cluster == 1
    return p


@pytest.mark.parametrize("m", [4, 24, 48, 88, 176, 4092])
@pytest.mark.parametrize("name,k,n", _linears(_7B))
def test_gemm_plan_7b(m, name, k, n):
    _check(m, k, n, name)


@pytest.mark.parametrize("m", [1, 5, 24, 257])
@pytest.mark.parametrize("name,k,n", _linears(_RED))
def test_gemm_plan_reduced_config(m, name, k, n):
    _check(m, k, n, name)


def test_gemm_plan_reads_the_weight_once_up_to_m_256():
    """Every M <= 256 gets a single wgmma N covering all its rows, so each
    W tile is loaded once; the widths step to the next one s8 takes."""
    widths = {m: gemm_plan(m, 12288, 4096).width for m in range(1, SMALL_M + 1)}
    assert widths[1] == 8 and widths[9] == 24 and widths[24] == 24
    assert widths[25] == 48 and widths[48] == 48 and widths[88] == 96
    assert widths[176] == 192 and widths[256] == 256
    assert all(widths[m] >= m for m in widths)
    assert gemm_plan(257, 12288, 4096).regime == "tiled"


@pytest.mark.parametrize("m,k,n", [(24, 16 * 37, 200), (4, 16 * 37, 1100),
                                   (88, 16 * 9, 64), (24, 16 * 57, 1024)])
def test_gemm_plan_gives_every_split_block_k(m, k, n):
    """K a multiple of 16 but not of the 128-byte step, few K steps (5, 2,
    8) and few W tiles: the split stops before a block of the cluster
    would get no K step."""
    _check(m, k, n, "")


def test_gemm_plan_splits_k_where_tiles_are_few():
    assert gemm_plan(24, 1024, 4096).cluster == 8           # k/v: 16 tiles
    assert gemm_plan(24, 4096, 4096).cluster == 4           # q/o: 64 tiles
    assert gemm_plan(24, 12288, 4096).cluster == 1          # gate/up fills the card
    assert gemm_plan(24, 64, 16).cluster == 1               # one K step


# -- the int4 GEMM's plan (``kernels/int4_matmul.gemm_plan``) -----------------

def _check4(m, k, n, aligned=True):
    p = int4_plan(m, n, k, aligned)
    ktiles = -(-k // KT)
    # operands always swapped: W rows are wgmma's A, X rows its N
    assert p.regime == ("swap" if m <= SMALL_M else "tiled")
    assert p.width in S8_WIDTHS
    if p.regime == "swap":
        assert m <= p.width                        # every packed W byte read once
        assert p.tile_n == (64 if p.width <= 48 else 128)
    else:
        assert (p.tile_n, p.width, p.cluster) == (128, 256, 1)
    # TMA only where the packed rows are 16-byte multiples and aligned
    assert p.tma == (aligned and k % INT4_K_ALIGN == 0)
    # the split covers K and gives every block of the cluster a K step
    per = -(-ktiles // p.cluster)
    assert p.cluster in (1, 2, 4, 8)
    assert (p.cluster - 1) * per < ktiles <= p.cluster * per
    # the ring (packed W rows of KT/2 bytes) and a split's partial sums fit
    ring = p.stages * (p.tile_n * KT // 2 + p.width * KT)
    assert p.stages >= 2
    assert SMEM_RESERVE + ring <= p.smem <= SMEM_PER_BLOCK
    if p.cluster > 1:
        assert SMEM_RESERVE + 4 * 2 * p.tile_n * (p.width // 2) <= p.smem
        per_sm = SMEM_PER_SM // (p.smem + 1024)
        assert -(-n // p.tile_n) * p.cluster <= 132 * per_sm
    return p


@pytest.mark.parametrize("m", [4, 24, 48, 88, 176, 4092])
@pytest.mark.parametrize("name,k,n", _linears(_7B))
def test_int4_plan_7b(m, name, k, n):
    p = _check4(m, k, n)
    if name == "lm_head":
        assert p.cluster == 1
    assert p.tma


@pytest.mark.parametrize("m", [1, 5, 24, 257])
@pytest.mark.parametrize("name,k,n", _linears(_RED))
def test_int4_plan_reduced_config(m, name, k, n):
    _check4(m, k, n)


@pytest.mark.parametrize("m", [1, 8, 9, 24, 25, 48, 49, 96, 97, 192, 193, 256, 257, 300])
def test_int4_plan_widths_and_regimes(m):
    """Every width edge: the smallest built width that covers M, up to the
    swapped regime's end; past it, 256-row X tiles over a second grid
    dimension."""
    p = _check4(m, 4096, 12288)
    want = next(w for w in (8, 24, 48, 96, 192, 256) if w >= m) if m <= SMALL_M else 256
    assert p.width == want


@pytest.mark.parametrize("m,k,n,aligned", [
    (1, 2, 1, True), (7, 48, 200, True), (5, 62, 33, True), (9, 128, 40, False),
    (24, 4096, 1031, False), (300, 94, 97, True)])
def test_int4_plan_picks_the_load_producer_from_shapes_and_pointers(m, k, n, aligned):
    """K % 32 != 0 (packed rows not 16-byte multiples) or an unaligned base
    pointer: the producer stages the ring with ordinary loads; the plan is
    otherwise the same."""
    p = _check4(m, k, n, aligned)
    assert not p.tma
    assert p._replace(tma=True) == int4_plan(m, n, k, True)._replace(tma=True)


@pytest.mark.parametrize("m,k,n", [(24, 32 * 37, 200), (4, 32 * 37, 1100),
                                   (88, 32 * 9, 64), (24, 32 * 57, 1024)])
def test_int4_plan_gives_every_split_block_k(m, k, n):
    _check4(m, k, n)


def test_int4_plan_reads_packed_bytes_once_and_splits_where_tiles_are_few():
    assert int4_plan(24, 1024, 4096).cluster == 8          # k/v: 16 W tiles
    assert int4_plan(24, 4096, 4096).cluster == 4          # q/o: 64
    assert int4_plan(24, 12288, 4096).cluster == 1         # gate/up fills the card
    assert int4_plan(88, 12288, 4096).cluster == 2         # tree: 96 tiles of 128
    # the packed stage is half the int8 one's W bytes: deeper rings
    assert int4_plan(24, 12288, 4096).stages >= gemm_plan(24, 12288, 4096).stages
    assert int4_plan(4092, 12288, 4096).stages == 5
