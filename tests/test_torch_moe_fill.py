"""Each expert's kept rows (``fill``) from the port's MoE routing to its
batched expert GEMM, against the JAX package, on the CPU.

``moe.route`` returns ``fill`` (E,) int32 = min(tokens routed to the
expert, C); ``MoE.forward`` passes it to the W8A8 expert product, whose
kernel writes +0 to the rows past it and reads no weight of an expert with
none.  Held here: ``fill`` equals the count taken from the reference's own
routing; the plain version with ``rows=fill``, fed a real dispatch, equals
the reference's jitted W8A8 ``_expert_linear`` on every row, the zero rows
past the fill included (bit for bit); the CPU wrapper's rows contract
(NaN scales of an expert with no kept row still give +0); and the batched
kernel's launch plan (``kernels/int8_matmul.batched_plan``) at moonshot's
and phi3.5-moe's expert linears, beside the one-expert plan it leaves as
it was.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import SpecConfig as JSpecConfig
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.serving.engine import SpecEngine as JSpecEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.kernels.int8_matmul import (BATCHED_STATIC, KT, MAX_STAGES, NUM_SMS,
                                             SMEM_PER_BLOCK, SMEM_PER_SM, SMEM_RESERVE,
                                             SWAP_MAX_C, TILE_M, TILED_WIDTHS, WIDTHS,
                                             batched_plan, gemm_plan, int8_matmul_batched,
                                             int8_matmul_batched_ref)
from repro_torch.models import moe
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)
from test_torch_moe import MOE_ARCHS, _cfgs, _jax_dispatch, _jax_params, _moe_input

FACTORS = [None, 1.25]


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_fill_is_the_reference_count_clamped_at_capacity(arch, factor):
    jcfg, pcfg = _cfgs(arch, factor)
    jp = _jax_params(arch)["layers"][0]["moe"]
    x = _moe_input(jcfg.d_model)
    want = _jax_dispatch(jp, jcfg, jnp.asarray(x))
    E, K = jcfg.num_experts, jcfg.experts_per_token
    C = jmoe.capacity(x.shape[0] * x.shape[1], E, K, jcfg.moe_capacity_factor)
    count = np.bincount(np.asarray(want["eidx"]).reshape(-1), minlength=E)
    r = moe.route(moe.router_logits(torch.from_numpy(x).reshape(-1, pcfg.d_model),
                                    torch.from_numpy(np.array(jp["router"]["w"]))),
                  K, E, pcfg.moe_capacity_factor)
    assert r["fill"].dtype == torch.int32 and r["fill"].shape == (E,)
    np.testing.assert_array_equal(r["fill"].numpy(), np.minimum(count, C))
    # the kept slots are exactly rows 0 .. fill-1 of each expert
    kept = np.asarray(want["slot_tok"]).reshape(E, C) < x.shape[0] * x.shape[1]
    np.testing.assert_array_equal(kept.sum(axis=1), r["fill"].numpy())
    assert all(kept[e, :f].all() for e, f in enumerate(r["fill"].tolist()))


@pytest.fixture(scope="module")
def prepared():
    """The reference's W8A8-prepared params of each arch (layer 0's experts)
    and the port's from them through the bridge."""
    out = {}
    for arch in MOE_ARCHS:
        jcfg, pcfg = _cfgs(arch)
        jprep = JSpecEngine(JModel(jcfg), JSpecConfig(verifier="w8a8")).prepare_params(
            _jax_params(arch))
        port = from_jax_params(jax.tree.map(np.asarray, jprep), pcfg, device="cpu")
        out[arch] = (jprep["layers"][0]["moe"], port.layers[0].moe)
    return out


@pytest.mark.parametrize("factor", FACTORS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_product_with_fill_equals_reference_on_every_row(prepared, arch, factor):
    """A real dispatch (the layer's input gathered by the reference's slot →
    token map) through the reference's jitted W8A8 ``_expert_linear`` and
    through the port's expert linear with ``rows=fill``: every row equal bit
    for bit, the zero rows past each expert's fill (+0) included."""
    jcfg, pcfg = _cfgs(arch, factor)
    jp, layer = prepared[arch]
    x = _moe_input(jcfg.d_model, seed=3)
    n, D = x.shape[0] * x.shape[1], jcfg.d_model
    E = jcfg.num_experts
    want = _jax_dispatch(jp, jcfg, jnp.asarray(x))
    slot_tok = np.asarray(want["slot_tok"])
    C = slot_tok.shape[0] // E
    xe = np.concatenate([x.reshape(n, D), np.zeros((1, D), np.float32)])[slot_tok]
    xe = xe.reshape(E, C, D)
    r = moe.route(moe.router_logits(torch.from_numpy(x).reshape(n, D), layer.router.w),
                  jcfg.experts_per_token, E, pcfg.moe_capacity_factor)
    assert int(r["fill"].sum()) < E * C          # some rows lie past the fill
    for name in ("up", "gate"):
        if name not in jp:
            continue
        ref = np.asarray(jax.jit(jmoe._expert_linear)(jp[name], jnp.asarray(xe)))
        got = getattr(layer, name)(torch.from_numpy(xe), r["fill"]).numpy()
        np.testing.assert_array_equal(got, ref, err_msg=name)
        past = np.arange(C)[None, :] >= r["fill"].numpy()[:, None]
        assert (got[past] == 0).all() and not np.signbit(got[past]).any()


def test_batched_wrapper_rows_on_the_cpu():
    """Rows past each expert's fill come out +0 whatever the scales hold (a
    NaN Δw of an expert with no kept row included); rows=None computes every
    row; a fill above C keeps every row; bad rows are refused."""
    g = torch.Generator().manual_seed(1)
    E, C, K, N = 5, 7, 96, 40
    x = torch.randint(-127, 128, (E, C, K), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (E, N, K), generator=g, dtype=torch.int8)
    dx, dw = torch.rand(E, C, generator=g) * 1e-2, torch.rand(E, N, generator=g) * 1e-3
    dw[1] = float("nan")
    rows = torch.tensor([3, 0, 7, 1, 9], dtype=torch.int32)
    for out_dtype in (torch.float32, torch.bfloat16):
        full = int8_matmul_batched_ref(x, w, dx, dw, out_dtype)
        y = int8_matmul_batched(x, w, dx, dw, out_dtype=out_dtype, rows=rows)
        assert torch.equal(y, int8_matmul_batched_ref(x, w, dx, dw, out_dtype, rows))
        for e, f in enumerate(rows.tolist()):
            assert torch.equal(y[e, :f], full[e, :f])
            assert (y[e, f:] == 0).all() and not torch.signbit(y[e, f:].float()).any()
        assert full[1].isnan().all() and torch.equal(y[1], torch.zeros_like(y[1]))
        torch.testing.assert_close(int8_matmul_batched(x, w, dx, dw, out_dtype=out_dtype),
                                   full, rtol=0, atol=0, equal_nan=True)
    for bad in (rows[:4], rows.long(), rows[::2]):
        with pytest.raises(ValueError, match="rows must be"):
            int8_matmul_batched(x, w, dx, dw, rows=bad)


def _shapes():
    """(arch, E, C, K, N) of moonshot's and phi3.5-moe's expert linears."""
    for arch in ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"):
        cfg = get_config(arch)
        E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        for c in (1, 3, 6, 11, 21, 120, 257, 300, 480):
            for k, n in ((D, F), (F, D)):
                yield arch, E, c, k, n


@pytest.mark.parametrize("arch,e,c,k,n", list(_shapes()))
def test_batched_plan(arch, e, c, k, n):
    """The regime from C alone; swapped: a built width covering C, the
    one-expert plan's tiles, a persistent grid of what the card holds;
    tiled: the expert's own N tile where a built width divides N, 128-row M
    tiles, the staged output tile and a ring of three or four stages within
    the block's shared memory, one block per SM."""
    p = batched_plan(c, n, k, e)
    room = SMEM_PER_BLOCK - BATCHED_STATIC
    assert p.regime == ("swap" if c <= SWAP_MAX_C else "tiled")
    assert SMEM_RESERVE < p.smem <= room and 2 <= p.stages <= MAX_STAGES
    if p.regime == "swap":
        assert p.width in WIDTHS and c <= p.width and p.tile_n in (64, 128)
        assert p.smem >= SMEM_RESERVE + p.stages * (p.tile_n + p.width) * KT
        per_sm = SMEM_PER_SM // (p.smem + BATCHED_STATIC + 1024)
        items = -(-n // p.tile_n) * e
        assert p.cluster == 1                    # 16 and 64 experts fill the card
        assert p.grid == min(items, NUM_SMS * min(3, per_sm)) and per_sm >= 1
        one = gemm_plan(c, n, k)
        assert (p.width, p.tile_n) == (one.width, one.tile_n)
    else:
        assert p.tile_n == p.width and p.width in TILED_WIDTHS and p.cluster == 1
        assert n % p.tile_n == 0
        assert p.tile_n == {1408: 176, 2048: 256, 6400: 256, 4096: 256}[n]
        assert p.smem >= (SMEM_RESERVE + p.stages * (TILE_M + p.tile_n) * KT
                          + TILE_M * (2 * p.tile_n + 16))          # the staged bf16 tile
        assert p.stages == {176: 4, 256: 3}[p.tile_n]
        assert p.grid == min(e * -(-c // TILE_M) * (n // p.tile_n), NUM_SMS)


@pytest.mark.parametrize("e,c,k,n,cluster", [(4, 1, 16 * 37, 200, 2), (3, 9, 144, 72, 2),
                                             (2, 40, 4096, 64, 8), (2, 200, 4096, 64, 1),
                                             (5, 257, 48, 130, 1)])
def test_batched_plan_few_experts(e, c, k, n, cluster):
    """The card test's edge shapes: few experts and W tiles split K across a
    cluster, one item per cluster (the grid holds every item); a tiled N
    that no built width divides takes 256 and masks."""
    p = batched_plan(c, n, k, e)
    assert p.cluster == cluster
    if p.regime == "swap":
        ktiles = -(-k // KT)
        assert (p.cluster - 1) * -(-ktiles // p.cluster) < ktiles
        assert p.grid == -(-n // p.tile_n) * e * p.cluster
        assert p.smem >= SMEM_RESERVE + 4 * 2 * p.tile_n * (p.width // 2)
    else:
        assert p.tile_n == 256 and p.grid == e * -(-c // TILE_M)


@pytest.mark.parametrize("m,n,k,want", [
    (4, 12288, 4096, ("swap", 64, 8, 1, 8, 75776)),
    (24, 12288, 4096, ("swap", 64, 24, 1, 6, 69632)),
    (24, 1024, 4096, ("swap", 64, 24, 8, 6, 69632)),
    (24, 4096, 4096, ("swap", 64, 24, 4, 6, 69632)),
    (88, 12288, 4096, ("swap", 128, 96, 1, 8, 231424)),
    (176, 12288, 4096, ("swap", 128, 192, 1, 5, 206848)),
    (24, 151936, 4096, ("swap", 64, 24, 1, 6, 69632)),
    (24, 4096, 12288, ("swap", 64, 24, 4, 6, 69632)),
    (4092, 12288, 4096, ("tiled", 256, 256, 1, 4, 198656))])
def test_one_expert_plan_is_unchanged(m, n, k, want):
    """``gemm_plan`` (``int8_matmul`` and, through ``swap_plan``,
    ``int4_matmul``) keeps the plans it had before the batched product got a
    kernel of its own: the 7B's linears at vanilla, chain, tree, paged tree
    and prefill rows."""
    assert tuple(gemm_plan(m, n, k))[:6] == want
