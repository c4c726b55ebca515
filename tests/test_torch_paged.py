"""The port's paged, prefix-shared KV cache against the JAX package, and
the port's own paged-serving losslessness.

* ``flash_decode_paged``'s plain version (gather + ``flash_decode_ref``)
  against the reference's Pallas kernel in interpret mode, chain/tree ×
  f32/int8 KV, over a shuffled block table with a scratch tail: 1e-5 (f32
  accumulation in another order).
* The device helpers (``physical_slots``, ``write_cache_paged``,
  ``_compact_attn_rows_paged``, ``scatter_prefill_rows``, ``clone_block``,
  the swap round trip) bit-equal to the reference's on the same inputs.
* ``BlockPool`` / ``PrefixIndex`` / ``plan_group`` (copied) against the
  reference on the same operation sequences: same ids, refcounts, slack,
  counters and errors.  ``BlockPool.release`` keeps the reference's
  return value; the checks here read refcounts (the reference's failing
  assertion on that list is not copied).
* Paged scheduled ``generate_requests`` gives the reference's T = 0 tokens
  per request (``smollm-135m`` ``.reduced()``, f32, bridged weights).
* Inside the port: paged ≡ contiguous ≡ solo, prefix sharing on ≡ off,
  preempt-resume ≡ uninterrupted, at T = 0 and T > 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import paged_cache as jpc
from repro.core.tree import TreeTemplate as JTreeTemplate
from repro.kernels.flash_decode import flash_decode_paged as jflash_paged
from repro.models import transformer as jtransformer
from repro.models.attention import _quant_kv as j_quant_kv
from repro.models.attention import write_cache_paged as jwrite_paged
from repro.serving.request import GenerationRequest as JRequest
from repro_torch.bridge import array
from repro_torch.core import paged_cache as pc
from repro_torch.core.config import SpecConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import flash_decode_paged, flash_decode_paged_ref
from repro_torch.models import Model, transformer
from repro_torch.models.attention import last_writer, write_cache_paged
from repro_torch.serving.engine import SpecEngine
from repro_torch.serving.request import GenerationRequest
from repro_torch.serving.scheduler import Scheduler
from test_torch_batching import (JSCFG, jax_scheduled_tokens, port_scheduled, port_setup,
                                 request_mix)


def _table(rng, B, nb, used):
    """(B, nb) int32: each row's first ``used[b]`` logical blocks on
    distinct shuffled physical blocks, the rest on scratch (0)."""
    ids = rng.permutation(np.arange(1, 1 + sum(used)))
    bt = np.zeros((B, nb), np.int32)
    o = 0
    for b, u in enumerate(used):
        bt[b, :u] = ids[o:o + u]
        o += u
    return bt


# ---------------------------------------------------------------------------
# flash_decode_paged: plain version vs the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [16, 5])
@pytest.mark.parametrize("int8,tree", [(False, False), (True, False), (False, True),
                                       (True, True)])
def test_flash_decode_paged_ref_matches_pallas_interpret(int8, tree, bs):
    rng = np.random.default_rng(bs)
    B, Hkv, G, dh, nb = 2, 2, 2, 32, 9
    used = (6, 4) if bs == 16 else (9, 7)
    bt = _table(rng, B, nb, used)
    N = 1 + sum(used)
    pool_k = rng.standard_normal((N, bs, Hkv, dh)).astype(np.float32)
    pool_v = rng.standard_normal((N, bs, Hkv, dh)).astype(np.float32)
    jk = {}
    if int8:
        kq, ks = j_quant_kv(jnp.asarray(pool_k))
        vq, vs = j_quant_kv(jnp.asarray(pool_v))
        pool_k, pool_v = np.asarray(kq), np.asarray(vq)
        jk = dict(k_scale=ks, v_scale=vs)
    start = np.array([used[0] * bs - 9, used[1] * bs - 4], np.int32)
    if tree:
        tpl = JTreeTemplate((3, 1))                   # 7 nodes
        T = tpl.num_nodes
        qpos = start[:, None] + np.asarray(tpl.depths)[None, :]
        jk.update(tree_mask=jnp.asarray(tpl.mask), win_start=jnp.asarray(start))
    else:
        T = 4
        qpos = start[:, None] + np.arange(T)[None, :]
    q = rng.standard_normal((B, T, Hkv * G, dh)).astype(np.float32)
    want = jflash_paged(jnp.asarray(q), jnp.asarray(pool_k), jnp.asarray(pool_v),
                        jnp.asarray(bt), jnp.asarray(qpos, jnp.int32), interpret=True, **jk)
    pk = {k: torch.from_numpy(np.array(v)) for k, v in jk.items()}
    got = flash_decode_paged(torch.from_numpy(q), torch.from_numpy(np.array(pool_k)),
                             torch.from_numpy(np.array(pool_v)), torch.from_numpy(bt),
                             torch.from_numpy(qpos.astype(np.int32)), **pk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_decode_paged_checks_its_table():
    q = torch.zeros(2, 1, 2, 32)
    pool = torch.zeros(3, 4, 1, 32)
    qpos = torch.zeros(2, 1, dtype=torch.int32)
    for bad in (torch.zeros(2, 3, dtype=torch.int64), torch.zeros(3, 3, dtype=torch.int32),
                torch.zeros(2, 0, dtype=torch.int32), torch.zeros(6, dtype=torch.int32)):
        with pytest.raises(ValueError, match="bt must be"):
            flash_decode_paged(q, pool, pool, bad, qpos)
    ops.reset_launch_counts()
    flash_decode_paged(q, pool, pool, torch.zeros(2, 3, dtype=torch.int32), qpos)
    assert ops.launch_counts() == {}                 # CPU tensors: the plain version


# ---------------------------------------------------------------------------
# Device helpers, bit-equal to the reference's
# ---------------------------------------------------------------------------

def _pools(rng, N, bs, Hkv, dh, int8):
    if int8:
        out = {"k": rng.integers(-127, 128, (N, bs, Hkv, dh)).astype(np.int8),
               "v": rng.integers(-127, 128, (N, bs, Hkv, dh)).astype(np.int8),
               "k_scale": rng.random((N, bs, Hkv)).astype(np.float32),
               "v_scale": rng.random((N, bs, Hkv)).astype(np.float32)}
    else:
        out = {"k": rng.standard_normal((N, bs, Hkv, dh)).astype(np.float32),
               "v": rng.standard_normal((N, bs, Hkv, dh)).astype(np.float32)}
    return out


@pytest.mark.parametrize("int8", [False, True])
def test_paged_writes_and_tree_commit_bit_equal_to_jax(int8):
    rng = np.random.default_rng(int(int8))
    B, T, Hkv, dh, bs, nb = 3, 4, 2, 8, 8, 5
    bt = _table(rng, B, nb, (5, 3, 4))
    N = 1 + 12
    pools = _pools(rng, N, bs, Hkv, dh, int8)
    jpool = {k: jnp.asarray(v) for k, v in pools.items()}
    ppool = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    far = np.array([[0, 1, 2, 3], [23, 24, 25, 26], [nb * bs + 3] * 4], np.int32)
    np.testing.assert_array_equal(
        pc.physical_slots(torch.from_numpy(bt), torch.from_numpy(far), bs).numpy(),
        np.asarray(jpc.physical_slots(jnp.asarray(bt), jnp.asarray(far), bs)))
    for step in range(4):
        k = rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
        v = rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
        starts = rng.integers(0, [5 * bs - T, 3 * bs - T, 4 * bs - T])
        slots = (starts[:, None] + np.arange(T)[None, :]).astype(np.int32)
        # jitted, as in the reference's decode step: its eager int8 scale
        # divides by 127 exactly (ROADMAP §3), its jitted one multiplies
        jpool = jax.jit(jwrite_paged)(jpool, jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(slots), jnp.asarray(bt))
        write_cache_paged(ppool, torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(slots), torch.from_numpy(bt))
    for name in pools:
        np.testing.assert_array_equal(ppool[name].numpy(), np.asarray(jpool[name]), name)
    # tree commit: accepted path rows move inside each row's blocks
    start = np.array([10, 3, 20], np.int32)
    path = np.array([[0, 2, 5, 6], [0, 1, 3, 3], [0, 3, 4, 6]], np.int32)
    n_accept = np.array([3, 1, 2], np.int32)
    jpool = jtransformer._compact_attn_rows_paged(
        jpool, jnp.asarray(bt), jnp.asarray(start), jnp.asarray(path), jnp.asarray(n_accept))
    transformer._compact_attn_rows_paged(ppool, torch.from_numpy(bt), torch.from_numpy(start),
                                         torch.from_numpy(path), torch.from_numpy(n_accept))
    for name in pools:
        np.testing.assert_array_equal(ppool[name].numpy(), np.asarray(jpool[name]), name)


def test_last_writer_names_the_last_write_to_each_row():
    rows = torch.tensor([5, 3, 5, 0, 3, 5, 7])
    assert last_writer(rows).tolist() == [5, 4, 5, 3, 4, 5, 6]


@pytest.mark.parametrize("int8", [False, True])
def test_paged_write_last_wins_equals_sequential_scatter(int8):
    """Idle rows (tables all at scratch) and a live row's slots past its
    table collide on scratch rows.  ``last_wins`` gives each colliding
    write the last writer's values, so the pool equals a sequential
    scatter in (row, t) order, whichever write the device lets stick."""
    rng = np.random.default_rng(11 + int(int8))
    B, T, Hkv, dh, bs, nb = 4, 3, 2, 8, 4, 3
    bt = _table(rng, B, nb, (2, 0, 1, 0))
    pools = _pools(rng, 1 + 6, bs, Hkv, dh, int8)
    k = rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, T, Hkv, dh)).astype(np.float32)
    slots = np.array([[6, 7, 8], [0, 1, 2], [3, 4, 5], [0, 1, 2]], np.int32)
    phys = pc.physical_slots(torch.from_numpy(bt), torch.from_numpy(slots), bs).reshape(-1)
    assert len(set(phys.tolist())) < B * T                  # writes do collide
    got, plain = ({n: torch.from_numpy(a.copy()) for n, a in pools.items()} for _ in range(2))
    write_cache_paged(got, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(slots),
                      torch.from_numpy(bt), last_wins=True)
    for r in range(B):                                      # one row, one t at a time
        for t in range(T):
            write_cache_paged(plain, torch.from_numpy(k[r:r + 1, t:t + 1]),
                              torch.from_numpy(v[r:r + 1, t:t + 1]),
                              torch.from_numpy(slots[r:r + 1, t:t + 1]),
                              torch.from_numpy(bt[r:r + 1]))
    for name in pools:
        assert torch.equal(got[name], plain[name]), name


@pytest.mark.parametrize("int8", [False, True])
def test_block_moves_and_swap_bit_equal_to_jax(int8):
    rng = np.random.default_rng(7)
    bs, Hkv, dh, N = 4, 2, 8, 9
    pools = _pools(rng, N, bs, Hkv, dh, int8)
    jl = [{k: jnp.asarray(v) for k, v in pools.items()}]
    pl = [{k: torch.from_numpy(v.copy()) for k, v in pools.items()}]
    row = {k: rng.standard_normal((1, 13) + v.shape[2:]).astype(v.dtype)
           if v.dtype != np.int8 else rng.integers(-127, 128, (1, 13) + v.shape[2:]).astype(np.int8)
           for k, v in pools.items()}
    jl = [jpc.scatter_prefill_rows(jl[0], [5, 2, 7], {k: jnp.asarray(v) for k, v in row.items()},
                                   bs, first_block=1)]
    pc.scatter_prefill_rows(pl[0], [5, 2, 7], {k: torch.from_numpy(v) for k, v in row.items()},
                            bs, first_block=1)
    jl = jpc.clone_block(jl, 5, 8)
    pc.clone_block(pl, 5, 8)
    for name in pools:
        np.testing.assert_array_equal(pl[0][name].numpy(), np.asarray(jl[0][name]), name)
    jsnap = jpc.swap_out_blocks(jl, [2, 7, 8])
    psnap = pc.swap_out_blocks(pl, [2, 7, 8])
    for name in pools:
        np.testing.assert_array_equal(psnap[0][name].numpy(), jsnap[0][name])
        pl[0][name].zero_()
    pc.swap_in_blocks(pl, [1, 3, 4], psnap)
    jl = jpc.swap_in_blocks([{k: jnp.zeros_like(v) for k, v in jl[0].items()}], [1, 3, 4],
                            jsnap)
    for name in pools:
        np.testing.assert_array_equal(pl[0][name].numpy(), np.asarray(jl[0][name]), name)


def test_gather_and_init_paged_cache_match_jax():
    from repro_torch.configs import get_config
    from repro.configs import get_config as jget_config

    rng = np.random.default_rng(2)
    pool = rng.standard_normal((7, 4, 2, 8)).astype(np.float32)
    bt = _table(rng, 2, 3, (3, 2))
    np.testing.assert_array_equal(
        pc.gather_block_rows(torch.from_numpy(pool), torch.from_numpy(bt)).numpy(),
        np.asarray(jpc.gather_block_rows(jnp.asarray(pool), jnp.asarray(bt))))
    for kv in ("bf16", "int8"):
        cfg = dataclasses.replace(get_config("smollm-135m").reduced(), kv_cache_dtype=kv)
        jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), kv_cache_dtype=kv)
        got = pc.init_paged_cache(cfg, 3, 5, 11, 16, device="cpu")
        want = jpc.init_paged_cache(jcfg, 3, 5, 11, 16)
        assert got["bt"].shape == want["bt"].shape and not got["bt"].any()
        for gl, wl in zip(got["layers"], want["layers"]):
            assert {k: (tuple(v.shape), str(array(v).dtype)) for k, v in gl.items()} == \
                {k: (tuple(v.shape), str(np.asarray(v).dtype)) for k, v in wl.items()}


def test_bridge_round_trips_a_paged_cache():
    """A reference paged cache (pools + block table) crosses to the port
    and back unchanged, so both sides can be handed the same pool."""
    from repro.configs import get_config as jget_config
    from repro_torch.bridge import cache_from_numpy, cache_to_numpy

    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), kv_cache_dtype="int8",
                               dtype=jnp.bfloat16)
    rng = np.random.default_rng(4)
    jcache = jpc.init_paged_cache(jcfg, 2, 3, 7, 4)
    jcache["bt"] = jnp.asarray(_table(rng, 2, 3, (3, 2)))
    layer = jcache["layers"][0]
    layer["k"] = jnp.asarray(rng.integers(-127, 128, layer["k"].shape), jnp.int8)
    layer["k_scale"] = jnp.asarray(rng.random(layer["k_scale"].shape), jnp.float32)
    tree = jax.tree.map(np.asarray, jcache)
    port = cache_from_numpy(tree, device="cpu")
    assert set(port) == {"layers", "bt"} and port["bt"].dtype == torch.int32
    back = cache_to_numpy(port)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Host allocator: the same operation sequences on both sides
# ---------------------------------------------------------------------------

def _pool_state(pool):
    return (sorted(pool._ref.items()), pool.free_blocks, pool.cached_blocks, pool.slack,
            pool.unique_allocated, pool.peak_allocated, dict(pool.counters),
            {r: pool.owned(r) for r in sorted(pool._owned)})


@pytest.mark.parametrize("seed", range(6))
def test_block_pool_and_prefix_index_match_jax(seed):
    """Random admit (lookup + reserve + share + alloc + register) / cow /
    append / swap-out / release sequences over a shared-prefix prompt
    universe: every return value, error, refcount and counter equals the
    reference's, and the invariants hold after every operation."""
    rng = np.random.default_rng(seed)
    bs, N = 4, 14 + seed
    a, b = rng.integers(0, 50, 8), rng.integers(0, 50, 8)
    prompts = [np.tile(a, 2), np.concatenate([np.tile(a, 2), a[:3]]), np.tile(b, 2),
               np.concatenate([b, b[:2]]), rng.integers(0, 50, 11)]
    sides = []
    for mod in (pc, jpc):
        index = mod.PrefixIndex(bs)
        sides.append((mod.BlockPool(N, bs, prefix=index), index))
    live = []                          # admitted, not yet released or swapped
    for op in range(60):
        kind = str(rng.choice(["admit", "admit", "append", "cow", "swap", "release"]))
        prompt = prompts[int(rng.integers(len(prompts)))]
        pick = int(rng.integers(1 << 30))
        if kind != "admit" and not live:
            continue
        rid = op if kind == "admit" else live[pick % len(live)]
        outs = []
        for pool, index in sides:
            try:
                if kind == "admit":
                    ids, rows = index.lookup(prompt)
                    pool.reserve(rid, pool.blocks_for(prompt.size + 3) - len(ids) + 1)
                    pool.share(rid, ids)
                    pool.alloc(rid, pool.blocks_for(prompt.size) - len(ids))
                    index.register(prompt, pool.owned(rid))
                    out = (ids, rows, pool.owned(rid))
                elif kind == "append":
                    out = pool.alloc(rid, 1)
                elif kind == "cow":
                    out = pool.cow(rid, pool.owned(rid)[-1])
                elif kind == "swap":
                    out = pool.swap_out(rid)
                else:
                    out = pool.release(rid)
            except (ValueError, RuntimeError) as exc:
                out = type(exc).__name__
            pool.check_invariants()
            outs.append((out, _pool_state(pool), len(index), index.hits, index.evictions))
        assert outs[0] == outs[1], (op, kind)
        failed = isinstance(outs[0][0], str)
        if kind == "admit" and not failed:
            live.append(rid)
        elif kind in ("swap", "release") and not failed:
            live.remove(rid)
            if kind == "swap":             # a release after the swap frees nothing
                assert [pool.release(rid) for pool, _ in sides] == [[], []]


def test_plan_group_and_demand_match_jax():
    cases = [([10, 20, 33], [5, 5, 9], 3, 50, dict(block_size=8)),
             ([1024] * 12, [64] * 12, 5, 1095, dict(block_size=128)),
             ([7, 7, 7, 40], [3, 3, 3, 3], 5, 50, dict(block_size=4, batch_slots=2)),
             ([12, 30], [4, 4], 2, 40, dict(block_size=16, pool_blocks=5))]
    for lens, budgets, gamma, buf, kw in cases:
        assert dataclasses.astuple(pc.plan_group(lens, budgets, gamma, buf, **kw)) == \
            dataclasses.astuple(jpc.plan_group(lens, budgets, gamma, buf, **kw))
    with pytest.raises(ValueError, match="exceeds pool"):
        pc.plan_group([100], [10], 3, 120, block_size=8, pool_blocks=4)
    assert pc.request_demand_tokens(9, 4, 3) == jpc.request_demand_tokens(9, 4, 3)


# ---------------------------------------------------------------------------
# Paged serving: the reference's tokens, and the port's own losslessness
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("drafter,verifier,block_size", [
    ("ngram", "w8a8", 8), ("vanilla", "bf16", 5), ("ngram-tree", "w4a8", 3)])
def test_paged_scheduled_tokens_match_jax(drafter, verifier, block_size):
    """5 requests through 2 slots over the paged pool (prefix sharing on,
    block sizes that do and do not divide the prompts): every request's
    greedy tokens equal the reference's paged run exactly.  The pruned
    drafter is held to the reference on the contiguous layout
    (``test_torch_batching.py``) and to that here through paged ≡
    contiguous at T = 0 below: the reference's pruned compile alone would
    take this file past its time budget."""
    got, eng = port_scheduled(drafter, verifier, "paged", block_size=block_size)
    want = jax_scheduled_tokens(drafter, verifier, "paged", block_size=block_size)
    for r, w in zip(got, want):
        np.testing.assert_array_equal(r.tokens, w)
        assert not r.bad
    g = eng.group_stats[0]
    assert g["kv_layout"] == "paged" and g["shared_blocks"] > 0 and g["peak_blocks"] > 0


@pytest.mark.parametrize("drafter,verifier,kv,temperature", [
    ("ngram", "w8a8", "bf16", 0.0), ("ngram-tree", "bf16", "int8", 0.0),
    ("pruned", "w4a8", "bf16", 0.0), ("pruned", "w4a8", "bf16", 0.8),
    ("ngram", "bf16", "int8", 0.9)])
def test_paged_equals_contiguous_and_solo_in_port(drafter, verifier, kv, temperature):
    """Inside the port: paged ≡ contiguous ≡ solo per request, with prefix
    sharing on and off, at T = 0 and T > 0, bf16 and int8 KV."""
    model, params = port_setup()
    model = Model(dataclasses.replace(model.cfg, kv_cache_dtype=kv), device="cpu")
    reqs = request_mix(temperature=temperature)
    runs = {}
    for name, layout, sharing, slots in (("contiguous", "contiguous", True, 2),
                                         ("paged", "paged", True, 2),
                                         ("paged_unshared", "paged", False, 2)):
        eng = SpecEngine(model, SpecConfig(**JSCFG, kv_layout=layout, kv_block_size=8,
                                           kv_prefix_sharing=sharing),
                         drafter=drafter, verifier=verifier)
        runs[name] = [r.tokens for r in eng.generate_requests(params, reqs,
                                                              batch_slots=slots)]
        if layout == "paged":
            assert (eng.group_stats[0]["shared_blocks"] > 0) == sharing
    solo = SpecEngine(model, SpecConfig(**JSCFG), drafter=drafter, verifier=verifier)
    for i, req in enumerate(reqs):
        alone = solo.generate_requests(params, [req], batch_slots=1)[0].tokens
        for name, toks in runs.items():
            np.testing.assert_array_equal(toks[i], alone, err_msg=f"{name} request {i}")


def test_paged_small_pool_serializes_and_oversized_request_raises():
    model, params = port_setup()
    reqs = request_mix()
    base, _ = port_scheduled("ngram", "bf16", "contiguous")
    scfg = SpecConfig(**JSCFG, kv_layout="paged", kv_block_size=8, kv_pool_blocks=7)
    eng = SpecEngine(model, scfg, drafter="ngram", verifier="bf16")
    out = eng.generate_requests(params, reqs)
    assert eng.group_stats[0]["peak_blocks"] <= 6
    for r, b in zip(out, base):
        np.testing.assert_array_equal(r.tokens, b.tokens)
    eng = SpecEngine(model, dataclasses.replace(scfg, kv_pool_blocks=3), drafter="ngram",
                     verifier="bf16")
    with pytest.raises(ValueError, match="exceeds pool capacity"):
        eng.generate_requests(params, reqs)


class Harness:
    """Tick the scheduler by hand over a paged serving group (as
    ``generate_requests`` sets it up) so that a better-keyed arrival
    preempts a running request — the batch ``run`` never does."""

    def __init__(self, reqs, *, drafter, verifier, temp, pool_blocks):
        model, params = port_setup()
        scfg = SpecConfig(**{**JSCFG, "temperature": temp}, kv_layout="paged",
                          kv_block_size=8, kv_pool_blocks=pool_blocks)
        self.eng = SpecEngine(model, scfg, drafter=drafter, verifier=verifier)
        self.reqs = reqs
        self.group = self.eng.serving_group(self.eng._prepare_cached(params), reqs,
                                            batch_slots=2)
        self.ctx, self.state = self.group.ctx, self.group.state
        self.sched = Scheduler([], 2)

    def submit(self, j):
        assert self.sched.submit(self.reqs[j]) == j      # group index == request index

    def tick(self):
        self.state, _ = self.sched.tick(self.state, **self.group.hooks)
        self.ctx.check_invariants()


@pytest.mark.parametrize("drafter,verifier", [("ngram", "w8a8"), ("pruned", "bf16"),
                                              ("ngram-tree", "w4a8")])
def test_preempt_resume_equals_uninterrupted(drafter, verifier):
    """A running low-priority request is preempted mid-decode (its blocks
    and row registers copied to host memory), higher-priority
    shared-prefix arrivals run through the freed blocks, the victim
    resumes — and every request's tokens equal the uninterrupted
    contiguous run, at T = 0 and T > 0."""
    rng = np.random.default_rng(17)
    pat, other = rng.integers(0, 256, 6), rng.integers(0, 256, 18)
    reqs = [GenerationRequest(other, max_new_tokens=10, seed=1, priority=2),
            GenerationRequest(np.tile(pat, 2), max_new_tokens=4, seed=2),
            GenerationRequest(np.concatenate([np.tile(pat, 2), pat[:3]]), max_new_tokens=5,
                              seed=3)]
    for temp in (0.0, 0.8):
        d_vic = pc.blocks_for_tokens(pc.request_demand_tokens(18, 10, 3), 8)
        h = Harness(reqs, drafter=drafter, verifier=verifier, temp=temp,
                    pool_blocks=1 + d_vic + 1)
        h.submit(0)
        h.tick()
        h.tick()
        h.submit(1)
        h.submit(2)
        for _ in range(100):
            if not h.sched.busy:
                break
            h.tick()
        assert h.sched.preemptions >= 1 and h.ctx.swaps >= 1 and not h.ctx.swap
        snap = h.ctx.snapshot()
        assert snap["swap_in_blocks"] > 0 and snap["preemptions"] >= 1
        want, _ = port_scheduled(drafter, verifier, "contiguous", reqs=reqs,
                                 temperature=temp)
        for i, w in enumerate(want):
            np.testing.assert_array_equal(h.sched.results[i].tokens, w.tokens)
        assert h.ctx.pool.unique_allocated == 0


def test_jax_request_type_is_not_needed_by_the_port():
    """The port's requests are its own copy (same fields, plus ``bad`` on
    the result)."""
    r, j = GenerationRequest(np.arange(4), 3, seed=2), JRequest(np.arange(4), 3, seed=2)
    assert (r.prompt.tolist(), r.max_new_tokens, r.seed, r.priority) == \
        (j.prompt.tolist(), j.max_new_tokens, j.seed, j.priority)



def _first_tick_admissions(events) -> int:
    """Admissions inside the first scheduler tick of a trace."""
    n, ticks = 0, 0
    for ev in events:
        if ev.get("ph") == "B" and ev["name"] == "tick":
            ticks += 1
        elif ev.get("ph") == "B" and ev["name"] == "admit" and ticks == 1:
            n += 1
    return n


def test_default_pool_leaves_a_slot_idle_with_sharing_as_in_jax():
    """A fault of the reference, kept by the port (ROADMAP §3):
    ``plan_group`` sizes the pool for the requests' plain demands, but
    admission with prefix sharing reserves one more block of copy-on-write
    headroom when it donates a partly filled boundary block.  With equal
    demands the last slot then waits for the first harvest: 3 slots, 2
    admissions in the first tick — in the reference and in the port."""
    from repro.core.config import SpecConfig as JSpecConfig
    from repro.serving.engine import SpecEngine as JSpecEngine
    from repro.serving.trace import Tracer as JTracer
    from repro_torch.serving.trace import Tracer
    from test_torch_batching import jax_setup

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, 21) for _ in range(3)]
    model, params = port_setup()
    jmodel, jparams = jax_setup()
    counts = []
    for eng, tr, req_cls, p in (
            (SpecEngine(model, SpecConfig(**JSCFG, kv_layout="paged", kv_block_size=8),
                        drafter="ngram", verifier="bf16"), Tracer(), GenerationRequest,
             params),
            (JSpecEngine(jmodel, JSpecConfig(**JSCFG, kv_layout="paged", kv_block_size=8),
                         drafter="ngram", verifier="bf16"), JTracer(), JRequest, jparams)):
        eng.generate_requests(p, [req_cls(x, max_new_tokens=4, seed=i)
                                  for i, x in enumerate(prompts)], tracer=tr)
        assert eng.group_stats[0]["slots"] == 3
        counts.append(_first_tick_admissions(tr.events))
    assert counts == [2, 2]
