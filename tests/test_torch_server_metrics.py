"""The serving front-end's host pieces and state primitives, port against
reference, on the CPU (no model runs):

* ``ServerMetrics``: the same event sequence gives an equal ``summary()``
  (with and without per-request timelines) and a byte-equal Prometheus
  ``expose_text()``; ``percentile`` and ``RequestTimeline`` edge cases.
* ``sampling.sample``: argmax at T = 0, the Gumbel-argmax rule at T > 0.
* ``faults.poison_params`` poisons the leaf the reference poisons (the first
  of the largest floating-point leaves in pytree order) and shares the rest.
* ``merge_state_rows`` (in place) gives the reference's merged state,
  contiguous and paged, and leaves every other row and block as it was.
* ``StepSnapshot`` restores the registers and the window KV of a step in
  place, for all rows or some.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.paged_cache import SCRATCH_BLOCK
from repro.serving.engine import merge_state_rows as jmerge_state_rows
from repro.serving.faults import poison_params as jpoison_params
from repro.serving.metrics import RequestTimeline as JRequestTimeline
from repro.serving.metrics import ServerMetrics as JServerMetrics
from repro.serving.metrics import percentile as jpercentile
from repro_torch.bridge import cache_from_numpy, from_jax_params
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.core.config import SpecConfig
from repro_torch.models import Model
from repro_torch.serving.engine import SpecEngine, StepSnapshot, merge_state_rows
from repro_torch.serving.faults import poison_params
from repro_torch.serving.metrics import RequestTimeline, ServerMetrics, percentile
from repro_torch.serving.sampling import sample
from test_torch_batching import jax_setup, one_torch_thread  # noqa: F401


def feed(m, rng):
    """A seeded event sequence through every hook, two KV sources."""
    snaps = [{"prefix_hits": 3, "prefix_misses": 1, "shared_blocks": 5, "cow_forks": 2,
              "swap_out_bytes": 4096, "preemptions": 1,
              "pool": {"capacity": 24, "free": 20, "cached": 1, "unique_allocated": 3,
                       "peak_allocated": 9}},
             {"prefix_misses": 2, "cold_prefill_tokens": 77}]
    m.add_kv_source("lane0", lambda: snaps[0])
    m.add_kv_source("lane1", lambda: snaps[1])
    t = 0.0
    for rid in range(12):
        t += float(rng.exponential(0.05))
        m.on_submit(rid, t, deadline_t=None if rid % 3 else t + float(rng.uniform(0.1, 2)),
                    degraded=rid % 5 == 0)
    for rid in range(12):
        t += float(rng.exponential(0.02))
        if rid in (4, 9):
            m.on_shed(rid, t)
            continue
        m.on_admit(rid, t)
        for _ in range(int(rng.integers(1, 6))):
            t += float(rng.exponential(0.01))
            m.on_tokens(rid, t, int(rng.integers(1, 5)))
            m.on_step(t, int(rng.integers(0, 5)), 4)
            m.on_decode_step("ngram:w8a8" if rid % 2 else "ngram-tree:w8a8",
                             [int(a) for a in rng.integers(0, 5, 3)],
                             float(rng.exponential(0.008)))
        if rid == 7:
            m.on_guardrail("verify_nan_trips")
            m.on_guardrail("bf16_rescued_rows", 2)
            m.on_guardrail("custom_event")
            m.on_failed(rid, t)
        else:
            m.on_finish(rid, t)
        m.on_slot_event(None)
    return m


@pytest.mark.parametrize("keep", [True, False])
def test_server_metrics_match_reference(keep, tmp_path):
    port = feed(ServerMetrics(keep_timelines=keep), np.random.default_rng(1))
    ref = feed(JServerMetrics(keep_timelines=keep), np.random.default_rng(1))
    assert port.summary(include_requests=True) == ref.summary(include_requests=True)
    assert port.expose_text() == ref.expose_text()
    assert port.deadline_hit_rate == ref.deadline_hit_rate
    port.check_conservation()
    port.on_submit(99, 9.0)
    with pytest.raises(AssertionError, match="conservation"):
        port.check_conservation()
    with pytest.raises(AssertionError, match="conservation"):
        ref.on_submit(99, 9.0) or ref.check_conservation()
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    port.save(str(a), include_requests=True)
    ref.save(str(b), include_requests=True)
    assert a.read_text() == b.read_text()


def test_empty_metrics_match_reference():
    assert ServerMetrics().summary() == JServerMetrics().summary()
    assert ServerMetrics().expose_text() == JServerMetrics().expose_text()


@pytest.mark.parametrize("values,q", [
    ([], 50), ([3.0], 0), ([3.0], 100), ([1, 2, 3, 4], 50), ([1, 2, 3, 4], 75),
    ([4, 1, 3, 2], 0), ([4, 1, 3, 2], 100), ([5, 5, 1], 99.9), ([0.1, 0.2], 50.0001),
    (list(range(100)), 99), (list(range(101)), 1)])
def test_percentile_matches_reference(values, q):
    got, want = percentile(values, q), jpercentile(values, q)
    assert (np.isnan(got) and np.isnan(want)) or got == want


def test_timeline_edges_match_reference():
    seen = []
    for cls in (RequestTimeline, JRequestTimeline):
        tl = cls(rid=1, arrival_t=1.0)
        assert tl.ttft is None and tl.itl == [] and tl.deadline_hit is None
        tl.emits = [(1.5, 2), (1.9, 4), (1.9, 1)]
        assert tl.ttft == 0.5 and tl.itl == pytest.approx([0.1] * 4 + [0.0])
        hits = []
        tl.deadline_t, tl.status, tl.finish_t = 2.0, "shed", 1.2
        hits.append(tl.deadline_hit)
        tl.status = "done"
        hits.append(tl.deadline_hit)
        assert hits == [False, True]
        seen.append((tl.itl, tl.to_dict()))
    assert seen[0] == seen[1]


def test_sample_greedy_and_gumbel():
    logits = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 17)).astype(np.float32))
    np.testing.assert_array_equal(sample(None, logits, 0.0).numpy(),
                                  logits.argmax(-1).numpy())
    g = prng.request_generator(5, "cpu")
    got = sample(g, logits, 0.7)
    noise = prng.gumbel_rows([prng.request_generator(5, "cpu")], logits.numel(), "cpu")
    want = (logits / 0.7 + noise.reshape(logits.shape)).argmax(-1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("verifier", ["bf16", "w8a8"])
def test_poison_params_picks_the_reference_leaf(verifier):
    from repro.core.config import SpecConfig as JSpecConfig
    from repro.serving.engine import SpecEngine as JSpecEngine

    jmodel, jparams = jax_setup()
    cfg = get_config("smollm-135m").reduced()
    model = Model(cfg, device="cpu")
    raw = from_jax_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    params = SpecEngine(model, SpecConfig(verifier=verifier)).prepare_params(raw)
    jprep = JSpecEngine(jmodel, JSpecConfig(verifier=verifier)).prepare_params(jparams)
    jpois = jpoison_params(jprep)
    jnan = [jax.tree_util.keystr(p) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jpois)[0]
            if jnp.issubdtype(leaf.dtype, jnp.floating) and bool(jnp.isnan(leaf).all())]
    pois = poison_params(params)
    nan = [name for name, t in pois.named_buffers()
           if t.is_floating_point() and bool(torch.isnan(t).all())]
    assert len(jnan) == len(nan) == 1
    assert jnan[0].replace("']['", "/").replace("'][", "/").replace("][", "/") \
        .strip("[]'").replace("'", "") == nan[0].replace(".", "/")
    # a new params object sharing every other tensor; the original untouched
    assert pois is not params
    shared = {name for name, t in pois.named_buffers()
              if t is dict(params.named_buffers())[name]}
    assert shared == {name for name, _ in params.named_buffers()} - set(nan)
    assert not any(torch.isnan(t).any() for t in params.buffers() if t.is_floating_point())


# ---------------------------------------------------------------------------
# merge_state_rows and StepSnapshot
# ---------------------------------------------------------------------------

B, S, H, DH, NB, BS = 4, 12, 2, 3, 9, 4


def numpy_state(rng, paged: bool, int8: bool):
    """A random engine state (numpy leaves) in the reference's schema."""
    kv = np.int8 if int8 else np.float32

    def rand(shape, dt):
        if dt == np.int8:
            return rng.integers(-128, 128, shape).astype(np.int8)
        return rng.normal(size=shape).astype(dt)

    lead = (NB, BS) if paged else (B, S)
    layers = []
    for _ in range(2):
        layer = {"k": rand(lead + (H, DH), kv), "v": rand(lead + (H, DH), kv)}
        if int8:
            layer["k_scale"] = rand(lead + (H,), np.float32)
            layer["v_scale"] = rand(lead + (H,), np.float32)
        layers.append(layer)
    cache = {"layers": layers}
    if paged:
        # rows own disjoint blocks, scratch past them
        bt = np.full((B, 3), SCRATCH_BLOCK, np.int32)
        ids = rng.permutation(np.arange(1, NB))
        for r, n in enumerate((2, 3, 1, 2)):
            bt[r, :n] = ids[:n]
            ids = ids[n:]
        cache["bt"] = bt
    return {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32),
            "length": rng.integers(2, 9, (B,)).astype(np.int32),
            "target": rng.integers(9, 12, (B,)).astype(np.int32),
            "cache": cache,
            "drafter_state": {},
            "stats": {"commits": rng.integers(0, 9, (B,)).astype(np.int32),
                      "steps": np.int32(rng.integers(0, 9)),
                      "row_steps": rng.integers(0, 9, (B,)).astype(np.int32),
                      "bad": rng.integers(0, 2, (B,)).astype(bool)}}


def to_port(st, seeds):
    out = {k: torch.from_numpy(np.array(st[k])) for k in ("tokens", "length", "target")}
    out["cache"] = cache_from_numpy(st["cache"], device="cpu")
    out["drafter_state"] = {}
    out["stats"] = {k: torch.from_numpy(np.array(v)) for k, v in st["stats"].items()}
    out["generators"] = prng.row_generators(seeds, "cpu")
    return out


def port_numpy(st):
    """A copy of a port state's tensors as numpy, in the reference's schema."""
    out = {k: st[k].numpy().copy() for k in ("tokens", "length", "target")}
    out["cache"] = {"layers": [{k: v.numpy().copy() for k, v in layer.items()}
                               for layer in st["cache"]["layers"]]}
    if "bt" in st["cache"]:
        out["cache"]["bt"] = st["cache"]["bt"].numpy().copy()
    out["stats"] = {k: v.numpy().copy() for k, v in st["stats"].items()}
    return out


def assert_tree_equal(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("rows", [[1], [0, 2, 3], []])
def test_merge_state_rows_matches_reference(paged, int8, rows):
    rng = np.random.default_rng(11)
    dst, src = numpy_state(rng, paged, int8), numpy_state(rng, paged, int8)
    if paged:
        src["cache"]["bt"] = dst["cache"]["bt"]        # the step never writes it
    jdst = jax.tree.map(jnp.asarray, {**dst, "key": np.zeros((B, 2), np.uint32)})
    jsrc = jax.tree.map(jnp.asarray, {**src, "key": np.ones((B, 2), np.uint32)})
    want = jmerge_state_rows(jdst, jsrc, rows)
    want.pop("key")
    pdst, psrc = to_port(dst, range(B)), to_port(src, range(10, 10 + B))
    for g in psrc["generators"]:
        torch.rand(3, generator=g)
    gens = list(pdst["generators"])
    tensors = [t.data_ptr() for t in jax.tree.leaves(
        {k: v for k, v in pdst.items() if k != "generators"})]
    out = merge_state_rows(pdst, psrc, rows)
    assert out is pdst and out["generators"] == gens
    assert [t.data_ptr() for t in jax.tree.leaves(
        {k: v for k, v in out.items() if k != "generators"})] == tensors
    assert_tree_equal(port_numpy(out), {k: want[k] for k in ("tokens", "length", "target",
                                                            "cache", "stats")})
    for r in range(B):
        got = out["generators"][r].get_state()
        expect = psrc["generators"][r] if r in rows else prng.request_generator(r, "cpu")
        assert torch.equal(got, expect.get_state())
    assert_tree_equal(port_numpy(psrc), {k: src[k] for k in ("tokens", "length", "target",
                                                             "cache", "stats")})


@pytest.mark.parametrize("paged", [False, True])
def test_step_snapshot_restores_registers_and_window(paged):
    """take → a step writing the registers, the generators and the window's
    KV rows → restore gives the taken registers and generator states back
    (a rerun rewrites the window).  A second snapshot of the step's result
    with its window, restored for rows 0 and 2 after another step, puts
    back exactly those rows' registers and window KV."""
    from repro_torch.core.paged_cache import physical_slots

    rng = np.random.default_rng(5)
    st = to_port(numpy_state(rng, paged, False), range(B))
    window = 3
    regs = ("tokens", "length", "target", "stats")
    snap = StepSnapshot(st, window)
    snap.take(st)
    before = port_numpy(st)
    gen_before = [g.get_state() for g in st["generators"]]

    def window_rows(state):
        start = (state["length"].long() - 1).clamp(min=0)
        return start[:, None] + torch.arange(window)[None]

    def step(state, value):
        slots = window_rows(state)
        for layer in state["cache"]["layers"]:
            for t in layer.values():
                if paged:
                    t.view((-1,) + tuple(t.shape[2:]))[physical_slots(
                        state["cache"]["bt"], slots, BS)] = value
                else:
                    t[torch.arange(B)[:, None], slots.clamp(max=S - 1)] = value
        state["tokens"].add_(1)
        state["length"].add_(2)
        for t in state["stats"].values():
            t.add_(1) if t.dtype != torch.bool else t.logical_not_()
        for g in state["generators"]:
            torch.rand(2, generator=g)

    step(st, 7.0)
    snap.restore(st)
    assert_tree_equal({k: port_numpy(st)[k] for k in regs}, {k: before[k] for k in regs})
    assert all(torch.equal(g.get_state(), s) for g, s in zip(st["generators"], gen_before))

    slots = window_rows(st).numpy()
    step(st, 7.0)
    after = port_numpy(st)
    retry = StepSnapshot(st, window)
    retry.take(st)
    retry.take_window(st, snap.length)
    snap.restore(st)
    step(st, -3.0)
    retry.restore(st, [0, 2])
    got = port_numpy(st)
    assert_tree_equal({k: got[k] for k in regs}, {k: after[k] for k in regs})
    checked = 0
    for gl in got["cache"]["layers"]:
        for buf in gl.values():
            for r in range(B):
                for p in slots[r]:
                    if paged:
                        blk = before["cache"]["bt"][r, p // BS] if p // BS < 3 else 0
                        if blk == SCRATCH_BLOCK:
                            continue
                        val = buf[blk, p % BS]
                    else:
                        val = buf[r, min(p, S - 1)]
                    assert (val == (7.0 if r in (0, 2) else -3.0)).all()
                    checked += 1
    assert checked > 0
