"""The sliding-window ring cache of the port against the JAX package, on the
CPU: every self-attention cache of a config with ``sliding_window`` is a
ring of ``min(window, max_len) + RING_PAD`` slots with each slot's position
in ``kpos``, and every causal read sees at most ``window`` positions back.

Configs are ``.reduced()`` (f32) with ``sliding_window=8``, so a ring has
136 slots and a 150-token prompt wraps it at prefill (the ``T >= R``
write); the weights are the reference's, bridged as numpy (vision's cross
gates at 0.5 and random biases, as in ``test_torch_families.py``).

Tolerances: cache layouts and writes (``k``/``v``, the int8 scales and
``kpos``) bit-equal to the jitted reference; attention outputs, logits,
the loss and gradients within rtol 1e-5 / atol 2e-5 of each tensor (f32;
the two differ in matmul blocking and in the order of the softmax's sums,
the port reading through ``flash_decode``'s plain version); greedy tokens
and verify steps exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.config import SpecConfig as JSpecConfig
from repro.models import Model as JModel
from repro.models import attention as jattention
from repro.models import transformer as jtransformer
from repro.serving.engine import SpecEngine as JSpecEngine
from repro.serving.request import GenerationRequest as JRequest
from repro.train import trainer as jtrainer
from repro_torch.bridge import cache_from_numpy, cache_to_numpy, from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.config import SpecConfig
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.models import Model, attention, transformer
from repro_torch.serving.engine import SpecEngine
from repro_torch.serving.request import GenerationRequest
from repro_torch.train.trainer import value_and_grad
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)
from test_torch_families import _aux
from test_torch_families import _jax_params as _family_params

W = 8                     # the window of every config here: rings of 136 slots
TOL = dict(rtol=1e-5, atol=2e-5)
ARCHS = ["smollm-135m", "phi3.5-moe-42b-a6.6b", "zamba2-2.7b", "whisper-small",
         "llama-3.2-vision-90b"]
FAMILIES = ("whisper-small", "llama-3.2-vision-90b")
P, GAMMA, N_NEW = 150, 4, 10


def _cfgs(arch, kv="bf16", window=W):
    """(reference, port) reduced configs with the window (phi3.5-moe's
    reduced config is dropless)."""
    return tuple(dataclasses.replace(get(arch).reduced(), sliding_window=window,
                                     kv_cache_dtype=kv)
                 for get in (jget_config, get_config))


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    """The reference's weights (numpy)."""
    if arch in FAMILIES:
        return _family_params(arch)
    return jax.tree.map(np.array, JModel(_cfgs(arch)[0]).init_params(jax.random.PRNGKey(0)))


def _jtree(arch):
    return jax.tree.map(jnp.asarray, _jparams(arch))


def _pparams(arch):
    return from_jax_params(_jparams(arch), _cfgs(arch)[1], device="cpu")


def _tokens(B=2, T=P, seed=0, V=256):
    return np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)


def _prompts(B=2, seed=0, V=256):
    """Rows of a repeated pattern, longer than the ring, so prompt lookup
    finds drafts."""
    pat = np.random.default_rng(seed).integers(0, V, (B, 6))
    return np.tile(pat, -(-P // 6))[:, :P].astype(np.int32)


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=msg, **TOL)


def _tree_equal(want, got):
    """Two cache pytrees (numpy leaves) bit-equal, leaf for leaf."""
    lw, tw = jax.tree.flatten(jax.tree.map(np.asarray, want))
    lg, tg = jax.tree.flatten(got)
    assert tw == tg
    for w, g in zip(lw, lg):
        assert w.dtype == g.dtype and w.shape == g.shape
        assert w.tobytes() == g.tobytes()


# ---------------------------------------------------------------------------
# Layout and writes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_ring_cache_layout_matches_jax(kv):
    """Every self-attention cache of the five families is a ring of the
    reference's size (``max_len`` rounded first: window 8 at 64 gives 136
    slots, not 72), ``kpos`` at -2^30; the cross caches stay as they are."""
    for arch in ARCHS:
        jcfg, pcfg = _cfgs(arch, kv)
        for max_len in (64, 300):
            want = jtransformer.init_cache(jcfg, 2, max_len)
            got = transformer.init_cache(pcfg, 2, max_len, "cpu")
            _tree_equal(want, cache_to_numpy(got))
            rings = [kv for kv in map(transformer.self_kv, got["layers"] + got.get("shared", []))
                     if kv is not None and "k" in kv]
            assert rings and all(r["kpos"].shape == (2, 136) for r in rings)
            assert all(bool((r["kpos"] == attention.NEG_POS).all()) for r in rings)
    jcfg, pcfg = _cfgs("smollm-135m", kv, window=4096)
    want = jattention.init_attn_cache(jcfg, 1, 5120, 4096)
    got = attention.init_attn_cache(pcfg, 1, 5120, "cpu", 4096)
    assert got["k"].shape[1] == want["k"].shape[1] == 4224
    assert transformer.init_cache(pcfg, 1, 5000, "cpu")["layers"][0]["k"].shape[1] == 4224


class _KV:
    """The attention fields ``init_attn_cache`` and ``write_cache`` read."""

    def __init__(self, kv, dtype):
        self.num_kv_heads, self.head_dim, self.kv_cache_dtype, self.dtype = 2, 32, kv, dtype


def _walk(B=2, hq=4, steps=((0, P),) + tuple((P - 1 + 3 * i, GAMMA + 1) for i in range(60))
          + ((P + 180, 1),), seed=0):
    """A walk over the ring (136 slots): a prefill of T >= R, then windows
    of γ+1 that advance by 3 (a rejected tail rewritten by the next), past a
    second wrap, then one T = 1 step.  Yields (start, q, k, v) numpy."""
    rng = np.random.default_rng(seed)
    for start, t in steps:
        yield (start, *(rng.standard_normal((B, t, h, 32)).astype(np.float32)
                        for h in (hq, 2, 2)))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_write_cache_ring_bit_equal_to_jax(kv):
    """In-place ring writes give the jitted reference's ``k``, ``v``,
    scales and ``kpos`` bit for bit over a walk that wraps the ring."""
    jcache = jattention.init_attn_cache(_KV(kv, jnp.float32), 2, 64, W)
    pcache = attention.init_attn_cache(_KV(kv, torch.float32), 2, 64, "cpu", W)
    jwrite = jax.jit(jattention.write_cache, static_argnums=4)
    for i, (start, _, k, v) in enumerate(_walk()):
        qpos = (start + np.arange(k.shape[1], dtype=np.int32))[None].repeat(2, 0)
        jcache = jwrite(jcache, jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos), W)
        out = attention.write_cache(pcache, torch.from_numpy(k), torch.from_numpy(v),
                                    torch.from_numpy(qpos))
        assert out is pcache
        if i in (0, 1, 30, 61):
            _tree_equal(jcache, {n: t.numpy() for n, t in pcache.items()})
    assert int(pcache["kpos"].max()) == P + 180


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_attend_over_a_wrapped_ring_matches_jax(kv):
    """Over the walk's ring, the reference's windowed ``attend`` (2-D
    ``kpos``) ≡ the port's plain ``attend`` and ``flash_decode_ref`` with
    ``kpos``/``window`` — and, for T = 1, a from-scratch masked attend over
    the positions still in the window (``tests/test_extensions.py:168``)."""
    jcache = jattention.init_attn_cache(_KV(kv, jnp.float32), 2, 64, W)
    jwrite = jax.jit(jattention.write_cache, static_argnums=4)
    for i, (start, q, k, v) in enumerate(_walk()):
        t = q.shape[1]
        qpos = (start + np.arange(t, dtype=np.int32))[None].repeat(2, 0)
        jcache = jwrite(jcache, jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos), W)
        if t > GAMMA + 1 or (i % 7 and i != 61):
            continue
        sc = dict(k_scale=jcache.get("k_scale"), v_scale=jcache.get("v_scale"))
        want = jattention.attend(jnp.asarray(q), jcache["k"], jcache["v"], jnp.asarray(qpos),
                                 jcache["kpos"], window=W, **sc)
        pc = {n: torch.from_numpy(np.array(x)) for n, x in jcache.items()}
        psc = dict(k_scale=pc.get("k_scale"), v_scale=pc.get("v_scale"))
        tq, tpos = torch.from_numpy(q), torch.from_numpy(qpos)
        _close(attention.attend(tq, pc["k"], pc["v"], tpos, pc["kpos"], window=W, plain=True,
                                **psc), want, f"attend step {i}")
        _close(flash_decode_ref(tq, pc["k"], pc["v"], tpos, **psc, kpos=pc["kpos"], window=W),
               want, f"flash_decode_ref step {i}")
        _close(flash_decode(tq, pc["k"], pc["v"], tpos, **psc, kpos=pc["kpos"], window=W),
               want, f"flash_decode step {i}")
        _close(attention.ring_attend(tq, pc, tpos, W), want, f"ring_attend step {i}")
    # T = 1 at the walk's end against the last W positions, recomputed
    p = start
    keep = jcache["kpos"] > p - W
    assert int(keep.sum()) == 2 * W
    rows = [np.nonzero(np.asarray(keep[b]))[0] for b in range(2)]
    order = [r[np.argsort(np.asarray(jcache["kpos"])[b, r])] for b, r in enumerate(rows)]
    sub = {n: jnp.stack([x[b, order[b]] for b in range(2)]) for n, x in jcache.items()}
    want = jattention.attend(jnp.asarray(q), sub["k"], sub["v"], jnp.asarray(qpos),
                             jnp.arange(p - W + 1, p + 1, dtype=jnp.int32), window=W,
                             k_scale=sub.get("k_scale"), v_scale=sub.get("v_scale"))
    _close(attention.ring_attend(torch.from_numpy(q), pc, torch.from_numpy(qpos), W), want,
           "ring read against a recompute over the window")


def test_flash_decode_ring_refuses_bad_inputs():
    q = torch.zeros(2, 1, 4, 32)
    k = torch.zeros(2, 136, 2, 32)
    qpos = torch.zeros(2, 1, dtype=torch.int32)
    kpos = torch.zeros(2, 136, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        flash_decode(q, k, k, qpos, kpos=kpos)
    with pytest.raises(ValueError, match="kpos must be"):
        flash_decode(q, k, k, qpos, kpos=kpos[:, :8].contiguous(), window=W)
    with pytest.raises(ValueError, match="window must be"):
        flash_decode(q, k, k, qpos, kpos=kpos, window=0)
    with pytest.raises(ValueError, match="token-tree"):
        flash_decode(q, k, k, qpos, kpos=kpos, window=W, tree_mask=torch.ones(1, 1, dtype=bool),
                     win_start=torch.zeros(2, dtype=torch.int32))


# ---------------------------------------------------------------------------
# The five families
# ---------------------------------------------------------------------------

def _aux_np(arch, B=2):
    return _aux(arch, B=B) if arch in FAMILIES else None


def _ja(x):
    return None if x is None else jnp.asarray(x)


def _pa(x):
    return None if x is None else torch.from_numpy(x)


@functools.lru_cache(maxsize=None)
def _jax_forward(arch):
    """The reference's windowed no-cache forward over P + γ tokens (T > the
    ring's 136 slots and > W), the yardstick of both tests below."""
    toks, aux = _tokens(T=P + GAMMA), _aux_np(arch)
    jm = JModel(_cfgs(arch)[0])
    fwd = jax.jit(lambda p, x, a: jm.forward(p, x, aux_embeds=a)[0])    # jit: ~5x faster
    return np.asarray(fwd(_jtree(arch), jnp.asarray(toks), _ja(aux)))


@pytest.mark.parametrize("arch", ARCHS)
def test_windowed_forward_matches_jax(arch):
    """The no-cache forward under the window mask."""
    toks, aux = _tokens(T=P + GAMMA), _aux_np(arch)
    got, _ = Model(_cfgs(arch)[1], device="cpu").forward(_pparams(arch), torch.from_numpy(toks),
                                                         aux_embeds=_pa(aux))
    _close(got, _jax_forward(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_ring_prefill_verify_decode_match_jax(arch):
    """Prefill of 149 tokens (wraps the 136-slot ring), a verify window of
    γ+1 (the reference's logits at those positions: its windowed forward),
    the commit of its first two tokens, then a T = 1 decode over the
    rejected tail's slots; every ring's ``kpos`` holds the last 136
    positions written (the rejected tail's too), as the reference's
    ``write_cache`` leaves it."""
    pm, pp = Model(_cfgs(arch)[1], device="cpu"), _pparams(arch)
    want = _jax_forward(arch)
    toks, aux = _tokens(T=P + GAMMA), _aux_np(arch)
    B = toks.shape[0]
    pc = pm.prefill(pp, pm.init_cache(B, 256), torch.from_numpy(toks[:, :P - 1]),
                    aux_embeds=_pa(aux))
    start = torch.full((B,), P - 1, dtype=torch.int32)
    logits, pc = pm.verify_step(pp, pc, torch.from_numpy(toks[:, P - 1:P + GAMMA]), start)
    _close(logits, want[:, P - 1:P + GAMMA], "verify")
    pc = pm.commit(pc, torch.full((B,), 1, dtype=torch.int32))
    logits, pc = pm.decode_step(pp, pc, torch.from_numpy(toks[:, P + 1:P + 2]), start + 2)
    _close(logits[:, 0], want[:, P + 1], "decode")
    rings = [kv for kv in map(transformer.self_kv, pc["layers"] + pc.get("shared", []))
             if kv is not None and "kpos" in kv]
    kpos = np.sort(np.arange(P + GAMMA - 136, P + GAMMA, dtype=np.int32))
    assert rings
    for r in rings:
        np.testing.assert_array_equal(np.sort(r["kpos"].numpy(), axis=1), np.stack([kpos] * B))
        np.testing.assert_array_equal(r["kpos"].numpy() % 136, np.arange(136)[None].repeat(B, 0))


def test_bridge_carries_kpos_both_ways():
    """A reference ring cache (after a wrapping prefill) → the port → back:
    bit for bit, ``kpos`` int32 included."""
    jcfg, pcfg = _cfgs("zamba2-2.7b", "int8")
    jm = JModel(jcfg)
    prefill = jax.jit(lambda p, c, x: jm.prefill(p, c, x))
    jc = prefill(_jtree("zamba2-2.7b"), jm.init_cache(2, 256), jnp.asarray(_tokens()[:, :-1]))
    jc = jax.tree.map(np.array, jc)
    pc = cache_from_numpy(jc, device="cpu")
    assert pc["shared"][0]["kpos"].dtype == torch.int32
    assert pc["layers"][0].keys() == jc["layers"][0].keys()
    _tree_equal(jc, cache_to_numpy(pc))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

def _scfg(cls, drafter, verifier, **kw):
    return cls(temperature=0.0, gamma=GAMMA, drafter=drafter, verifier=verifier, **kw)


@functools.lru_cache(maxsize=None)
def _jax_generate(drafter, verifier, kv):
    jcfg = _cfgs("smollm-135m", kv)[0]
    r = JSpecEngine(JModel(jcfg), _scfg(JSpecConfig, drafter, verifier)).generate(
        _jtree("smollm-135m"), jnp.asarray(_prompts()), N_NEW)
    return np.asarray(r.tokens)[:, :P + N_NEW], int(r.steps)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("verifier", ["bf16", "w8a8"])
@pytest.mark.parametrize("drafter", ["ngram", "vanilla"])
def test_generate_greedy_tokens_match_jax(drafter, verifier, kv):
    """``SpecEngine.generate`` on a prompt longer than the ring: the
    reference's greedy tokens and verify steps; spec ≡ vanilla."""
    want, steps = _jax_generate(drafter, verifier, kv)
    pcfg = _cfgs("smollm-135m", kv)[1]
    r = SpecEngine(Model(pcfg, device="cpu"), _scfg(SpecConfig, drafter, verifier)).generate(
        _pparams("smollm-135m"), torch.from_numpy(_prompts()), N_NEW)
    assert not bool(r.bad.any())
    np.testing.assert_array_equal(r.tokens[:, :P + N_NEW].numpy(), want)
    assert r.steps == steps
    np.testing.assert_array_equal(want, _jax_generate("vanilla", verifier, kv)[0])


def _requests(cls):
    """Three prompts of different lengths (two longer than the ring),
    budgets and seeds."""
    pat = np.random.default_rng(3).integers(0, 256, 7)
    return [cls(np.tile(pat, 40)[:n], max_new_tokens=m, seed=s)
            for n, m, s in ((150, 8, 0), (40, 11, 1), (170, 6, 2))]


def test_generate_requests_contiguous_matches_jax():
    """Scheduled serving over contiguous rings (three requests through two
    slots: a slot recycled, its row's ``kpos`` reset in place) gives the
    reference's tokens."""
    jcfg, pcfg = _cfgs("smollm-135m")
    want = JSpecEngine(JModel(jcfg), _scfg(JSpecConfig, "ngram", "w8a8")).generate_requests(
        _jtree("smollm-135m"), _requests(JRequest), batch_slots=2)
    got = SpecEngine(Model(pcfg, device="cpu"), _scfg(SpecConfig, "ngram", "w8a8")) \
        .generate_requests(_pparams("smollm-135m"), _requests(GenerationRequest),
                           batch_slots=2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))


def test_scheduled_sampling_matches_solo_over_rings():
    """T = 1: each request through two recycled slots equals the request
    served alone (each row draws from its own request's generator), so a
    recycled row's ring holds nothing of its last request."""
    pcfg = _cfgs("smollm-135m", "int8")[1]
    eng = SpecEngine(Model(pcfg, device="cpu"),
                     SpecConfig(temperature=1.0, gamma=3, drafter="ngram", verifier="w8a8"))
    params = eng.prepare_params(_pparams("smollm-135m"))
    reqs = _requests(GenerationRequest)
    got = eng.generate_requests(params, reqs, batch_slots=2)
    for r, req in zip(got, reqs):
        alone = eng.generate_requests(params, [req], batch_slots=1)[0]
        np.testing.assert_array_equal(r.tokens, alone.tokens)
        assert r.new_tokens == req.max_new_tokens and not r.bad


@pytest.mark.parametrize("spec", [dict(kv_layout="paged", kv_block_size=8),
                                  dict(drafter="ngram-tree", tree_branches=(2, 1))])
def test_paged_and_tree_refusals_match_jax(spec):
    jcfg, pcfg = _cfgs("smollm-135m")
    with pytest.raises(ValueError) as jerr:
        JSpecEngine(JModel(jcfg), JSpecConfig(**spec)).generate_requests(
            _jtree("smollm-135m"), _requests(JRequest))
    with pytest.raises(ValueError) as perr:
        SpecEngine(Model(pcfg, device="cpu"), SpecConfig(**spec)).generate_requests(
            _pparams("smollm-135m"), _requests(GenerationRequest))
    assert str(perr.value) == str(jerr.value)
    assert "sliding-window" in str(perr.value)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-2.7b"])
def test_windowed_loss_and_grads_match_jax(arch):
    """``train/trainer.value_and_grad`` of a windowed model (T 24 > W):
    the reference's loss and every leaf's gradient."""
    jcfg, pcfg = _cfgs(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (2, 24)).astype(np.int32)
    labels = rng.integers(-1, 256, (2, 24)).astype(np.int32)
    fn = jax.jit(jax.value_and_grad(jtrainer.loss_fn, has_aux=True), static_argnums=1)
    (loss, _), jgrads = fn(_jtree(arch), jcfg, jnp.asarray(toks), jnp.asarray(labels), None)
    (pl, _), grads = value_and_grad(_pparams(arch), pcfg, {"tokens": toks, "labels": labels})
    np.testing.assert_allclose(float(pl), float(loss), rtol=1e-5)
    jleaves = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    assert len(jleaves) == len(grads)
    for (name, got), want in zip(grads.items(), jleaves):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-5 * np.abs(want).max() + 1e-6, err_msg=name)
