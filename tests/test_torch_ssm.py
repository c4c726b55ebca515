"""The port's SSM (``mamba2-370m``) and hybrid (``zamba2-2.7b``) decoders
(``models/ssm.py``, ``kernels/ssd_update.py`` and what reads them) against
the JAX package, on the CPU.

Every check feeds numpy-seeded inputs, or weights bridged from the
reference's pytree, through both, in f32 on ``.reduced()`` configs (2
layers, d_model 128, 16 SSD heads of P 16, N 16; zamba2's shared block
after layer 1).  Tolerances: module outputs and states within rtol/atol
1e-5 (f32; the two differ in exp, log1p and the einsums' sum order, by a
few ulp each); bridge round trips, quantized weights and indices exactly.
The engine-level checks (greedy tokens, L, refusals) are in
``test_torch_ssm_engine.py``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.config import QuantConfig as JQuantConfig
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro.models import transformer as jtransformer
from repro.quant.apply import quantize_params as jquantize_params
from repro_torch.bridge import (cache_from_numpy, cache_to_numpy, from_jax_params,
                                to_numpy)
from repro_torch.configs import get_config
from repro_torch.core.config import QuantConfig
from repro_torch.kernels.ssd_update import ssd_update, ssd_update_ref
from repro_torch.models import Model, ssm, transformer
from repro_torch.models.linear import Linear, W4A8Linear, W8A8Linear
from repro_torch.quant.apply import quantize_params
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["mamba2-370m", "zamba2-2.7b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch):
    """(reference, port) reduced configs."""
    return jget_config(arch).reduced(), get_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JModel(_cfgs(arch)[0]).init_params(jax.random.PRNGKey(0))


def _port_params(arch):
    return from_jax_params(jax.tree.map(np.asarray, _jax_params(arch)), _cfgs(arch)[1],
                           device="cpu")


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=msg, **TOL)


def _ssm_cache(cfg, rng, B):
    """A warm SSM cache: random state and conv tail."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    return {"state": _np(rng, B, H, P, N, scale=0.5),
            "conv": _np(rng, B, ssm.D_CONV - 1, di + 2 * N)}


def test_check_supported_admits_ssm_and_hybrid():
    """Both families are admitted now, at full size and reduced; their
    layer kinds and shared positions are the reference's."""
    for arch in ARCHS:
        for jcfg, pcfg in ((jget_config(arch), get_config(arch)), _cfgs(arch)):
            transformer.check_supported(pcfg)
            assert transformer.layer_kinds(pcfg) == jtransformer.layer_kinds(jcfg)
            assert set(transformer.layer_kinds(pcfg)) == {"ssm"}
            assert (transformer.shared_attn_positions(pcfg)
                    == jtransformer.shared_attn_positions(jcfg))
            assert (pcfg.d_inner, pcfg.ssm_heads) == (jcfg.d_inner, jcfg.ssm_heads)
    assert transformer.shared_attn_positions(get_config("zamba2-2.7b")) == list(
        range(5, 54, 6))
    base = get_config("zamba2-2.7b")
    # every family is ported, and the sliding window (ring cache) too: only
    # an unknown arch_type is refused
    for kw in (dict(arch_type="vlm"), dict(arch_type="audio"), dict(encoder_layers=2),
               dict(sliding_window=64)):
        transformer.check_supported(dataclasses.replace(base, **kw))
    transformer.check_supported(dataclasses.replace(get_config("smollm-135m"),
                                                    cross_attn_every=2))
    with pytest.raises(NotImplementedError):
        transformer.check_supported(dataclasses.replace(base, arch_type="graph"))


def test_softplus_matches_jax():
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) within 3 ulp: the form is
    the reference's, but XLA's exp and log1p are not torch's, so no torch
    form is bit-equal (measured: max(x, 0) + log1p(exp(-|x|)) and
    ``torch.logaddexp`` both differ by up to 3 ulp on 2e5 points).  Below
    the smallest normal f32 the reference flushes to 0 and torch keeps the
    subnormal."""
    rng = np.random.default_rng(0)
    x = np.concatenate([_np(rng, 100000, scale=5.0), np.linspace(-30, 30, 20001,
                                                                 dtype=np.float32),
                        np.array([0.0, 20.0, -20.0, 88.0, -88.0], np.float32)])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    normal = np.abs(want) >= np.finfo(np.float32).tiny     # XLA flushes subnormals to 0
    assert ulp[normal].max() <= 3
    assert np.abs(got - want)[~normal].max() <= np.finfo(np.float32).tiny


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("warm", [False, True])
def test_preprocess_matches_jax(arch, warm):
    """in_proj, the width-4 causal conv over the cached tail, SiLU, the
    split into z, x, B, C and dt = softplus(dt_raw + dt_bias)."""
    jcfg, pcfg = _cfgs(arch)
    rng = np.random.default_rng(1)
    u = _np(rng, 2, 5, pcfg.d_model)
    conv = _ssm_cache(pcfg, rng, 2)["conv"] if warm else None
    want = jssm._preprocess(_jax_params(arch)["layers"][0]["ssm"], jcfg, jnp.asarray(u),
                            None if conv is None else jnp.asarray(conv), None, "")
    got = _port_params(arch).layers[0].ssm.preprocess(
        torch.from_numpy(u), None if conv is None else torch.from_numpy(conv), None, "")
    for name, g, w in zip(("z", "x", "Bm", "Cm", "dt", "xBC_pad"), got, want):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, name)


def _apply(arch, T, warm, collect_states, seed=2):
    jcfg, pcfg = _cfgs(arch)
    rng = np.random.default_rng(seed)
    u = _np(rng, 3, T, pcfg.d_model)
    cache = _ssm_cache(pcfg, rng, 3) if warm else None
    jout, jc = jssm.apply_ssm(_jax_params(arch)["layers"][0]["ssm"], jcfg, jnp.asarray(u),
                              cache=None if cache is None else jax.tree.map(jnp.asarray, cache),
                              collect_states=collect_states)
    pc = None if cache is None else cache_from_numpy({"layers": [cache]}, "cpu")["layers"][0]
    out, pc = _port_params(arch).layers[0].ssm(torch.from_numpy(u), pc,
                                                collect_states=collect_states)
    return out, pc, jout, jc


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("T,warm", [(1, True), (6, True), (16, False), (17, True),
                                    (37, False), (40, True)])
def test_apply_ssm_matches_jax(arch, T, warm):
    """Sequential (T <= 16, through ``ssd_update``'s plain version) and
    chunked (T > 16, chunk 8, padded when T is no multiple): the block's
    output, and the cache it leaves, written in place."""
    out, pc, jout, jc = _apply(arch, T, warm, False)
    _close(out, jout, "out")
    if warm:
        _close(pc["state"], jc["state"], "state")
        _close(pc["conv"], jc["conv"], "conv")
    else:
        assert pc is None and jc is None


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_ssm_collect_states_matches_jax(arch):
    """A verify window keeps every position's state and the padded conv
    input: the candidate's ``states_all`` and ``xbc_pad`` are the
    reference's, beside the layer's own untouched tensors."""
    out, pc, jout, jc = _apply(arch, 6, True, True)
    _close(out, jout, "out")
    assert set(pc) == {"state", "conv", "states_all", "xbc_pad"}
    assert set(jc) == {"states_all", "xbc_pad"}
    _close(pc["states_all"], jc["states_all"], "states_all")
    _close(pc["xbc_pad"], jc["xbc_pad"], "xbc_pad")


@pytest.mark.parametrize("arch", ARCHS)
def test_commit_ssm_cache_matches_jax_at_every_n_last(arch):
    """Each row keeps the state after window token n_last and the conv
    tail ending there, for every n_last in [0, T); written into the layer's
    own tensors."""
    _, pc, _, jc = _apply(arch, 6, True, True)
    state, conv = pc["state"], pc["conv"]
    for n in range(6):
        for n_last in (np.full(3, n, np.int32), np.array([n, (n + 2) % 6, 5 - n], np.int32)):
            want = jssm.commit_ssm_cache(jc, jnp.asarray(n_last))
            got = ssm.commit_ssm_cache(pc, torch.from_numpy(n_last))
            assert got["state"] is state and got["conv"] is conv
            _close(got["state"], want["state"], f"state n_last={n_last}")
            _close(got["conv"], want["conv"], f"conv n_last={n_last}")


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("B,T,H,P,N", [(2, 6, 4, 16, 16), (1, 1, 3, 8, 32), (3, 4, 2, 64, 64)])
def test_ssd_update_ref_matches_jax_sequential(collect, B, T, H, P, N):
    """The kernel's plain version against the reference's ``lax.scan``."""
    rng = np.random.default_rng(3)
    x, Bm, Cm = _np(rng, B, T, H, P), _np(rng, B, T, N), _np(rng, B, T, N)
    dt = np.abs(_np(rng, B, T, H, scale=0.1))
    A = np.linspace(1.0, 16.0, H).astype(np.float32)
    h0 = _np(rng, B, H, P, N)
    jy, js = jssm._ssd_sequential(*(jnp.asarray(a) for a in (x, Bm, Cm, dt, A, h0)), collect)
    args = [torch.from_numpy(a) for a in (x, Bm, Cm, dt, A, h0)]
    y, s = ssd_update_ref(*args, collect)
    _close(y, jy, "y")
    _close(s, js, "states")
    y2, s2 = ssd_update(*args, collect)       # the wrapper on CPU tensors: the plain version
    assert torch.equal(y2, y) and torch.equal(s2, s)


def test_ssd_update_rejects_bad_inputs():
    x = torch.zeros(2, 3, 4, 16)
    ok = dict(Bm=torch.zeros(2, 3, 16), Cm=torch.zeros(2, 3, 16), dt=torch.zeros(2, 3, 4),
              A=torch.ones(4), h0=torch.zeros(2, 4, 16, 16))
    ssd_update(x, **ok)
    for name, bad in (("Bm", torch.zeros(2, 3, 8)), ("dt", torch.zeros(2, 4)),
                      ("h0", torch.zeros(2, 4, 16, 16).double()),
                      ("A", torch.ones(8)[::2])):
        with pytest.raises(ValueError):
            ssd_update(x, **{**ok, name: bad})


def _jax_cache(arch, B, S, rng):
    """A reference cache with random SSM states and conv tails."""
    jcfg = _cfgs(arch)[0]
    cache = jax.tree.map(np.asarray, JModel(jcfg).init_cache(B, S))
    for layer in cache["layers"]:
        layer.update(_ssm_cache(_cfgs(arch)[1], rng, B))
    return cache


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_verify_commit_match_jax(arch):
    """Prefill (chunked), a verify window (collect_states, the shared
    block's KV cache written), its logits and candidate cache, then the
    commit at per-row n_last: the port against the reference."""
    jcfg, pcfg = _cfgs(arch)
    rng = np.random.default_rng(5)
    B, P, T = 2, 21, 5
    toks = rng.integers(0, jcfg.vocab_size, (B, P + T)).astype(np.int32)
    jm, pm = JModel(jcfg), Model(pcfg, device="cpu")
    jparams, params = _jax_params(arch), _port_params(arch)
    jc = jm.prefill(jparams, jm.init_cache(B, 64), jnp.asarray(toks[:, :P]))
    pc = pm.prefill(params, pm.init_cache(B, 64), torch.from_numpy(toks[:, :P]))
    assert ("shared" in pc) == (arch == "zamba2-2.7b")
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **TOL),
                 jax.tree.map(np.asarray, jc), cache_to_numpy(pc))
    start = np.full(B, P, np.int32)
    jl, jcand = jm.verify_step(jparams, jc, jnp.asarray(toks[:, P:]), jnp.asarray(start))
    pl, pcand = pm.verify_step(params, pc, torch.from_numpy(toks[:, P:]),
                               torch.from_numpy(start))
    _close(pl, jl, "logits")
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **TOL),
                 jax.tree.map(np.asarray, jcand), cache_to_numpy(pcand))
    n_last = np.array([0, T - 1], np.int32)
    jcom = jm.commit(jcand, jnp.asarray(n_last))
    before = [t for layer in pc["layers"] for t in layer.values()]
    pcom = pm.commit(pcand, torch.from_numpy(n_last))
    after = [t for layer in pcom["layers"] for t in layer.values()]
    assert len(after) == len(before) and all(a is b for a, b in zip(after, before))
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **TOL),
                 jax.tree.map(np.asarray, jcom), cache_to_numpy(pcom))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    jcfg, pcfg = _cfgs(arch)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    want, _ = JModel(jcfg).forward(_jax_params(arch), jnp.asarray(toks))
    got, _ = Model(pcfg, device="cpu").forward(_port_params(arch), torch.from_numpy(toks))
    _close(got, want, "logits")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("verifier", ["bf16", "w8a8"])
def test_bridge_round_trip(arch, verifier):
    """Raw and prepared SSM and hybrid trees (the SSM buffers, the inner
    norm, ``shared_attn``) cross the bridge both ways bit for bit."""
    jcfg, pcfg = _cfgs(arch)
    jparams = _jax_params(arch)
    if verifier == "w8a8":
        jparams = jquantize_params(jparams, None, JQuantConfig())
    tree = jax.tree.map(np.asarray, jparams)
    params = from_jax_params(tree, pcfg, device="cpu")
    assert isinstance(params.layers[0], transformer.SSMBlock)
    assert (params.shared_attn is not None) == ("shared_attn" in tree)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), tree, to_numpy(params))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_bridge_round_trip_with_shared_and_candidates(arch):
    """Serving caches (SSM layers and the ``"shared"`` KV list) and a verify
    candidate tree cross both ways bit for bit; the port's candidate carries
    the layer's own tensors besides the reference's keys."""
    jcfg, _ = _cfgs(arch)
    rng = np.random.default_rng(7)
    tree = _jax_cache(arch, 2, 32, rng)
    got = cache_to_numpy(cache_from_numpy(tree, "cpu"))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), tree, got)
    toks = rng.integers(0, jcfg.vocab_size, (2, 4)).astype(np.int32)
    _, jcand = JModel(jcfg).verify_step(_jax_params(arch), jax.tree.map(jnp.asarray, tree),
                                        jnp.asarray(toks), jnp.asarray([3, 7], jnp.int32))
    cand = jax.tree.map(np.asarray, jcand)
    assert set(cand["layers"][0]) == {"states_all", "xbc_pad"}
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), cand,
                 cache_to_numpy(cache_from_numpy(cand, "cpu")))


@functools.lru_cache(maxsize=None)
def _calibrate(arch):
    jcfg, pcfg = _cfgs(arch)
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    jstats, pstats = {}, {}
    JModel(jcfg).forward(_jax_params(arch), jnp.asarray(toks), collect=jstats)
    params = _port_params(arch)
    Model(pcfg, device="cpu").forward(params, torch.from_numpy(toks), collect=pstats)
    return jstats, pstats, params


@pytest.mark.parametrize("arch", ARCHS)
def test_calibration_keys_match_jax(arch):
    """Statistics at the reference's paths: ``layers/<i>/ssm/in_proj`` and
    ``out_proj``; zamba2's shared block's applications fold into one
    ``shared_attn/…`` key each by a running max."""
    jstats, pstats, _ = _calibrate(arch)
    assert set(pstats) == set(jstats)
    assert {"layers/0/ssm/in_proj", "layers/1/ssm/out_proj"} <= set(pstats)
    if arch == "zamba2-2.7b":
        assert {f"shared_attn/{k}" for k in ("attn/q", "attn/o", "ffn/up", "ffn/down")} \
            <= set(pstats)
    for k in jstats:
        np.testing.assert_allclose(pstats[k].numpy(), np.asarray(jstats[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("w_bits", [8, 4])
def test_quantize_params_ssm_tree_bit_identical(arch, w_bits):
    """On the same statistics: ``in_proj``, ``out_proj`` and the shared
    block's linears become W8A8 (W4A8 under ``w_bits=4``), bit-identical to
    the reference's; conv, A, D, dt and the norms stay as they were."""
    jstats, _, params = _calibrate(arch)
    stats = {k: np.asarray(v) for k, v in jstats.items()}
    jq = jquantize_params(_jax_params(arch), {k: jnp.asarray(v) for k, v in stats.items()},
                          JQuantConfig(w_bits=w_bits))
    pq = quantize_params(params, {k: torch.from_numpy(v.copy()) for k, v in stats.items()},
                         QuantConfig(w_bits=w_bits))
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 jax.tree.map(np.asarray, jq), to_numpy(pq))
    want = W4A8Linear if w_bits == 4 else W8A8Linear
    blk = pq.layers[0].ssm
    assert isinstance(blk.in_proj, want) and isinstance(blk.out_proj, want)
    assert blk.conv_w is params.layers[0].ssm.conv_w
    assert blk.A_log.dtype == torch.float32
    if arch == "zamba2-2.7b":
        assert isinstance(pq.shared_attn.attn.q, want)
        assert isinstance(pq.shared_attn.ffn.down, want)
    else:
        assert pq.lm_head is None and isinstance(params.layers[1].ssm.in_proj, Linear)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_layout_matches_jax(arch):
    """Shapes and dtypes of the serving cache, the pruned stack's cut
    included (the shared list keeps only applications below the cut)."""
    jcfg, pcfg = _cfgs(arch)
    for n in (None, 1):
        want = jax.tree.map(lambda a: (a.shape, np.dtype(a.dtype).name),
                            JModel(jcfg).init_cache(2, 40, num_layers=n))
        got = transformer.init_cache(pcfg, 2, 40, "cpu", num_layers=n)
        assert set(got) == set(want)
        for name in want:
            for g, w in zip(got[name], want[name]):
                assert {k: (tuple(t.shape), str(t.dtype).split(".")[-1])
                        for k, t in g.items()} == w


@pytest.mark.parametrize("arch", ARCHS)
def test_commit_cache_tree_refuses_recurrent_caches_as_jax(arch):
    """The tree commit keeps refusing SSM (and shared) caches, with the
    reference's type and message."""
    jcfg, pcfg = _cfgs(arch)
    tree = _jax_cache(arch, 2, 32, np.random.default_rng(9))
    args = (np.zeros(2, np.int32), np.zeros((2, 3), np.int32), np.zeros(2, np.int32))
    with pytest.raises(NotImplementedError) as jerr:
        jtransformer.commit_cache_tree(jcfg, jax.tree.map(jnp.asarray, tree),
                                       *(jnp.asarray(a) for a in args))
    with pytest.raises(NotImplementedError) as perr:
        transformer.commit_cache_tree(pcfg, cache_from_numpy(tree, "cpu"),
                                      *(torch.from_numpy(a) for a in args))
    assert str(perr.value) == str(jerr.value)
