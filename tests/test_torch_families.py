"""The port's last four model families against the JAX package, on the CPU:
``codeqwen1.5-7b`` (MHA, q/k/v biases), ``stablelm-12b`` (GQA),
``llama-3.2-vision-90b`` (gated cross-attention layers over image
embeddings) and ``whisper-small`` (bidirectional encoder, decoder blocks
with self + cross attention, LayerNorm, GELU, biases, tied embeddings).

Every check runs ``.reduced()`` configs in f32 (2 layers, d_model 128, 4
heads of 32; vision: layer 1 a cross layer over 8 image tokens; whisper: a
2-layer encoder over 16 frames) with the reference's weights bridged as
numpy.  Two changes to the reference tree make the checks see every path:
the biases (zero at init) are drawn at random, and the vision cross gates
(0 at init, so a fresh cross layer adds nothing) are set to 0.5, where
``tanh`` gives the same f32 bits in XLA and torch
(:func:`test_gate_tanh_is_bit_equal_in_both`).

Tolerances: logits and module outputs within rtol 1e-5 / atol 2e-5 (f32;
the two differ in matmul blocking and, for the cross read, in the order of
the softmax's sums: the port reads through ``flash_decode``'s plain
version); bridge round trips, quantized weights, calibration statistics'
keys and layouts exactly.  The engine-level checks are in
``test_torch_families_engine.py``, which shares this file's setup.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jget_config
from repro.core.config import QuantConfig as JQuantConfig
from repro.models import Model as JModel
from repro.models import attention as jattention
from repro.models import transformer as jtransformer
from repro.quant.apply import quantize_params as jquantize_params
from repro_torch.bridge import (cache_from_numpy, cache_to_numpy, from_jax_params, tensor,
                                to_numpy)
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.config import QuantConfig
from repro_torch.models import Model, attention, transformer
from repro_torch.quant.apply import quantize_params
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

ARCHS = ["codeqwen1.5-7b", "stablelm-12b", "llama-3.2-vision-90b", "whisper-small"]
MODALITY = ["llama-3.2-vision-90b", "whisper-small"]
TOL = dict(rtol=1e-5, atol=2e-5)
GATE = 0.5


def _cfgs(arch):
    """(reference, port) reduced configs."""
    return jget_config(arch).reduced(), get_config(arch).reduced()


def _with_gates(tree, gate=GATE):
    """A copy of a reference pytree (numpy leaves) with every cross gate at ``gate``."""
    tree = jax.tree.map(np.array, tree)
    for lp in tree["layers"]:
        if "gate_attn" in lp:
            lp["gate_attn"] = np.asarray(gate, np.float32)
            lp["gate_ffn"] = np.asarray(gate, np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    """The reference's weights (numpy) with random biases and the cross
    gates at GATE."""
    tree = jax.tree.map(np.array, JModel(_cfgs(arch)[0]).init_params(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def biases(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k == "b":
                    node[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
                else:
                    biases(v)
        elif isinstance(node, list):
            for v in node:
                biases(v)

    biases(tree)
    return _with_gates(tree)


def _jax_tree(arch):
    return jax.tree.map(jnp.asarray, _jax_params(arch))


def _port_params(arch):
    return from_jax_params(_jax_params(arch), _cfgs(arch)[1], device="cpu")


def _aux(arch, B=3, seed=1):
    """Seeded (B, Sa, D) image or audio embeddings, or None."""
    cfg = _cfgs(arch)[1]
    n = cfg.num_image_tokens or cfg.num_audio_frames
    if not n:
        return None
    return np.random.default_rng(seed).standard_normal((B, n, cfg.d_model)).astype(np.float32)


def _tokens(B=3, T=12, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, T)).astype(np.int32)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _close(got, want, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), err_msg=msg, **TOL)


def _leaves_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_registry_holds_every_reference_config():
    """All eleven configs, field for field (dtype aside), with the
    reference's parameter census, reduced variants and layer kinds; the
    port accepts each."""
    assert sorted(REGISTRY) == sorted(JREGISTRY)
    for name, jcfg in JREGISTRY.items():
        for j, p in ((jcfg, REGISTRY[name]), (jcfg.reduced(), REGISTRY[name].reduced())):
            jf, pf = dataclasses.asdict(j), dataclasses.asdict(p)
            jf.pop("dtype"), pf.pop("dtype")
            assert jf == pf, name
            assert p.param_count() == j.param_count(), name
            assert p._layer_census() == j._layer_census(), name
            assert transformer.layer_kinds(p) == jtransformer.layer_kinds(j), name
            transformer.check_supported(p)
    assert transformer.layer_kinds(get_config("llama-3.2-vision-90b")).count("cross") == 20
    assert transformer.layer_kinds(_cfgs("llama-3.2-vision-90b")[1]) == ["dense", "cross"]
    assert set(transformer.layer_kinds(get_config("whisper-small"))) == {"audio"}


def test_check_supported_refuses_only_sliding_windows():
    """A window is accepted (every self-attention cache a ring); an unknown
    ``arch_type`` or ``attn_impl`` is still refused."""
    for arch in ARCHS:
        transformer.check_supported(dataclasses.replace(get_config(arch), sliding_window=64))
    with pytest.raises(NotImplementedError):
        transformer.check_supported(dataclasses.replace(get_config("smollm-135m"),
                                                        arch_type="graph"))
    with pytest.raises(ValueError, match="attn_impl"):
        transformer.check_supported(dataclasses.replace(get_config("smollm-135m"),
                                                        attn_impl="triton"))


def test_gate_tanh_is_bit_equal_in_both():
    """The gate value the tests use has the same f32 tanh in XLA and torch."""
    j = np.asarray(jnp.tanh(jnp.float32(GATE)))
    p = torch.tanh(torch.tensor(GATE, dtype=torch.float32)).numpy()
    assert j.tobytes() == p.tobytes()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch):
    jcfg, pcfg = _cfgs(arch)
    toks, aux = _tokens(), _aux(arch)
    want, _ = JModel(jcfg).forward(_jax_tree(arch), jnp.asarray(toks), aux_embeds=_j(aux))
    got, total = Model(pcfg, device="cpu").forward(_port_params(arch), torch.from_numpy(toks),
                                                   aux_embeds=_t(aux))
    _close(got, want, arch)
    assert float(total) == 0.0


def test_gates_reach_the_logits():
    """The cross path moves the logits once its gates are non-zero, in both
    and by the same amount: at the reference's zero gates a cross layer
    adds nothing at all."""
    arch = "llama-3.2-vision-90b"
    jcfg, pcfg = _cfgs(arch)
    toks, aux = _tokens(), _aux(arch)
    shut = _with_gates(_jax_params(arch), 0.0)
    jl = {g: np.asarray(JModel(jcfg).forward(jax.tree.map(jnp.asarray, tree),
                                             jnp.asarray(toks), aux_embeds=_j(aux))[0])
          for g, tree in ((0.0, shut), (GATE, _jax_params(arch)))}
    pm = Model(pcfg, device="cpu")
    pl = {g: pm.forward(from_jax_params(tree, pcfg, device="cpu"), torch.from_numpy(toks),
                        aux_embeds=_t(aux))[0].numpy()
          for g, tree in ((0.0, shut), (GATE, _jax_params(arch)))}
    assert np.abs(pl[GATE] - pl[0.0]).max() > 1e-2
    _close(pl[GATE] - pl[0.0], jl[GATE] - jl[0.0])
    # at zero gates the logits do not depend on the image at all
    other = pm.forward(from_jax_params(shut, pcfg, device="cpu"), torch.from_numpy(toks),
                       aux_embeds=_t(_aux(arch, seed=9)))[0].numpy()
    assert np.array_equal(other, pl[0.0])


@pytest.mark.parametrize("arch", MODALITY)
def test_cross_attention_matches_jax(arch):
    """The cross layer's attention alone, at prefill (K/V from the
    embeddings, written into the cache in place) and at decode (K/V read
    from the cache): outputs and cache within TOL; its norm's one reader is
    q."""
    jcfg, pcfg = _cfgs(arch)
    i = transformer.layer_kinds(pcfg).index("cross" if arch.startswith("llama") else "audio")
    jp = _jax_tree(arch)["layers"][i]["cross"]
    mod = _port_params(arch).layers[i].cross
    assert mod.readers() == (mod.q,)
    rng = np.random.default_rng(4)
    aux = _aux(arch)
    x = rng.standard_normal((3, 5, pcfg.d_model)).astype(np.float32)
    Sa = aux.shape[1]
    jcache = {n: jnp.zeros((3, Sa, pcfg.num_kv_heads, pcfg.head_dim)) for n in ("ck", "cv")}
    want, jcache = jattention.cross_attention(jp, jcfg, jnp.asarray(x), kv_embeds=_j(aux),
                                              cache=jcache)
    cache = attention.init_cross_cache(pcfg, 3, Sa, "cpu")
    ck = cache["ck"]
    got, cache = mod(torch.from_numpy(x), kv_embeds=_t(aux), cache=cache)
    assert cache["ck"] is ck
    _close(got, want, "prefill")
    _close(cache["ck"], jcache["ck"])
    _close(cache["cv"], jcache["cv"])
    x2 = rng.standard_normal((3, 1, pcfg.d_model)).astype(np.float32)
    want, _ = jattention.cross_attention(jp, jcfg, jnp.asarray(x2), cache=jcache)
    got, _ = mod(torch.from_numpy(x2), cache=cache)
    _close(got, want, "decode")
    with pytest.raises(ValueError, match="kv_embeds"):
        mod(torch.from_numpy(x2))


@pytest.mark.parametrize("causal", [True, False])
def test_cross_attend_matches_plain_attention(causal):
    """``cross_attend`` (flash_decode with every query at Sa - 1) equals the
    reference's non-causal ``attend`` within TOL; the plain non-causal
    ``attend`` (the encoder's) too, and causal stays causal."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 6, 8, 32)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)).copy()
    if causal:
        qpos = pos[:, 10:16].copy()
        want = jattention.attend(*map(jnp.asarray, (q, k, v, qpos, pos)), causal=True)
        got = attention.attend(*map(torch.from_numpy, (q, k, v, qpos, pos)), causal=True)
    else:
        zq, zk = np.zeros((2, 6), np.int32), np.zeros(40, np.int32)
        want = jattention.attend(*map(jnp.asarray, (q, k, v, zq, zk)), causal=False)
        _close(attention.cross_attend(*map(torch.from_numpy, (q, k, v))), want, "cross")
        want = jattention.attend(*map(jnp.asarray, (q, k[:, :6], v[:, :6], zq, pos[:, :6])),
                                 causal=False)
        got = attention.attend(*map(torch.from_numpy, (q, k[:, :6], v[:, :6], zq,
                                                       pos[:, :6])), causal=False)
    _close(got, want)


def test_encoder_matches_jax():
    """whisper's encoder alone: non-causal self-attention blocks over the
    frames, then its norm."""
    jcfg, pcfg = _cfgs("whisper-small")
    aux = _aux("whisper-small")
    want = jtransformer._encode(_jax_tree("whisper-small")["encoder"], jcfg, jnp.asarray(aux),
                                None, "encoder")
    got = _port_params("whisper-small").encoder(torch.from_numpy(aux))
    _close(got, want)


@functools.lru_cache(maxsize=None)
def _jax_prefill_verify(arch, kv="bf16"):
    """The reference's prefill (with aux) and one verify window over it:
    (prefilled cache, logits, candidate cache) as numpy."""
    jcfg = dataclasses.replace(_cfgs(arch)[0], kv_cache_dtype=kv)
    jm = JModel(jcfg)
    toks = _tokens(T=14)
    cache = jm.prefill(_jax_tree(arch), jm.init_cache(3, 64), jnp.asarray(toks[:, :9]),
                       aux_embeds=_j(_aux(arch)))
    pre = jax.tree.map(np.array, cache)
    logits, cand = jm.verify_step(_jax_tree(arch), cache, jnp.asarray(toks[:, 8:]),
                                  jnp.full((3,), 8, jnp.int32))
    return pre, np.asarray(logits), jax.tree.map(np.array, cand)


@pytest.mark.parametrize("arch,kv", [(a, "bf16") for a in ARCHS] + [("whisper-small", "int8")])
def test_prefill_verify_match_jax(arch, kv):
    """Prefill with the embeddings fills the cross caches; the verify
    window then reads them (and its self cache) from there: caches and
    logits within TOL, and the port's cache round-trips the bridge into the
    reference's layout."""
    pcfg = dataclasses.replace(_cfgs(arch)[1], kv_cache_dtype=kv)
    pm = Model(pcfg, device="cpu")
    params = _port_params(arch)
    toks = _tokens(T=14)
    want_pre, want_logits, want_cand = _jax_prefill_verify(arch, kv)
    cache = pm.prefill(params, pm.init_cache(3, 64), torch.from_numpy(toks[:, :9]),
                       aux_embeds=_t(_aux(arch)))
    got_pre = cache_to_numpy(cache)
    assert jax.tree.structure(got_pre) == jax.tree.structure(want_pre)
    for g, w in zip(jax.tree.leaves(got_pre), jax.tree.leaves(want_pre)):
        if g.dtype == np.int8:       # a rounding step apart at most
            assert np.abs(g.astype(np.int32) - w.astype(np.int32)).max() <= 1
        else:
            _close(g, w)
    logits, cand = pm.verify_step(params, cache, torch.from_numpy(toks[:, 8:]),
                                  torch.full((3,), 8, dtype=torch.int32))
    _close(logits, want_logits)
    assert jax.tree.structure(cache_to_numpy(cand)) == jax.tree.structure(want_cand)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip(arch):
    """Parameters (bf16 and both quantized layouts, the scalar gates, the
    encoder) and caches (nested audio caches, cross caches) cross both ways
    bit for bit."""
    jcfg, pcfg = _cfgs(arch)
    tree = _jax_params(arch)
    _leaves_equal(to_numpy(from_jax_params(tree, pcfg, device="cpu")), tree)
    for bits in (8, 4):
        jq = jax.tree.map(np.asarray, jquantize_params(_jax_tree(arch), None,
                                                       JQuantConfig(w_bits=bits)))
        _leaves_equal(to_numpy(from_jax_params(jq, pcfg, device="cpu")), jq)
    cache = jax.tree.map(np.array, JModel(jcfg).init_cache(2, 40))
    for leaf in jax.tree.leaves(cache):
        leaf[...] = np.random.default_rng(leaf.size).standard_normal(leaf.shape)
    port = cache_from_numpy(cache, device="cpu")
    _leaves_equal(cache_to_numpy(port), cache)
    _leaves_equal(cache_to_numpy(Model(pcfg, device="cpu").init_cache(2, 40)),
                  jax.tree.map(np.asarray, JModel(jcfg).init_cache(2, 40)))


@pytest.mark.parametrize("arch,w_bits", [("codeqwen1.5-7b", 8), ("codeqwen1.5-7b", 4),
                                         ("whisper-small", 8),
                                         ("llama-3.2-vision-90b", 8),
                                         ("llama-3.2-vision-90b", 4)])
def test_quantize_params_bit_identical(arch, w_bits):
    """The reference's prepared tree, bit for bit, with calibration stats:
    codeqwen's biased q/k/v, whisper's encoder, cross linears and biases
    (its norms stay as they are), vision's cross layers (the gates are
    scalars and stay f32)."""
    jcfg, pcfg = _cfgs(arch)
    jm = JModel(jcfg)
    toks, aux = _tokens(B=1, T=16, seed=3), _aux(arch, B=1, seed=3)
    jstats = {}
    jm.forward(_jax_tree(arch), jnp.asarray(toks), aux_embeds=_j(aux), collect=jstats)
    want = jax.tree.map(np.asarray, jquantize_params(_jax_tree(arch), jstats,
                                                     JQuantConfig(w_bits=w_bits)))
    pstats = {k: tensor(np.asarray(v), "cpu") for k, v in jstats.items()}
    got = quantize_params(_port_params(arch), pstats, QuantConfig(w_bits=w_bits))
    _leaves_equal(to_numpy(got), want)


@pytest.mark.parametrize("arch", MODALITY)
def test_calibration_keys_match_jax(arch):
    """Calibration records the encoder's and the cross layers' linears
    (k and v on the embeddings) under the reference's keys, with the
    reference's per-channel maxima within TOL."""
    jcfg, pcfg = _cfgs(arch)
    toks, aux = _tokens(B=1, T=16, seed=3), _aux(arch, B=1, seed=3)
    jstats, pstats = {}, {}
    JModel(jcfg).forward(_jax_tree(arch), jnp.asarray(toks), aux_embeds=_j(aux),
                         collect=jstats)
    Model(pcfg, device="cpu").forward(_port_params(arch), torch.from_numpy(toks),
                                      aux_embeds=_t(aux), collect=pstats)
    assert sorted(pstats) == sorted(jstats)
    assert any(k.startswith("encoder/") for k in pstats) == (arch == "whisper-small")
    assert any("/cross/k" in k for k in pstats)
    for k in jstats:
        _close(pstats[k], jstats[k], k)


def test_commit_cache_tree_audio_matches_jax():
    """A tree verify window over whisper's nested cache, then the commit of
    the accepted path: the decoder's own K/V rows move, the cross caches
    stay."""
    from repro.core.tree import TreeTemplate as JTreeTemplate
    from repro_torch.core.tree import TreeTemplate

    arch = "whisper-small"
    jcfg, pcfg = _cfgs(arch)
    jm, pm = JModel(jcfg), Model(pcfg, device="cpu")
    jt, pt = JTreeTemplate((2, 2, 1)), TreeTemplate((2, 2, 1))
    toks = _tokens(T=9 + pt.num_nodes)
    jcache = jm.prefill(_jax_tree(arch), jm.init_cache(3, 64), jnp.asarray(toks[:, :9]),
                        aux_embeds=_j(_aux(arch)))
    pcache = pm.prefill(_port_params(arch), pm.init_cache(3, 64),
                        torch.from_numpy(toks[:, :9]), aux_embeds=_t(_aux(arch)))
    win = toks[:, 9:]
    start = np.array([8, 8, 8], np.int32)
    _, jcand = jm.verify_step(_jax_tree(arch), jcache, jnp.asarray(win), jnp.asarray(start),
                              tree_depths=jnp.asarray(jt.depths), tree_mask=jnp.asarray(jt.mask))
    tables = pt.on("cpu")
    _, pcand = pm.verify_step(_port_params(arch), pcache, torch.from_numpy(win),
                              torch.from_numpy(start), tree_depths=tables.depths,
                              tree_mask=tables.mask, tree_bits=tables.mask_bits)
    paths = np.array([[0, 1, 3, 7], [0, 2, 5, 0], [0, 1, 0, 0]], np.int32)
    n_acc = np.array([3, 2, 1], np.int32)
    want = jm.commit_tree(jcand, jnp.asarray(start), jnp.asarray(paths), jnp.asarray(n_acc))
    ck = pcand["layers"][0]["ck"]
    got = pm.commit_tree(pcand, torch.from_numpy(start), torch.from_numpy(paths),
                         torch.from_numpy(n_acc))
    assert got["layers"][0]["ck"] is ck
    for g, w in zip(jax.tree.leaves(cache_to_numpy(got)), jax.tree.leaves(want)):
        _close(g, w)


def test_init_cache_layout_matches_jax():
    for arch in MODALITY:
        jcfg, pcfg = _cfgs(arch)
        got = cache_to_numpy(Model(pcfg, device="cpu").init_cache(2, 100))
        want = jax.tree.map(np.asarray, JModel(jcfg).init_cache(2, 100))
        _leaves_equal(got, want)
    layer = Model(_cfgs("whisper-small")[1], device="cpu").init_cache(2, 100)["layers"][0]
    assert list(layer) == ["self", "ck", "cv"]
    assert transformer.self_kv(layer) is layer["self"]
    vis = Model(_cfgs("llama-3.2-vision-90b")[1], device="cpu").init_cache(2, 100)["layers"]
    assert transformer.self_kv(vis[1]) is None and transformer.self_kv(vis[0]) is vis[0]
