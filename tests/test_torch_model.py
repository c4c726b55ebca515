"""The port's model, weight bridge and W8A8 preparation against the JAX
package, on ``smollm-135m`` ``.reduced()`` (2 layers, d 128, G = 2,
vocab 256, f32) with the same weights (bridged as numpy).

Tolerances: f32 logits differ only by summation order (torch's and XLA's
CPU matmuls block differently) — 1e-4 on logits of magnitude ~1.  bf16
rounds every op's output to 8 mantissa bits in both frameworks, but not
always at the same intermediate — 0.1 absolute.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.config import QuantConfig as JQuantConfig
from repro.models import Model as JModel
from repro.quant import quantize_params as jquantize
from repro_torch.bridge import (array, cache_from_numpy, cache_to_numpy,
                                from_jax_params, tensor, to_numpy)
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.quant.apply import quantize_params
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(tie=True, dtype="f32", kv="bf16"):
    jcfg = jget_config("smollm-135m").reduced()
    pcfg = get_config("smollm-135m").reduced()
    jcfg = dataclasses.replace(jcfg, tie_embeddings=tie, kv_cache_dtype=kv)
    pcfg = dataclasses.replace(pcfg, tie_embeddings=tie, kv_cache_dtype=kv)
    if dtype == "bf16":
        jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
        pcfg = dataclasses.replace(pcfg, dtype=torch.bfloat16)
    return jcfg, pcfg


def _tokens(B=2, T=24, V=256, seed=0):
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, V, 6)
    return np.stack([np.roll(np.tile(pat, T // 6 + 1)[:T], b) for b in range(B)]).astype(np.int32)


def _leaves_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _calibrated(jm, jparams):
    collect = {}
    jm.forward(jparams, jnp.asarray(_tokens(1, 24, seed=3)), collect=collect)
    return collect


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_bridge_round_trip_bit_exact(dtype):
    jcfg, pcfg = _configs(tie=False, dtype=dtype)
    jm = JModel(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(1))
    jq = jquantize(jparams, _calibrated(jm, jparams), JQuantConfig())
    for tree in (_np_tree(jparams), _np_tree(jq)):
        params = from_jax_params(tree, pcfg, device="cpu")
        _leaves_equal(to_numpy(params), tree)
    cache = jax.tree.map(np.array, JModel(dataclasses.replace(
        jcfg, kv_cache_dtype="int8")).init_cache(2, 40))
    cache["layers"][0]["k_scale"][:] = 0.5
    _leaves_equal(cache_to_numpy(cache_from_numpy(cache, device="cpu")), cache)
    # the port stores the int8 weight transposed, (dout, din)
    q0 = from_jax_params(_np_tree(jq), pcfg, device="cpu").layers[0].attn.q
    assert q0.w_int8.shape == (pcfg.q_dim, pcfg.d_model) and q0.w_int8.is_contiguous()
    assert array(tensor(np.asarray(jparams["embed"]["w"]), CPU)).dtype.name == (
        "bfloat16" if dtype == "bf16" else "float32")


@pytest.mark.parametrize("calibrated", [False, True])
def test_quantize_params_bit_identical(calibrated):
    jcfg, pcfg = _configs(tie=False)
    jm = JModel(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(2))
    stats = _calibrated(jm, jparams) if calibrated else None
    jq = _np_tree(jquantize(jparams, stats, JQuantConfig()))
    pstats = {k: tensor(np.asarray(v), CPU) for k, v in stats.items()} if stats else None
    pq = quantize_params(from_jax_params(_np_tree(jparams), pcfg, device="cpu"), pstats)
    _leaves_equal(to_numpy(pq), jq)


@pytest.mark.parametrize("dtype,w8a8,tol", [
    ("f32", False, 1e-4), ("f32", True, 1e-4), ("bf16", False, 1e-1)])
def test_forward_logits_match_jax(dtype, w8a8, tol):
    jcfg, pcfg = _configs(tie=False, dtype=dtype)
    jm, pm = JModel(jcfg), Model(pcfg, device="cpu")
    jparams = jm.init_params(jax.random.PRNGKey(3))
    if w8a8:
        jparams = jquantize(jparams, _calibrated(jm, jparams), JQuantConfig())
    params = from_jax_params(_np_tree(jparams), pcfg, device="cpu")
    toks = _tokens(2, 24, seed=4)
    jl, _ = jax.jit(jm.forward)(jparams, jnp.asarray(toks))
    pl, _ = pm.forward(params, torch.from_numpy(toks))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("w8a8", [False, True])
def test_prefill_verify_match_jax(kv, w8a8):
    """Prefill → verify_step logits and cache vs the reference's (both
    jitted on the JAX side, as its engine runs the step)."""
    jcfg, pcfg = _configs(tie=True, kv=kv)
    jm, pm = JModel(jcfg), Model(pcfg, device="cpu")
    jparams = jm.init_params(jax.random.PRNGKey(4))
    if w8a8:
        jparams = jquantize(jparams, None, JQuantConfig())
    params = from_jax_params(_np_tree(jparams), pcfg, device="cpu")
    toks = _tokens(2, 30, seed=5)
    P, B = 20, 2
    start = np.full((B,), P - 1, np.int32)
    jc = jax.jit(jm.prefill)(jparams, jm.init_cache(B, 40), jnp.asarray(toks[:, :P - 1]))
    jl, jc = jax.jit(jm.verify_step)(jparams, jc, jnp.asarray(toks[:, P - 1:P + 5]),
                                     jnp.asarray(start))
    pc = pm.prefill(params, pm.init_cache(B, 40), torch.from_numpy(toks[:, :P - 1]))
    pl, pc = pm.verify_step(params, pc, torch.from_numpy(toks[:, P - 1:P + 5]),
                            torch.from_numpy(start))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    jcn, pcn = _np_tree(jc), cache_to_numpy(pc)
    for lj, lp in zip(jcn["layers"], pcn["layers"]):
        assert set(lj) == set(lp)
        for name in lj:
            a, b = lp[name].astype(np.float64), lj[name].astype(np.float64)
            if name in ("k", "v") and kv == "int8":
                # int8 codes: a value within f32 rounding of a .5 boundary
                # may round to the neighbouring code
                assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-3
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_prefill_then_decode_equals_forward():
    """Inside the port: the cached decode path reproduces the full forward."""
    _, pcfg = _configs(tie=True)
    pm = Model(pcfg, device="cpu")
    params = pm.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(2, 16, seed=6))
    full, _ = pm.forward(params, toks)
    cache = pm.prefill(params, pm.init_cache(2, 16), toks[:, :10])
    logits, _ = pm.verify_step(params, cache, toks[:, 10:], torch.full((2,), 10, dtype=torch.int32))
    torch.testing.assert_close(logits, full[:, 10:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_long_prefill_attention_matches_jax(int8):
    """Beyond 4096 keys the plain path switches to the chunked online
    softmax (padded to a 1024 multiple); held against the reference's."""
    from repro.models.attention import _quant_kv as jq
    from repro.models.attention import attend as jattend
    from repro_torch.models.attention import attend

    rng = np.random.default_rng(7)
    S, T = 4100, 3
    q = rng.standard_normal((1, T, 2, 32)).astype(np.float32)
    k = rng.standard_normal((1, S, 1, 32)).astype(np.float32)
    v = rng.standard_normal((1, S, 1, 32)).astype(np.float32)
    qpos = np.array([[5, 2000, 4099]], np.int32)
    kpos = np.arange(S, dtype=np.int32)[None]          # 2-D: the plain path
    jk, pk = {}, {}
    if int8:
        (k, ks), (v, vs) = (tuple(np.array(a) for a in jax.jit(jq)(jnp.asarray(x)))
                            for x in (k, v))
        jk = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        pk = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    want = jattend(*(jnp.asarray(a) for a in (q, k, v, qpos, kpos)), impl="jnp", **jk)
    got = attend(*(torch.from_numpy(a) for a in (q, k, v, qpos, kpos)), **pk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_model_rejects_unknown_attn_impl():
    """attn_impl takes the reference's "auto", "jnp" and "pallas"; "pallas"
    (the CUDA kernels) off the card and any other value are refused once,
    when the Model is built."""
    _, pcfg = _configs()
    Model(pcfg, device="cpu")
    Model(dataclasses.replace(pcfg, attn_impl="jnp"), device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        Model(dataclasses.replace(pcfg, attn_impl="pallas"), device="cpu")
    with pytest.raises(ValueError, match="attn_impl"):
        Model(dataclasses.replace(pcfg, attn_impl="flash"), device="cpu")


@pytest.mark.parametrize("d,dtype", [(4096, torch.bfloat16), (576, torch.float32)])
def test_norm_row_does_not_depend_on_row_count_on_cpu(d, dtype):
    """On the CPU the norms keep torch's row mean (``models/common.row_mean``),
    whose rows already do not depend on how many rows come with them, as the
    card's folded mean's do not (``tests/test_torch_card.py``)."""
    from repro_torch.models.common import layer_norm, rms_norm

    g = torch.Generator().manual_seed(d)
    x = (torch.randn(4092, d, generator=g) * 3).to(dtype)
    scale = torch.rand(d, generator=g) + 0.5
    bias = torch.randn(d, generator=g)
    for norm in (lambda t: rms_norm(t, scale), lambda t: layer_norm(t, scale, bias)):
        one = norm(x[:1])
        for m in (4, 24, 88, 300, 4092):
            assert torch.equal(norm(x[:m])[:1], one), m
        assert torch.equal(norm(x[:24].view(4, 6, d))[:, 0], norm(x[:24:6])), "(B, T, D)"
