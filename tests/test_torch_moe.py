"""The port's MoE decoders (``models/moe.py`` and what reads it) against
the JAX package, on the CPU.

Every check feeds numpy-seeded inputs, or weights bridged from the
reference's pytree, through both, in f32 on ``.reduced()`` configs (4
experts, top-2; dropless unless the capacity factor is set to 1.25, where
slots are dropped).  Tolerances: float outputs within 1e-5 (f32, the two
sum in different orders); dispatch indices, quantized weights, W8A8 expert
outputs exactly.  The engine-level checks (greedy tokens, paged serving,
the CLI) are in ``test_torch_moe_engine.py``.
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
from repro.core.config import SpecConfig as JSpecConfig
from repro.models import Model as JModel
from repro.models import moe as jmoe
from repro.quant.apply import quantize_params as jquantize_params
from repro.serving.engine import SpecEngine as JSpecEngine
from repro.serving.faults import poison_params as jpoison_params
from repro_torch.bridge import from_jax_params, tensor, to_numpy
from repro_torch.configs import get_config
from repro_torch.core.config import QuantConfig, SpecConfig
from repro_torch.kernels import ops
from repro_torch.kernels.int8_matmul import (KT, SMALL_M, gemm_plan, int8_matmul_batched,
                                             int8_matmul_batched_ref, int8_matmul_ref)
from repro_torch.models import Model, moe, transformer
from repro_torch.models.linear import W4A8Linear, W8A8ExpertLinear, W8A8Linear
from repro_torch.quant.apply import quantize_params
from repro_torch.serving.engine import SpecEngine
from repro_torch.serving.faults import poison_params

MOE_ARCHS = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b", "arctic-480b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(arch, factor=None, **kw):
    """(reference, port) reduced configs; ``factor``: the capacity factor
    (None: reduced()'s dropless one)."""
    jcfg, pcfg = jget_config(arch).reduced(), get_config(arch).reduced()
    if factor is not None:
        kw["moe_capacity_factor"] = factor
    return dataclasses.replace(jcfg, **kw), dataclasses.replace(pcfg, **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return JModel(_cfgs(arch)[0]).init_params(jax.random.PRNGKey(0))


def _port_params(arch, pcfg):
    return from_jax_params(jax.tree.map(np.asarray, _jax_params(arch)), pcfg, device="cpu")


def _moe_input(d, seed=0, B=3, T=8):
    """(B, T, d) f32 with repeated rows (they route alike, so an expert's
    queue overflows at factor 1.25) and a zero row (every probability ties)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((4, d)).astype(np.float32)
    x = base[rng.integers(0, 4, B * T)] + 0.05 * rng.standard_normal((B * T, d))
    x[3] = 0.0
    return x.astype(np.float32).reshape(B, T, d)


def _jax_dispatch(p, cfg, x):
    """The reference's routing and dispatch (``apply_moe``'s own lines, on
    its own helpers): eidx, pos, keep, slot_tok."""
    B, T, D = x.shape
    E, K, n = cfg.num_experts, cfg.experts_per_token, B * T
    logits = x.reshape(n, D).astype(jnp.float32) @ p["router"]["w"]
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    e_flat = eidx.reshape(-1)
    pos = jmoe._rank_positions(e_flat, E).reshape(n, K)
    C = jmoe.capacity(n, E, K, cfg.moe_capacity_factor)
    keep = pos < C
    keep_flat = keep.reshape(-1)
    p_flat = jnp.where(keep_flat, pos.reshape(-1), C - 1)
    slot_ids = jnp.where(keep_flat, e_flat * C + p_flat, E * C)
    slot_tok = jnp.full((E * C,), n, jnp.int32).at[slot_ids].set(
        jnp.arange(n * K, dtype=jnp.int32) // K, mode="drop")
    return dict(eidx=eidx, pos=pos, keep=keep, slot_tok=slot_tok)


@pytest.mark.parametrize("factor", [None, 1.25])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_apply_moe_matches_jax(arch, factor):
    """Outputs, aux loss and the dispatch itself (expert choice, queue
    positions, capacity keep, slot → token map) equal the reference's;
    at factor 1.25 slots are dropped, dropless none."""
    jcfg, pcfg = _cfgs(arch, factor)
    jp = _jax_params(arch)["layers"][0]["moe"]
    layer = _port_params(arch, pcfg).layers[0].moe
    x = _moe_input(jcfg.d_model)
    want_y, want_aux = jmoe.apply_moe(jp, jcfg, jnp.asarray(x))
    aux = []
    y = layer(torch.from_numpy(x), aux=aux)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(float(aux[0]), float(want_aux), rtol=1e-6)

    want = _jax_dispatch(jp, jcfg, jnp.asarray(x))
    r = moe.route(moe.router_logits(torch.from_numpy(x).reshape(-1, pcfg.d_model),
                                    layer.router.w),
                  pcfg.experts_per_token, pcfg.num_experts, pcfg.moe_capacity_factor)
    for name in ("eidx", "pos", "keep", "slot_tok"):
        np.testing.assert_array_equal(r[name].numpy(), np.asarray(want[name]), err_msg=name)
    assert bool((~r["keep"]).any()) == (factor == 1.25)


def test_top_k_ties_take_the_lower_index_as_jax():
    rng = np.random.default_rng(1)
    probs = rng.integers(0, 3, (64, 8)).astype(np.float32) / 4   # many exact ties
    probs[0] = 0.125
    for k in (1, 2, 6):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        v, i = moe.top_k(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(v.numpy(), np.asarray(wv))


@pytest.mark.parametrize("n_bins", [1, 4, 64])
def test_rank_positions_match_jax(n_bins):
    rng = np.random.default_rng(n_bins)
    ids = rng.integers(0, n_bins + 1, 300).astype(np.int32)     # n_bins: masked slots
    want = jmoe._rank_positions(jnp.asarray(ids), n_bins)
    np.testing.assert_array_equal(moe.rank_positions(torch.from_numpy(ids), n_bins).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("n,factor", [(1, 1.25), (4, 1.25), (24, 1.25), (88, 1.25),
                                      (176, 1.25), (4092, 1.25), (24, 64.0), (5, 0.1)])
def test_capacity_matches_jax(n, factor):
    assert moe.capacity(n, 64, 6, factor) == jmoe.capacity(n, 64, 6, factor)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_w8a8_expert_linear_bit_equal_to_jitted_reference(dtype):
    """``_expert_linear``'s W8A8 branch, jitted (Δx = max · f32(1/127), the
    form the reference's decode step runs), against the port's expert
    linear on the same prepared weights: bit for bit."""
    from repro.quant.int8 import quantize_batched as jquantize_batched

    rng = np.random.default_rng(2)
    E, C, din, dout = 4, 5, 64, 48
    w = (rng.standard_normal((E, din, dout)) * 0.1).astype(np.float32)
    s = (rng.random(din) * 2 + 0.25).astype(np.float32)
    jp = jquantize_batched({"w": jnp.asarray(w)}, jnp.asarray(s))
    x = (rng.standard_normal((E, C, din)) * 3).astype(np.float32)
    x[1, 2] = 0.0                                   # a zero (pad) row
    want = jax.jit(jmoe._expert_linear)(jp, jnp.asarray(x).astype(dtype))
    lin = W8A8ExpertLinear(tensor(jp["w_int8"], "cpu").transpose(1, 2).contiguous(),
                           tensor(jp["w_scale"], "cpu"), tensor(jp["smooth"], "cpu"))
    got = lin(tensor(np.asarray(jnp.asarray(x).astype(dtype)), "cpu"))
    np.testing.assert_array_equal(np.asarray(got.float()), np.asarray(want.astype(jnp.float32)))


def test_int8_matmul_batched_ref_is_per_expert_int8_matmul_ref():
    g = torch.Generator().manual_seed(0)
    E, C, K, N = 5, 7, 96, 40
    x = torch.randint(-127, 128, (E, C, K), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (E, N, K), generator=g, dtype=torch.int8)
    dx, dw = torch.rand(E, C, generator=g) * 1e-2, torch.rand(E, N, generator=g) * 1e-3
    for out_dtype in (torch.float32, torch.bfloat16):
        want = torch.stack([int8_matmul_ref(x[e], w[e], dx[e], dw[e], out_dtype)
                            for e in range(E)])
        assert torch.equal(int8_matmul_batched_ref(x, w, dx, dw, out_dtype), want)
        ops.reset_launch_counts()
        assert torch.equal(int8_matmul_batched(x, w, dx, dw, out_dtype=out_dtype), want)
        assert ops.launch_counts() == {}          # the CPU runs the plain version
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul_batched(x, w.transpose(1, 2).contiguous().transpose(1, 2), dx, dw)
    with pytest.raises(ValueError, match="dx must be"):
        int8_matmul_batched(x, w, dx[:, :3], dw)


@pytest.mark.parametrize("arch,c", [(a, c) for a in ("moonshot-v1-16b-a3b",
                                                     "phi3.5-moe-42b-a6.6b")
                                    for c in (1, 3, 6, 11, 21, 120, 257, 480)])
def test_batched_gemm_plan(arch, c):
    """The batched product's plan at an arch's expert linears: the regime
    follows C (the rows per expert) alone; swapped, a width covering C, and
    the grid holds E times one expert's W tiles, so a K split happens only
    where even that leaves the card idle (never at moonshot's 64 experts)."""
    cfg = get_config(arch)
    E, D, F = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
    for k, n in ((D, F), (F, D)):
        p = gemm_plan(c, n, k, E)
        assert p.regime == ("swap" if c <= SMALL_M else "tiled")
        if p.regime == "swap":
            assert c <= p.width and p.tile_n in (64, 128)
            one = gemm_plan(c, n, k)
            assert (p.width, p.tile_n, p.stages) == (one.width, one.tile_n, one.stages)
            assert p.cluster <= one.cluster
            if E >= 64:
                assert p.cluster == 1
            ktiles = -(-k // KT)
            assert (p.cluster - 1) * -(-ktiles // p.cluster) < ktiles
        else:
            assert p == gemm_plan(c, n, k)


@pytest.mark.parametrize("w_bits", [8, 4])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b"])
def test_quantize_params_moe_tree_bit_identical(arch, w_bits):
    """Calibration statistics (the experts' on their gathered rows, pad rows
    included), then ``quantize_params`` on the same statistics: every
    prepared leaf bit-identical to the reference's.  Under ``w_bits=4`` the
    experts stay int8, the 2-D linears go int4, the router stays f32."""
    jcfg, pcfg = _cfgs(arch)
    jparams = _jax_params(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    jstats = {}
    JModel(jcfg).forward(jparams, jnp.asarray(toks), collect=jstats)
    pstats = {}
    params = _port_params(arch, pcfg)
    Model(pcfg, device="cpu").forward(params, torch.from_numpy(toks), collect=pstats)
    assert set(pstats) == set(jstats)
    assert "layers/0/moe/up" in pstats and "layers/0/moe/down" in pstats
    for k in jstats:
        np.testing.assert_allclose(pstats[k].numpy(), np.asarray(jstats[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    stats = {k: np.asarray(v) for k, v in jstats.items()}
    jq = jquantize_params(jparams, {k: jnp.asarray(v) for k, v in stats.items()},
                          JQuantConfig(w_bits=w_bits))
    pq = quantize_params(params, {k: torch.from_numpy(v.copy()) for k, v in stats.items()},
                         QuantConfig(w_bits=w_bits))
    got = to_numpy(pq)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a), b),
                 jax.tree.map(np.asarray, jq), got)
    layer = pq.layers[0].moe
    assert all(isinstance(getattr(layer, n), W8A8ExpertLinear) for n in ("up", "gate", "down"))
    assert layer.router.w.dtype == torch.float32
    want_cls = W4A8Linear if w_bits == 4 else W8A8Linear
    assert isinstance(pq.layers[0].attn.q, want_cls)
    if arch == "arctic-480b":
        assert isinstance(layer.dense.up, want_cls)


@pytest.mark.parametrize("verifier", ["bf16", "w8a8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_round_trip(arch, verifier):
    """Raw and prepared MoE trees cross the bridge both ways bit for bit
    (expert ``w_int8`` stored (E, dout, din), transposed back)."""
    jcfg, pcfg = _cfgs(arch)
    jparams = _jax_params(arch)
    if verifier == "w8a8":
        jparams = JSpecEngine(JModel(jcfg), JSpecConfig(verifier="w8a8")).prepare_params(
            jparams)
    tree = jax.tree.map(np.asarray, jparams)
    params = from_jax_params(tree, pcfg, device="cpu")
    if verifier == "w8a8":
        up = params.layers[0].moe.up
        E, din, dout = tree["layers"][0]["moe"]["up"]["w_int8"].shape
        assert up.w_int8.shape == (E, dout, din) and up.w_int8.is_contiguous()
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(a, b), tree, to_numpy(params))


@pytest.mark.parametrize("factor", [None, 1.25])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_and_aux_match_jax(arch, factor):
    jcfg, pcfg = _cfgs(arch, factor)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab_size, (3, 12)).astype(np.int32)
    want, want_aux = JModel(jcfg).forward(_jax_params(arch), jnp.asarray(toks))
    got, aux = Model(pcfg, device="cpu").forward(_port_params(arch, pcfg),
                                                 torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("verifier", ["bf16", "w8a8"])
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "arctic-480b"])
def test_poison_params_picks_the_reference_leaf_on_moe(arch, verifier):
    """The largest float leaf, the first in the reference's sorted flatten
    order on ties (``down`` before ``gate`` and ``up``)."""
    jcfg, pcfg = _cfgs(arch)
    jprep = JSpecEngine(JModel(jcfg), JSpecConfig(verifier=verifier)).prepare_params(
        _jax_params(arch))
    jnan = [jax.tree_util.keystr(p) for p, leaf in
            jax.tree_util.tree_flatten_with_path(jpoison_params(jprep))[0]
            if jnp.issubdtype(leaf.dtype, jnp.floating) and bool(jnp.isnan(leaf).all())]
    params = SpecEngine(Model(pcfg, device="cpu"), SpecConfig(verifier=verifier)) \
        .prepare_params(_port_params(arch, pcfg))
    nan = [name.replace(".", "/") for name, t in poison_params(params).named_buffers()
           if t.is_floating_point() and bool(torch.isnan(t).all())]
    assert len(jnan) == len(nan) == 1
    assert jnan[0].replace("']['", "/").replace("'][", "/").replace("][", "/") \
        .strip("[]'").replace("'", "") == nan[0]


def test_check_supported_takes_moe_and_rejects_the_rest():
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        transformer.check_supported(cfg)
        assert set(transformer.layer_kinds(cfg)) == {"moe"}
        assert transformer.layer_kinds(cfg) == __import__(
            "repro.models.transformer", fromlist=["layer_kinds"]).layer_kinds(jget_config(arch))
    base = get_config("moonshot-v1-16b-a3b")
    for kw in (dict(arch_type="ssm"), dict(arch_type="hybrid"), dict(arch_type="vlm"),
               dict(arch_type="audio"), dict(sliding_window=64), dict(cross_attn_every=2),
               dict(encoder_layers=2)):
        with pytest.raises(NotImplementedError):
            transformer.check_supported(dataclasses.replace(base, **kw))


def test_with_config_shares_every_tensor():
    _, pcfg = _cfgs("moonshot-v1-16b-a3b", 1.25)
    params = _port_params("moonshot-v1-16b-a3b", pcfg)
    other = transformer.with_config(params, dataclasses.replace(pcfg, moe_capacity_factor=4.0))
    assert other.layers[0].moe.cfg.moe_capacity_factor == 4.0
    assert params.layers[0].moe.cfg.moe_capacity_factor == 1.25
    mine = dict(params.named_buffers())
    assert all(t is mine[name] for name, t in other.named_buffers())
