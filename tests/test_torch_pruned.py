"""The port's pruned drafter (paper Table 5) and truncated stacks against the
JAX package.

A forward over the first ``num_layers`` layers (final norm and ``lm_head``
still applied) must match the reference's within f32 summation order
(1e-4); greedy (T = 0) pruned drafting must give the reference's tokens
exactly for the bf16 and W8A8 verifiers on ``smollm-135m`` ``.reduced()``
(f32) with the same bridged weights; inside the port pruned drafting stays
lossless (pruned == vanilla at T = 0) and at T > 0 each row's drafts come
from that row's generator alone.
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
from repro.serving.engine import SpecEngine as JSpecEngine
from repro_torch.bridge import cache_to_numpy, from_jax_params
from repro_torch.configs import get_config
from repro_torch.core import prng
from repro_torch.core.config import SpecConfig
from repro_torch.core.drafters import PrunedDrafter
from repro_torch.core.protocols import get_drafter
from repro_torch.models import Model
from repro_torch.serving.engine import SpecEngine
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

N_NEW, GAMMA = 12, 3


def _prompt(V=256, B=2, reps=5, seed=0):
    rng = np.random.default_rng(seed)
    return np.tile(rng.integers(0, V, 6), reps)[None, :].repeat(B, 0).astype(np.int32)


def _cfgs(kv="bf16", layers=None):
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), kv_cache_dtype=kv)
    pcfg = dataclasses.replace(get_config("smollm-135m").reduced(), kv_cache_dtype=kv)
    if layers:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        pcfg = dataclasses.replace(pcfg, num_layers=layers)
    return jcfg, pcfg


@functools.lru_cache(maxsize=None)
def _jax_params(layers=None):
    return JModel(_cfgs(layers=layers)[0]).init_params(jax.random.PRNGKey(0))


@pytest.mark.parametrize("num_layers", [1, 2, 3])
def test_truncated_stack_matches_jax(num_layers):
    """Forward, prefill and decode over the first layers of a 4-layer model."""
    jcfg, pcfg = _cfgs(layers=4)
    jm, pm = JModel(jcfg), Model(pcfg, device="cpu")
    jparams = _jax_params(4)
    params = from_jax_params(jax.tree.map(np.asarray, jparams), pcfg, device="cpu")
    toks = _prompt(seed=4)[:, :24]
    jl, _ = jax.jit(functools.partial(jm.forward, num_layers=num_layers))(
        jparams, jnp.asarray(toks))
    pl, _ = pm.forward(params, torch.from_numpy(toks), num_layers=num_layers)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)

    start = np.full((2,), 20, np.int32)
    jc = jm.prefill(jparams, jm.init_cache(2, 32, num_layers), jnp.asarray(toks[:, :20]),
                    num_layers=num_layers)
    jl, jc = jm.decode_step(jparams, jc, jnp.asarray(toks[:, 20:21]), jnp.asarray(start),
                            num_layers=num_layers)
    pc = pm.prefill(params, pm.init_cache(2, 32, num_layers), torch.from_numpy(toks[:, :20]),
                    num_layers=num_layers)
    assert len(pc["layers"]) == num_layers
    pl, pc = pm.decode_step(params, pc, torch.from_numpy(toks[:, 20:21]),
                            torch.from_numpy(start), num_layers=num_layers)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for lj, lp in zip(jax.tree.map(np.asarray, jc)["layers"], cache_to_numpy(pc)["layers"]):
        for name in lj:
            np.testing.assert_allclose(lp[name], lj[name], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("verifier,kv", [("bf16", "bf16"), ("w8a8", "bf16"),
                                         ("w8a8", "int8")])
def test_pruned_greedy_tokens_match_jax(verifier, kv):
    jcfg, pcfg = _cfgs(kv, layers=4)
    jscfg = JSpecConfig(temperature=0.0, gamma=GAMMA, drafter="pruned", verifier=verifier,
                        pruned_retention=0.5)
    want = JSpecEngine(JModel(jcfg), jscfg).generate(_jax_params(4), jnp.asarray(_prompt()),
                                                     N_NEW)
    params = from_jax_params(jax.tree.map(np.asarray, _jax_params(4)), pcfg, device="cpu")
    scfg = SpecConfig(temperature=0.0, gamma=GAMMA, drafter="pruned", verifier=verifier,
                      pruned_retention=0.5)
    got = SpecEngine(Model(pcfg, device="cpu"), scfg).generate(
        params, torch.from_numpy(_prompt()), N_NEW)
    P = _prompt().shape[1]
    np.testing.assert_array_equal(got.tokens[:, :P + N_NEW].numpy(),
                                  np.asarray(want.tokens)[:, :P + N_NEW])
    assert got.steps == want.steps and not bool(got.bad.any())


@pytest.fixture(scope="module")
def port_model_params():
    _, pcfg = _cfgs(layers=4)
    model = Model(pcfg, device="cpu")
    return model, model.init_params(torch.Generator().manual_seed(1))


@pytest.mark.parametrize("verifier", ["bf16", "w8a8", "w4a8"])
def test_pruned_equals_vanilla_in_port(port_model_params, verifier):
    """Pruned drafting stays lossless (the reference's
    ``tests/test_spec_engine.py::test_pruned_drafter_lossless``)."""
    model, params = port_model_params
    prompt = torch.from_numpy(_prompt(seed=2))
    out = {}
    for drafter in ("pruned", "vanilla"):
        scfg = SpecConfig(temperature=0.0, gamma=GAMMA, drafter=drafter, verifier=verifier,
                          pruned_retention=0.5)
        out[drafter] = SpecEngine(model, scfg).generate(params, prompt, N_NEW)
    P = prompt.shape[1]
    assert torch.equal(out["pruned"].tokens[:, :P + N_NEW], out["vanilla"].tokens[:, :P + N_NEW])


def test_pruned_drafter_state_and_config(port_model_params):
    model, params = port_model_params
    d = get_drafter("pruned", SpecConfig(gamma=4, pruned_retention=0.75, temperature=0.5))
    assert isinstance(d, PrunedDrafter) and d.gamma == 4 and d.temperature == 0.5
    assert d.n_keep(model) == 3 and d.with_temperature(0.0).temperature == 0.0
    assert d.with_temperature(0.0).retention == 0.75
    assert PrunedDrafter(retention=0.01).n_keep(model) == 1
    empty = d.alloc_state(model, params, 2, 40)
    assert len(empty["layers"]) == 3 and not bool(empty["layers"][0]["k"].any())
    prompts = torch.from_numpy(_prompt())
    state = d.init_state(model, params, prompts, 40)
    want = model.prefill(params, model.init_cache(2, 40, 3), prompts[:, :-1], num_layers=3)
    for a, b in zip(state["layers"], want["layers"]):
        assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_pruned_sampled_drafts_come_from_each_rows_generator(port_model_params):
    """At T > 0 row b's drafts depend on its own generator only: the same
    row drafts the same tokens alone or beside another row, and q is a
    distribution per draft."""
    model, params = port_model_params
    d = PrunedDrafter(gamma=GAMMA, retention=0.5, temperature=1.0)
    prompts = torch.from_numpy(np.stack([_prompt(seed=1)[0], _prompt(seed=2)[0]]))
    P = prompts.shape[1]
    tokens = torch.zeros((2, P + 8), dtype=torch.int32)
    tokens[:, :P] = prompts
    length = torch.full((2,), P, dtype=torch.int32)
    both, _ = d.propose(model, params, tokens, length,
                        d.init_state(model, params, prompts, P + 8),
                        prng.row_generators([7, 8], "cpu"))
    alone, _ = d.propose(model, params, tokens[1:], length[1:],
                         d.init_state(model, params, prompts[1:], P + 8),
                         prng.row_generators([8], "cpu"))
    assert torch.equal(both.tokens[1:], alone.tokens)
    assert both.probs.shape == (2, GAMMA, model.cfg.vocab_size)
    torch.testing.assert_close(both.probs.sum(-1), torch.ones(2, GAMMA))


def test_serve_cli_pruned_retention_flag():
    from repro_torch.launch import serve

    r = serve.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                    "--verifier", "w8a8", "--drafter", "pruned", "--pruned-retention", "0.5",
                    "--batch", "2", "--prompt-len", "24", "--new-tokens", "6"])
    assert r.new_tokens == 12 and not bool(r.bad.any())


def test_pruned_draft_params_feed_only_the_draft_prefill_as_in_jax():
    """The reference prefills the draft cache with ``draft_params`` but
    proposes with the verifier's params (``repro/core/drafters.py``
    ``PrunedDrafter.init_state`` / ``propose``); the port keeps that
    behaviour, and the tokens stay the reference's (and lossless)."""
    jcfg, pcfg = _cfgs(layers=4)
    other = JModel(jcfg).init_params(jax.random.PRNGKey(9))
    jscfg = JSpecConfig(temperature=0.0, gamma=GAMMA, drafter="pruned", verifier="bf16",
                        pruned_retention=0.5)
    want = JSpecEngine(JModel(jcfg), jscfg).generate(
        _jax_params(4), jnp.asarray(_prompt()), N_NEW, draft_params=other)
    model = Model(pcfg, device="cpu")
    to_port = lambda t: from_jax_params(jax.tree.map(np.asarray, t), pcfg, device="cpu")  # noqa: E731
    scfg = SpecConfig(temperature=0.0, gamma=GAMMA, drafter="pruned", verifier="bf16",
                      pruned_retention=0.5)
    params, draft = to_port(_jax_params(4)), to_port(other)
    got = SpecEngine(model, scfg).generate(params, torch.from_numpy(_prompt()), N_NEW,
                                           draft_params=draft)
    P = _prompt().shape[1]
    np.testing.assert_array_equal(got.tokens[:, :P + N_NEW].numpy(),
                                  np.asarray(want.tokens)[:, :P + N_NEW])
    van = SpecEngine(model, dataclasses.replace(scfg, drafter="vanilla")).generate(
        params, torch.from_numpy(_prompt()), N_NEW)
    assert torch.equal(got.tokens[:, :P + N_NEW], van.tokens[:, :P + N_NEW])
