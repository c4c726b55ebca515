"""The port's MoE decoders through the serving engine against the JAX
package, on the CPU: ``SpecEngine.generate`` greedy tokens for every
drafter × verifier on a reduced ``moonshot-v1-16b-a3b`` (dropless, where
speculation equals vanilla, and at capacity factor 1.25, where slots are
dropped), paged ``generate_requests`` with ``step_traces``, and the serve
CLI.  The modules themselves are held in ``test_torch_moe.py``, whose
setup this file shares.  Tokens compare exactly.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import SpecConfig as JSpecConfig
from repro.models import Model as JModel
from repro.serving.engine import SpecEngine as JSpecEngine
from repro.serving.request import GenerationRequest as JRequest
from repro_torch.core.config import SpecConfig
from repro_torch.models import Model
from repro_torch.serving.engine import SpecEngine
from repro_torch.serving.request import GenerationRequest
from test_torch_moe import _cfgs, _jax_params, _port_params

N_NEW, GAMMA = 10, 4


def _prompts(V=256, B=3, seed=0):
    """Rows of different repeated patterns: prompt lookup finds drafts, and
    the rows route differently."""
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, V, (B, 6))
    return np.tile(pat, 5).astype(np.int32)


SPEC_KW = {"ngram": dict(drafter="ngram"), "vanilla": dict(drafter="vanilla"),
           "pruned": dict(drafter="pruned", pruned_retention=0.5),
           "ngram-tree": dict(drafter="ngram-tree", tree_branches=(2, 1, 1))}


@functools.lru_cache(maxsize=None)
def _jax_tokens(drafter, verifier, factor):
    jcfg, _ = _cfgs("moonshot-v1-16b-a3b", factor)
    scfg = JSpecConfig(temperature=0.0, gamma=GAMMA, verifier=verifier, **SPEC_KW[drafter])
    r = JSpecEngine(JModel(jcfg), scfg).generate(_jax_params("moonshot-v1-16b-a3b"),
                                                 jnp.asarray(_prompts()), N_NEW)
    return np.asarray(r.tokens)[:, :_prompts().shape[1] + N_NEW]


@functools.lru_cache(maxsize=None)
def _port_tokens(drafter, verifier, factor):
    _, pcfg = _cfgs("moonshot-v1-16b-a3b", factor)
    scfg = SpecConfig(temperature=0.0, gamma=GAMMA, verifier=verifier, **SPEC_KW[drafter])
    r = SpecEngine(Model(pcfg, device="cpu"), scfg).generate(
        _port_params("moonshot-v1-16b-a3b", pcfg), torch.from_numpy(_prompts()), N_NEW)
    assert not bool(r.bad.any())
    return r.tokens[:, :_prompts().shape[1] + N_NEW].numpy()


@pytest.mark.parametrize("verifier", ["bf16", "w8a8", "w4a8"])
@pytest.mark.parametrize("drafter", ["ngram", "vanilla", "pruned", "ngram-tree"])
def test_generate_greedy_tokens_match_jax(drafter, verifier):
    """Dropless: the port's greedy tokens are the reference's for every
    drafter × verifier, and (lossless speculation) vanilla's."""
    got = _port_tokens(drafter, verifier, None)
    np.testing.assert_array_equal(got, _jax_tokens(drafter, verifier, None))
    np.testing.assert_array_equal(got, _port_tokens("vanilla", verifier, None))


@pytest.mark.parametrize("drafter,verifier", [("ngram", "w8a8"), ("vanilla", "w8a8"),
                                              ("ngram-tree", "w4a8"), ("pruned", "bf16")])
def test_generate_with_drops_matches_jax(drafter, verifier):
    """At capacity factor 1.25 a token's output depends on its batch, so
    speculation need not equal vanilla; the port still drops exactly the
    reference's slots and gives its tokens."""
    np.testing.assert_array_equal(_port_tokens(drafter, verifier, 1.25),
                                  _jax_tokens(drafter, verifier, 1.25))


REQS = ((5, 6, 11), (4, 9, 22), (3, 7, 33), (2, 5, 44))


def _requests(cls):
    rng = np.random.default_rng(3)
    pats = rng.integers(0, 256, (len(REQS), 6))
    return [cls(np.tile(p, k), max_new_tokens=n, seed=s) for p, (k, n, s) in zip(pats, REQS)]


@pytest.mark.parametrize("drafter,verifier,factor", [("ngram", "w8a8", None),
                                                     ("ngram-tree", "w4a8", 1.25)])
def test_paged_generate_requests_match_jax(drafter, verifier, factor):
    """Four requests through two slots over the paged KV cache: per-request
    greedy tokens and ``step_traces`` equal the reference's."""
    jcfg, pcfg = _cfgs("moonshot-v1-16b-a3b", factor)
    kw = dict(temperature=0.0, gamma=3, kv_layout="paged", kv_block_size=8,
              **SPEC_KW[drafter])
    jeng = JSpecEngine(JModel(jcfg), JSpecConfig(**kw), verifier=verifier)
    want = jeng.generate_requests(_jax_params("moonshot-v1-16b-a3b"), _requests(JRequest),
                                  batch_slots=2)
    eng = SpecEngine(Model(pcfg, device="cpu"), SpecConfig(**kw), verifier=verifier)
    got = eng.generate_requests(_port_params("moonshot-v1-16b-a3b", pcfg),
                                _requests(GenerationRequest), batch_slots=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
    assert eng.step_traces == jeng.step_traces


def test_serve_cli_runs_moonshot_reduced(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "moonshot-v1-16b-a3b", "--reduced", "--device", "cpu",
                "--verifier", "w8a8", "--drafter", "ngram", "--batch", "2",
                "--prompt-len", "24", "--new-tokens", "8"])
    assert "L=" in capsys.readouterr().out
