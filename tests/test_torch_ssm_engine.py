"""The port's SSM and hybrid decoders through the serving engine against
the JAX package, on the CPU: ``SpecEngine.generate`` greedy tokens, L and
step counts for ``mamba2-370m`` and ``zamba2-2.7b`` (reduced) × {ngram,
vanilla, pruned} × {bf16, w8a8, w4a8}, with int8 KV on zamba2's shared
attention once; contiguous ``generate_requests``; and the refusals (tree,
paged, the serving loop, heterogeneous prompt lengths, ``collect_states``
past the sequential path) with the reference's types and messages.  The
modules themselves are held in ``test_torch_ssm.py``, whose setup this
file shares.  Tokens and step counts compare exactly; L is a ratio of
those counts.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import SpecConfig as JSpecConfig
from repro.models import Model as JModel
from repro.serving.engine import SpecEngine as JSpecEngine
from repro.serving.request import GenerationRequest as JRequest
from repro.serving.server import ServingLoop as JServingLoop
from repro_torch.core.config import SpecConfig
from repro_torch.models import Model
from repro_torch.serving.engine import SpecEngine
from repro_torch.serving.request import GenerationRequest
from repro_torch.serving.server import ServingLoop
from test_torch_ssm import ARCHS, _cfgs, _jax_params, _port_params
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

N_NEW, GAMMA = 10, 4
SPEC_KW = {"ngram": dict(drafter="ngram"), "vanilla": dict(drafter="vanilla"),
           "pruned": dict(drafter="pruned", pruned_retention=0.5)}


def _prompts(V=256, B=3, seed=0):
    """Rows of different repeated patterns, so prompt lookup finds drafts."""
    pat = np.random.default_rng(seed).integers(0, V, (B, 6))
    return np.tile(pat, 4).astype(np.int32)


def _kv(arch, kv):
    jcfg, pcfg = _cfgs(arch)
    return (dataclasses.replace(jcfg, kv_cache_dtype=kv),
            dataclasses.replace(pcfg, kv_cache_dtype=kv))


@functools.lru_cache(maxsize=None)
def _jax_prepared(arch, verifier):
    """The reference's prepared weights, once per verifier (preparing a
    prepared tree again is the identity, so every drafter's engine takes
    them as they are)."""
    return JSpecEngine(JModel(_cfgs(arch)[0]), JSpecConfig(verifier=verifier)).prepare_params(
        _jax_params(arch))


@functools.lru_cache(maxsize=None)
def _port_prepared(arch, verifier):
    return SpecEngine(Model(_cfgs(arch)[1], device="cpu"),
                      SpecConfig(verifier=verifier)).prepare_params(_port_params(arch))


@functools.lru_cache(maxsize=None)
def _jax_run(arch, drafter, verifier, kv="bf16"):
    jcfg, _ = _kv(arch, kv)
    scfg = JSpecConfig(temperature=0.0, gamma=GAMMA, verifier=verifier, **SPEC_KW[drafter])
    r = JSpecEngine(JModel(jcfg), scfg).generate(_jax_prepared(arch, verifier),
                                                 jnp.asarray(_prompts()), N_NEW)
    return (np.asarray(r.tokens)[:, :_prompts().shape[1] + N_NEW], r.mean_accept_len,
            r.steps)


@functools.lru_cache(maxsize=None)
def _port_run(arch, drafter, verifier, kv="bf16"):
    _, pcfg = _kv(arch, kv)
    scfg = SpecConfig(temperature=0.0, gamma=GAMMA, verifier=verifier, **SPEC_KW[drafter])
    r = SpecEngine(Model(pcfg, device="cpu"), scfg).generate(
        _port_prepared(arch, verifier), torch.from_numpy(_prompts()), N_NEW)
    assert not bool(r.bad.any())
    return r.tokens[:, :_prompts().shape[1] + N_NEW].numpy(), r.mean_accept_len, r.steps


@pytest.mark.parametrize("verifier", ["bf16", "w8a8", "w4a8"])
@pytest.mark.parametrize("drafter", ["ngram", "vanilla", "pruned"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_greedy_tokens_match_jax(arch, drafter, verifier):
    """Greedy tokens, L and verify steps are the reference's, and the
    tokens are vanilla's (lossless speculation over the rollback commit).
    The pruned drafter's SSM draft states run on past rejected drafts
    without rollback, in both, so its L is the reference's too."""
    got, L, steps = _port_run(arch, drafter, verifier)
    want, jL, jsteps = _jax_run(arch, drafter, verifier)
    np.testing.assert_array_equal(got, want)
    assert (L, steps) == (pytest.approx(jL, abs=1e-6), jsteps)
    np.testing.assert_array_equal(got, _port_run(arch, "vanilla", verifier)[0])


def test_generate_with_int8_kv_matches_jax():
    """zamba2's shared attention over an int8 KV cache."""
    got, L, steps = _port_run("zamba2-2.7b", "ngram", "w8a8", "int8")
    want, jL, jsteps = _jax_run("zamba2-2.7b", "ngram", "w8a8", "int8")
    np.testing.assert_array_equal(got, want)
    assert (L, steps) == (pytest.approx(jL, abs=1e-6), jsteps)


def _requests(cls):
    """Equal-length prompts, different budgets and seeds."""
    pats = np.random.default_rng(3).integers(0, 256, (4, 6))
    return [cls(np.tile(p, 3), max_new_tokens=n, seed=s)
            for p, n, s in zip(pats, (6, 9, 7, 5), (11, 22, 33, 44))]


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_requests_contiguous_matches_jax(arch):
    """Four requests through two slots of the contiguous cache: admission
    resets a row's state, conv tail and shared KV in place; per-request
    greedy tokens and ``step_traces`` equal the reference's."""
    jcfg, pcfg = _cfgs(arch)
    kw = dict(temperature=0.0, gamma=3, drafter="ngram")
    jeng = JSpecEngine(JModel(jcfg), JSpecConfig(**kw), verifier="w8a8")
    want = jeng.generate_requests(_jax_prepared(arch, "w8a8"), _requests(JRequest),
                                  batch_slots=2)
    eng = SpecEngine(Model(pcfg, device="cpu"), SpecConfig(**kw), verifier="w8a8")
    got = eng.generate_requests(_port_prepared(arch, "w8a8"), _requests(GenerationRequest),
                                batch_slots=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
    assert eng.step_traces == jeng.step_traces


def _same_error(jfn, pfn):
    with pytest.raises(Exception) as jerr:
        jfn()
    with pytest.raises(Exception) as perr:
        pfn()
    assert type(perr.value) is type(jerr.value)
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("arch", ARCHS)
def test_refusals_match_jax(arch):
    """Tree speculation, the paged layout, the serving loop and
    heterogeneous prompt lengths are refused with the reference's type and
    message; so is ``collect_states`` on a window past the sequential path."""
    jcfg, pcfg = _cfgs(arch)
    jm, pm = JModel(jcfg), Model(pcfg, device="cpu")
    tree = dict(drafter="ngram-tree", tree_branches=(2, 1))
    _same_error(lambda: JSpecEngine(jm, JSpecConfig(**tree)),
                lambda: SpecEngine(pm, SpecConfig(**tree)))
    paged = dict(kv_layout="paged", kv_block_size=8)
    _same_error(lambda: JSpecEngine(jm, JSpecConfig(**paged)).generate_requests(
                    _jax_params(arch), _requests(JRequest)),
                lambda: SpecEngine(pm, SpecConfig(**paged)).generate_requests(
                    _port_params(arch), _requests(GenerationRequest)))
    _same_error(lambda: JServingLoop(JSpecEngine(jm, JSpecConfig()), _jax_params(arch)),
                lambda: ServingLoop(SpecEngine(pm, SpecConfig()), _port_params(arch)))

    def mixed(cls):
        reqs = _requests(cls)
        reqs[1] = cls(reqs[1].prompt[:-2], max_new_tokens=4)
        return reqs
    _same_error(lambda: JSpecEngine(jm, JSpecConfig()).generate_requests(
                    _jax_params(arch), mixed(JRequest)),
                lambda: SpecEngine(pm, SpecConfig()).generate_requests(
                    _port_params(arch), mixed(GenerationRequest)))
    win = np.zeros((2, 17), np.int32)
    start = np.zeros(2, np.int32)
    _same_error(lambda: jm.verify_step(_jax_params(arch), jm.init_cache(2, 64),
                                       jnp.asarray(win), jnp.asarray(start)),
                lambda: pm.verify_step(_port_params(arch), pm.init_cache(2, 64),
                                       torch.from_numpy(win), torch.from_numpy(start)))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_reduced(arch, capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--verifier", "w8a8",
                "--drafter", "ngram", "--batch", "2", "--prompt-len", "24",
                "--new-tokens", "8"])
    assert "L=" in capsys.readouterr().out
    with pytest.raises(ValueError, match="recurrent"):
        serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--kv-layout", "paged",
                    "--batch", "2", "--prompt-len", "24", "--new-tokens", "4"])
