"""The last four families through the port's serving engine against the
JAX package, on the CPU: ``SpecEngine.generate`` greedy tokens, L and
verify steps for ``codeqwen1.5-7b``, ``stablelm-12b``,
``llama-3.2-vision-90b`` and ``whisper-small`` (reduced, f32) × {ngram,
vanilla} × {bf16, w8a8}, plus the token tree (codeqwen, whisper), the
pruned drafter (vision), W4A8 (stablelm) and an int8 KV cache (codeqwen);
the image and audio embeddings go through ``generate`` and, one slice per
request, through ``generate_requests``; the paged layout is refused for
the cross-attention models with the reference's message; the serve CLI
runs whisper and vision.  Tokens and step counts compare exactly; L is a
ratio of those counts.  The vision cross gates are at 0.5 (shared setup,
``test_torch_families.py``), so the image moves the tokens.

Also T = 1 sampling on an MoE (phi3.5-moe, reduced: dropless) and an SSM
(mamba2, equal-length prompts) decoder: scheduled requests through two
slots equal each request served alone.
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
from repro_torch.configs import get_config
from repro_torch.core.config import SpecConfig
from repro_torch.models import Model
from repro_torch.serving.engine import SpecEngine
from repro_torch.serving.request import GenerationRequest
from test_torch_families import ARCHS, MODALITY, _aux, _cfgs, _jax_tree, _port_params
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

N_NEW, GAMMA = 10, 4
SPEC_KW = {"ngram": dict(drafter="ngram"), "vanilla": dict(drafter="vanilla"),
           "pruned": dict(drafter="pruned", pruned_retention=0.5),
           "tree": dict(drafter="ngram-tree", tree_branches=(2, 2, 1))}


def _prompts(V=256, B=3, seed=0):
    """Rows of different repeated patterns, so prompt lookup finds drafts."""
    pat = np.random.default_rng(seed).integers(0, V, (B, 6))
    return np.tile(pat, 4).astype(np.int32)


def _scfg(cls, drafter, verifier):
    kw = dict(SPEC_KW[drafter])
    if drafter != "tree":
        kw["gamma"] = GAMMA
    return cls(temperature=0.0, verifier=verifier, **kw)


@functools.lru_cache(maxsize=None)
def _jax_run(arch, drafter, verifier, kv="bf16"):
    import dataclasses

    jcfg = dataclasses.replace(_cfgs(arch)[0], kv_cache_dtype=kv)
    aux = _aux(arch)
    r = JSpecEngine(JModel(jcfg), _scfg(JSpecConfig, drafter, verifier)).generate(
        _jax_tree(arch), jnp.asarray(_prompts()), N_NEW,
        aux_embeds=None if aux is None else jnp.asarray(aux))
    return (np.asarray(r.tokens)[:, :_prompts().shape[1] + N_NEW], r.mean_accept_len,
            r.steps)


@functools.lru_cache(maxsize=None)
def _port_run(arch, drafter, verifier, kv="bf16"):
    import dataclasses

    pcfg = dataclasses.replace(_cfgs(arch)[1], kv_cache_dtype=kv)
    aux = _aux(arch)
    r = SpecEngine(Model(pcfg, device="cpu"), _scfg(SpecConfig, drafter, verifier)).generate(
        _port_params(arch), torch.from_numpy(_prompts()), N_NEW,
        aux_embeds=None if aux is None else torch.from_numpy(aux))
    assert not bool(r.bad.any())
    return r.tokens[:, :_prompts().shape[1] + N_NEW].numpy(), r.mean_accept_len, r.steps


CASES = ([(a, d, v, "bf16") for a in ARCHS for d in ("ngram", "vanilla")
          for v in ("bf16", "w8a8")]
         + [("codeqwen1.5-7b", "tree", "w8a8", "bf16"), ("whisper-small", "tree", "w8a8", "bf16"),
            ("llama-3.2-vision-90b", "pruned", "w8a8", "bf16"),
            ("stablelm-12b", "ngram", "w4a8", "bf16"),
            ("codeqwen1.5-7b", "ngram", "w8a8", "int8")])


@pytest.mark.parametrize("arch,drafter,verifier,kv", CASES)
def test_generate_greedy_tokens_match_jax(arch, drafter, verifier, kv):
    """Greedy tokens, L and verify steps are the reference's, with the
    embeddings for vision and whisper; the tokens are vanilla's (the port's
    counterpart of ``tests/test_serving_modalities.py``)."""
    got, L, steps = _port_run(arch, drafter, verifier, kv)
    want, jL, jsteps = _jax_run(arch, drafter, verifier, kv)
    np.testing.assert_array_equal(got, want)
    assert (L, steps) == (pytest.approx(jL, abs=1e-6), jsteps)
    np.testing.assert_array_equal(got, _port_run(arch, "vanilla", verifier, kv)[0])
    assert L >= 1.0


def test_embeddings_move_the_tokens():
    """Other embeddings, other tokens (the cross path is live in both
    families' runs); no embeddings reads the zeroed cross caches, as the
    reference's serve CLI does."""
    for arch in MODALITY:
        pcfg = _cfgs(arch)[1]
        eng = SpecEngine(Model(pcfg, device="cpu"), _scfg(SpecConfig, "vanilla", "bf16"))
        runs = [eng.generate(_port_params(arch), torch.from_numpy(_prompts()), N_NEW,
                             aux_embeds=aux).tokens
                for aux in (torch.from_numpy(_aux(arch)), torch.from_numpy(_aux(arch, seed=5)),
                            None)]
        assert not torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
        jr = JSpecEngine(JModel(_cfgs(arch)[0]), _scfg(JSpecConfig, "vanilla", "bf16")).generate(
            _jax_tree(arch), jnp.asarray(_prompts()), N_NEW)
        np.testing.assert_array_equal(runs[2].numpy()[:, :24 + N_NEW],
                                      np.asarray(jr.tokens)[:, :24 + N_NEW])


def _requests(cls):
    """Three prompts of different lengths, budgets and seeds."""
    pats = np.random.default_rng(3).integers(0, 256, (3, 6))
    return [cls(np.tile(p, k)[:n], max_new_tokens=m, seed=s)
            for p, k, n, m, s in zip(pats, (3, 4, 3), (18, 22, 15), (6, 9, 7), (11, 22, 33))]


def test_generate_requests_with_aux_matches_jax():
    """Three requests through two slots of the contiguous cache, each with
    its own image embeddings (sliced in request order): admission prefills
    the row's cross caches with the rest of its row; per-request greedy
    tokens equal the reference's and the request served alone.  (whisper
    admits through the same prefill, its encoder in front.)"""
    arch = "llama-3.2-vision-90b"
    jcfg, pcfg = _cfgs(arch)
    aux = _aux(arch, B=3, seed=6)
    kw = dict(temperature=0.0, gamma=3, drafter="ngram")
    jeng = JSpecEngine(JModel(jcfg), JSpecConfig(**kw), verifier="w8a8")
    want = jeng.generate_requests(_jax_tree(arch), _requests(JRequest), batch_slots=2,
                                  aux_embeds=jnp.asarray(aux))
    eng = SpecEngine(Model(pcfg, device="cpu"), SpecConfig(**kw), verifier="w8a8")
    params = eng.prepare_params(_port_params(arch))
    reqs = _requests(GenerationRequest)
    got = eng.generate_requests(params, reqs, batch_slots=2, aux_embeds=torch.from_numpy(aux))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.tokens, np.asarray(b.tokens))
    assert eng.step_traces == jeng.step_traces
    alone = eng.generate_requests(params, reqs[1:2], batch_slots=1,
                                  aux_embeds=torch.from_numpy(aux[1:2]))[0]
    np.testing.assert_array_equal(alone.tokens, got[1].tokens)


@pytest.mark.parametrize("arch", MODALITY)
def test_paged_layout_refused_as_in_jax(arch):
    jcfg, pcfg = _cfgs(arch)
    paged = dict(kv_layout="paged", kv_block_size=8)
    with pytest.raises(ValueError) as jerr:
        JSpecEngine(JModel(jcfg), JSpecConfig(**paged)).generate_requests(
            _jax_tree(arch), _requests(JRequest))
    with pytest.raises(ValueError) as perr:
        SpecEngine(Model(pcfg, device="cpu"), SpecConfig(**paged)).generate_requests(
            _port_params(arch), _requests(GenerationRequest))
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("arch", MODALITY)
def test_serve_cli_runs_reduced(arch, capsys):
    """``--arch`` takes the cross-attention models; the CLI passes no
    embeddings (as the reference's), so the cross caches stay zero."""
    from repro_torch.launch import serve

    r = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--verifier", "w8a8",
                    "--drafter", "ngram", "--batch", "2", "--prompt-len", "24",
                    "--new-tokens", "8"])
    assert "L=" in capsys.readouterr().out
    assert r.new_tokens == 16 and not bool(r.bad.any())


@pytest.mark.parametrize("arch,prompt_len", [("phi3.5-moe-42b-a6.6b", None),
                                             ("mamba2-370m", 18)])
def test_moe_and_ssm_scheduled_sampling_matches_solo(arch, prompt_len):
    """T = 1: five requests through two slots (slots recycled, rows reset in
    place) each equal the request served alone, on a dropless MoE decoder
    and an SSM decoder (equal-length prompts, as its recurrent cache
    needs); each row draws from its own request's generator."""
    cfg = get_config(arch).reduced()
    model = Model(cfg, device="cpu")
    raw = model.init_params(torch.Generator().manual_seed(3))
    pat = np.random.default_rng(4).integers(0, cfg.vocab_size, 6)
    reqs = [GenerationRequest(np.tile(pat, k)[:prompt_len], max_new_tokens=n, seed=k)
            for k, n in ((5, 9), (4, 12), (3, 7), (6, 5), (4, 10))]
    eng = SpecEngine(model, SpecConfig(temperature=1.0, gamma=3, drafter="ngram",
                                       verifier="w8a8"))
    params = eng.prepare_params(raw)
    got = eng.generate_requests(params, reqs, batch_slots=2)
    for r, req in zip(got, reqs):
        alone = eng.generate_requests(params, [req], batch_slots=1)[0]
        np.testing.assert_array_equal(r.tokens, alone.tokens)
        assert r.new_tokens == req.max_new_tokens and not r.bad
