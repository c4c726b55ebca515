"""The port's drafting, verification and serving engine against the JAX
package, plus the port's own lossless gate and its import hygiene.

Greedy (T = 0) generation must give the reference's tokens exactly for
every drafter × verifier × KV-cache dtype on ``smollm-135m`` ``.reduced()``
with the same (bridged) weights.  At T > 0 the port is handed the exact
noise that ``jax.random`` drew, so its accept/reject decisions and samples
must match too.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import prng as jprng
from repro.core.config import SpecConfig as JSpecConfig
from repro.core.drafting import draft_tokens as jdraft
from repro.core.verification import verify as jverify
from repro.models import Model as JModel
from repro.serving.engine import SpecEngine as JSpecEngine
from repro_torch.bridge import from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.config import SpecConfig
from repro_torch.core.drafting import draft_tokens
from repro_torch.core.verification import verify
from repro_torch.models import Model
from repro_torch.serving.engine import SpecEngine
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

SRC = Path(__file__).resolve().parent.parent / "src"
N_NEW, GAMMA = 12, 4


def _prompt(V=256, B=2, reps=5, seed=0):
    rng = np.random.default_rng(seed)
    pat = rng.integers(0, V, 6)
    return np.tile(pat, reps)[None, :].repeat(B, 0).astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
def test_draft_tokens_match_jax(seed):
    rng = np.random.default_rng(seed)
    B, S = 4, 48
    toks = rng.integers(0, 6 if seed % 2 else 40, (B, S)).astype(np.int32)
    length = rng.integers(1, S, B).astype(np.int32)
    for gamma in (0, 3, 5):
        want = jdraft(jnp.asarray(toks), jnp.asarray(length), gamma=gamma)
        got = draft_tokens(torch.from_numpy(toks), torch.from_numpy(length), gamma=gamma)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _logits_and_drafts(seed, B=3, gamma=4, V=50):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, gamma + 1, V)) * 3).astype(np.float32)
    drafts = rng.integers(0, V, (B, gamma)).astype(np.int32)
    # make some drafts the argmax so acceptance lengths vary
    top = logits.argmax(-1)
    drafts[0, :] = top[0, :gamma]
    drafts[1, :2] = top[1, :2]
    return logits, drafts


@pytest.mark.parametrize("gamma", [0, 4])
def test_verify_greedy_matches_jax(gamma):
    logits, drafts = _logits_and_drafts(1, gamma=gamma)
    want = jverify(jnp.asarray(logits), jnp.asarray(drafts), 0.0, jax.random.PRNGKey(0))
    got = verify(torch.from_numpy(logits), torch.from_numpy(drafts), 0.0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("gamma,temperature,seed",
                         [(4, 1.0, 0), (4, 0.7, 1), (2, 1.5, 2), (0, 1.0, 3)])
def test_verify_sampled_matches_jax_with_jax_noise(gamma, temperature, seed):
    logits, drafts = _logits_and_drafts(seed, gamma=gamma)
    B, _, V = logits.shape
    key = jax.random.PRNGKey(seed)
    want = jverify(jnp.asarray(logits), jnp.asarray(drafts), temperature, key)
    k_acc, k_res, k_bonus = jprng.split3(key)
    # jax.random.categorical(k, logp) is argmax(logp + gumbel(k, logp.shape))
    noise = dict(
        uniforms=torch.from_numpy(np.array(jax.random.uniform(k_acc, (B, gamma)))),
        gumbel_res=torch.from_numpy(np.array(jax.random.gumbel(k_res, (B, V)))),
        gumbel_bonus=torch.from_numpy(np.array(jax.random.gumbel(k_bonus, (B, V)))))
    got = verify(torch.from_numpy(logits), torch.from_numpy(drafts), temperature, **noise)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # without noise the rows draw from their own generators, reproducibly
    gens = lambda: [torch.Generator().manual_seed(i) for i in range(B)]  # noqa: E731
    r1 = verify(torch.from_numpy(logits), torch.from_numpy(drafts), temperature, gens())
    r2 = verify(torch.from_numpy(logits), torch.from_numpy(drafts), temperature, gens())
    assert all(torch.equal(a, b) for a, b in zip(r1, r2))


def _cfgs(kv):
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), kv_cache_dtype=kv)
    pcfg = dataclasses.replace(get_config("smollm-135m").reduced(), kv_cache_dtype=kv)
    return jcfg, pcfg


@functools.lru_cache(maxsize=None)
def _jax_params():
    return JModel(_cfgs("bf16")[0]).init_params(jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _jax_tokens(drafter, verifier, kv):
    jcfg, _ = _cfgs(kv)
    scfg = JSpecConfig(temperature=0.0, gamma=GAMMA, drafter=drafter, verifier=verifier)
    r = JSpecEngine(JModel(jcfg), scfg).generate(_jax_params(), jnp.asarray(_prompt()), N_NEW)
    return np.asarray(r.tokens)


def _port_generate(drafter, verifier, kv):
    _, pcfg = _cfgs(kv)
    params = from_jax_params(jax.tree.map(np.asarray, _jax_params()), pcfg, device="cpu")
    scfg = SpecConfig(temperature=0.0, gamma=GAMMA, drafter=drafter, verifier=verifier)
    return SpecEngine(Model(pcfg, device="cpu"), scfg).generate(
        params, torch.from_numpy(_prompt()), N_NEW)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("verifier", ["bf16", "w8a8"])
@pytest.mark.parametrize("drafter", ["ngram", "vanilla"])
def test_generate_greedy_tokens_match_jax(drafter, verifier, kv):
    r = _port_generate(drafter, verifier, kv)
    P = _prompt().shape[1]
    np.testing.assert_array_equal(r.tokens[:, :P + N_NEW].numpy(),
                                  _jax_tokens(drafter, verifier, kv)[:, :P + N_NEW])
    assert not bool(r.bad.any())
    assert r.new_tokens == 2 * N_NEW and 1.0 <= r.mean_accept_len <= GAMMA + 1


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("verifier", ["bf16", "w8a8"])
def test_spec_equals_vanilla_in_port(verifier, kv):
    """The reference's own lossless gate, inside the port."""
    _, pcfg = _cfgs(kv)
    model = Model(pcfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(1))
    prompt = torch.from_numpy(_prompt(seed=2))
    out = {}
    for drafter in ("ngram", "vanilla"):
        scfg = SpecConfig(temperature=0.0, gamma=GAMMA, drafter=drafter, verifier=verifier)
        out[drafter] = SpecEngine(model, scfg).generate(params, prompt, N_NEW)
    P = prompt.shape[1]
    assert torch.equal(out["ngram"].tokens[:, :P + N_NEW], out["vanilla"].tokens[:, :P + N_NEW])
    assert out["ngram"].steps <= out["vanilla"].steps


@pytest.mark.parametrize("verifier", ["bf16", "w8a8"])
def test_nan_activation_sets_bad_row(verifier):
    """A NaN planted in one row's activations (an embedding row only that
    row's prompt uses) must reach that row's verifier logits and set its
    ``bad`` flag, through every W8A8 linear and lm_head; the other row
    stays clean."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), tie_embeddings=False)
    model = Model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(1))
    prompt = torch.from_numpy(_prompt(seed=2))
    poison = int(np.setdiff1d(np.arange(cfg.vocab_size), prompt.numpy())[0])
    prompt[0, 10] = poison
    with torch.no_grad():
        params.embed.w[poison] = float("nan")
    scfg = SpecConfig(temperature=0.0, gamma=GAMMA, drafter="ngram", verifier=verifier)
    r = SpecEngine(model, scfg).generate(params, prompt, 4)
    assert r.bad.tolist() == [True, False]


def _run(args, **kw):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          env=env, timeout=120, **kw)


def test_serve_cli_cpu_prints_acceptance_length():
    p = _run(["-m", "repro_torch.launch.serve", "--arch", "smollm-135m", "--reduced",
              "--device", "cpu", "--verifier", "w8a8", "--kv-cache", "int8",
              "--gamma", "4", "--batch", "2", "--prompt-len", "24", "--new-tokens", "8"])
    assert p.returncode == 0, p.stderr
    assert "mean acceptance length L=" in p.stdout


def test_serve_cli_without_card_exits_with_message():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device works")
    p = _run(["-m", "repro_torch.launch.serve", "--reduced"])
    assert p.returncode != 0
    assert "CUDA card" in p.stderr
    with pytest.raises(RuntimeError, match="CUDA card"):
        Model(get_config("smollm-135m").reduced())


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "             or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    p = _run(["-c", code])
    assert p.returncode == 0, p.stderr
    assert int(p.stdout.strip()) >= 25
