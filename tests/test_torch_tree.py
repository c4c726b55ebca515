"""The port's token-tree speculation against the JAX package, and the
port's own chain-as-tree bit-identity.

Template tables, tree drafts, tree verification (T = 0, and T > 0 with the
noise ``jax.random`` drew handed to the port) and the tree commit must
equal the reference's exactly; the tree-masked ``flash_decode`` plain
version is held to the Pallas kernel in interpret mode at 1e-5 (f32
accumulation in another order); greedy ``ngram-tree`` generation must give
the reference's tokens for every verifier on ``smollm-135m`` ``.reduced()``
(f32).  Inside the port, any chain drafter run through the tree route
(``ChainTreeAdapter``) must reproduce the chain route bit for bit, at
T = 0 and at T > 0 on the same per-row generators.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import prng as jprng
from repro.core.config import SpecConfig as JSpecConfig
from repro.core.drafting import draft_tree_tokens as jdraft_tree
from repro.core.tree import TreeTemplate as JTreeTemplate
from repro.core.verification import verify_tree as jverify_tree
from repro.kernels.flash_decode import flash_decode as jflash
from repro.models import Model as JModel
from repro.models import transformer as jtransformer
from repro.models.attention import _quant_kv as j_quant_kv
from repro.serving.engine import SpecEngine as JSpecEngine
from repro_torch.bridge import cache_from_numpy, cache_to_numpy, from_jax_params
from repro_torch.configs import get_config
from repro_torch.core.config import SpecConfig
from repro_torch.core.drafters import ChainTreeAdapter
from repro_torch.core.drafting import draft_tree_tokens
from repro_torch.core.protocols import get_drafter
from repro_torch.core.tree import TreeTemplate
from repro_torch.core.verification import verify_tree
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import flash_decode, tree_mask_bits
from repro_torch.models import Model
from repro_torch.models import transformer
from repro_torch.serving.engine import SpecEngine
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

TEMPLATES = [(), (1, 1, 1), (2, 2), (3, 1, 2), (3, 2, 1, 1), (4, 4, 4), (64,)]
N_NEW = 12


@pytest.mark.parametrize("branches", TEMPLATES)
def test_template_tables_equal(branches):
    jt, pt = JTreeTemplate(branches), TreeTemplate(branches)
    for name in ("parents", "depths", "mask", "children", "leaves", "paths", "src_leaf"):
        np.testing.assert_array_equal(getattr(pt, name), getattr(jt, name), err_msg=name)
    for name in ("num_nodes", "max_depth", "max_branch", "num_leaves", "gamma", "is_chain"):
        assert getattr(pt, name) == getattr(jt, name), name
    tables = pt.on("cpu")
    assert tables is pt.on(torch.device("cpu"))              # built once per device
    assert torch.equal(tables.mask, torch.from_numpy(jt.mask))
    # the kernel's bit words carry the mask exactly
    bits = tables.mask_bits.numpy().view(np.uint32)
    N = pt.num_nodes
    unpacked = (bits[:, np.arange(N) // 32] >> (np.arange(N) % 32)) & 1
    np.testing.assert_array_equal(unpacked.astype(bool), jt.mask)
    assert torch.equal(tree_mask_bits(tables.mask), tables.mask_bits)
    with pytest.raises(ValueError, match="64 leaves"):
        TreeTemplate((4, 4, 4, 2))


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("branches", [(2, 1), (3, 2, 1, 1), (4, 4), (1, 1, 1, 1)])
def test_draft_tree_tokens_match_jax(branches, seed):
    rng = np.random.default_rng(seed)
    B, S = 4, 60
    toks = rng.integers(0, 5 if seed % 2 else 30, (B, S)).astype(np.int32)
    length = rng.integers(2, S, B).astype(np.int32)
    want = jdraft_tree(jnp.asarray(toks), jnp.asarray(length), JTreeTemplate(branches))
    got = draft_tree_tokens(torch.from_numpy(toks), torch.from_numpy(length),
                            TreeTemplate(branches))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tree_inputs(branches, seed, V=40, B=4, stochastic=False):
    """Logits, drafts (some on the argmax path) and optional draft q."""
    rng = np.random.default_rng(seed)
    tpl = JTreeTemplate(branches)
    N = tpl.num_nodes
    logits = (rng.standard_normal((B, N, V)) * 3).astype(np.float32)
    drafts = rng.integers(0, V, (B, N - 1)).astype(np.int32)
    top = logits.argmax(-1)
    for b in range(B):               # row b follows the argmax down b levels
        node = 0
        for _ in range(min(b, tpl.max_depth)):
            child = tpl.children[node, b % tpl.max_branch]
            if child < 0:
                break
            drafts[b, child - 1] = top[b, node]
            node = child
    q = None
    if stochastic:
        q = rng.random((B, N - 1, V)).astype(np.float32)
        q /= q.sum(-1, keepdims=True)
    return logits, drafts, q


def _check_tree_result(got, want):
    for name in ("n_accept", "next_token", "n_commit", "path_nodes", "path_tokens"):
        g, w = getattr(got, name), getattr(want, name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("branches", [(), (1, 1, 1), (2, 2), (3, 2, 1, 1)])
def test_verify_tree_greedy_matches_jax(branches):
    logits, drafts, _ = _tree_inputs(branches, 1)
    want = jverify_tree(jnp.asarray(logits), jnp.asarray(drafts), JTreeTemplate(branches),
                        0.0, jax.random.PRNGKey(0))
    got = verify_tree(torch.from_numpy(logits), torch.from_numpy(drafts),
                      TreeTemplate(branches), 0.0)
    _check_tree_result(got, want)


@pytest.mark.parametrize("branches,temperature,stochastic,seed", [
    ((2, 2), 1.0, False, 0), ((3, 2, 1, 1), 0.7, False, 1), ((1, 1, 1), 1.0, True, 2),
    ((3, 1, 2), 1.5, True, 3), ((), 1.0, False, 4)])
def test_verify_tree_sampled_matches_jax_with_jax_noise(branches, temperature,
                                                        stochastic, seed):
    logits, drafts, q = _tree_inputs(branches, seed, stochastic=stochastic)
    B, N, V = logits.shape
    jt = JTreeTemplate(branches)
    key = jax.random.PRNGKey(seed)
    want = jverify_tree(jnp.asarray(logits), jnp.asarray(drafts), jt, temperature, key,
                        draft_probs=None if q is None else jnp.asarray(q))
    k_acc, k_res, k_bonus = jprng.split3(key)
    # jax.random.categorical(k, logp) is argmax(logp + gumbel(k, logp.shape))
    noise = dict(
        uniforms=torch.from_numpy(np.array(
            jax.random.uniform(k_acc, (B, jt.max_depth * jt.max_branch)))),
        gumbel_res=torch.from_numpy(np.array(jax.random.gumbel(k_res, (B, V)))),
        gumbel_bonus=torch.from_numpy(np.array(jax.random.gumbel(k_bonus, (B, V)))))
    got = verify_tree(torch.from_numpy(logits), torch.from_numpy(drafts),
                      TreeTemplate(branches), temperature,
                      draft_probs=None if q is None else torch.from_numpy(q), **noise)
    _check_tree_result(got, want)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("branches,g", [((3, 2, 1, 1), 2), ((2, 2), 3), ((4,), 1),
                                        ((1, 1, 1), 2)])
def test_flash_decode_tree_ref_matches_pallas_interpret(branches, g, int8):
    """f32 throughout; the two sum in different orders: 1e-5."""
    tpl = TreeTemplate(branches)
    T = tpl.num_nodes
    rng = np.random.default_rng(T * g + int8)
    B, S, Hkv, dh = 2, 48, 2, 32
    q = rng.standard_normal((B, T, Hkv * g, dh)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, dh)).astype(np.float32)
    win_start = np.array([5, S - T - 3], np.int32)
    qpos = (win_start[:, None] + tpl.depths[None, :]).astype(np.int32)
    jk, pk = {}, {}
    if int8:
        (k, ks), (v, vs) = (tuple(np.array(a) for a in jax.jit(j_quant_kv)(jnp.asarray(x)))
                            for x in (k, v))
        jk = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
        pk = dict(k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    want = jflash(*(jnp.asarray(a) for a in (q, k, v, qpos)), tree_mask=jnp.asarray(tpl.mask),
                  win_start=jnp.asarray(win_start), block_s=16, interpret=True, **jk)
    ops.reset_launch_counts()
    got = flash_decode(*(torch.from_numpy(a) for a in (q, k, v, qpos)),
                       tree_mask=torch.from_numpy(tpl.mask),
                       win_start=torch.from_numpy(win_start), **pk)
    assert ops.launch_counts() == {}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_flash_decode_tree_rejects_bad_inputs():
    q = torch.zeros(1, 3, 2, 32)
    kv = torch.zeros(1, 8, 1, 32)
    qpos = torch.zeros(1, 3, dtype=torch.int32)
    mask = torch.ones(3, 3, dtype=torch.bool)
    ws = torch.zeros(1, dtype=torch.int32)
    for kw in (dict(tree_mask=mask), dict(win_start=ws),
               dict(tree_mask=mask[:2, :2], win_start=ws),
               dict(tree_mask=mask, win_start=ws.long()),
               dict(tree_mask=mask, win_start=ws, tree_bits=torch.zeros(3, 2, dtype=torch.int32)),
               dict(tree_bits=torch.zeros(3, 1, dtype=torch.int32))):
        with pytest.raises(ValueError):
            flash_decode(q, kv, kv, qpos, **kw)


@pytest.mark.parametrize("int8", [False, True])
def test_commit_cache_tree_matches_jax(int8):
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(),
                               kv_cache_dtype="int8" if int8 else "bf16")
    rng = np.random.default_rng(int8)
    jcache = jax.tree.map(np.array, JModel(jcfg).init_cache(3, 40))
    for layer in jcache["layers"]:
        for name, buf in layer.items():
            layer[name] = (rng.integers(-127, 128, buf.shape).astype(buf.dtype) if int8
                           and name in ("k", "v") else
                           rng.standard_normal(buf.shape).astype(buf.dtype))
    tpl = JTreeTemplate((3, 2, 1, 1))
    start = np.array([4, 0, 17], np.int32)
    n_accept = np.array([4, 0, 2], np.int32)
    path_nodes = np.zeros((3, tpl.max_depth + 1), np.int32)
    path_nodes[0] = tpl.paths[5]
    path_nodes[2, :3] = tpl.paths[3][:3]
    want = jtransformer.commit_cache_tree(
        jcfg, jax.tree.map(jnp.asarray, jcache), jnp.asarray(start),
        jnp.asarray(path_nodes), jnp.asarray(n_accept))
    cache = cache_from_numpy(jcache, device="cpu")
    got = transformer.commit_cache_tree(None, cache, torch.from_numpy(start),
                                        torch.from_numpy(path_nodes),
                                        torch.from_numpy(n_accept))
    assert got is cache                                       # moved in place
    for lw, lg in zip(jax.tree.map(np.asarray, want)["layers"], cache_to_numpy(got)["layers"]):
        assert set(lw) == set(lg)
        for name in lw:
            assert lg[name].tobytes() == lw[name].tobytes(), name


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------

def _prompt(V=256, B=2, reps=5, seed=0):
    rng = np.random.default_rng(seed)
    return np.tile(rng.integers(0, V, 6), reps)[None, :].repeat(B, 0).astype(np.int32)


def _cfgs(kv):
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), kv_cache_dtype=kv)
    pcfg = dataclasses.replace(get_config("smollm-135m").reduced(), kv_cache_dtype=kv)
    return jcfg, pcfg


@functools.lru_cache(maxsize=None)
def _jax_params():
    return JModel(_cfgs("bf16")[0]).init_params(jax.random.PRNGKey(0))


@pytest.mark.parametrize("verifier,kv", [("bf16", "bf16"), ("w8a8", "int8"),
                                         ("w4a8", "bf16")])
def test_ngram_tree_greedy_tokens_match_jax(verifier, kv):
    jcfg, pcfg = _cfgs(kv)
    branches = (3, 2, 1, 1)
    jscfg = JSpecConfig(temperature=0.0, drafter="ngram-tree", verifier=verifier,
                        tree_branches=branches)
    want = JSpecEngine(JModel(jcfg), jscfg).generate(_jax_params(), jnp.asarray(_prompt()),
                                                     N_NEW)
    params = from_jax_params(jax.tree.map(np.asarray, _jax_params()), pcfg, device="cpu")
    scfg = SpecConfig(temperature=0.0, drafter="ngram-tree", verifier=verifier,
                      tree_branches=branches)
    got = SpecEngine(Model(pcfg, device="cpu"), scfg).generate(
        params, torch.from_numpy(_prompt()), N_NEW)
    P = _prompt().shape[1]
    np.testing.assert_array_equal(got.tokens[:, :P + N_NEW].numpy(),
                                  np.asarray(want.tokens)[:, :P + N_NEW])
    assert got.steps == want.steps and not bool(got.bad.any())


@pytest.fixture(scope="module")
def port_model_params():
    _, pcfg = _cfgs("bf16")
    model = Model(pcfg, device="cpu")
    return model, model.init_params(torch.Generator().manual_seed(3))


@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("verifier", ["bf16", "w8a8"])
@pytest.mark.parametrize("drafter", ["ngram", "vanilla", "pruned"])
def test_chain_as_tree_bit_identical_to_chain(port_model_params, drafter, verifier,
                                              temperature):
    """Any chain drafter through the tree route (depth positions, ancestor
    mask, path commit, tree rejection sampling) reproduces the chain route
    bit for bit, on the same per-row generators."""
    model, params = port_model_params
    scfg = SpecConfig(gamma=3, temperature=temperature, pruned_retention=0.5)
    prompt = torch.from_numpy(_prompt(B=3, seed=11))
    out = []
    for d in (get_drafter(drafter, scfg), ChainTreeAdapter(get_drafter(drafter, scfg))):
        out.append(SpecEngine(model, scfg, drafter=d, verifier=verifier).generate(
            params, prompt, N_NEW, seed=5))
    assert torch.equal(out[0].tokens, out[1].tokens)
    assert torch.equal(out[0].lengths, out[1].lengths)
    assert out[0].steps == out[1].steps and out[0].mean_accept_len == out[1].mean_accept_len


def test_wide_tree_lossless_greedy_in_port(port_model_params):
    """Whatever the template proposes, T = 0 commits the autoregressive
    stream."""
    model, params = port_model_params
    prompt = torch.from_numpy(_prompt(seed=3))
    P = prompt.shape[1]
    van = SpecEngine(model, SpecConfig(gamma=0, drafter="vanilla", verifier="bf16")).generate(
        params, prompt, N_NEW)
    for branches in [(2, 2), (3, 2, 1, 1), (4, 4, 4)]:
        scfg = SpecConfig(drafter="ngram-tree", verifier="bf16", tree_branches=branches)
        tree = SpecEngine(model, scfg).generate(params, prompt, N_NEW)
        assert torch.equal(van.tokens[:, :P + N_NEW], tree.tokens[:, :P + N_NEW]), branches
        assert tree.steps <= van.steps


def test_serve_cli_tree_flag_conflicts():
    from repro_torch.launch import serve

    for argv in (["--tree-branches", "2,2", "--gamma", "3"],
                 ["--tree-branches", "2,2", "--drafter", "ngram"]):
        with pytest.raises(SystemExit):
            serve.parse_args([*argv, "--device", "cpu"])
    args = serve.parse_args(["--tree-branches", "3,2,1,1", "--device", "cpu"])
    assert args.drafter == "ngram-tree" and args.tree_branches == (3, 2, 1, 1)
