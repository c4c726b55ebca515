"""The port's W4A8 verification against the JAX package.

Weight preparation (quantize, pack) must give the reference's bytes and
scales exactly; the port's W4A8 linear must be bit-equal to the jitted
reference ``w4a8_matmul``; the plain ``int4_matmul`` must equal the Pallas
kernel run in interpret mode (both are exact int32 sums and one f32
epilogue); and greedy (T = 0) generation with the ``w4a8`` verifier must
give the reference's tokens on ``smollm-135m`` ``.reduced()`` (f32) with
the same bridged weights.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.config import QuantConfig as JQuantConfig
from repro.core.config import SpecConfig as JSpecConfig
from repro.kernels.int4_matmul import int4_matmul as jint4
from repro.models import Model as JModel
from repro.quant import int4 as jint4q
from repro.quant import quantize_params as jquantize
from repro.serving.engine import SpecEngine as JSpecEngine
from repro_torch.bridge import from_jax_params, tensor, to_numpy
from repro_torch.configs import get_config
from repro_torch.core.config import QuantConfig, SpecConfig
from repro_torch.kernels import ops
from repro_torch.kernels.int4_matmul import int4_matmul, int4_matmul_ref
from repro_torch.kernels.ref import w4a8_matmul_ref
from repro_torch.models import Model
from repro_torch.models.linear import W4A8Linear, W8A8Linear
from repro_torch.quant import int4
from repro_torch.quant.apply import quantize_params
from repro_torch.serving.engine import SpecEngine

CPU = torch.device("cpu")
N_NEW, GAMMA = 12, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_equal(a, b):
    la, ta = jax.tree.flatten(a)
    lb, tb = jax.tree.flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("din,dout,dtype", [
    (64, 40, np.float32), (2, 1, np.float32), (96, 130, ml_dtypes.bfloat16)])
def test_quantize_pack_unpack_bit_identical(din, dout, dtype):
    rng = np.random.default_rng(din + dout)
    w = (rng.standard_normal((din, dout)) * rng.uniform(0.01, 3, (1, dout))).astype(dtype)
    w[:, 0] = 0.0                                    # an all-zero column (EPS clamp)
    jq, js = jint4q.quantize_symmetric_int4(jnp.asarray(w), axis=0)
    q, s = int4.quantize_symmetric_int4(tensor(w, CPU), dim=0)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy().view(np.int32), np.asarray(js).view(np.int32))
    packed = int4.pack_int4(q)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jint4q.pack_int4(jq)))
    np.testing.assert_array_equal(int4.unpack_int4(packed).numpy(), q.numpy())
    # every byte value unpacks as the reference's arithmetic shifts do
    every = np.arange(-128, 128, dtype=np.int8).reshape(128, 2)
    np.testing.assert_array_equal(int4.unpack_int4(torch.from_numpy(every)).numpy(),
                                  np.asarray(jint4q.unpack_int4(jnp.asarray(every))))
    with pytest.raises(ValueError, match="even"):
        int4.pack_int4(q[:1] if din > 1 else q)


def _mixed_configs():
    """Reduced smollm with an odd d_ff: the FFN's down projection has an
    odd din and stays W8A8, every other linear becomes W4A8."""
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), d_ff=257,
                               tie_embeddings=False)
    pcfg = dataclasses.replace(get_config("smollm-135m").reduced(), d_ff=257,
                               tie_embeddings=False)
    return jcfg, pcfg


@pytest.mark.parametrize("calibrated", [False, True])
def test_w4a8_quantize_params_bit_identical_mixed_tree(calibrated):
    jcfg, pcfg = _mixed_configs()
    jm = JModel(jcfg)
    jparams = jm.init_params(jax.random.PRNGKey(5))
    stats = None
    if calibrated:
        stats = {}
        toks = np.random.default_rng(3).integers(0, jcfg.vocab_size, (1, 24)).astype(np.int32)
        jm.forward(jparams, jnp.asarray(toks), collect=stats)
    jq = _np_tree(jquantize(jparams, stats, JQuantConfig(w_bits=4)))
    pstats = {k: tensor(np.asarray(v), CPU) for k, v in stats.items()} if stats else None
    pq = quantize_params(from_jax_params(_np_tree(jparams), pcfg, device="cpu"), pstats,
                         QuantConfig(w_bits=4))
    _leaves_equal(to_numpy(pq), jq)
    blk = pq.layers[0]
    assert isinstance(blk.ffn.down, W8A8Linear) and isinstance(blk.ffn.up, W4A8Linear)
    assert isinstance(pq.lm_head, W4A8Linear)
    # packed (dout, din/2), din contiguous
    assert blk.attn.q.w_int4.shape == (pcfg.q_dim, pcfg.d_model // 2)
    assert blk.attn.q.w_int4.is_contiguous()
    # the round trip through the bridge is bit-exact with w_int4 leaves
    _leaves_equal(to_numpy(from_jax_params(jq, pcfg, device="cpu")), jq)


@pytest.mark.parametrize("shape,dtype", [((2, 3, 96), np.float32),
                                         ((7, 128), np.float32),
                                         ((5, 64), ml_dtypes.bfloat16)])
def test_w4a8_linear_bit_equal_to_jitted_reference(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    K, N = shape[-1], 72
    x = (rng.standard_normal(shape) * 2).astype(dtype)
    w = rng.standard_normal((K, N)).astype(np.float32)
    s = rng.uniform(0.125, 8.0, K).astype(np.float32)
    jp = jint4q.quantize_linear_w4({"w": jnp.asarray(w)}, jnp.asarray(s))
    want = jax.jit(jint4q.w4a8_matmul)(jnp.asarray(x), jp["w_int4"], jp["w_scale"],
                                       jp["smooth"])
    lin = W4A8Linear(tensor(np.asarray(jp["w_int4"]), CPU).T.contiguous(),
                     tensor(np.asarray(jp["w_scale"]), CPU), tensor(s, CPU))
    got = lin(tensor(x, CPU))
    assert got.dtype == tensor(x, CPU).dtype and got.shape == (*shape[:-1], N)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
    ref = w4a8_matmul_ref(tensor(x, CPU), lin.w_int4, lin.w_scale, lin.smooth)
    assert torch.equal(ref, got)


@pytest.mark.parametrize("m,k,n", [(1, 2, 1), (13, 96, 70), (24, 256, 33), (40, 130, 64)])
def test_int4_matmul_ref_matches_pallas_interpret(m, k, n):
    """As ``tests/test_kernels.py`` runs the reference kernel: interpret mode."""
    rng = np.random.default_rng(m * k + n)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    q = rng.integers(-7, 8, (k, n)).astype(np.int8)
    dx = rng.uniform(1e-3, 1e-1, m).astype(np.float32)
    dw = rng.uniform(1e-3, 1e-1, n).astype(np.float32)
    packed = np.asarray(jint4q.pack_int4(jnp.asarray(q)))
    for out_dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        want = jint4(jnp.asarray(xq), jnp.asarray(packed), jnp.asarray(dx), jnp.asarray(dw),
                     out_dtype=jdt, block_m=16, block_n=32, block_k=64, interpret=True)
        ops.reset_launch_counts()
        got = int4_matmul(torch.from_numpy(xq), torch.from_numpy(packed.T.copy()),
                          torch.from_numpy(dx), torch.from_numpy(dw), out_dtype=out_dtype)
        assert ops.launch_counts() == {}                  # CPU: the plain version
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        assert torch.equal(got, int4_matmul_ref(torch.from_numpy(xq),
                                                torch.from_numpy(packed.T.copy()),
                                                torch.from_numpy(dx),
                                                torch.from_numpy(dw), out_dtype))


@pytest.mark.parametrize("bad", range(4))
def test_int4_matmul_rejects_bad_inputs(bad):
    x = torch.zeros(4, 32, dtype=torch.int8)
    w = torch.zeros(8, 16, dtype=torch.int8)
    dx, dw = torch.ones(4), torch.ones(8)
    args = [(x[:, :31], w[:, :15], dx, dw),                  # K odd vs K/2
            (x.float(), w, dx, dw),                          # not int8
            (x, w, dx[:3], dw),                              # wrong Δx
            (x, w.t(), dx, dw)][bad]                         # (K/2, N): not (N, K/2)
    with pytest.raises(ValueError):
        int4_matmul(*args)


# ---------------------------------------------------------------------------
# End to end: greedy tokens against the reference's
# ---------------------------------------------------------------------------

def _prompt(V=256, B=2, reps=5, seed=0):
    rng = np.random.default_rng(seed)
    return np.tile(rng.integers(0, V, 6), reps)[None, :].repeat(B, 0).astype(np.int32)


def _cfgs(kv):
    jcfg = dataclasses.replace(jget_config("smollm-135m").reduced(), kv_cache_dtype=kv)
    pcfg = dataclasses.replace(get_config("smollm-135m").reduced(), kv_cache_dtype=kv)
    return jcfg, pcfg


def _generate(model, scfg, params, prompt=None):
    prompt = _prompt() if prompt is None else prompt
    return SpecEngine(model, scfg).generate(params, torch.from_numpy(prompt), N_NEW)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return JModel(_cfgs("bf16")[0]).init_params(jax.random.PRNGKey(0))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("drafter", ["ngram", "vanilla"])
def test_w4a8_generate_greedy_tokens_match_jax(drafter, kv):
    jcfg, pcfg = _cfgs(kv)
    jscfg = JSpecConfig(temperature=0.0, gamma=GAMMA, drafter=drafter, verifier="w4a8")
    want = JSpecEngine(JModel(jcfg), jscfg).generate(_jax_params(), jnp.asarray(_prompt()),
                                                     N_NEW)
    params = from_jax_params(_np_tree(_jax_params()), pcfg, device="cpu")
    scfg = SpecConfig(temperature=0.0, gamma=GAMMA, drafter=drafter, verifier="w4a8")
    got = _generate(Model(pcfg, device="cpu"), scfg, params)
    P = _prompt().shape[1]
    np.testing.assert_array_equal(got.tokens[:, :P + N_NEW].numpy(),
                                  np.asarray(want.tokens)[:, :P + N_NEW])
    assert not bool(got.bad.any())


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_w4a8_spec_equals_vanilla_in_port(kv):
    """The reference's lossless gate for the W4A8 verifier, inside the port."""
    _, pcfg = _cfgs(kv)
    model = Model(pcfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(1))
    prompt = _prompt(seed=2)
    out = {d: _generate(model, SpecConfig(temperature=0.0, gamma=GAMMA, drafter=d,
                                                    verifier="w4a8"), params, prompt)
           for d in ("ngram", "vanilla")}
    P = prompt.shape[1]
    assert torch.equal(out["ngram"].tokens[:, :P + N_NEW], out["vanilla"].tokens[:, :P + N_NEW])
    assert out["ngram"].steps <= out["vanilla"].steps


def test_w4a8_nan_activation_sets_bad_row():
    """A NaN planted in one row's activations reaches that row's W4A8
    verifier logits and sets its ``bad`` flag; the other row stays clean."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), tie_embeddings=False)
    model = Model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(1))
    prompt = _prompt(seed=2)
    poison = int(np.setdiff1d(np.arange(cfg.vocab_size), prompt)[0])
    prompt[0, 10] = poison
    with torch.no_grad():
        params.embed.w[poison] = float("nan")
    r = _generate(model, SpecConfig(temperature=0.0, gamma=GAMMA, drafter="ngram",
                                              verifier="w4a8"), params, prompt)
    assert r.bad.tolist() == [True, False]
