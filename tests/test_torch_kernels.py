"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; the JAX
kernels run in Pallas interpret mode.  Inputs are made with numpy from a
seed and handed to both sides.  ``smooth_quant`` and ``int8_matmul`` must
be bit-equal (same IEEE operations, exact integer sums); ``flash_decode``
sums in another order and is held to 1e-5 in f32.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_decode import flash_decode as jflash
from repro.kernels.int8_matmul import int8_matmul as jint8
from repro.kernels.smooth_quant import smooth_quant as jsq
from repro.models.attention import _quant_kv as j_quant_kv
from repro.models.attention import attend as jattend
from repro_torch.bridge import tensor
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref, int32_acc, split_k
from repro_torch.kernels.ref import w8a8_matmul_ref
from repro_torch.kernels.smooth_quant import smooth_quant, smooth_quant_ref
from repro_torch.models.attention import _quant_kv

CPU = torch.device("cpu")


def _t(a):
    return tensor(a, CPU)


@pytest.mark.parametrize("m,k,block_m,dtype", [
    (13, 128, 8, np.float32),       # M not a multiple of the block
    (300, 96, 256, np.float32),
    (24, 512, 16, ml_dtypes.bfloat16),
])
def test_smooth_quant_bit_equal(m, k, block_m, dtype):
    rng = np.random.default_rng(m * k)
    x = (rng.standard_normal((m, k)) * rng.uniform(0.1, 30, (m, 1))).astype(dtype)
    x[0, :] = 0.0                                       # an all-zero row (EPS clamp)
    s = rng.uniform(0.125, 8.0, k).astype(np.float32)
    q_pal, dx_pal = jsq(jnp.asarray(x), jnp.asarray(s), block_m=block_m, interpret=True)
    # jitted, as the reference's decode step runs it (XLA then multiplies by
    # f32(1/127) instead of dividing; see kernels/smooth_quant.py)
    q_or, dx_or = jax.jit(jref.smooth_quant_ref)(jnp.asarray(x), jnp.asarray(s))
    q, dx = smooth_quant(_t(x), _t(s))
    for qj, dj in ((q_pal, dx_pal), (q_or, dx_or)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(dx.numpy().view(np.int32),
                                      np.asarray(dj).view(np.int32))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_smooth_quant_non_finite_rows_match_jax(dtype):
    """A NaN in a row makes its Δx NaN (the max carries it through), an
    inf makes Δx inf; the codes of such rows match the reference's too."""
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((12, 256)) * 4).astype(dtype)
    x[1, 5], x[2, 7], x[4, 9] = np.nan, np.inf, -np.inf
    x[3, :] = np.nan
    s = rng.uniform(0.125, 8.0, 256).astype(np.float32)
    q, dx = smooth_quant(_t(x), _t(s))
    assert bool(dx[[1, 3]].isnan().all()) and bool(dx[[2, 4]].isinf().all())
    assert bool(dx[[0, *range(5, 12)]].isfinite().all())
    q_pal, dx_pal = jsq(jnp.asarray(x), jnp.asarray(s), block_m=8, interpret=True)
    q_or, dx_or = jax.jit(jref.smooth_quant_ref)(jnp.asarray(x), jnp.asarray(s))
    for qj, dj in ((q_pal, dx_pal), (q_or, dx_or)):
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(dx.numpy().view(np.int32),
                                      np.asarray(dj).view(np.int32))


@pytest.mark.parametrize("m,k,n", [(24, 128, 96), (7, 512, 64), (40, 256, 200)])
def test_int8_matmul_exact(m, k, n):
    rng = np.random.default_rng(m + k + n)
    x = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)      # reference (K, N)
    w_nk = _t(np.ascontiguousarray(w.T))                     # port (N, K)
    kw = dict(block_m=16, block_n=32, block_k=64, interpret=True)
    # unit scales, f32 out: the output is the int32 accumulator itself
    one_m, one_n = np.ones(m, np.float32), np.ones(n, np.float32)
    acc_j = jint8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(one_m), jnp.asarray(one_n),
                  out_dtype=jnp.float32, **kw)
    acc_p = int8_matmul(_t(x), w_nk, _t(one_m), _t(one_n), out_dtype=torch.float32)
    np.testing.assert_array_equal(np.asarray(acc_j).astype(np.int64),
                                  acc_p.numpy().astype(np.int64))
    np.testing.assert_array_equal(int32_acc(_t(x), w_nk).numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))
    dx = rng.uniform(1e-3, 0.1, m).astype(np.float32)
    dw = rng.uniform(1e-3, 0.1, n).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        yj = jint8(jnp.asarray(x), jnp.asarray(w), jnp.asarray(dx), jnp.asarray(dw),
                   out_dtype=jdt, **kw)
        yp = int8_matmul(_t(x), w_nk, _t(dx), _t(dw), out_dtype=tdt)
        np.testing.assert_array_equal(yp.float().numpy(), np.asarray(yj).astype(np.float32))


@pytest.mark.parametrize("m,k,n,split", [
    (300, 256, 96, False), (24, 12288, 72, True), (24, 4096, 4096, True),
    (24, 4096, 151936, False), (4092, 4096, 12288, False), (1, 16, 1, False)])
def test_int8_matmul_split_k_covers_k(m, k, n, split):
    """The card's kernel splits K across blocks only where the output has
    too few 64x64 tiles to fill the card (decode shapes other than
    lm_head), in whole 64-wide K tiles that cover K."""
    chunk, splits = split_k(m, n, k)
    assert chunk % 64 == 0 and (splits - 1) * chunk < k <= splits * chunk
    assert (splits > 1) == split


def _attn_inputs(b, t, s, hkv, g, dh, seed, int8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hkv * g, dh)).astype(dtype)
    k = rng.standard_normal((b, s, hkv, dh)).astype(dtype)
    v = rng.standard_normal((b, s, hkv, dh)).astype(dtype)
    start = rng.integers(0, s - t + 1, b)
    qpos = (start[:, None] + np.arange(t)[None]).astype(np.int32)
    ks = vs = None
    if int8:
        k, ks = (np.asarray(a) for a in jax.jit(j_quant_kv)(jnp.asarray(k)))
        v, vs = (np.asarray(a) for a in jax.jit(j_quant_kv)(jnp.asarray(v)))
    return q, k, v, qpos, ks, vs


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("t", [1, 6])
@pytest.mark.parametrize("g", [1, 2])
def test_flash_decode_matches_jax(int8, t, g):
    b, s, hkv, dh = 2, 53, 2, 32                           # S not a block multiple
    q, k, v, qpos, ks, vs = _attn_inputs(b, t, s, hkv, g, dh, 10 * t + g, int8)
    jk = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)) if int8 else {}
    pk = dict(k_scale=_t(ks), v_scale=_t(vs)) if int8 else {}
    o_pal = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
                   block_s=16, interpret=True, **jk)
    o_att = jattend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
                    jnp.arange(s, dtype=jnp.int32), impl="jnp", **jk)
    o = flash_decode(_t(q), _t(k), _t(v), _t(qpos), **pk)
    for oj in (o_pal, o_att):
        np.testing.assert_allclose(o.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-5)


def test_flash_decode_bf16_matches_jax():
    q, k, v, qpos, _, _ = _attn_inputs(2, 6, 70, 2, 2, 64, 3, False, ml_dtypes.bfloat16)
    oj = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
                block_s=32, interpret=True)
    o = flash_decode(_t(q), _t(k), _t(v), _t(qpos))
    assert o.dtype == torch.bfloat16
    # both accumulate in f32; outputs are rounded to bf16 (8-bit mantissa)
    np.testing.assert_allclose(o.float().numpy(), np.asarray(oj).astype(np.float32),
                               rtol=2e-2, atol=2e-2)


def test_quant_kv_bit_equal():
    x = np.random.default_rng(5).standard_normal((2, 7, 3, 32)).astype(np.float32)
    qj, sj = jax.jit(j_quant_kv)(jnp.asarray(x))
    qp, sp = _quant_kv(_t(x))
    np.testing.assert_array_equal(qp.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(0)
    x = _t(rng.standard_normal((5, 64)).astype(np.float32))
    s = _t(rng.uniform(0.5, 2, 64).astype(np.float32))
    w = _t(rng.integers(-127, 128, (32, 64), dtype=np.int8))
    q, k, v, qpos, ks, vs = _attn_inputs(1, 2, 20, 1, 2, 32, 1, True)
    ops.reset_launch_counts()
    xq, dx = smooth_quant(x, s)
    y = int8_matmul(xq, w, dx, torch.ones(32), out_dtype=torch.float32)
    o = flash_decode(_t(q), _t(k), _t(v), _t(qpos), k_scale=_t(ks), v_scale=_t(vs))
    assert ops.launch_counts() == {}          # plain versions are not launches
    rq, rdx = smooth_quant_ref(x, s)
    assert torch.equal(xq, rq) and torch.equal(dx, rdx)
    assert torch.equal(y, w8a8_matmul_ref(x, w, torch.ones(32), s, torch.float32))
    assert torch.equal(ops.w8a8_matmul(x, w, torch.ones(32), s), y)
    assert torch.equal(o, flash_decode_ref(_t(q), _t(k), _t(v), _t(qpos), _t(ks), _t(vs)))
    with pytest.raises(ValueError, match="device"):
        ops.dispatch(torch.empty(1, device="meta"), lambda: 0, lambda: 1)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """The loader has no fallback: no toolkit means an error."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        ops._nvcc()


def _bad_calls():
    f32, i8 = torch.float32, torch.int8
    x = torch.zeros(4, 32)
    s = torch.ones(32)
    xq = torch.zeros(4, 32, dtype=i8)
    w = torch.zeros(8, 32, dtype=i8)
    q = torch.zeros(1, 2, 4, 32)
    k = torch.zeros(1, 9, 2, 32)
    qpos = torch.zeros(1, 2, dtype=torch.int32)
    return [
        lambda: smooth_quant(x.to(torch.float16), s),                     # dtype
        lambda: smooth_quant(x, torch.ones(31)),                          # shape
        lambda: smooth_quant(torch.zeros(32, 4).T, s),                    # layout
        lambda: int8_matmul(xq.float(), w, torch.ones(4), torch.ones(8)),  # dtype
        lambda: int8_matmul(xq, torch.zeros(32, 8, dtype=i8), torch.ones(4), torch.ones(8)),
        lambda: int8_matmul(xq, torch.zeros(32, 8, dtype=i8).T, torch.ones(4), torch.ones(8)),
        lambda: int8_matmul(torch.zeros(4, 24, dtype=i8), torch.zeros(8, 24, dtype=i8),
                            torch.ones(4), torch.ones(8)),                 # K % 16
        lambda: int8_matmul(xq, w, torch.ones(4), torch.ones(8), out_dtype=torch.int32),
        lambda: flash_decode(q, k.to(torch.bfloat16), k, qpos),           # dtype mix
        lambda: flash_decode(q, k.to(i8), k.to(i8), qpos),                # int8, no scales
        lambda: flash_decode(q, k, k, qpos, k_scale=torch.ones(1, 9, 2)),  # unpaired
        lambda: flash_decode(q, k, k, qpos.long()),                       # qpos dtype
        lambda: flash_decode(torch.zeros(1, 2, 4, 48), torch.zeros(1, 9, 2, 48),
                             torch.zeros(1, 9, 2, 48), qpos),             # head_dim
        lambda: flash_decode(q.transpose(1, 2).contiguous().transpose(1, 2), k, k, qpos),
        lambda: flash_decode(q, k, k, qpos.to(f32)),
    ]


@pytest.mark.parametrize("i", range(len(_bad_calls())))
def test_wrappers_reject_bad_inputs(i):
    with pytest.raises(ValueError):
        _bad_calls()[i]()

