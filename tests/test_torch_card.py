"""The port's CUDA kernels against their plain versions on the card.

Every test here needs a CUDA card and the CUDA toolkit (the kernels are
built from ``src/repro_torch/csrc`` at first use) and skips without a card.
The file imports neither jax nor the JAX package, so it also runs where
only the port's dependencies are installed; ``--noconftest`` keeps the
suite's JAX conftest out:

    python -m pytest -q --noconftest -m gpu tests/test_torch_card.py

``chip_smoke.py`` checks the kernels at the 7B main path's shapes; these
tests cover the edges the main path does not reach: partial tiles, K and
S not multiples of the blocks, every instantiated head size, f32 inputs,
and the wrappers' card-only input checks.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_ref
from repro_torch.kernels.int8_matmul import int8_matmul, int8_matmul_ref
from repro_torch.kernels.smooth_quant import smooth_quant, smooth_quant_ref
from repro_torch.models import Model
from repro_torch.models.attention import _quant_kv

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


@pytest.mark.parametrize("m,k,dtype", [
    (1, 16, torch.float32), (13, 4096, torch.bfloat16), (300, 96, torch.float32),
    (5, 12288, torch.bfloat16), (3, 100, torch.bfloat16)])
def test_smooth_quant_bit_equal_on_card(dev, m, k, dtype):
    g = _gen(dev, m * k)
    x = (torch.randn(m, k, generator=g, device=dev) * 5).to(dtype)
    x[0] = 0                                            # an all-zero row (EPS clamp)
    s = torch.rand(k, generator=g, device=dev) * 7.875 + 0.125
    q, dx = smooth_quant(x, s)
    rq, rdx = smooth_quant_ref(x, s)
    assert torch.equal(q, rq)
    assert torch.equal(dx.view(torch.int32), rdx.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_smooth_quant_non_finite_rows_bit_equal_on_card(dev, dtype):
    """A row holding a NaN gets Δx = NaN, as torch.amax gives (fmaxf would
    drop the NaN and quantize the row to finite codes); an inf gives inf."""
    g = _gen(dev, 7)
    x = (torch.randn(12, 4096, generator=g, device=dev) * 4).to(dtype)
    x[1, 5], x[2, 7], x[4, 9] = float("nan"), float("inf"), float("-inf")
    x[3] = float("nan")
    x[5, 4095] = float("nan")                          # in the last thread's stride
    s = torch.rand(4096, generator=g, device=dev) * 7.875 + 0.125
    q, dx = smooth_quant(x, s)
    rq, rdx = smooth_quant_ref(x, s)
    assert dx[[1, 3, 5]].isnan().all() and dx[[2, 4]].isinf().all()
    assert torch.equal(q, rq)
    assert torch.equal(dx.view(torch.int32), rdx.view(torch.int32))


@pytest.mark.parametrize("m,k,n", [
    (1, 16, 1), (7, 48, 200), (65, 4096, 130), (130, 80, 64), (24, 12288, 72),
    (300, 256, 96)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_exact_on_card(dev, m, k, n, out_dtype):
    g = _gen(dev, m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    ones_m, ones_n = torch.ones(m, device=dev), torch.ones(n, device=dev)
    # unit scales, f32 out: the output is the int32 accumulator itself
    acc = int8_matmul(x, w, ones_m, ones_n, out_dtype=torch.float32)
    want = x.cpu().to(torch.int64) @ w.cpu().to(torch.int64).T
    assert torch.equal(acc.cpu().to(torch.int64), want)
    dx = torch.rand(m, generator=g, device=dev) * 1e-2
    dw = torch.rand(n, generator=g, device=dev) * 1e-3
    y = int8_matmul(x, w, dx, dw, out_dtype=out_dtype)
    assert y.dtype == out_dtype
    assert torch.equal(y, int8_matmul_ref(x, w, dx, dw, out_dtype))


def _attn(dev, b, t, s, hkv, g, dh, dtype, int8, seed):
    gen = _gen(dev, seed)
    q = torch.randn(b, t, hkv * g, dh, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, s, hkv, dh, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, s, hkv, dh, generator=gen, device=dev).to(dtype)
    start = torch.randint(0, s - t + 1, (b,), generator=gen, device=dev)
    qpos = (start[:, None] + torch.arange(t, device=dev)).to(torch.int32).contiguous()
    kw = {}
    if int8:
        k, ks = _quant_kv(k)
        v, vs = _quant_kv(v)
        kw = dict(k_scale=ks, v_scale=vs)
    return q, k, v, qpos, kw


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,s,hkv,g,dh", [
    (2, 1, 53, 2, 1, 32),      # S under one split and not a chunk multiple
    (2, 6, 300, 2, 2, 64),     # several splits, the last one partial
    (1, 3, 128, 1, 9, 128),    # S exactly one split; G·T not a row-block multiple
    (4, 6, 1152, 8, 4, 128),   # the 7B verify window
    (1, 1, 6, 3, 3, 64)])      # S shorter than the window's chunk
def test_flash_decode_matches_plain_on_card(dev, b, t, s, hkv, g, dh, dtype, int8):
    q, k, v, qpos, kw = _attn(dev, b, t, s, hkv, g, dh, dtype, int8, seed=s + t + g)
    o = flash_decode(q, k, v, qpos, **kw)
    ro = flash_decode_ref(q, k, v, qpos, **kw)
    assert o.dtype == dtype and bool(torch.isfinite(o).all())
    if dtype == torch.float32:
        # f32 throughout; the two sum in different orders
        torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
    else:
        # both accumulate in f32 and round once to bf16 (8-bit mantissa): they
        # may differ by one rounding step, 2^-7 of the value
        torch.testing.assert_close(o.float(), ro.float(), rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_row_does_not_depend_on_window_length(dev, int8):
    """The split over S depends on S alone, and slots past a window's last
    position are skipped: a query row's output is the same, bit for bit,
    whether it comes alone (vanilla, T = 1) or first in a verify window
    (T = 6).  Row 0 sits in the first split, row 1 deep in the cache."""
    q, k, v, _, kw = _attn(dev, 2, 6, 1152, 8, 4, 128, torch.bfloat16, int8, seed=3)
    qpos = torch.tensor([[5], [1040]], dtype=torch.int32, device=dev)
    qpos = (qpos + torch.arange(6, device=dev)).to(torch.int32).contiguous()
    full = flash_decode(q, k, v, qpos, **kw)
    alone = flash_decode(q[:, :1].contiguous(), k, v, qpos[:, :1].contiguous(), **kw)
    assert torch.equal(alone, full[:, :1])
    torch.testing.assert_close(full.float(), flash_decode_ref(q, k, v, qpos, **kw).float(),
                               rtol=2 ** -7, atol=1e-5)


def test_nan_activation_sets_bad_row_on_card(dev):
    """A NaN planted in one row's activations (an embedding row only that
    row's prompt uses) reaches its W8A8 verifier logits through the
    smooth_quant and int8_matmul kernels and sets its ``bad`` flag."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine

    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), tie_embeddings=False)
    model = Model(cfg, device=dev)
    params = model.init_params(_gen(dev, 1))
    rng = np.random.default_rng(2)
    prompt = torch.from_numpy(np.tile(rng.integers(0, cfg.vocab_size, 6), 5)[None]
                              .repeat(2, 0).astype(np.int32))
    poison = int(np.setdiff1d(np.arange(cfg.vocab_size), prompt.numpy())[0])
    prompt[0, 10] = poison
    with torch.no_grad():
        params.embed.w[poison] = float("nan")
    ops.reset_launch_counts()
    scfg = SpecConfig(temperature=0.0, gamma=4, drafter="ngram", verifier="w8a8")
    r = SpecEngine(model, scfg).generate(params, prompt.to(dev), 4)
    counts = ops.launch_counts()
    assert counts.get("smooth_quant", 0) > 0 and counts.get("int8_matmul", 0) > 0
    assert r.bad.tolist() == [True, False]


def test_each_launch_counts_once(dev):
    x = torch.randn(4, 64, device=dev)
    s = torch.ones(64, device=dev)
    w = torch.ones(32, 64, dtype=torch.int8, device=dev)
    q, k, v, qpos, kw = _attn(dev, 1, 2, 40, 1, 2, 32, torch.float32, True, seed=0)
    ops.reset_launch_counts()
    xq, dx = smooth_quant(x, s)
    int8_matmul(xq, w, dx, torch.ones(32, device=dev))
    flash_decode(q, k, v, qpos, **kw)
    flash_decode(q, k.float(), v.float(), qpos)
    ops.w8a8_matmul(x, w, torch.ones(32, device=dev), s)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"smooth_quant": 2, "int8_matmul": 2,
                                   "flash_decode": 1, "flash_decode_int8": 1}


def test_wrappers_reject_card_only_faults(dev):
    x = torch.zeros(4, 32, device=dev)
    w = torch.zeros(8, 32, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="devices"):
        smooth_quant(x, torch.ones(32))                       # smooth on the CPU
    with pytest.raises(ValueError, match="devices"):
        int8_matmul(x.to(torch.int8), w, torch.ones(4), torch.ones(8, device=dev))
    buf = torch.zeros(4 * 32 + 1, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        int8_matmul(buf[1:].view(4, 32), w, torch.ones(4, device=dev),
                    torch.ones(8, device=dev))
    q = torch.zeros(1, 1, 2, 32, device=dev)
    kv = torch.zeros(1 * 5 * 1 * 32 + 1, device=dev)[1:].view(1, 5, 1, 32)
    with pytest.raises(ValueError, match="aligned"):
        flash_decode(q, kv, kv, torch.zeros(1, 1, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("verifier_w8a8", [False, True])
def test_verify_step_on_card_matches_cpu(dev, verifier_w8a8):
    """Prefill → verify_step on the card (through the kernels) against the
    same weights on the CPU (plain versions), f32 reduced config.  The
    int8 activation codes may flip where the two sides' f32 values round
    differently across a .5 boundary, so W8A8 is held to 1e-2."""
    from repro_torch.quant.apply import quantize_params

    cfg = get_config("smollm-135m").reduced()
    cfg = dataclasses.replace(cfg, kv_cache_dtype="bf16")
    cpu = Model(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    if verifier_w8a8:
        params = quantize_params(params)
    gpu = Model(cfg, device=dev)
    params_gpu = copy.deepcopy(params).to(dev)       # Module.to moves in place
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 30)).astype(np.int32))
    start = torch.full((2,), 23, dtype=torch.int32)
    out = []
    for m, p, d in ((cpu, params, "cpu"), (gpu, params_gpu, dev)):
        cache = m.prefill(p, m.init_cache(2, 40), toks[:, :23].to(d))
        logits, _ = m.verify_step(p, cache, toks[:, 23:29].to(d), start.to(d))
        out.append(logits.cpu())
    tol = 1e-2 if verifier_w8a8 else 1e-4
    torch.testing.assert_close(out[1], out[0], rtol=tol, atol=tol)
