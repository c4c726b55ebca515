"""The port's CUDA kernels against their plain versions on the card.

Every test here needs a CUDA card and the CUDA toolkit (the kernels are
built from ``src/repro_torch/csrc`` at first use) and skips without a card.
The file imports neither jax nor the JAX package, so it also runs where
only the port's dependencies are installed; ``--noconftest`` keeps the
suite's JAX conftest out:

    python -m pytest -q --noconftest -m gpu tests/test_torch_card.py

``chip_smoke.py`` checks the kernels at the 7B main path's shapes; these
tests cover the edges the main path does not reach: the GEMMs' regime and
width edges and rows against M, the int4 GEMM's load producer (K % 32 != 0,
unaligned pointers), the fused norm's rows against the row count and NaN
rows, the bf16 linear's rows against M, T > 0 scheduling, partial tiles, K and
S not multiples of the blocks, every instantiated head size, f32 inputs,
paged block sizes that divide neither the 32-key chunk nor the 128-key
split, idle rows on the scratch block, and the wrappers' card-only input
checks; the MoE path's batched expert GEMM, routing rows against the row
count and its decode step through graphs; the SSM path's ``ssd_update``
(states bit-equal to the plain version, rows against the window and the
batch), the gated norm's and the tied logits' rows against the row count,
and the SSM and hybrid decode steps through graphs; the cross-attention
read's rows against the window and the batch at llama-3.2-vision's and
whisper's shapes, head size 160 (stablelm-12b) through every variant, and
the vision and whisper decode steps through graphs; the ring variant of
``flash_decode`` (the sliding window) over a wrapped ring at every head
size a windowed family reaches, its rows against the window and the batch,
and a windowed decode step through graphs; training: the
gradients of ``ssd_update`` and of the cross read against their plain
versions', the other wrappers' refusal of a gradient, a bf16 train step,
a bf16 checkpoint written and read on the card, and a trained checkpoint
served through graphs.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.core.tree import TreeTemplate
from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_paged,
                                              flash_decode_paged_ref, flash_decode_ref)
from repro_torch.kernels.int4_matmul import int4_matmul, int4_matmul_ref, unpack_nk
from repro_torch.kernels.int8_matmul import (int8_matmul, int8_matmul_batched,
                                             int8_matmul_batched_ref, int8_matmul_ref)
from repro_torch.kernels.smooth_quant import (norm_smooth_quant, norm_smooth_quant_ref,
                                               smooth_quant, smooth_quant_ref)
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
    (5, 12288, torch.bfloat16), (3, 100, torch.bfloat16),
    (6, 28672, torch.bfloat16), (24, 13440, torch.bfloat16), (4, 13824, torch.float32)])
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


@pytest.mark.parametrize("d,dtype", [(4096, torch.bfloat16), (576, torch.float32),
                                     (5120, torch.bfloat16), (2048, torch.bfloat16)])
def test_norm_row_does_not_depend_on_row_count(dev, d, dtype):
    """A row's RMSNorm and LayerNorm bits are the same whether it comes
    alone, in vanilla's 4-row step, a 24- or 88-row verify window or a
    prefill: greedy spec tokens equal vanilla's only if every op of the
    verify forward is row-invariant (torch's own row reduction is not)."""
    from repro_torch.models.common import layer_norm, rms_norm

    g = _gen(dev, d)
    x = (torch.randn(4092, d, generator=g, device=dev) * 3).to(dtype)
    scale = torch.rand(d, generator=g, device=dev) + 0.5
    bias = torch.randn(d, generator=g, device=dev)
    for norm in (lambda t: rms_norm(t, scale), lambda t: layer_norm(t, scale, bias)):
        one = norm(x[:1])
        for m in (4, 24, 88, 300, 4092):
            assert torch.equal(norm(x[:m])[:1], one), m
        assert torch.equal(norm(x[:24].view(4, 6, d))[:, 0], norm(x[:24:6])), "(B, T, D)"


@pytest.mark.parametrize("m,k,n", [
    (1, 16, 1), (7, 48, 200), (65, 4096, 130), (130, 80, 64), (24, 12288, 72),
    (300, 256, 96),
    (24, 2560, 10448), (4, 1024, 4384)])    # zamba2's and mamba2's in_proj: N % 64 != 0
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


@pytest.mark.parametrize("m", [1, 8, 9, 24, 25, 49, 88, 96, 176, 193, 256, 257, 300, 4092])
@pytest.mark.parametrize("k,n", [(16 * 37, 200), (4096 + 16, 1100)])
def test_int8_matmul_regime_edges_on_card(dev, m, k, n):
    """Every edge of the launch plan: the wgmma widths (8 | 9 → 24, 24 | 25
    → 48, 49 → 96, 88 → 96, 96, 176 → 192, 193 → 256, 256), the swapped
    regime's end (256 | 257), the tiled
    regime; N not a multiple of the W tile; K a multiple of 16 but not of
    the 128-byte K step, with and without a cluster split of K."""
    g = _gen(dev, m * 7 + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    acc = int8_matmul(x, w, torch.ones(m, device=dev), torch.ones(n, device=dev),
                      out_dtype=torch.float32)
    want = x.cpu().to(torch.int64) @ w.cpu().to(torch.int64).T
    assert torch.equal(acc.cpu().to(torch.int64), want)
    dx = torch.rand(m, generator=g, device=dev) * 1e-2
    dw = torch.rand(n, generator=g, device=dev) * 1e-3
    assert torch.equal(int8_matmul(x, w, dx, dw), int8_matmul_ref(x, w, dx, dw))


@pytest.mark.parametrize("k,n", [(4096, 1100), (4096, 12288)])
def test_int8_matmul_row_does_not_depend_on_m_on_card(dev, k, n):
    """The rows of a 4-row call equal the same rows of 24-, 88-, 300- and
    4092-row calls: both regimes and every cluster split give one int32
    sum and one epilogue per element."""
    g = _gen(dev, k + n)
    x = torch.randint(-127, 128, (4092, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device=dev, dtype=torch.int8)
    dx = torch.rand(4092, generator=g, device=dev) * 1e-2
    dw = torch.rand(n, generator=g, device=dev) * 1e-3
    four = int8_matmul(x[:4], w, dx[:4], dw)
    for m in (24, 88, 300, 4092):
        assert torch.equal(int8_matmul(x[:m], w, dx[:m], dw)[:4], four), m


@pytest.mark.parametrize("m,k,n", [(24, 4096, 12288), (24, 4096, 1024), (4092, 4096, 12288)])
def test_int8_matmul_is_one_kernel_per_call_on_card(dev, m, k, n):
    """One device kernel per call — no workspace memset, no epilogue
    kernel — with a cluster split of K (k/v at M 24) or without: one call
    captured in a graph holds one node, a kernel, and counts one launch."""
    x = torch.randint(-127, 128, (m, k), device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), device=dev, dtype=torch.int8)
    dx, dw = torch.rand(m, device=dev), torch.rand(n, device=dev)
    ops.reset_launch_counts()
    with ops.launches_apart() as counted:
        assert _graph_node_types(lambda: int8_matmul(x, w, dx, dw)) == [0]
    assert counted == {"int8_matmul": 2}                  # the warm-up and the capture


def test_int8_matmul_misaligned_weight_raises_on_card(dev):
    x = torch.zeros(4, 32, dtype=torch.int8, device=dev)
    buf = torch.zeros(8 * 32 + 1, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        int8_matmul(x, buf[1:].view(8, 32), torch.ones(4, device=dev),
                    torch.ones(8, device=dev))


@pytest.mark.parametrize("m,k,n", [
    (1, 2, 1), (7, 48, 200), (65, 4096, 130), (130, 96, 64), (24, 12288, 72),
    (300, 256, 97), (5, 62, 33), (24, 4096, 1031),
    (24, 2560, 10448), (4, 1024, 4384)])    # zamba2's and mamba2's in_proj
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_bit_equal_on_card(dev, m, k, n, out_dtype):
    """Ragged M and N, K not a multiple of the 128-value K step, and K not
    a multiple of 32 (packed rows not 16-byte multiples: the load producer
    instead of TMA)."""
    g = _gen(dev, m + k + n)
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k // 2), generator=g, device=dev, dtype=torch.int8)
    ones_m, ones_n = torch.ones(m, device=dev), torch.ones(n, device=dev)
    # unit scales, f32 out: the output is the int32 accumulator itself
    acc = int4_matmul(x, w, ones_m, ones_n, out_dtype=torch.float32)
    lo = (w.cpu().to(torch.int64) << 60) >> 60
    hi = w.cpu().to(torch.int64) >> 4
    unpacked = torch.stack([lo, hi], dim=2).reshape(n, k)
    assert torch.equal(acc.cpu().to(torch.int64), x.cpu().to(torch.int64) @ unpacked.T)
    dx = torch.rand(m, generator=g, device=dev) * 1e-2
    dw = torch.rand(n, generator=g, device=dev) * 1e-3
    y = int4_matmul(x, w, dx, dw, out_dtype=out_dtype)
    assert y.dtype == out_dtype
    assert torch.equal(y, int4_matmul_ref(x, w, dx, dw, out_dtype))


def test_int4_matmul_unaligned_pointer_on_card(dev):
    """A packed weight that does not start 16-byte aligned takes the load
    producer (byte loads, no TMA) and stays exact."""
    g = _gen(dev, 5)
    x = torch.randint(-127, 128, (9, 128), generator=g, device=dev, dtype=torch.int8)
    buf = torch.randint(-128, 128, (40 * 64 + 1,), generator=g, device=dev, dtype=torch.int8)
    w = buf[1:].view(40, 64)
    dx, dw = torch.rand(9, device=dev), torch.rand(40, device=dev)
    assert torch.equal(int4_matmul(x, w, dx, dw), int4_matmul_ref(x, w, dx, dw))


def _int4_inputs(dev, m, k, n, seed):
    g = _gen(dev, seed)
    x = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-128, 128, (n, k // 2), generator=g, device=dev, dtype=torch.int8)
    dx = torch.rand(m, generator=g, device=dev) * 1e-2
    dw = torch.rand(n, generator=g, device=dev) * 1e-3
    return x, w, dx, dw


@pytest.mark.parametrize("m", [1, 8, 9, 24, 25, 49, 88, 96, 176, 193, 256, 257, 300, 4092])
@pytest.mark.parametrize("k,n", [(32 * 37, 200), (4096 + 32, 1100)])
def test_int4_matmul_regime_edges_on_card(dev, m, k, n):
    """Every edge of the int4 plan: the wgmma widths (8 | 9 → 24, 24 | 25 →
    48, 49 → 96, 88 → 96, 96, 176 → 192, 193 → 256, 256), the swapped
    regime's end (256 | 257) and the X-tiled grid past it; N not a multiple
    of the W tile; K a multiple of 32 but not of the 128-value K step, with
    and without a cluster split of K; weights -8..7, all nibbles."""
    x, w, dx, dw = _int4_inputs(dev, m, k, n, m * 7 + k + n)
    acc = int4_matmul(x, w, torch.ones(m, device=dev), torch.ones(n, device=dev),
                      out_dtype=torch.float32)
    want = x.cpu().to(torch.int64) @ unpack_nk(w.cpu()).to(torch.int64).T
    assert torch.equal(acc.cpu().to(torch.int64), want)
    assert torch.equal(int4_matmul(x, w, dx, dw), int4_matmul_ref(x, w, dx, dw))


@pytest.mark.parametrize("k,n", [(4096, 1100), (4096, 12288), (62, 40)])
def test_int4_matmul_row_does_not_depend_on_m_on_card(dev, k, n):
    """The rows of a 4-row call equal the same rows of 24-, 88-, 176-, 300-
    and 4092-row calls: every width, both grids, every cluster split and
    both producers give one int32 sum and one epilogue per element."""
    x, w, dx, dw = _int4_inputs(dev, 4092, k, n, k + n)
    four = int4_matmul(x[:4], w, dx[:4], dw)
    for m in (24, 88, 176, 300, 4092):
        assert torch.equal(int4_matmul(x[:m], w, dx[:m], dw)[:4], four), m


@pytest.mark.parametrize("m,k,n", [(24, 4096, 12288), (24, 4096, 1024), (88, 4096, 12288),
                                   (4092, 4096, 12288), (5, 62, 33)])
def test_int4_matmul_is_one_kernel_per_call_on_card(dev, m, k, n):
    """One device kernel per call — no workspace memset, no epilogue
    kernel — with a cluster split of K (k/v at M 24, the tree's M 88) or
    without, and with the load producer (K 62): one call captured in a
    graph holds one node, a kernel, and counts one launch.  (Counted by
    graph nodes, not the profiler, whose device records went missing in
    some processes.)"""
    x, w, dx, dw = _int4_inputs(dev, m, k, n, 3)
    ops.reset_launch_counts()
    with ops.launches_apart() as counted:
        assert _graph_node_types(lambda: int4_matmul(x, w, dx, dw)) == [0]
    assert counted == {"int4_matmul": 2}                  # the warm-up and the capture


def _norm_inputs(dev, m, d, dtype, seed, n=3):
    g = _gen(dev, seed)
    x = (torch.randn(m, d, generator=g, device=dev) * 3).to(dtype)
    scale = torch.rand(d, generator=g, device=dev) + 0.5
    smooths = [torch.rand(d, generator=g, device=dev) * 7.875 + 0.125 for _ in range(n)]
    return x, scale, smooths


def _same_codes(got, want):
    for (q, dx), (rq, rdx) in zip(got, want):
        assert torch.equal(q, rq)
        assert torch.equal(dx.view(torch.int32), rdx.view(torch.int32))


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("m,d,dtype", [(1, 4096, torch.bfloat16), (4, 4096, torch.bfloat16),
                                       (24, 4096, torch.bfloat16), (88, 4096, torch.bfloat16),
                                       (176, 4096, torch.bfloat16),
                                       (4092, 4096, torch.bfloat16), (24, 576, torch.float32),
                                       (7, 100, torch.bfloat16), (3, 12288, torch.bfloat16)])
def test_norm_smooth_quant_bit_equal_on_card(dev, m, d, dtype, n):
    """The fused kernel against its plain version (the same sum order in
    elementwise f32 adds, run on the card), bit for bit; D not a multiple
    of the 16-byte vector takes element loads in the same order."""
    x, scale, smooths = _norm_inputs(dev, m, d, dtype, m + d + n, n)
    x[0] = 0                                            # an all-zero row (EPS clamp)
    _same_codes(norm_smooth_quant(x, scale, 1e-5, smooths),
                norm_smooth_quant_ref(x, scale, 1e-5, smooths))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_norm_smooth_quant_non_finite_rows_on_card(dev, dtype):
    """A NaN or inf in a row makes the row's norm NaN, so its Δx is NaN and
    its codes 0, as the plain version gives; other rows are untouched."""
    x, scale, smooths = _norm_inputs(dev, 12, 4096, dtype, 9)
    x[1, 5], x[2, 7], x[4, 9] = float("nan"), float("inf"), float("-inf")
    x[3] = float("nan")
    got = norm_smooth_quant(x, scale, 1e-5, smooths)
    _same_codes(got, norm_smooth_quant_ref(x, scale, 1e-5, smooths))
    for q, dx in got:
        assert dx[[1, 2, 3, 4]].isnan().all() and dx[[0, 5, 6]].isfinite().all()
        assert not q[[1, 2, 3, 4]].any()


@pytest.mark.parametrize("d,dtype", [(4096, torch.bfloat16), (576, torch.float32)])
def test_norm_smooth_quant_rows_do_not_depend_on_row_count_on_card(dev, d, dtype):
    x, scale, smooths = _norm_inputs(dev, 4092, d, dtype, d)
    full = norm_smooth_quant(x, scale, 1e-5, smooths)
    for m in (1, 4, 24, 88, 176, 300):
        got = norm_smooth_quant(x[:m].contiguous(), scale, 1e-5, smooths)
        _same_codes(got, [(q[:m], dx[:m]) for q, dx in full])


@pytest.mark.parametrize("n", [1, 2, 3])
@pytest.mark.parametrize("d", [576, 2048, 4096, 5120, 8192])
@pytest.mark.parametrize("m", [1, 4, 12, 24, 88, 176, 256])
def test_norm_smooth_quant_bit_equal_at_engine_shapes_on_card(dev, m, d, n):
    """The fused norm's body at the rows the engine makes (vanilla 4, a
    window of 6 or 22 at B 4 / 8, a paged tick) and the widths of every
    family (smollm 576, moonshot 2048, the 7B 4096, stablelm 5120, vision
    8192), with 1-3 readers: bit-equal to the plain version."""
    x, scale, smooths = _norm_inputs(dev, m, d, torch.bfloat16, 7 * m + d + n, n)
    _same_codes(norm_smooth_quant(x, scale, 1e-5, smooths),
                norm_smooth_quant_ref(x, scale, 1e-5, smooths))


@pytest.mark.parametrize("d", [2048, 5120, 8192])
def test_norm_smooth_quant_rows_do_not_depend_on_engine_row_count_on_card(dev, d):
    """A row's codes and Δx are the same bits whatever number of rows of
    the engine's shapes shares the call (B·T for T 1, 6 and 22 at B 4 and
    8, 30/60/110 for the GEMM width edges, 176, 256)."""
    x, scale, smooths = _norm_inputs(dev, 256, d, torch.bfloat16, d + 1)
    full = norm_smooth_quant(x, scale, 1e-5, smooths)
    for m in (1, 4, 8, 12, 24, 30, 48, 60, 88, 110, 176):
        got = norm_smooth_quant(x[:m].contiguous(), scale, 1e-5, smooths)
        _same_codes(got, [(q[:m], dx[:m]) for q, dx in full])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_norm_smooth_quant_unaligned_inputs_on_card(dev, dtype):
    """x and the smooth vectors off their 16-byte alignment: the body copies
    the smooth vectors element by element (4-byte cp.async) and loads x
    element by element, bit-equal to the plain version."""
    x, scale, smooths = _norm_inputs(dev, 24, 4097, dtype, 11)
    x = x[:, 1:].contiguous().view(-1)
    xs = torch.empty(x.numel() + 1, dtype=dtype, device=dev)
    xs[1:] = x
    x = xs[1:].view(24, 4096)
    sm = []
    for s_ in smooths:
        buf = torch.empty(4097, device=dev)
        buf[1:] = s_[1:]
        sm.append(buf[1:])
    assert x.data_ptr() % 16 and all(s_.data_ptr() % 16 for s_ in sm)
    scale = scale[1:].contiguous()
    _same_codes(norm_smooth_quant(x, scale, 1e-5, sm), norm_smooth_quant_ref(x, scale, 1e-5, sm))


@pytest.mark.parametrize("verifier", ["w8a8", "w4a8"])
def test_fused_norm_path_equals_plain_path_on_card(dev, verifier, monkeypatch):
    """A 7B-shaped decoder layer (d 4096, 32/8 heads, d_ff 12288) with its
    final norm and lm_head, at the chain window's 24 rows: the logits of the
    fused path (attn_norm → q/k/v, ffn_norm → gate/up, final_norm → lm_head,
    one norm_smooth_quant launch each) equal those of the same path with
    the kernel replaced by its plain version, bit for bit."""
    import repro_torch.kernels.smooth_quant as sq
    from repro_torch.core.config import QuantConfig
    from repro_torch.quant.apply import quantize_params

    cfg = dataclasses.replace(get_config("quasar-paper-7b"), num_layers=1)
    model = Model(cfg, device=dev)
    params = quantize_params(model.init_params(_gen(dev, 4)),
                             qcfg=QuantConfig(w_bits=8 if verifier == "w8a8" else 4))
    tokens = torch.randint(0, cfg.vocab_size, (4, 6), generator=_gen(dev, 5), device=dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        fused, _ = model.forward(params, tokens)
    assert ops.launch_counts()["norm_smooth_quant"] == 3
    monkeypatch.setattr(sq, "norm_smooth_quant",
                        lambda x, scale, eps, smooths: norm_smooth_quant_ref(x, scale, eps,
                                                                             smooths))
    with torch.no_grad():
        plain, _ = model.forward(params, tokens)
    assert torch.isfinite(fused).all()
    assert torch.equal(fused, plain)


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 12288), (12288, 4096)])
def test_bf16_linear_row_does_not_depend_on_m_on_card(dev, k, n):
    """The bf16 verifier's linear (``models/linear.Linear``): a row of a
    4-row call (vanilla's step) equals the same row in 12-, 24- and 88-row
    calls (the chain window at B 2 and 4, the tree window), so greedy spec
    tokens can equal vanilla's with the bf16 verifier too (at M 12 cuBLAS
    took another kernel for (4096, 4096) and (4096, 1024) before every
    call ran one padded shape)."""
    from repro_torch.models.linear import Linear

    g = _gen(dev, k + n)
    lin = Linear((torch.randn(k, n, generator=g, device=dev) * k ** -0.5).to(torch.bfloat16))
    x = torch.randn(88, k, generator=g, device=dev).to(torch.bfloat16)
    four = lin(x[:4])
    for m in (12, 24, 88):
        assert torch.equal(lin(x[:m])[:4], four), m
    assert torch.equal(lin(x[:24].view(4, 6, k))[:, 0], lin(x[:24:6])), "(B, T, K)"


def test_scheduled_sampling_equals_solo_on_card(dev):
    """T > 0 on the card: five requests through two slots (slots recycled)
    each sample the tokens they sample alone — a row's draws and the
    reductions over its 151936-wide vocabulary (softmax, the residual's
    sum) do not depend on the rows beside it."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.request import GenerationRequest

    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), vocab_size=151936)
    model = Model(cfg, device=dev)
    params = model.init_params(_gen(dev, 2))
    rng = np.random.default_rng(4)
    pat = rng.integers(0, cfg.vocab_size, 6)
    reqs = [GenerationRequest(np.tile(pat, k), max_new_tokens=n, seed=k, temperature=1.0)
            for k, n in ((5, 9), (4, 12), (3, 7), (6, 5), (4, 10))]
    for drafter in ("ngram", "pruned"):
        eng = SpecEngine(model, SpecConfig(temperature=1.0, gamma=3, drafter=drafter,
                                           verifier="w8a8", pruned_retention=0.5))
        got = eng.generate_requests(params, reqs, batch_slots=2)
        for r, req in zip(got, reqs):
            alone = eng.generate_requests(params, [req], batch_slots=1)[0]
            assert not r.bad
            np.testing.assert_array_equal(r.tokens, alone.tokens)


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
    (4, 6, 1152, 16, 1, 128),  # moonshot's verify window: MHA, G = 1
    (1, 1, 6, 3, 3, 64),       # S shorter than the window's chunk
    (2, 3, 300, 2, 9, 32),     # G·T = 27: not a multiple of the 16-row tile
    (3, 5, 700, 2, 7, 64),     # G·T = 35, three tiles, the last nearly empty
    (4, 6, 1152, 32, 1, 80),   # zamba2's shared attention: dh 80 (5 k steps of 16)
    (2, 1, 300, 3, 2, 80),     # dh 80, vanilla's window, a partial split
    (4, 6, 1152, 8, 4, 160),   # stablelm-12b's verify window: dh 160 (20 dim tiles)
    (2, 1, 300, 3, 2, 160),    # dh 160, vanilla's window, a partial split
    (4, 6, 1152, 32, 1, 128)])  # codeqwen's verify window: MHA at 32 KV heads
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


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("start", [5, 120, 1040])
def test_flash_decode_every_window_row_equals_its_row_alone(dev, start, int8):
    """Every row t of a verify window (T = 6) gives the bits of the same
    query alone (T = 1) at its position — the slots past it, which the
    window holds and the lone query does not, add nothing.  Windows that
    start in the first split, end across a split edge, and sit deep in the
    cache."""
    q, k, v, _, kw = _attn(dev, 2, 6, 1152, 8, 4, 128, torch.bfloat16, int8, seed=start)
    qpos = (start + torch.arange(6, device=dev)).expand(2, 6).to(torch.int32).contiguous()
    full = flash_decode(q, k, v, qpos, **kw)
    for t in range(6):
        alone = flash_decode(q[:, t:t + 1].contiguous(), k, v, qpos[:, t:t + 1].contiguous(),
                             **kw)
        assert torch.equal(alone, full[:, t:t + 1]), t


def _tree_attn(dev, branches, b, s, hkv, g, dh, dtype, int8, seed):
    tpl = TreeTemplate(branches)
    T = tpl.num_nodes
    q, k, v, _, kw = _attn(dev, b, T, s, hkv, g, dh, dtype, int8, seed)
    gen = _gen(dev, seed + 1)
    win_start = torch.randint(0, s - T + 1, (b,), generator=gen, device=dev).to(torch.int32)
    win_start[0] = s - T                    # one window ends at the last slot
    tables = tpl.on(dev)
    qpos = (win_start[:, None] + tables.depths[None, :]).to(torch.int32).contiguous()
    kw.update(tree_mask=tables.mask, win_start=win_start)
    return q, k, v, qpos, kw, tables


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("branches,b,s,hkv,g,dh", [
    ((3, 2, 1, 1), 4, 1152, 8, 4, 128),   # the 7B tree window
    ((3, 2, 1, 1), 4, 1152, 16, 1, 128),  # moonshot's tree window: MHA, G = 1
    ((2, 2), 2, 300, 2, 3, 64),           # several splits, the window in the last
    ((4, 4, 4), 2, 700, 8, 4, 128),       # 340 rows per KV head: three row blocks
    ((64,), 1, 200, 2, 4, 128),           # the widest template: 260 rows
    ((3, 1), 2, 40, 1, 9, 32),            # S under one split
    ((1,) * 40, 1, 160, 1, 2, 64),        # a 41-node chain: two mask words per node
    ((2, 1), 2, 500, 2, 7, 32),           # G·T = 35 at dh 32
    ((3, 2, 1, 1), 4, 1152, 8, 4, 160),   # stablelm-12b's tree window: dh 160
    ((3, 2, 1, 1), 4, 1152, 32, 1, 128)])  # codeqwen's tree window: G = 1, 32 KV heads
def test_flash_decode_tree_matches_plain_on_card(dev, branches, b, s, hkv, g, dh, dtype,
                                                 int8):
    q, k, v, qpos, kw, tables = _tree_attn(dev, branches, b, s, hkv, g, dh, dtype, int8,
                                           seed=s + g)
    ops.reset_launch_counts()
    o = flash_decode(q, k, v, qpos, tree_bits=tables.mask_bits, **kw)
    o2 = flash_decode(q, k, v, qpos, **kw)      # bit words made from the mask
    ro = flash_decode_ref(q, k, v, qpos, **kw)
    torch.cuda.synchronize()
    name = "flash_decode_tree_int8" if int8 else "flash_decode_tree"
    assert ops.launch_counts() == {name: 2}
    assert torch.equal(o, o2)
    assert o.dtype == dtype and bool(torch.isfinite(o).all())
    if dtype == torch.float32:
        torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(o.float(), ro.float(), rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("t,dtype", [(6, torch.bfloat16), (6, torch.float32),
                                     (1, torch.bfloat16), (43, torch.bfloat16)])
def test_flash_decode_chain_template_tree_bit_equal_to_chain(dev, t, dtype, int8):
    """The tree variant with the chain template (lower-triangular mask,
    win_start = start) gives the chain variant's bits: same splits, same
    visible keys, same order of sums — also when G*T rows span row blocks."""
    g = 4
    q, k, v, qpos, kw = _attn(dev, 4, t, 1152, 8, g, 128, dtype, int8, seed=t)
    tables = TreeTemplate.chain(t - 1).on(dev)
    chain = flash_decode(q, k, v, qpos, **kw)
    tree = flash_decode(q, k, v, qpos, tree_mask=tables.mask, win_start=qpos[:, 0].contiguous(),
                        tree_bits=tables.mask_bits, **kw)
    assert torch.equal(chain, tree)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("branches,g", [((3, 2, 1, 1), 1), ((3, 2, 1, 1), 4), ((3, 2, 1, 1), 9),
                                        ((4, 4, 4), 1), ((4, 4, 4), 4), ((4, 4, 4), 9)])
def test_flash_decode_tree_root_row_equals_vanilla_row(dev, branches, g, int8):
    """The root row of a tree window sees the slots before the window by
    position and itself by the mask — the keys a T = 1 chain query at
    qpos = win_start sees — and gives that query's bits, wherever the root
    rows fall among the 16-row tiles and row blocks (G·T from 22 to 765)."""
    q, k, v, qpos, kw, tables = _tree_attn(dev, branches, 2, 1152, 2, g, 128,
                                           torch.bfloat16, int8, seed=7 * g)
    tree = flash_decode(q, k, v, qpos, tree_bits=tables.mask_bits, **kw)
    scales = {n: kw[n] for n in ("k_scale", "v_scale") if n in kw}
    root = flash_decode(q[:, :1].contiguous(), k, v, kw["win_start"][:, None].contiguous(),
                        **scales)
    assert torch.equal(tree[:, :1], root)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tree", [False, True])
def test_flash_decode_batch_row_does_not_depend_on_batch(dev, tree, int8):
    """Each batch row run alone (B = 1) gives its row of the B = 4 call, bit
    for bit, for the chain (T 6) and the (3,2,1,1) tree window."""
    if tree:
        q, k, v, qpos, kw, tables = _tree_attn(dev, (3, 2, 1, 1), 4, 1152, 8, 4, 128,
                                               torch.bfloat16, int8, seed=11)
        kw["tree_bits"] = tables.mask_bits
    else:
        q, k, v, qpos, kw = _attn(dev, 4, 6, 1152, 8, 4, 128, torch.bfloat16, int8, seed=11)
    full = flash_decode(q, k, v, qpos, **kw)
    for b in range(4):
        one = {n: (x[b:b + 1].contiguous() if n in ("k_scale", "v_scale", "win_start") else x)
               for n, x in kw.items()}
        alone = flash_decode(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                             v[b:b + 1].contiguous(), qpos[b:b + 1].contiguous(), **one)
        assert torch.equal(alone, full[b:b + 1])


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tree", [False, True])
def test_flash_decode_dh160_rows_do_not_depend_on_window_or_batch(dev, tree, int8):
    """At stablelm-12b's head size 160 (32/8 heads) a row's bits are the
    same alone (T = 1 at its position, or the tree's root at the window's
    start) as in the window, and alone (B = 1) as in the batch of 4."""
    if tree:
        q, k, v, qpos, kw, tables = _tree_attn(dev, (3, 2, 1, 1), 4, 1152, 8, 4, 160,
                                               torch.bfloat16, int8, seed=160)
        kw["tree_bits"] = tables.mask_bits
    else:
        q, k, v, qpos, kw = _attn(dev, 4, 6, 1152, 8, 4, 160, torch.bfloat16, int8, seed=160)
    full = flash_decode(q, k, v, qpos, **kw)
    scales = {n: kw[n] for n in ("k_scale", "v_scale") if n in kw}
    root = flash_decode(q[:, :1].contiguous(), k, v, qpos[:, :1].contiguous(), **scales)
    assert torch.equal(full[:, :1], root)
    for b in range(4):
        one = {n: (x[b:b + 1].contiguous() if n in ("k_scale", "v_scale", "win_start") else x)
               for n, x in kw.items()}
        alone = flash_decode(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                             v[b:b + 1].contiguous(), qpos[b:b + 1].contiguous(), **one)
        assert torch.equal(alone, full[b:b + 1])


def _ring_attn(dev, b, t, window, hkv, g, dh, dtype, int8, seed, past=None):
    """A ring of ``window + RING_PAD`` slots filled as the model's writes
    leave it: a prefill of ``past`` tokens (by default 1.5 rings: the T >= S
    write), then the query window's own K/V at its positions.  Returns (q,
    cache, qpos)."""
    import types

    from repro_torch.models.attention import RING_PAD, init_attn_cache, write_cache

    gen = _gen(dev, seed)
    cfg = types.SimpleNamespace(num_kv_heads=hkv, head_dim=dh, dtype=dtype,
                                kv_cache_dtype="int8" if int8 else "bf16")
    cache = init_attn_cache(cfg, b, window, dev, window)
    S = window + RING_PAD
    past = past if past is not None else S + S // 2
    for start, n in ((0, past), (past, t)):
        k = torch.randn(b, n, hkv, dh, generator=gen, device=dev).to(dtype)
        v = torch.randn(b, n, hkv, dh, generator=gen, device=dev).to(dtype)
        pos = (start + torch.arange(n, device=dev)).to(torch.int32).expand(b, n)
        write_cache(cache, k, v, pos.contiguous())
    q = torch.randn(b, t, hkv * g, dh, generator=gen, device=dev).to(dtype)
    qpos = (past + torch.arange(t, device=dev)).to(torch.int32).expand(b, t).contiguous()
    return q, cache, qpos


def _ring_kw(cache, window):
    return dict(k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                kpos=cache["kpos"], window=window)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,t,window,hkv,g,dh,past", [
    (2, 1, 8, 2, 2, 64, None),         # a ring of 136 slots: two splits, the last partial
    (2, 6, 8, 2, 2, 64, None),
    (4, 6, 4096, 8, 4, 128, None),     # quasar-paper-7b at long_500k's window (4224 slots)
    (4, 1, 4096, 8, 4, 128, None),
    (1, 6, 4096, 8, 4, 128, None),     # the long_500k read's B 1
    (1, 1, 4096, 8, 4, 128, None),
    (4, 6, 4096, 8, 4, 128, 1024),     # partly filled: slots past 1030 unwritten
    (1, 1, 4096, 8, 4, 128, 1024),
    (2, 6, 4096, 8, 4, 128, 0),        # a fresh ring: the window's own keys alone
    (2, 6, 64, 32, 1, 80, None),       # zamba2's shared attention
    (2, 6, 64, 8, 4, 160, None)])      # stablelm-12b
def test_flash_decode_ring_matches_plain_on_card(dev, b, t, window, hkv, g, dh, past, dtype,
                                                 int8):
    """The ring variant (``kpos``/``window``) over a wrapped, a partly
    filled and a fresh ring against its plain version: every key at most
    ``window - 1`` positions back visible, the rest (older keys, unwritten
    or future slots) masked."""
    q, cache, qpos = _ring_attn(dev, b, t, window, hkv, g, dh, dtype, int8, seed=window + t,
                                past=past)
    kw = _ring_kw(cache, window)
    ops.reset_launch_counts()
    o = flash_decode(q, cache["k"], cache["v"], qpos, **kw)
    assert ops.launch_counts() == {"flash_decode_ring" + "_int8" * int8: 1}
    ro = flash_decode_ref(q, cache["k"], cache["v"], qpos, **kw)
    assert o.dtype == dtype and bool(torch.isfinite(o).all())
    if dtype == torch.float32:
        torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
    else:
        torch.testing.assert_close(o.float(), ro.float(), rtol=2 ** -7, atol=1e-5)
    # the window matters once the ring holds keys older than it: without it
    # (every older key visible) the output moves
    if int(qpos.max()) >= window:
        wide = flash_decode_ref(q, cache["k"], cache["v"], qpos, k_scale=kw["k_scale"],
                                v_scale=kw["v_scale"], kpos=cache["kpos"], window=2 ** 29)
        assert (wide.float() - ro.float()).abs().max() > 1e-2


@pytest.mark.parametrize("past", [None, 1024])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dh", [64, 80, 128, 160])
def test_flash_decode_ring_rows_do_not_depend_on_window_or_batch(dev, dh, int8, past):
    """Over a wrapped ring (``past`` None) and a partly filled one (1030 of
    4224 slots written, the rest unwritten) a row's bits are the same in a
    window of any T in 1..6 (its first T rows) as in the verify window of
    6, and in a batch of 1 or 2 as in the batch of 4: the splits, the key
    slices and the chunks' order depend on S alone, and a chunk skipped
    for one window (no row of its block sees it) adds exact zeros in the
    other."""
    q, cache, qpos = _ring_attn(dev, 4, 6, 4096, 8, 4, dh, torch.bfloat16, int8, seed=dh,
                                past=past)
    kw = _ring_kw(cache, 4096)
    full = flash_decode(q, cache["k"], cache["v"], qpos, **kw)
    for t in range(1, 7):
        first = flash_decode(q[:, :t].contiguous(), cache["k"], cache["v"],
                             qpos[:, :t].contiguous(), **kw)
        assert torch.equal(full[:, :t], first), t
    for n in (1, 2):
        for b in range(0, 4, n):
            rows = slice(b, b + n)
            one = {k: (x[rows].contiguous() if isinstance(x, torch.Tensor) else x)
                   for k, x in kw.items()}
            alone = flash_decode(q[rows].contiguous(), cache["k"][rows].contiguous(),
                                 cache["v"][rows].contiguous(), qpos[rows].contiguous(),
                                 **one)
            assert torch.equal(alone, full[rows]), (n, b)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("verifier", ["w8a8", "bf16"])
def test_ring_graph_replay_equals_eager_on_card(dev, verifier, kv):
    """A windowed model (window 16, rings of 144 slots) on 180-token prompts:
    ``generate`` through captured steps gives the eager steps' tokens and
    launches, the ring read launched at every step; greedy ngram ≡ vanilla
    (row invariance over the ring)."""
    from repro_torch.core.config import SpecConfig

    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), vocab_size=151936,
                              kv_cache_dtype=kv, sliding_window=16)
    model = Model(cfg, device=dev)
    raw = model.init_params(_gen(dev, 3))
    pat = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 7))
    prompts = torch.from_numpy(np.tile(pat, 26)[:, :180].astype(np.int32)).to(dev)
    toks = {}
    for drafter in ("ngram", "vanilla"):
        scfg = SpecConfig(temperature=0.0, verifier=verifier, **GRAPH_DRAFTERS[drafter])
        out = _eager_and_graph(model, scfg, lambda eng: eng.generate(raw, prompts, 24))
        (eager, n_eager, _), (graph, n_graph, g_eng) = out[False], out[True]
        assert torch.equal(graph.tokens, eager.tokens) and not graph.bad.any()
        ring = "flash_decode_ring" + "_int8" * (kv == "int8")
        assert n_graph == n_eager and n_graph[ring] >= graph.steps * cfg.num_layers
        assert g_eng._programs.captures == 1
        toks[drafter] = graph.tokens[:, :180 + 24]
    assert torch.equal(toks["ngram"], toks["vanilla"])


@pytest.mark.parametrize("hq,hkv,sa,dh", [(64, 8, 1600, 128),    # llama-3.2-vision
                                          (12, 12, 1500, 64)])   # whisper-small
def test_cross_attention_row_does_not_depend_on_t_on_card(dev, hq, hkv, sa, dh):
    """The cross-attention read (``models/attention.cross_attend``: every
    query at position Sa - 1, so every key is visible) gives a row's bits
    whatever the window (T = 1 against γ+1 = 6) and the batch (B = 1
    against 4), and agrees with the plain non-causal attention within one
    bf16 rounding step."""
    from repro_torch.models.attention import _mask, _attend_direct, cross_attend

    g = _gen(dev, sa)
    q = torch.randn(4, 6, hq, dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(4, sa, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(4, sa, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
    ops.reset_launch_counts()
    full = cross_attend(q, k, v)
    assert ops.launch_counts() == {"flash_decode_cross": 1}
    for t in range(6):
        assert torch.equal(cross_attend(q[:, t:t + 1].contiguous(), k, v), full[:, t:t + 1]), t
    for b in range(4):
        alone = cross_attend(q[b:b + 1].contiguous(), k[b:b + 1].contiguous(),
                             v[b:b + 1].contiguous())
        assert torch.equal(alone, full[b:b + 1]), b
    zeros = torch.zeros((4, 6), dtype=torch.int32, device=dev)
    valid = _mask(zeros, torch.zeros(sa, dtype=torch.int32, device=dev), causal=False)
    plain = _attend_direct(q, k, v, valid)
    torch.testing.assert_close(full.float(), plain.float(), rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,hq,hkv,sa,dh", [
    (4, 6, 12, 12, 1500, 64),      # whisper-small
    (4, 6, 64, 8, 1600, 128),      # llama-3.2-vision-90b
    (2, 6, 64, 8, 1000, 128),      # S not a multiple of the 16-key chunk: four splits of 256
    (3, 5, 12, 12, 40, 64),        # S shorter than one split (and than one 128-key split)
    (2, 1, 8, 8, 9, 32),           # a reduced config's 9 keys, T 1
    (1, 64, 12, 12, 1500, 64),     # a training-sized window: 64 rows per KV head
    (1, 64, 64, 8, 1600, 128),     # 512 rows per KV head: eight row blocks
    (2, 6, 32, 32, 700, 80),       # every other instantiated head size
    (2, 6, 32, 8, 300, 160),
    (2, 3, 8, 2, 257, 32)])
def test_cross_read_matches_plain_on_card(dev, b, t, hq, hkv, sa, dh, dtype):
    """The cross read (``flash_decode_cross``: no positions; bf16 through
    the sliced body, f32 through the f32 body) within one bf16 rounding
    step of its plain version (``flash_decode_ref`` with every query at
    Sa - 1), one counted launch per call."""
    from repro_torch.kernels.flash_decode import flash_decode_cross

    g = _gen(dev, b * t * sa + dh)
    q = torch.randn(b, t, hq, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(b, sa, hkv, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(b, sa, hkv, dh, generator=g, device=dev).to(dtype)
    qpos = torch.full((b, t), sa - 1, dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    o = flash_decode_cross(q, k, v)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"flash_decode_cross": 1}
    assert o.shape == q.shape and o.dtype == dtype and torch.isfinite(o).all()
    torch.testing.assert_close(o.float(), flash_decode_ref(q, k, v, qpos).float(),
                               rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("hq,hkv,sa,dh", [(64, 8, 1600, 128),    # llama-3.2-vision
                                          (12, 12, 1500, 64)])   # whisper-small
def test_cross_read_is_one_kernel_per_call_on_card(dev, hq, hkv, sa, dh):
    """A bf16 cross read is one device kernel, its splits merged inside it:
    one call captured in a graph holds one node, a kernel (no fill of
    positions, no merge kernel), and counts one launch."""
    from repro_torch.kernels.flash_decode import flash_decode_cross

    g = _gen(dev, sa + dh)
    q = torch.randn(4, 6, hq, dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(4, sa, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(4, sa, hkv, dh, generator=g, device=dev).to(torch.bfloat16)
    with ops.launches_apart() as counted:
        assert _graph_node_types(lambda: flash_decode_cross(q, k, v)) == [0]
    assert counted == {"flash_decode_cross": 2}           # the warm-up and the capture


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tree", [False, True])
def test_flash_decode_paged_dh160_bit_equal_to_contiguous_on_card(dev, tree, int8):
    """stablelm-12b's paged read (head size 160, block 128, and 24, which
    divides neither the 32-key chunk nor the 128-key split): the contiguous
    kernel's bits over the same logical content."""
    for bs in (128, 24):
        if tree:
            q, k, v, qpos, kw, tables = _tree_attn(dev, (3, 2, 1, 1), 4, 1152, 8, 4, 160,
                                                   torch.bfloat16, int8, seed=bs)
            kw["tree_bits"] = tables.mask_bits
        else:
            q, k, v, qpos, kw = _attn(dev, 4, 6, 1152, 8, 4, 160, torch.bfloat16, int8,
                                      seed=bs)
        bt, pages = _to_pages(dev, bs, bs + 160, k, v, kw)
        contig = flash_decode(q, k, v, qpos, **kw)
        pkw = {n: kw[n] for n in ("tree_mask", "win_start", "tree_bits") if n in kw}
        paged = flash_decode_paged(q, pages["k"], pages["v"], bt, qpos,
                                   k_scale=pages.get("k_scale"), v_scale=pages.get("v_scale"),
                                   **pkw)
        assert torch.equal(paged, contig), bs


def _to_pages(dev, bs, seed, k, v, kw):
    """The same logical content as contiguous k/v (B, S, Hkv, dh) (+ scales)
    in shuffled physical blocks of size ``bs`` behind a (B, nb) table whose
    last two logical blocks are scratch (0); the scratch block and three
    spare blocks hold junk."""
    B, S, Hkv, dh = k.shape
    used = -(-S // bs)
    nb, N = used + 2, 1 + B * used + 3
    g = torch.Generator().manual_seed(seed)
    bt = torch.zeros((B, nb), dtype=torch.int32)
    bt[:, :used] = (torch.randperm(N - 1, generator=g)[:B * used] + 1).view(B, used)
    bt = bt.to(dev)
    rows = bt[:, :used].reshape(-1).long()
    pages = {}
    for name, x in (("k", k), ("v", v), ("k_scale", kw.get("k_scale")),
                    ("v_scale", kw.get("v_scale"))):
        if x is None:
            continue
        junk = torch.randn((N, bs) + tuple(x.shape[2:]), generator=g) * 3
        pool = (junk.to(torch.int8) if x.dtype == torch.int8 else junk.to(x.dtype)).to(dev)
        pad = torch.zeros((B, used * bs - S) + tuple(x.shape[2:]), dtype=x.dtype, device=dev)
        pool[rows] = torch.cat([x, pad], dim=1).reshape((B * used, bs) + tuple(x.shape[2:]))
        pages[name] = pool
    return bt, pages


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("tree", [False, True])
@pytest.mark.parametrize("bs,s,b,hkv,g", [
    (8, 300, 4, 8, 4), (16, 1152, 4, 8, 4), (128, 1152, 4, 8, 4), (24, 300, 4, 8, 4),
    (5, 97, 4, 8, 4),
    (128, 1152, 8, 16, 1)])    # moonshot's paged run: 8 slots, MHA, G = 1
def test_flash_decode_paged_bit_equal_to_contiguous_on_card(dev, bs, s, b, hkv, g, tree,
                                                            int8):
    """Over the same logical content the paged kernel gives the contiguous
    kernel's bits — for block sizes that divide the 32-key chunk, equal the
    128-key split, and divide neither (24, 5) — and agrees with its plain
    version within one bf16 rounding step."""
    if tree:
        q, k, v, qpos, kw, tables = _tree_attn(dev, (3, 2, 1, 1), b, s, hkv, g, 128,
                                               torch.bfloat16, int8, seed=bs)
        kw["tree_bits"] = tables.mask_bits
    else:
        q, k, v, qpos, kw = _attn(dev, b, 6, s, hkv, g, 128, torch.bfloat16, int8, seed=bs)
    bt, pages = _to_pages(dev, bs, bs + s, k, v, kw)
    ops.reset_launch_counts()
    contig = flash_decode(q, k, v, qpos, **kw)
    pkw = {n: kw[n] for n in ("tree_mask", "win_start", "tree_bits") if n in kw}
    paged = flash_decode_paged(q, pages["k"], pages["v"], bt, qpos,
                               k_scale=pages.get("k_scale"), v_scale=pages.get("v_scale"),
                               **pkw)
    ref = flash_decode_paged_ref(q, pages["k"], pages["v"], bt, qpos, pages.get("k_scale"),
                                 pages.get("v_scale"), kw.get("tree_mask"),
                                 kw.get("win_start"))
    torch.cuda.synchronize()
    name = "flash_decode_paged" + "_tree" * tree + "_int8" * int8
    assert ops.launch_counts()[name] == 1
    assert torch.equal(paged, contig)
    assert bool(torch.isfinite(paged).all())
    torch.testing.assert_close(paged.float(), ref.float(), rtol=2 ** -7, atol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
def test_flash_decode_paged_idle_rows_read_scratch_on_card(dev, int8):
    """Idle rows — an all-scratch table, positions at the window's start 0
    — read only the scratch block: finite, equal to the plain version, and
    the live rows beside them keep the contiguous kernel's bits."""
    q, k, v, qpos, kw = _attn(dev, 4, 6, 500, 8, 4, 128, torch.bfloat16, int8, seed=9)
    bt, pages = _to_pages(dev, 16, 3, k, v, kw)
    bt[1:3] = 0
    qpos[1:3] = torch.arange(6, device=dev, dtype=torch.int32)
    sc = dict(k_scale=pages.get("k_scale"), v_scale=pages.get("v_scale"))
    out = flash_decode_paged(q, pages["k"], pages["v"], bt, qpos, **sc)
    ref = flash_decode_paged_ref(q, pages["k"], pages["v"], bt, qpos, sc["k_scale"],
                                 sc["v_scale"])
    contig = flash_decode(q, k, v, qpos, **kw)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7, atol=1e-5)
    assert torch.equal(out[[0, 3]], contig[[0, 3]])


def test_flash_decode_paged_rejects_bad_tables_on_card(dev):
    q, k, v, qpos, kw = _attn(dev, 2, 1, 64, 1, 2, 32, torch.float32, False, seed=1)
    bt, pages = _to_pages(dev, 16, 1, k, v, kw)
    for bad in (bt.long(), bt[:1], bt.cpu(), bt.t().contiguous()[:, :2].t()):
        with pytest.raises(ValueError, match="bt must be|devices|contiguous"):
            flash_decode_paged(q, pages["k"], pages["v"], bad, qpos)


def test_paged_generate_requests_equals_contiguous_on_card(dev):
    """Scheduled serving on the card through the kernels: paged (prefix
    sharing on, block 16) gives the contiguous layout's tokens per request,
    and the paged kernel is what read the cache."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.request import GenerationRequest

    cfg = get_config("smollm-135m").reduced()
    model = Model(cfg, device=dev)
    params = model.init_params(_gen(dev, 0))
    rng = np.random.default_rng(3)
    pat = rng.integers(0, cfg.vocab_size, 6)
    reqs = [GenerationRequest(np.tile(pat, k), max_new_tokens=n, seed=k)
            for k, n in ((5, 9), (4, 12), (3, 7), (6, 5), (4, 10))]
    out = {}
    for layout in ("contiguous", "paged"):
        scfg = SpecConfig(temperature=0.0, gamma=3, verifier="w8a8", kv_layout=layout,
                          kv_block_size=16)
        ops.reset_launch_counts()
        eng = SpecEngine(model, scfg)
        out[layout] = eng.generate_requests(params, reqs, batch_slots=2)
        counts = ops.launch_counts()
        assert counts.get("flash_decode_paged" if layout == "paged" else "flash_decode", 0) > 0
    assert eng.group_stats[0]["shared_blocks"] > 0
    for a, b in zip(out["contiguous"], out["paged"]):
        assert not a.bad and not b.bad
        np.testing.assert_array_equal(a.tokens, b.tokens)


def _nan_row_run(dev, verifier, **spec):
    """Serve two rows with a NaN planted in row 0's activations (an
    embedding row only that row's prompt uses); returns (result, launch
    counts)."""
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
    scfg = SpecConfig(temperature=0.0, verifier=verifier, **spec)
    r = SpecEngine(model, scfg).generate(params, prompt.to(dev), 4)
    return r, ops.launch_counts()


def test_nan_activation_sets_bad_row_on_card(dev):
    """The planted NaN reaches row 0's W8A8 verifier logits through the
    smooth_quant and int8_matmul kernels and sets its ``bad`` flag."""
    r, counts = _nan_row_run(dev, "w8a8", gamma=4, drafter="ngram")
    assert counts.get("smooth_quant", 0) > 0 and counts.get("int8_matmul", 0) > 0
    assert r.bad.tolist() == [True, False]


@pytest.mark.parametrize("spec", [dict(gamma=4, drafter="ngram"),
                                  dict(drafter="ngram-tree", tree_branches=(3, 2, 1, 1))])
def test_w4a8_nan_activation_sets_bad_row_on_card(dev, spec):
    """The same through the W4A8 path (smooth_quant and int4_matmul), on the
    chain and the tree route."""
    r, counts = _nan_row_run(dev, "w4a8", **spec)
    assert counts.get("smooth_quant", 0) > 0 and counts.get("int4_matmul", 0) > 0
    assert "int8_matmul" not in counts
    assert r.bad.tolist() == [True, False]


def test_each_launch_counts_once(dev):
    x = torch.randn(4, 64, device=dev)
    s = torch.ones(64, device=dev)
    w = torch.ones(32, 64, dtype=torch.int8, device=dev)
    q, k, v, qpos, kw = _attn(dev, 1, 2, 40, 1, 2, 32, torch.float32, True, seed=0)
    tree = dict(tree_mask=torch.ones(2, 2, dtype=torch.bool, device=dev).tril(),
                win_start=qpos[:, 0].contiguous())
    ops.reset_launch_counts()
    xq, dx = smooth_quant(x, s)
    int8_matmul(xq, w, dx, torch.ones(32, device=dev))
    int4_matmul(xq, w[:, :32].contiguous(), dx, torch.ones(32, device=dev))
    flash_decode(q, k, v, qpos, **kw)
    flash_decode(q, k.float(), v.float(), qpos)
    flash_decode(q, k, v, qpos, **kw, **tree)
    flash_decode(q, k.float(), v.float(), qpos, **tree)
    bt, pages = _to_pages(dev, 8, 0, k, v, kw)
    pk = dict(k_scale=pages["k_scale"], v_scale=pages["v_scale"])
    fk, fv = pages["k"].float().contiguous(), pages["v"].float().contiguous()
    flash_decode_paged(q, pages["k"], pages["v"], bt, qpos, **pk)
    flash_decode_paged(q, fk, fv, bt, qpos)
    flash_decode_paged(q, pages["k"], pages["v"], bt, qpos, **pk, **tree)
    flash_decode_paged(q, fk, fv, bt, qpos, **tree)
    ops.w8a8_matmul(x, w, torch.ones(32, device=dev), s)
    ops.w4a8_matmul(x, w[:, :32].contiguous(), torch.ones(32, device=dev), s)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"smooth_quant": 3, "int8_matmul": 2, "int4_matmul": 2,
                                   "flash_decode": 1, "flash_decode_int8": 1,
                                   "flash_decode_tree": 1, "flash_decode_tree_int8": 1,
                                   "flash_decode_paged": 1, "flash_decode_paged_int8": 1,
                                   "flash_decode_paged_tree": 1,
                                   "flash_decode_paged_tree_int8": 1}


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


@pytest.mark.parametrize("verifier", ["bf16", "w4a8"])
def test_tree_verify_step_on_card_matches_cpu(dev, verifier):
    """Prefill → tree verify_step ((3, 2, 1, 1) window) → commit_tree on the
    card (through the kernels) against the same weights on the CPU (plain
    versions), f32 reduced config; W4A8 held to 1e-2 as W8A8 is above."""
    from repro_torch.quant.apply import quantize_params
    from repro_torch.core.config import QuantConfig

    cfg = get_config("smollm-135m").reduced()
    cpu = Model(cfg, device="cpu")
    params = cpu.init_params(torch.Generator().manual_seed(0))
    if verifier == "w4a8":
        params = quantize_params(params, qcfg=QuantConfig(w_bits=4))
    gpu = Model(cfg, device=dev)
    params_gpu = copy.deepcopy(params).to(dev)
    tpl = TreeTemplate((3, 2, 1, 1))
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 22 + tpl.num_nodes))
                            .astype(np.int32))
    start = torch.tensor([22, 22], dtype=torch.int32)
    path = torch.from_numpy(np.stack([tpl.paths[3], tpl.paths[0]])).to(torch.int32)
    n_accept = torch.tensor([4, 1], dtype=torch.int32)
    out, caches = [], []
    for m, p, d in ((cpu, params, "cpu"), (gpu, params_gpu, dev)):
        t = tpl.on(d)
        cache = m.prefill(p, m.init_cache(2, 60), toks[:, :22].to(d))
        logits, cache = m.verify_step(p, cache, toks[:, 22:].to(d), start.to(d),
                                      tree_depths=t.depths, tree_mask=t.mask,
                                      tree_bits=t.mask_bits)
        cache = m.commit_tree(cache, start.to(d), path.to(d), n_accept.to(d))
        out.append(logits.cpu())
        caches.append(cache["layers"][1]["k"][:, :27].cpu())
    tol = 1e-2 if verifier == "w4a8" else 1e-4
    torch.testing.assert_close(out[1], out[0], rtol=tol, atol=tol)
    torch.testing.assert_close(caches[1], caches[0], rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# The decode step as CUDA graphs (serving/graphs.py): replay ≡ eager
# ---------------------------------------------------------------------------

GRAPH_DRAFTERS = {
    "ngram": dict(drafter="ngram", gamma=3),
    "vanilla": dict(drafter="vanilla"),
    "pruned": dict(drafter="pruned", gamma=3, pruned_retention=0.5),
    "tree": dict(drafter="ngram-tree", tree_branches=(3, 2, 1, 1)),
}


def _graph_setup(dev, kv="bf16"):
    """The reduced config with the 7B's 151936-wide vocabulary, seeded
    weights, and four prompts a prompt lookup finds drafts in."""
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), vocab_size=151936,
                              kv_cache_dtype=kv)
    model = Model(cfg, device=dev)
    raw = model.init_params(_gen(dev, 3))
    rng = np.random.default_rng(5)
    pat = rng.integers(0, cfg.vocab_size, (4, 7))
    prompts = torch.from_numpy(np.concatenate([np.tile(pat, 5), pat[:, :2]], axis=1)
                               .astype(np.int32)).to(dev)
    return model, raw, prompts


def _eager_and_graph(model, scfg, run):
    """``run(engine)`` with graphs=False, then with the default (graphs);
    returns {graphs: (result, launch counts, engine)}."""
    from repro_torch.serving.engine import SpecEngine

    out = {}
    for graphs in (False, True):
        eng = SpecEngine(model, scfg, graphs=graphs)
        ops.reset_launch_counts()
        res = run(eng)
        torch.cuda.synchronize()
        out[graphs] = (res, ops.launch_counts(), eng)
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("verifier", ["w8a8", "w4a8"])
@pytest.mark.parametrize("drafter", list(GRAPH_DRAFTERS))
def test_graph_replay_equals_eager_on_card(dev, drafter, verifier, kv):
    """``generate`` through a captured step gives the eager step's tokens,
    bit for bit, with the same kernel launches over the run: one program,
    captured once, replayed at every step after the second."""
    from repro_torch.core.config import SpecConfig

    model, raw, prompts = _graph_setup(dev, kv)
    scfg = SpecConfig(temperature=0.0, verifier=verifier, **GRAPH_DRAFTERS[drafter])
    out = _eager_and_graph(model, scfg, lambda eng: eng.generate(raw, prompts, 16))
    (eager, n_eager, e_eng), (graph, n_graph, g_eng) = out[False], out[True]
    assert graph.steps == eager.steps >= 3
    assert torch.equal(graph.tokens, eager.tokens)
    assert not graph.bad.any()
    assert n_graph == n_eager
    assert g_eng.step_traces == e_eng.step_traces == 1
    assert (g_eng._programs.captures, e_eng._programs.captures) == (1, 0)
    assert graph.capture_s > 0 and eager.capture_s == 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("verifier", ["w8a8", "w4a8"])
def test_graph_replay_equals_eager_paged_with_preemption_on_card(dev, verifier, kv):
    """Paged serving through a captured step, with a pool small enough that
    a better-keyed arrival preempts a running request to host memory and it
    resumes: the eager run's tokens per request, and one program (swap-in
    writes the state in place and builds none)."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.core.paged_cache import blocks_for_tokens, request_demand_tokens
    from repro_torch.serving.request import GenerationRequest
    from repro_torch.serving.scheduler import Scheduler

    model, raw, _ = _graph_setup(dev, kv)
    rng = np.random.default_rng(17)
    pat = rng.integers(0, model.cfg.vocab_size, 6)
    reqs = [GenerationRequest(rng.integers(0, model.cfg.vocab_size, 40), 24, seed=1,
                              priority=2),
            GenerationRequest(np.tile(pat, 4), 12, seed=2),
            GenerationRequest(np.concatenate([np.tile(pat, 4), pat[:3]]), 12, seed=3)]
    demand = blocks_for_tokens(request_demand_tokens(40, 24, 3), 8)
    scfg = SpecConfig(temperature=0.0, gamma=3, verifier=verifier, kv_layout="paged",
                      kv_block_size=8, kv_pool_blocks=1 + demand + 1)

    def run(eng):
        group = eng.serving_group(eng.prepare_params(raw), reqs, batch_slots=2)
        sched, state = Scheduler([], 2), group.state
        sched.submit(reqs[0])
        for _ in range(2):
            state, _ = sched.tick(state, **group.hooks)
        sched.submit(reqs[1])
        sched.submit(reqs[2])
        while sched.busy:
            state, _ = sched.tick(state, **group.hooks)
        assert sched.preemptions >= 1 and group.ctx.snapshot()["swap_in_blocks"] > 0
        return [sched.results[i].tokens for i in range(len(reqs))]

    out = _eager_and_graph(model, scfg, run)
    for a, b in zip(out[False][0], out[True][0]):
        np.testing.assert_array_equal(a, b)
    assert out[True][1] == out[False][1]
    assert out[True][2].step_traces == 1 and out[True][2]._programs.captures == 1


@pytest.mark.parametrize("drafter", ["ngram", "pruned"])
def test_graph_sampling_equals_eager_on_card(dev, drafter):
    """T = 1 through a captured step draws the eager step's numbers: each
    row's generator is registered with the graph, and admission reseeds it
    in place.  Five requests through two slots (slots recycled, generators
    reseeded between replays) and a homogeneous batch."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.request import GenerationRequest

    model, raw, prompts = _graph_setup(dev)
    rng = np.random.default_rng(4)
    pat = rng.integers(0, model.cfg.vocab_size, 6)
    reqs = [GenerationRequest(np.tile(pat, k), max_new_tokens=n, seed=k)
            for k, n in ((5, 9), (4, 12), (3, 7), (6, 5), (4, 10))]
    scfg = SpecConfig(temperature=1.0, gamma=3, drafter=drafter, verifier="w8a8",
                      pruned_retention=0.5)

    def run(eng):
        params = eng.prepare_params(raw)
        scheduled = [r.tokens for r in eng.generate_requests(params, reqs, batch_slots=2)]
        return scheduled, eng.generate(params, prompts, 16, seed=7).tokens

    out = _eager_and_graph(model, scfg, run)
    for a, b in zip(out[False][0][0], out[True][0][0]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(out[False][0][1], out[True][0][1])
    assert out[True][2]._programs.captures == 2


def test_replayed_step_launches_equal_eager_step_on_card(dev):
    """A replay adds the kernel launches its capture counted: the third
    step of a captured program counts what one eager step launches."""
    from repro_torch.core import prng
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine

    model, raw, prompts = _graph_setup(dev)
    per_step = {}
    for graphs in (False, True):
        eng = SpecEngine(model, SpecConfig(temperature=0.0, gamma=3, verifier="w8a8"),
                         graphs=graphs)
        params = eng.prepare_params(raw)
        B, P = prompts.shape
        full = lambda v: torch.full((B,), v, dtype=torch.int32, device=dev)  # noqa: E731
        with torch.inference_mode():
            state = eng._init_state(params, prompts, full(P), full(P + 64), P + 72,
                                    prng.row_generators(range(B), dev))
            for _ in range(2):
                state = eng._step(params, state)
            ops.reset_launch_counts()
            eng._step(params, state)
            torch.cuda.synchronize()
        per_step[graphs] = ops.launch_counts()
    assert per_step[True] == per_step[False]
    assert per_step[True]["int8_matmul"] > 0 and per_step[True]["flash_decode"] == 2


def test_step_traces_count_temperature_groups_on_card(dev):
    """A scheduled run of two temperature groups builds and captures two
    programs, as the reference compiles two."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.request import GenerationRequest

    model, raw, _ = _graph_setup(dev)
    rng = np.random.default_rng(4)
    pat = rng.integers(0, model.cfg.vocab_size, 6)
    reqs = [GenerationRequest(np.tile(pat, k), max_new_tokens=n, seed=k,
                              temperature=0.0 if k % 2 else 0.9)
            for k, n in ((5, 9), (4, 12), (3, 7), (6, 5), (4, 10))]
    for layout in ("contiguous", "paged"):
        eng = SpecEngine(model, SpecConfig(gamma=3, verifier="w8a8", kv_layout=layout,
                                           kv_block_size=16))
        assert eng.step_traces == 0
        eng.generate_requests(raw, reqs, batch_slots=2)
        assert eng.step_traces == len(eng.group_stats) == 2
        assert eng._programs.captures == 2


def test_re_prepared_params_are_captured_anew_on_card(dev):
    """A graph reads the weights where they were at capture: stepping one
    state with re-prepared params builds and captures a new program, and
    its tokens are the eager step's with the new params, not a stale
    replay of the old ones."""
    from repro_torch.core import prng
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine

    model, raw, prompts = _graph_setup(dev)
    other = model.init_params(_gen(dev, 4))
    B, P = prompts.shape
    full = lambda v: torch.full((B,), v, dtype=torch.int32, device=dev)  # noqa: E731
    out = {}
    for graphs in (False, True):
        eng = SpecEngine(model, SpecConfig(temperature=0.0, gamma=3, verifier="w8a8"),
                         graphs=graphs)
        first, second = eng.prepare_params(raw), eng.prepare_params(other)
        with torch.inference_mode():
            state = eng._init_state(first, prompts, full(P), full(P + 64), P + 72,
                                    prng.row_generators(range(B), dev))
            for params in (first, first, first, second, second, second):
                state = eng._step(params, state)
            torch.cuda.synchronize()
        out[graphs] = (state["tokens"].clone(), state["length"].clone(), eng)
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    assert out[True][2].step_traces == 2 and out[True][2]._programs.captures == 2


# ---------------------------------------------------------------------------
# The serving front-end on the card (serving/server.py): the NaN guardrail
# under CUDA graphs, interleaved lanes, the threaded server
# ---------------------------------------------------------------------------

def _server_requests(model, n=5, temperature=None, seed=4):
    from repro_torch.serving.request import GenerationRequest

    rng = np.random.default_rng(seed)
    pat = rng.integers(0, model.cfg.vocab_size, 6)
    spec = ((5, 10, 11), (4, 12, 22), (3, 9, 33), (6, 8, 44), (4, 11, 55), (5, 7, 66))
    return [GenerationRequest(np.tile(pat, k), max_new_tokens=m, seed=s,
                              temperature=temperature) for k, m, s in spec[:n]]


def _serve(model, raw, reqs, *, faults=None, verifier="w8a8", layout="paged", **server):
    """A virtual-clock ServingLoop drained over ``reqs`` on the card;
    returns (loop, handles, engine)."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.server import ServerConfig, ServingLoop

    eng = SpecEngine(model, SpecConfig(temperature=0.0, gamma=3, verifier=verifier,
                                       kv_layout=layout, kv_block_size=16))
    clock = [0.0]
    loop = ServingLoop(eng, raw, ServerConfig(**{"batch_slots": 2, "max_prompt_len": 40,
                                                 "max_new_tokens": 16, **server}),
                       clock=lambda: clock[0], faults=faults)
    handles = [loop.submit(r) for r in reqs]
    polls = 0
    while loop.busy:
        before = loop.total_steps
        loop.poll()
        clock[0] += (loop.total_steps - before) * 0.25
        polls += 1
        assert polls < 500
    torch.cuda.synchronize()
    loop.metrics.check_conservation()
    for lane in loop._lanes.values():
        lane.sched.check_conservation()
        if lane.ctx is not None:
            assert lane.ctx.pool.unique_allocated == 0
    return loop, handles, eng


@pytest.mark.parametrize("verifier", ["w8a8", "w4a8"])
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_server_fault_free_has_no_robustness_events_on_card(dev, verifier, layout):
    """A fault-free run through the server on the card: every robustness
    counter is 0 (a kernel emitting NaN would hide behind the bf16
    rescue), the step is captured once and replayed, and the tokens are
    ``generate_requests``'."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine

    model, raw, _ = _graph_setup(dev)
    reqs = _server_requests(model)
    loop, handles, eng = _serve(model, raw, reqs, verifier=verifier, layout=layout)
    assert all(v == 0 for v in loop.metrics.robustness.values()), loop.metrics.robustness
    assert eng.step_traces == 1 and eng._programs.captures == 1
    want = SpecEngine(model, SpecConfig(temperature=0.0, gamma=3, verifier=verifier,
                                        kv_layout=layout, kv_block_size=16)
                      ).generate_requests(raw, reqs, batch_slots=2)
    for h, w in zip(handles, want):
        np.testing.assert_array_equal(h.result(0.0).tokens, w.tokens)
        np.testing.assert_array_equal(h.collected(), w.tokens)


def test_server_transient_nan_retry_replays_on_card(dev):
    """A transient ``nan_verify`` after the capture: the poisoned view runs
    eagerly (its own program), the guard restores the registers in place
    and the retry replays the lane's graph — bit-equal to the untripped
    run, every state tensor where it was."""
    from repro_torch.serving.faults import FaultPlan

    model, raw, _ = _graph_setup(dev)
    reqs = _server_requests(model)
    _, clean, _ = _serve(model, raw, reqs)
    loop, handles, eng = _serve(model, raw, reqs, faults=FaultPlan.parse("nan_verify@3+6"))
    rb = loop.metrics.robustness
    assert rb["verify_nan_trips"] == 2 and rb["retry_rescued_rows"] >= 2
    assert rb["bf16_rescued_rows"] == 0 and not loop.affected
    for h, c in zip(handles, clean):
        np.testing.assert_array_equal(h.result(0.0).tokens, c.result(0.0).tokens)
    # the lane's program (captured at step 1) plus one per poisoned view
    assert eng.step_traces == 3 and eng._programs.captures == 1


def test_server_sticky_quant_corrupt_rescue_then_repair_on_card(dev):
    """A sticky ``quant_corrupt`` at the second step: the retry trips again,
    the bf16 twin rescues every row (its program built, then captured),
    three rescued steps re-prepare the lane, and the repaired params'
    program is captured and replayed: the fast path again.  The first two
    requests' 16-token budgets outlast the poisoned steps, so no admission
    prefills with the poisoned params.  Untouched requests keep their
    tokens."""
    from repro_torch.serving.faults import FaultPlan

    model, raw, _ = _graph_setup(dev)
    reqs = _server_requests(model, n=6)
    for r in reqs[:2]:
        r.max_new_tokens = 16
    _, clean, _ = _serve(model, raw, reqs)
    loop, handles, eng = _serve(model, raw, reqs, faults=FaultPlan.parse("quant_corrupt@1"))
    rb = loop.metrics.robustness
    assert rb["verify_nan_trips"] == 3 and rb["bf16_rescued_rows"] >= 3
    assert rb["reprepares"] == 1 and rb["unrescued_rows"] == 0
    assert all(h.status == "done" for h in handles)
    for h, c in zip(handles, clean):
        if h.rid not in loop.affected:
            np.testing.assert_array_equal(h.result(0.0).tokens, c.result(0.0).tokens)
    lane = next(iter(loop._lanes.values()))
    progs = [p for p in eng._programs._programs.values() if p.params() is lane.params]
    assert len(progs) == 1 and progs[0].graph is not None   # the repaired params replay
    # lane (poisoned before its second step), poisoned view, bf16 twin and
    # repaired params: the last three captured at their second step
    assert eng.step_traces == 4 and eng._programs.captures == 3


def test_server_interleaved_temperature_lanes_equal_each_alone_on_card(dev):
    """Two lanes (T = 0 and T = 0.8) interleave replays of graphs that share
    one memory pool: each lane's tokens equal the same requests served
    alone (sound while no graph output lives in the pool)."""
    model, raw, _ = _graph_setup(dev)
    cold = _server_requests(model, n=3, temperature=0.0)
    hot = _server_requests(model, n=3, temperature=0.8, seed=9)
    mixed = [r for pair in zip(cold, hot) for r in pair]
    loop, handles, eng = _serve(model, raw, mixed, layout="contiguous")
    assert len(loop._lanes) == 2 and eng._programs.captures == 2
    for first, group in enumerate((cold, hot)):       # mixed[first::2] is group
        _, alone, _ = _serve(model, raw, group, layout="contiguous")
        for h, a in zip(handles[first::2], alone):
            np.testing.assert_array_equal(h.result(0.0).tokens, a.result(0.0).tokens)


def test_streaming_server_captures_on_its_thread_on_card(dev):
    """The serving thread builds and captures the step while this thread
    submits and consumes token by token; the tokens are the virtual-clock
    loop's, and the capture ran on the serving thread."""
    import threading

    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.server import ServerConfig, StreamingServer

    model, raw, _ = _graph_setup(dev)
    reqs = _server_requests(model, n=6)
    _, want, _ = _serve(model, raw, reqs)
    eng = SpecEngine(model, SpecConfig(temperature=0.0, gamma=3, verifier="w8a8",
                                       kv_layout="paged", kv_block_size=16))
    threads = []
    capture = eng._programs._capture

    def spy(*a, **k):
        threads.append(threading.current_thread().name)
        return capture(*a, **k)

    eng._programs._capture = spy
    with StreamingServer(eng, raw, ServerConfig(batch_slots=2, max_prompt_len=40,
                                                max_new_tokens=16)) as srv:
        handles = [srv.submit(r) for r in reqs]
        for h, w in zip(handles, want):
            streamed = np.concatenate(list(h.tokens()))
            np.testing.assert_array_equal(streamed, w.result(0.0).tokens)
    srv.metrics.check_conservation()
    assert all(v == 0 for v in srv.metrics.robustness.values())
    assert threads and all(t == "repro-torch-serving-loop" for t in threads)


# -- MoE (models/moe.py): the batched expert GEMM, row invariance, graphs ------

BATCHED_SHAPES = [
    (64, 3, 2048, 1408), (64, 11, 2048, 1408), (64, 21, 1408, 2048),   # moonshot decode
    (64, 480, 2048, 1408), (64, 480, 1408, 2048),                      # moonshot prefill
    (16, 4, 4096, 6400), (16, 4, 6400, 4096), (16, 300, 4096, 6400),   # phi3.5-moe
    (4, 1, 16 * 37, 200), (3, 9, 144, 72), (5, 257, 48, 130), (2, 200, 4096, 64),
    (2, 40, 4096, 64)]


@pytest.mark.parametrize("e,c,k,n", BATCHED_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_batched_bit_equal_on_card(dev, e, c, k, n, out_dtype):
    """Every expert's GEMM in one launch, bit-equal to the plain version at
    moonshot's and phi3.5-moe's expert shapes (decode C 3, 11, 21 and
    prefill C 480 on moonshot) and at the plan's edges: C 1, 9 and 40
    (wgmma widths 8, 24, 48), 200 and 257 (tiled), N not a multiple of the
    W tile, K not of the 128-byte step, a K split across a cluster (few
    experts, few tiles).  An expert's X tile runs past its C rows into the
    next expert's: those products are never written."""
    g = _gen(dev, e * c + k + n)
    x = torch.randint(-127, 128, (e, c, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (e, n, k), generator=g, device=dev, dtype=torch.int8)
    if c <= 21:
        acc = int8_matmul_batched(x, w, torch.ones(e, c, device=dev),
                                  torch.ones(e, n, device=dev), out_dtype=torch.float32)
        want = torch.stack([x[i].cpu().to(torch.int64) @ w[i].cpu().to(torch.int64).T
                            for i in range(e)])
        assert torch.equal(acc.cpu().to(torch.int64), want)
    dx = torch.rand(e, c, generator=g, device=dev) * 1e-2
    dw = torch.rand(e, n, generator=g, device=dev) * 1e-3
    y = int8_matmul_batched(x, w, dx, dw, out_dtype=out_dtype)
    assert y.shape == (e, c, n) and y.dtype == out_dtype
    assert torch.equal(y, int8_matmul_batched_ref(x, w, dx, dw, out_dtype))


def _graph_node_types(fn) -> list:
    """The CUDA graph node types (``CUgraphNodeType``: 0 kernel, 1 memcpy,
    2 memset, ...) of one call of ``fn``, captured after a warm-up call.
    Counts device work without the profiler, whose kernel records go
    missing in some processes (ROADMAP §3)."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        t = ctypes.c_int()
        assert cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t)) == 0
        types.append(t.value)
    return types


@pytest.mark.parametrize("with_rows", [False, True])
@pytest.mark.parametrize("c", [3, 480])
def test_int8_matmul_batched_is_one_kernel_per_call_on_card(dev, c, with_rows):
    """One device kernel per expert linear (no memset, no second kernel), at
    decode (swapped) and at prefill (tiled), with every row or with fills
    (experts with none, whose rows the same kernel zeroes): one call
    captured in a graph holds one node, a kernel, and counts one launch."""
    x = torch.randint(-127, 128, (64, c, 2048), device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (64, 1408, 2048), device=dev, dtype=torch.int8)
    dx, dw = torch.rand(64, c, device=dev), torch.rand(64, 1408, device=dev)
    rows = _fills(64, c, _gen(dev, c)) if with_rows else None
    ops.reset_launch_counts()
    with ops.launches_apart() as counted:
        assert _graph_node_types(lambda: int8_matmul_batched(x, w, dx, dw, rows=rows)) == [0]
    assert counted == {"int8_matmul_batched": 2}          # the warm-up and the capture


def _fills(e, c, g):
    """Per-expert kept rows drawn from {0, 1, partial, C} (int32, on g's
    device); expert 0 keeps none, expert 1 all."""
    choice = torch.randint(0, 4, (e,), generator=g, device=g.device)
    partial = torch.randint(0, c + 1, (e,), generator=g, device=g.device)
    rows = torch.stack([torch.zeros_like(partial), torch.ones_like(partial), partial,
                        torch.full_like(partial, c)])[choice, torch.arange(e, device=g.device)]
    rows[0], rows[min(1, e - 1)] = 0, c
    return rows.to(torch.int32).contiguous()


@pytest.mark.parametrize("e,c,k,n", BATCHED_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_int8_matmul_batched_rows_bit_equal_on_card(dev, e, c, k, n, out_dtype):
    """With per-expert fills from {0, 1, partial, C}: bit-equal to the plain
    version, +0 past each fill; expert 0 keeps no row and has NaN scales,
    and its output is zeros from both (the kernel reads none of its W)."""
    g = _gen(dev, e * c + k + n + 1)
    x = torch.randint(-127, 128, (e, c, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (e, n, k), generator=g, device=dev, dtype=torch.int8)
    dx = torch.rand(e, c, generator=g, device=dev) * 1e-2
    dw = torch.rand(e, n, generator=g, device=dev) * 1e-3
    dw[0] = float("nan")
    rows = _fills(e, c, g)
    y = int8_matmul_batched(x, w, dx, dw, out_dtype=out_dtype, rows=rows)
    want = int8_matmul_batched_ref(x, w, dx, dw, out_dtype, rows)
    assert torch.equal(y, want)
    assert torch.equal(y[0], torch.zeros_like(y[0]))
    past = torch.arange(c, device=dev)[None, :] >= rows[:, None]
    assert not y[past].float().signbit().any() and (y[past] == 0).all()


@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048)])
def test_int8_matmul_batched_row_does_not_depend_on_c_on_card(dev, k, n):
    """An expert's row has the same bits whatever C the engine makes (1 and
    3 vanilla and chain, 6 paged, 11 and 21 trees, 120 paged admission, 257
    and 480 prefill: every regime and width), with every row and with fills."""
    g = _gen(dev, k + n)
    E, CMAX = 64, 480
    x = torch.randint(-127, 128, (E, CMAX, k), generator=g, device=dev, dtype=torch.int8)
    w = torch.randint(-127, 128, (E, n, k), generator=g, device=dev, dtype=torch.int8)
    dx = torch.rand(E, CMAX, generator=g, device=dev) * 1e-2
    dw = torch.rand(E, n, generator=g, device=dev) * 1e-3
    fill = _fills(E, CMAX, g).clamp(min=1)
    first = int8_matmul_batched(x[:, :1].contiguous(), w, dx[:, :1].contiguous(), dw)
    for c in (3, 6, 11, 21, 120, 257, 480):
        xc, dxc = x[:, :c].contiguous(), dx[:, :c].contiguous()
        assert torch.equal(int8_matmul_batched(xc, w, dxc, dw)[:, :1], first), c
        rows = fill.clamp(max=c).to(torch.int32)
        assert torch.equal(int8_matmul_batched(xc, w, dxc, dw, rows=rows)[:, :1], first), c


def _moe_layer(dev, cfg, verifier="w8a8"):
    from repro_torch.core.config import QuantConfig
    from repro_torch.models.moe import MoE
    from repro_torch.quant.apply import quantize_params

    moe = MoE.init(_gen(dev, 11), cfg, dev)
    if verifier == "bf16":
        return moe
    return quantize_params(moe, None, QuantConfig(w_bits=8 if verifier == "w8a8" else 4))


def test_moe_routing_row_does_not_depend_on_m_on_card(dev):
    """At moonshot's width (d 2048, 64 experts top-6, experts of 1408),
    dropless: a row's router logits, probabilities, top-k, gates and the
    W8A8 layer's output (dispatch, expert GEMMs, combine) are the same bits
    in calls of 4, 24, 88 and 176 rows."""
    from repro_torch.models.moe import route, router_logits

    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b"), moe_capacity_factor=64.0)
    moe = _moe_layer(dev, cfg)
    g = _gen(dev, 12)
    x = (torch.randn(176, cfg.d_model, generator=g, device=dev)).to(torch.bfloat16)
    x[5] = 0                            # a zero row: every probability ties
    outs = {}
    with torch.inference_mode():
        for m in (4, 24, 88, 176):
            logits = router_logits(x[:m], moe.router.w)
            r = route(logits, cfg.experts_per_token, cfg.num_experts, cfg.moe_capacity_factor)
            y = moe(x[:m].view(1, m, -1)).view(m, -1)
            outs[m] = (logits[:4], r["probs"][:4], r["eidx"][:4], r["gates"][:4], y[:4])
    for m in (24, 88, 176):
        for a, b in zip(outs[m], outs[4]):
            assert torch.equal(a, b), m
    with torch.inference_mode():
        r = route(router_logits(x[:24], moe.router.w), 6, 64, 64.0)
    assert r["eidx"][5].tolist() == list(range(6))      # ties: the lower index first


def _moe_graph_setup(dev, factor, kv="bf16"):
    """A reduced moonshot with its 64 experts top-6 and a 4096-wide
    vocabulary; ``factor`` its capacity factor (64: dropless)."""
    cfg = dataclasses.replace(get_config("moonshot-v1-16b-a3b").reduced(), num_experts=64,
                              experts_per_token=6, moe_capacity_factor=factor,
                              vocab_size=4096, kv_cache_dtype=kv)
    model = Model(cfg, device=dev)
    raw = model.init_params(_gen(dev, 3))
    rng = np.random.default_rng(5)
    pat = rng.integers(0, cfg.vocab_size, (4, 7))
    prompts = torch.from_numpy(np.concatenate([np.tile(pat, 5), pat[:, :2]], axis=1)
                               .astype(np.int32)).to(dev)
    return model, raw, prompts


@pytest.mark.parametrize("factor", [1.25, 64.0])
@pytest.mark.parametrize("verifier", ["w8a8", "w4a8"])
@pytest.mark.parametrize("drafter", ["ngram", "tree"])
def test_moe_graph_replay_equals_eager_on_card(dev, drafter, verifier, factor):
    """The MoE decode step (routing, capacity dispatch, the batched expert
    GEMMs, combine) captured as a graph gives the eager step's tokens bit
    for bit, with drops (capacity factor 1.25) and without."""
    from repro_torch.core.config import SpecConfig

    model, raw, prompts = _moe_graph_setup(dev, factor)
    scfg = SpecConfig(temperature=0.0, verifier=verifier, **GRAPH_DRAFTERS[drafter])
    out = _eager_and_graph(model, scfg, lambda eng: eng.generate(raw, prompts, 16))
    (eager, n_eager, e_eng), (graph, n_graph, g_eng) = out[False], out[True]
    assert graph.steps == eager.steps >= 3
    assert torch.equal(graph.tokens, eager.tokens)
    assert not graph.bad.any()
    assert n_graph == n_eager and n_graph["int8_matmul_batched"] > 0
    assert (g_eng._programs.captures, e_eng._programs.captures) == (1, 0)


def test_moe_graph_replay_equals_eager_paged_on_card(dev):
    """The paged MoE tick through graphs gives the eager tick's tokens."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.request import GenerationRequest

    model, raw, prompts = _moe_graph_setup(dev, 1.25)
    reqs = [GenerationRequest(p.cpu().numpy(), 12, seed=i) for i, p in enumerate(prompts)]
    scfg = SpecConfig(temperature=0.0, gamma=3, verifier="w8a8", kv_layout="paged",
                      kv_block_size=16)
    out = _eager_and_graph(model, scfg,
                           lambda eng: eng.generate_requests(raw, reqs, batch_slots=2))
    (eager, n_eager, _), (graph, n_graph, g_eng) = out[False], out[True]
    for a, b in zip(eager, graph):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert n_graph == n_eager and n_graph["int8_matmul_batched"] > 0
    assert g_eng._programs.captures == 1


def test_moe_paged_idle_rows_do_not_change_live_tokens_on_card(dev):
    """Below the expert count's capacity factor an idle paged row's routing
    takes expert slots from the live rows, and idle rows (and slots past a
    row's table) write colliding scratch rows: the live tokens must not
    depend on which colliding write sticks.  Three requests of different
    lengths through 8 slots, eager and graphs, twice each: equal tokens."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.serving.request import GenerationRequest

    model, raw, prompts = _moe_graph_setup(dev, 1.25)
    reqs = [GenerationRequest(p.cpu().numpy(), n, seed=i)
            for i, (p, n) in enumerate(zip(prompts[:3], (12, 7, 16)))]
    scfg = SpecConfig(temperature=0.0, gamma=3, verifier="w8a8", kv_layout="paged",
                      kv_block_size=16)
    runs = [[r.tokens for r in SpecEngine(model, scfg, graphs=graphs).generate_requests(
        raw, reqs, batch_slots=8)] for graphs in (False, True, False, True)]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("verifier", ["w8a8", "w4a8"])
def test_moe_dropless_spec_equals_vanilla_on_card(dev, verifier):
    """Dropless (capacity factor = num_experts), greedy ngram, tree and
    pruned give vanilla's tokens on the card: every op of the MoE verify
    forward is row-invariant."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine

    model, raw, prompts = _moe_graph_setup(dev, 64.0)
    toks = {}
    for name, kw in (("vanilla", dict(drafter="vanilla")), ("ngram", dict(drafter="ngram")),
                     ("tree", GRAPH_DRAFTERS["tree"]),
                     ("pruned", dict(drafter="pruned", pruned_retention=0.5))):
        r = SpecEngine(model, SpecConfig(temperature=0.0, verifier=verifier, **kw)).generate(
            raw, prompts, 16)
        assert not r.bad.any()
        toks[name] = r.tokens[:, :prompts.shape[1] + 16]
    for name in ("ngram", "tree", "pruned"):
        assert torch.equal(toks[name], toks["vanilla"]), name


# ---------------------------------------------------------------------------
# The SSM path: ssd_update, the gated norm, the tied logits, graphs
# ---------------------------------------------------------------------------

def _ssd_inputs(dev, b, t, h, p, n, seed):
    from repro_torch.models.ssm import softplus

    g = _gen(dev, seed)
    x = torch.randn(b, t, h, p, generator=g, device=dev)
    bm = torch.randn(b, t, n, generator=g, device=dev)
    cm = torch.randn(b, t, n, generator=g, device=dev)
    dt = softplus(torch.randn(b, t, h, generator=g, device=dev) - 4.0)
    a = torch.exp(torch.log(torch.linspace(1.0, 16.0, h, device=dev)))
    h0 = torch.randn(b, h, p, n, generator=g, device=dev) * 0.5
    return x, bm, cm, dt, a, h0


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("b,t,h,p,n", [
    (4, 6, 80, 64, 64),     # zamba2's verify window
    (4, 6, 32, 64, 128),    # mamba2's
    (4, 1, 80, 64, 64),     # vanilla's step
    (2, 5, 16, 16, 16),     # the reduced configs'
    (1, 3, 3, 32, 256), (3, 2, 5, 48, 32)])
def test_ssd_update_matches_plain_on_card(dev, b, t, h, p, n, collect):
    """States bit-equal to the plain version (the same IEEE steps, no FMA);
    y within rtol 1e-5 / atol 1e-4: the two sum N f32 products in
    different orders."""
    from repro_torch.kernels.ssd_update import ssd_update, ssd_update_ref

    args = _ssd_inputs(dev, b, t, h, p, n, seed=b + t + h + n)
    y, states = ssd_update(*args, collect)
    ry, rstates = ssd_update_ref(*args, collect)
    assert states.shape == rstates.shape
    assert torch.equal(states, rstates)
    torch.testing.assert_close(y, ry, rtol=1e-5, atol=1e-4)


def test_ssd_update_row_does_not_depend_on_window_or_batch(dev):
    """A window of 6 tokens over 4 rows gives, bit for bit, what 6
    single-token steps of one row give (vanilla's decode of that row):
    every y and every kept state."""
    from repro_torch.kernels.ssd_update import ssd_update

    x, bm, cm, dt, a, h0 = _ssd_inputs(dev, 4, 6, 80, 64, 64, seed=9)
    y, states = ssd_update(x, bm, cm, dt, a, h0, True)
    for row in (0, 3):
        h = h0[row:row + 1].contiguous()
        for t in range(6):
            one = lambda z: z[row:row + 1, t:t + 1].contiguous()  # noqa: E731
            y1, h = ssd_update(one(x), one(bm), one(cm), one(dt), a, h, False)
            assert torch.equal(y1[0, 0], y[row, t]), (row, t)
            assert torch.equal(h[0], states[row, t]), (row, t)


def test_tied_logits_row_does_not_depend_on_row_count_on_card(dev):
    """mamba2's tied f32 logits (1024 → 50280): a row of vanilla's 4-row
    step equals the same row placed anywhere in a 24- or 88-row call
    (chunks of TIED_ROWS rows, one GEMM shape)."""
    from repro_torch.models.transformer import tied_logits

    g = _gen(dev, 50280)
    w = (torch.randn(50280, 1024, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    x = torch.randn(88, 1024, generator=g, device=dev).to(torch.bfloat16)
    four = tied_logits(x[:4], w)
    for m in (24, 88):
        big = x[:m].clone()
        big[::6][:4] = x[:4]
        assert torch.equal(tied_logits(big, w)[::6][:4], four), m
    assert torch.equal(tied_logits(x[:24].view(4, 6, 1024), w)[:, 0], tied_logits(x[:24:6], w))


def _ssm_graph_setup(dev, arch, kv="bf16"):
    """A reduced SSM or hybrid config (f32), seeded weights, four prompts a
    prompt lookup finds drafts in."""
    cfg = dataclasses.replace(get_config(arch).reduced(), kv_cache_dtype=kv)
    model = Model(cfg, device=dev)
    raw = model.init_params(_gen(dev, 3))
    rng = np.random.default_rng(5)
    pat = rng.integers(0, cfg.vocab_size, (4, 7))
    prompts = torch.from_numpy(np.concatenate([np.tile(pat, 5), pat[:, :2]], axis=1)
                               .astype(np.int32)).to(dev)
    return model, raw, prompts


@pytest.mark.parametrize("arch,verifier,kv", [
    ("mamba2-370m", "w8a8", "bf16"), ("mamba2-370m", "w4a8", "bf16"),
    ("zamba2-2.7b", "w8a8", "bf16"), ("zamba2-2.7b", "w4a8", "int8")])
@pytest.mark.parametrize("drafter", ["ngram", "vanilla", "pruned"])
def test_ssm_graph_replay_equals_eager_on_card(dev, arch, drafter, verifier, kv):
    """The SSM decode step (ssd_update with every window state kept, the
    commit's gathers into the layer's own state and conv) captured as a
    graph gives the eager step's tokens bit for bit, with the same
    launches; speculation gives vanilla's tokens."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine

    model, raw, prompts = _ssm_graph_setup(dev, arch, kv)
    scfg = SpecConfig(temperature=0.0, verifier=verifier, **GRAPH_DRAFTERS[drafter])
    out = _eager_and_graph(model, scfg, lambda eng: eng.generate(raw, prompts, 16))
    (eager, n_eager, e_eng), (graph, n_graph, g_eng) = out[False], out[True]
    assert graph.steps == eager.steps >= 3
    assert torch.equal(graph.tokens, eager.tokens)
    assert not graph.bad.any()
    assert n_graph == n_eager and n_graph["ssd_update"] > 0
    assert g_eng.step_traces == e_eng.step_traces == 1
    assert (g_eng._programs.captures, e_eng._programs.captures) == (1, 0)
    vanilla = SpecEngine(model, SpecConfig(temperature=0.0, verifier=verifier,
                                           drafter="vanilla")).generate(raw, prompts, 16)
    n = prompts.shape[1] + 16
    assert torch.equal(graph.tokens[:, :n], vanilla.tokens[:, :n])


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-2.7b"])
def test_ssm_replayed_step_launches_equal_eager_step_on_card(dev, arch):
    """A replayed SSM step counts what one eager step launches: one
    ssd_update per SSM layer, one flash_decode per shared application."""
    from repro_torch.core import prng
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine

    model, raw, prompts = _ssm_graph_setup(dev, arch)
    per_step = {}
    for graphs in (False, True):
        eng = SpecEngine(model, SpecConfig(temperature=0.0, gamma=3, verifier="w8a8"),
                         graphs=graphs)
        params = eng.prepare_params(raw)
        B, P = prompts.shape
        full = lambda v: torch.full((B,), v, dtype=torch.int32, device=dev)  # noqa: E731
        with torch.inference_mode():
            state = eng._init_state(params, prompts, full(P), full(P + 64), P + 72,
                                    prng.row_generators(range(B), dev))
            for _ in range(2):
                state = eng._step(params, state)
            ops.reset_launch_counts()
            eng._step(params, state)
            torch.cuda.synchronize()
        per_step[graphs] = ops.launch_counts()
    assert per_step[True] == per_step[False]
    assert per_step[True]["ssd_update"] == model.cfg.num_layers
    assert per_step[True].get("flash_decode", 0) == (1 if arch == "zamba2-2.7b" else 0)


def test_ssd_update_rejects_card_only_shapes(dev):
    from repro_torch.kernels.ssd_update import ssd_update

    x, bm, cm, dt, a, h0 = _ssd_inputs(dev, 1, 2, 2, 16, 16, seed=1)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_update(x[..., :8].contiguous(), bm, cm, dt, a, h0[:, :, :8].contiguous())
    with pytest.raises(ValueError, match="N in"):
        ssd_update(x, bm[..., :8].contiguous(), cm[..., :8].contiguous(), dt, a,
                   h0[..., :8].contiguous())


@pytest.mark.parametrize("arch,prompt_len", [("phi3.5-moe-42b-a6.6b", None),
                                             ("mamba2-370m", 18)])
def test_moe_and_ssm_graph_sampling_equals_eager_on_card(dev, arch, prompt_len):
    """T = 1 through a captured step draws the eager step's numbers on an
    MoE decoder (phi3.5-moe, reduced: dropless) and an SSM decoder (mamba2,
    equal-length prompts, as its recurrent cache needs): five requests
    through two slots (slots recycled, generators reseeded between
    replays), then a homogeneous batch."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.request import GenerationRequest

    model, raw, prompts = _ssm_graph_setup(dev, arch)
    rng = np.random.default_rng(4)
    pat = rng.integers(0, model.cfg.vocab_size, 6)
    reqs = [GenerationRequest(np.tile(pat, k)[:prompt_len], max_new_tokens=n, seed=k)
            for k, n in ((5, 9), (4, 12), (3, 7), (6, 5), (4, 10))]
    scfg = SpecConfig(temperature=1.0, gamma=3, drafter="ngram", verifier="w8a8")

    def run(eng):
        params = eng.prepare_params(raw)
        scheduled = [r.tokens for r in eng.generate_requests(params, reqs, batch_slots=2)]
        return scheduled, eng.generate(params, prompts, 16, seed=7).tokens

    out = _eager_and_graph(model, scfg, run)
    for a, b in zip(out[False][0][0], out[True][0][0]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(out[False][0][1], out[True][0][1])
    assert out[True][2]._programs.captures == 2


def _family_graph_setup(dev, arch):
    """A reduced llama-3.2-vision or whisper-small (f32) with 200 image
    tokens or audio frames, seeded weights, the vision cross gates at 0.5
    (0 at init would hide the cross path), seeded embeddings and four
    prompts a prompt lookup finds drafts in."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, **{"num_image_tokens" if cfg.num_image_tokens
                                      else "num_audio_frames": 200})
    model = Model(cfg, device=dev)
    raw = model.init_params(_gen(dev, 3))
    for blk in raw.layers:
        if hasattr(blk, "gate_attn"):
            blk.gate_attn.fill_(0.5)
            blk.gate_ffn.fill_(0.5)
    aux = torch.randn(4, 200, cfg.d_model, generator=_gen(dev, 8), device=dev)
    rng = np.random.default_rng(5)
    pat = rng.integers(0, cfg.vocab_size, (4, 7))
    prompts = torch.from_numpy(np.concatenate([np.tile(pat, 5), pat[:, :2]], axis=1)
                               .astype(np.int32)).to(dev)
    return model, raw, prompts, aux


@pytest.mark.parametrize("drafter", ["ngram", "tree", "pruned"])
@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "whisper-small"])
def test_family_graph_replay_equals_eager_on_card(dev, arch, drafter):
    """The cross-attention decode step (the cross read from ck/cv through
    flash_decode, the gates, whisper's LayerNorm, GELU and tied logits)
    captured as a graph gives the eager step's tokens bit for bit, with the
    same launches; speculation gives vanilla's tokens."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine

    model, raw, prompts, aux = _family_graph_setup(dev, arch)
    scfg = SpecConfig(temperature=0.0, verifier="w8a8", **GRAPH_DRAFTERS[drafter])
    out = _eager_and_graph(model, scfg,
                           lambda eng: eng.generate(raw, prompts, 16, aux_embeds=aux))
    (eager, n_eager, e_eng), (graph, n_graph, g_eng) = out[False], out[True]
    assert graph.steps == eager.steps >= 3
    assert torch.equal(graph.tokens, eager.tokens)
    assert not graph.bad.any()
    assert n_graph == n_eager and n_graph["int8_matmul"] > 0
    assert g_eng.step_traces == e_eng.step_traces == 1
    assert (g_eng._programs.captures, e_eng._programs.captures) == (1, 0)
    vanilla = SpecEngine(model, SpecConfig(temperature=0.0, verifier="w8a8",
                                           drafter="vanilla")).generate(raw, prompts, 16,
                                                                        aux_embeds=aux)
    n = prompts.shape[1] + 16
    assert torch.equal(graph.tokens[:, :n], vanilla.tokens[:, :n])


@pytest.mark.parametrize("arch,kernel", [("whisper-small", "flash_decode_cross"),
                                         ("quasar-paper-7b", "norm_smooth_quant")])
def test_bf16_step_replay_equals_eager_on_card(dev, arch, kernel):
    """A W8A8 spec step at full width in bf16 (two decoder layers; whisper's
    encoder whole over its 1500 frames): whisper's through the cross read's
    sliced body (dh 64, S 1500), the 7B's through the fused norm's body at
    (24, 4096); captured as a graph it gives the eager step's tokens bit
    for bit, with the same launches, and speculation gives vanilla's."""
    from repro_torch.core.config import SpecConfig
    from repro_torch.serving.engine import SpecEngine

    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    model = Model(cfg, device=dev)
    raw = model.init_params(_gen(dev, 3))
    aux = None
    if cfg.num_audio_frames:
        aux = (torch.randn(4, cfg.num_audio_frames, cfg.d_model, generator=_gen(dev, 8),
                           device=dev) * 0.5).to(cfg.dtype)
    rng = np.random.default_rng(5)
    pat = rng.integers(0, cfg.vocab_size, (4, 7))
    prompts = torch.from_numpy(np.tile(pat, 10).astype(np.int32)).to(dev)
    scfg = SpecConfig(temperature=0.0, verifier="w8a8", **GRAPH_DRAFTERS["ngram"])
    prep = SpecEngine(model, scfg).prepare_params(raw)
    out = _eager_and_graph(model, scfg,
                           lambda eng: eng.generate(prep, prompts, 16, aux_embeds=aux))
    (eager, n_eager, _), (graph, n_graph, g_eng) = out[False], out[True]
    assert graph.steps == eager.steps >= 3
    assert torch.equal(graph.tokens, eager.tokens) and not graph.bad.any()
    assert n_graph == n_eager and n_graph[kernel] >= graph.steps
    assert g_eng._programs.captures == 1
    vanilla = SpecEngine(model, SpecConfig(temperature=0.0, verifier="w8a8",
                                           drafter="vanilla")).generate(prep, prompts, 16,
                                                                        aux_embeds=aux)
    n = prompts.shape[1] + 16
    assert torch.equal(graph.tokens[:, :n], vanilla.tokens[:, :n])


# ---------------------------------------------------------------------------
# Training on the card: the kernels the bf16 forward reaches carry the plain
# version's gradient; every other kernel refuses a gradient
# ---------------------------------------------------------------------------

def _grads_of(fn, inputs, seed=0):
    """Gradients of a fixed random projection of ``fn(*inputs)``'s outputs
    with respect to every input."""
    xs = [x.detach().requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = _gen(xs[0].device, seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g, device=o.device)).sum()
               for o in outs)
    return torch.autograd.grad(loss, xs)


def _close_to_max(got, want, rtol=1e-4):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rtol * b.float().abs().max().item() + 1e-30, err


@pytest.mark.parametrize("collect", [False, True])
@pytest.mark.parametrize("t", [1, 6, 16])
def test_ssd_update_grad_equals_plain_on_card(dev, t, collect):
    """At mamba2's head shapes (32 heads, P 64, N 128), the autograd route of
    ``ssd_update`` (the kernel forward, counted once; ``ssd_update_ref``'s
    vector-Jacobian product backward) gives the plain version's gradients
    for x, B, C, dt, A and h0 within 1e-4 of each tensor's max."""
    from repro_torch.kernels.ssd_update import ssd_update, ssd_update_ref

    args = _ssd_inputs(dev, 2, t, 32, 64, 128, seed=t)
    ops.reset_launch_counts()
    got = _grads_of(lambda *a: ssd_update(*a, collect), args)
    assert ops.launch_counts() == {"ssd_update": 1}
    _close_to_max(got, _grads_of(lambda *a: ssd_update_ref(*a, collect), args))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,sa,dh", [(64, 8, 1600, 128),    # llama-3.2-vision
                                          (12, 12, 1500, 64)])   # whisper-small
def test_cross_read_grad_equals_plain_on_card(dev, hq, hkv, sa, dh, dtype):
    """The cross read under autograd: the kernel forward (within one bf16
    rounding step of ``flash_decode_ref``), ``flash_decode_ref``'s
    gradients for q, k and v (within 1e-4 of each tensor's max)."""
    from repro_torch.kernels.flash_decode import flash_decode_cross

    g = _gen(dev, sa + hq)
    q = torch.randn(2, 6, hq, dh, generator=g, device=dev).to(dtype)
    k = torch.randn(2, sa, hkv, dh, generator=g, device=dev).to(dtype)
    v = torch.randn(2, sa, hkv, dh, generator=g, device=dev).to(dtype)
    qpos = torch.full((2, 6), sa - 1, dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    with torch.enable_grad():
        out = flash_decode_cross(q.requires_grad_(), k, v)
    assert out.requires_grad and ops.launch_counts() == {"flash_decode_cross": 1}
    torch.testing.assert_close(out.detach().float(),
                               flash_decode_ref(q, k, v, qpos).detach().float(),
                               rtol=2 ** -7, atol=1e-5)
    _close_to_max(_grads_of(flash_decode_cross, (q, k, v)),
                  _grads_of(lambda q, k, v: flash_decode_ref(q, k, v, qpos), (q, k, v)))


def test_guarded_wrappers_raise_under_grad_on_card(dev):
    """A kernel with no backward raises when grad mode is on and an input
    needs a gradient (a ctypes launch would cut it silently); the same call
    runs under no_grad."""
    from repro_torch.kernels.smooth_quant import norm_smooth_quant

    g = _gen(dev, 11)
    x = torch.randn(4, 64, generator=g, device=dev)
    s = torch.ones(64, device=dev)
    xq, dx = smooth_quant(x, s)
    w = torch.randint(-127, 128, (32, 64), dtype=torch.int8, device=dev)
    we = torch.randint(-127, 128, (2, 32, 64), dtype=torch.int8, device=dev)
    w4 = torch.randint(-128, 128, (32, 32), dtype=torch.int8, device=dev)
    dw, dwe = torch.ones(32, device=dev), torch.ones(2, 32, device=dev)
    q = torch.randn(1, 2, 4, 64, generator=g, device=dev)
    kv = torch.randn(1, 128, 2, 64, generator=g, device=dev)
    qpos = torch.full((1, 2), 100, dtype=torch.int32, device=dev)
    pool = torch.randn(2, 128, 2, 64, generator=g, device=dev)
    bt = torch.ones((1, 1), dtype=torch.int32, device=dev)
    need = lambda t: t.detach().clone().requires_grad_(True)  # noqa: E731
    calls = {
        "smooth_quant": lambda: smooth_quant(need(x), s),
        "norm_smooth_quant": lambda: norm_smooth_quant(x, need(s), 1e-5, [s]),
        "int8_matmul": lambda: int8_matmul(xq, w, need(dx), dw),
        "int8_matmul_batched": lambda: int8_matmul_batched(
            xq.view(2, 2, 64), we, need(dx).view(2, 2), dwe),
        "int4_matmul": lambda: int4_matmul(xq, w4, dx, need(dw)),
        "flash_decode": lambda: flash_decode(need(q), kv, kv, qpos),
        "flash_decode_ring": lambda: flash_decode(
            need(q), kv, kv, qpos, kpos=torch.arange(128, dtype=torch.int32,
                                                     device=dev)[None].contiguous(), window=64),
        "flash_decode_paged": lambda: flash_decode_paged(q, need(pool), pool, bt, qpos),
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no backward"):
            call()
        with torch.no_grad():
            call()


def _train_reduced(dev, steps=40, arch="smollm-135m"):
    """A reduced config in bf16 trained ``steps`` steps on the card →
    (model, params, history)."""
    from repro_torch.data import lm_batches
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import Trainer

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=torch.bfloat16)
    model = Model(cfg, device=dev)
    tr = Trainer(model, AdamWConfig(lr=3e-3, warmup_steps=3, total_steps=steps), remat=True)
    params, opt = tr.init(_gen(dev, 0))
    params, opt, hist = tr.fit(params, opt, lm_batches(8, 64, cfg.vocab_size, seed=0,
                                                      markov_alpha=0.97),
                               steps=steps, log_every=5, log_fn=None)
    return model, params, hist


def test_bf16_train_step_lowers_the_loss_on_card(dev):
    """bf16 params, f32 moments, per-layer remat: the loss falls and every
    step's numbers are finite; the trained leaves stay bf16 buffers with no
    gradient attached."""
    model, params, hist = _train_reduced(dev)
    assert all(np.isfinite([h["loss"], h["grad_norm"]]).all() for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.3, [h["loss"] for h in hist]
    assert params.embed.w.dtype == torch.bfloat16
    assert not any(t.requires_grad for t in params.buffers())


def test_bf16_checkpoint_round_trip_without_ml_dtypes_on_card(dev, tmp_path, monkeypatch):
    """A bf16 tree written from the card and read back, with ``ml_dtypes``
    unimportable: every leaf bit-equal."""
    import sys

    from repro_torch.bridge import from_jax_params, to_tree
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.train.trainer import train_leaves

    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    model, params, _ = _train_reduced(dev, steps=3)
    path = str(tmp_path / "bf16.npz")
    save_checkpoint(path, {"params": to_tree(params), "step": 3})
    back = load_checkpoint(path)
    assert back["params"]["embed"]["w"].dtype == np.dtype("V2") and int(back["step"]) == 3
    again = from_jax_params(back["params"], model.cfg, device=dev)
    want, got = train_leaves(params), train_leaves(again)
    assert list(want) == list(got)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_served_trained_checkpoint_replay_equals_eager_on_card(dev, tmp_path):
    """A checkpoint trained on the card, served W8A8 (ngram) through the
    serve CLI's loader: the captured decode step gives the eager step's
    tokens bit for bit, and speculation gives vanilla's."""
    from repro_torch.bridge import from_jax_params, to_tree
    from repro_torch.core.config import SpecConfig
    from repro_torch.data import task_prompts
    from repro_torch.serving.engine import SpecEngine
    from repro_torch.train.checkpoint import load_checkpoint, save_checkpoint

    model, params, _ = _train_reduced(dev)
    path = str(tmp_path / "trained.npz")
    save_checkpoint(path, {"params": to_tree(params), "step": 40})
    raw = from_jax_params(load_checkpoint(path)["params"], model.cfg, device=dev)
    prompts = torch.as_tensor(task_prompts("gsm8k", 4, 48, model.cfg.vocab_size),
                              device=dev)
    scfg = SpecConfig(temperature=0.0, verifier="w8a8", drafter="ngram")
    out = _eager_and_graph(model, scfg, lambda eng: eng.generate(raw, prompts, 16))
    (eager, n_eager, _), (graph, n_graph, g_eng) = out[False], out[True]
    assert torch.equal(graph.tokens, eager.tokens) and n_graph == n_eager
    assert not graph.bad.any() and g_eng.step_traces == 1
    vanilla = SpecEngine(model, SpecConfig(temperature=0.0, verifier="w8a8",
                                           drafter="vanilla")).generate(raw, prompts, 16)
    n = prompts.shape[1] + 16
    assert torch.equal(graph.tokens[:, :n], vanilla.tokens[:, :n])


@pytest.mark.parametrize("arch,seq", [("smollm-135m", 64), ("mamba2-370m", 16),
                                      ("whisper-small", 32)])
def test_captured_train_step_equals_eager_on_card(dev, arch, seq):
    """The train step as a CUDA graph (``make_train_step(graphs=True)``):
    losses, gradient norms, leaves and moments equal the eager step's bit
    for bit over six steps (the first eager, the second captured), bf16
    weights with remat; mamba2 at T 16 runs ``ssd_update`` and whisper the
    cross read through their gradient route inside the graph, each launch
    counted once per replay."""
    from repro_torch.data import lm_batches
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import make_train_step, train_leaves

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=torch.bfloat16)
    opt_cfg = AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=6)
    n = cfg.num_audio_frames
    aux = (torch.randn(2, n, cfg.d_model, generator=_gen(dev, 9), device=dev)
           if n else None)
    runs = {}
    for graphs in (False, True):
        params = Model(cfg, device=dev).init_params(_gen(dev, 0))
        opt = adamw_init(train_leaves(params))
        step = make_train_step(cfg, opt_cfg, remat=True, graphs=graphs)
        data = lm_batches(2, seq, cfg.vocab_size, seed=0, markov_alpha=0.97)
        ops.reset_launch_counts()
        metrics = []
        for _ in range(6):
            params, opt, m = step(params, opt, {**next(data), "aux_embeds": aux})
            metrics.append(torch.stack([m["loss"], m["grad_norm"]]).float())
        torch.cuda.synchronize()
        runs[graphs] = (torch.stack(metrics), train_leaves(params), opt, ops.launch_counts())
    (m0, p0, o0, n0), (m1, p1, o1, n1) = runs[False], runs[True]
    assert torch.isfinite(m0).all() and torch.equal(m0, m1)
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
        assert torch.equal(o0["mu"][k], o1["mu"][k]) and torch.equal(o0["nu"][k], o1["nu"][k])
    assert o0["step"] == o1["step"] == 6
    want = {"mamba2-370m": "ssd_update", "whisper-small": "flash_decode_cross"}.get(arch)
    assert n0 == n1 and (want is None or n0.get(want, 0) > 0)
