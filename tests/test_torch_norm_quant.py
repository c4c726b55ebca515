"""The fused RMSNorm + smoothing + int8 quantization (``norm_smooth_quant``)
on the CPU: its plain version, its choice in ``models/common.Norm``, and
the JAX package's composition of the same steps.

``norm_smooth_quant_ref`` mirrors the card kernel's fixed order of the sum
of squares (``kernels/smooth_quant.row_sum_squares``), so a row's bits do
not depend on how many rows come with it, and then quantizes exactly as
``smooth_quant_ref`` does.  Its norm differs from the reference's
(``jnp.mean``, ``rsqrt``) and from the port's CPU composition (torch's mean,
``torch.rsqrt``) only in rounding, so the codes it gives are held to those
of the composition within one code, in at most 1e-4 of the elements, and
its Δx within 2^-20 relative for f32 rows (measured: at most 5 ulps) and
2^-7 (one bf16 step of the row's largest value) for bf16 rows (measured:
equal).
"""
import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.smooth_quant import smooth_quant as jsq
from repro.models.common import rms_norm as jrms_norm
from repro_torch.bridge import tensor
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.smooth_quant import (THREADS, chunk, max_width, norm_smooth_quant,
                                              norm_smooth_quant_ref, rms_norm_rows,
                                              row_sum_squares, smooth_quant_ref)
from repro_torch.models.common import Norm, rms_norm
from repro_torch.models.linear import Linear, W4A8Linear, W8A8Linear
from test_torch_batching import one_torch_thread  # noqa: F401  (autouse)

CPU = torch.device("cpu")
CODE_SHARE = 1e-4
DX_REL = {torch.float32: 2.0 ** -20, torch.bfloat16: 2.0 ** -7}


def _inputs(m, d, dtype, seed, n=3):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(m, d, generator=g) * 3).to(dtype)
    scale = torch.rand(d, generator=g) + 0.5
    smooths = [torch.rand(d, generator=g) * 7.875 + 0.125 for _ in range(n)]
    return x, scale, smooths


def _close_to(got, want, dtype):
    """The codes within one step in at most CODE_SHARE of them, Δx within
    DX_REL[dtype]."""
    for (q, dx), (rq, rdx) in zip(got, want):
        dq = (q.int() - torch.as_tensor(np.array(rq)).int()).abs()
        assert dq.max().item() <= 1
        assert (dq > 0).float().mean().item() <= CODE_SHARE
        rdx = torch.as_tensor(np.array(rdx))
        assert ((dx - rdx).abs() / rdx).max().item() <= DX_REL[dtype]


@pytest.mark.parametrize("d,dtype", [(4096, torch.bfloat16), (576, torch.float32),
                                     (100, torch.bfloat16)])
def test_norm_smooth_quant_ref_rows_do_not_depend_on_row_count(d, dtype):
    x, scale, smooths = _inputs(300, d, dtype, d)
    full = norm_smooth_quant_ref(x, scale, 1e-5, smooths)
    for m in (1, 4, 24, 88, 300):
        part = norm_smooth_quant_ref(x[:m], scale, 1e-5, smooths)
        for (q, dx), (fq, fdx) in zip(part, full):
            assert torch.equal(q, fq[:m]), m
            assert torch.equal(dx.view(torch.int32), fdx[:m].view(torch.int32)), m


@pytest.mark.parametrize("d,dtype", [(4096, torch.bfloat16), (576, torch.float32),
                                     (70, torch.float32)])
def test_norm_smooth_quant_ref_is_its_norm_then_smooth_quant(d, dtype):
    """X̂ and Δx are smooth_quant_ref of the ref's own normed rows, bit for
    bit; the sum of squares is the kernel's order, written out here element
    by element in numpy f32."""
    x, scale, smooths = _inputs(5, d, dtype, d + 1)
    y = rms_norm_rows(x, scale, 1e-5)
    assert y.dtype == dtype
    for (q, dx), s in zip(norm_smooth_quant_ref(x, scale, 1e-5, smooths), smooths):
        rq, rdx = smooth_quant_ref(y, s)
        assert torch.equal(q, rq)
        assert torch.equal(dx.view(torch.int32), rdx.view(torch.int32))
    c = chunk(dtype)
    x32 = x.float().numpy()
    for r in range(x32.shape[0]):
        part = np.zeros(THREADS, np.float32)
        for t in range(THREADS):
            for j in range(t, -(-d // c), THREADS):
                for k in range(j * c, min(j * c + c, d)):
                    part[t] = np.float32(part[t] + np.float32(x32[r, k] * x32[r, k]))
        warps = part.reshape(-1, 32)
        for o in (16, 8, 4, 2, 1):
            warps = warps + warps[:, np.arange(32) ^ o]
        total = warps[0, 0]
        for w in range(1, warps.shape[0]):
            total = np.float32(total + warps[w, 0])
        assert row_sum_squares(x.float()[r:r + 1], c).item() == total


@pytest.mark.parametrize("d,dtype", [(4096, torch.bfloat16), (4096, torch.float32),
                                     (576, torch.float32), (12288, torch.bfloat16)])
def test_norm_smooth_quant_ref_close_to_the_composition(d, dtype):
    """Against today's composition on the CPU (``rms_norm`` with torch's
    mean, then ``smooth_quant_ref``): codes within one step, Δx within one
    rounding of the norm (module docstring)."""
    x, scale, smooths = _inputs(300, d, dtype, d + 2)
    y = rms_norm(x, scale, 1e-5)
    _close_to(norm_smooth_quant_ref(x, scale, 1e-5, smooths),
              [smooth_quant_ref(y, s) for s in smooths], dtype)


@pytest.mark.parametrize("d,dtype", [(256, ml_dtypes.bfloat16), (96, np.float32)])
def test_norm_smooth_quant_close_to_jax(d, dtype):
    """The port's fused entry point (plain version on the CPU) against the
    JAX package's rms_norm and Pallas smooth_quant (interpret mode), same
    bounds; the CPU run launches no kernel."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((24, d)) * 3).astype(dtype)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    smooths = [rng.uniform(0.125, 8.0, d).astype(np.float32) for _ in range(2)]
    y = jrms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    want = [jsq(y, jnp.asarray(s), block_m=8, interpret=True) for s in smooths]
    ops.reset_launch_counts()
    got = norm_smooth_quant(tensor(x, CPU), tensor(scale, CPU), 1e-5,
                            [tensor(s, CPU) for s in smooths])
    assert ops.launch_counts() == {}
    _close_to(got, want, tensor(x, CPU).dtype)


def test_norm_smooth_quant_rejects_bad_inputs():
    x, scale, smooths = _inputs(4, 64, torch.float32, 0, n=4)
    with pytest.raises(ValueError, match="1 to 3"):
        norm_smooth_quant(x, scale, 1e-5, smooths)
    with pytest.raises(ValueError, match="1 to 3"):
        norm_smooth_quant(x, scale, 1e-5, [])
    with pytest.raises(ValueError, match="contiguous"):
        norm_smooth_quant(x, scale[:32], 1e-5, smooths[:1])
    with pytest.raises(ValueError, match="bf16/f32"):
        norm_smooth_quant(x.double(), scale, 1e-5, smooths[:1])
    assert max_width(torch.bfloat16) == 2 * max_width(torch.float32) == 16384


def _quantized(d):
    w8 = W8A8Linear(torch.zeros(8, d, dtype=torch.int8), torch.ones(8), torch.ones(d))
    w4 = W4A8Linear(torch.zeros(8, d // 2, dtype=torch.int8), torch.ones(8), torch.ones(d))
    return w8, w4


@pytest.mark.parametrize("case,fused", [
    ("card rmsnorm quantized readers", True), ("cpu", False), ("layernorm", False),
    ("bf16 reader", False), ("no readers (calibration)", False), ("too wide", False)])
def test_norm_fuses_on_the_card_with_quantized_readers_only(case, fused):
    """The fused path is chosen from the device and the configuration: an
    RMSNorm on the card whose readers are all W8A8/W4A8 linears.  (A stand-in
    for a card tensor: the choice reads only device, dtype and shape.)"""
    d = 64
    norm = Norm(types.SimpleNamespace(norm_eps=1e-5,
                                      norm="layernorm" if case == "layernorm" else "rmsnorm"), d)
    readers = _quantized(d)
    if case == "bf16 reader":
        readers = (readers[0], Linear(torch.zeros(d, 8)))
    if case.startswith("no readers"):
        readers = ()
    width = max_width(torch.bfloat16) + 8 if case == "too wide" else d
    x = types.SimpleNamespace(device=types.SimpleNamespace(type="cpu" if case == "cpu"
                                                           else "cuda"),
                              dtype=torch.bfloat16, shape=(2, 3, width))
    assert norm.fuses(x, readers) is fused


def test_norm_on_the_cpu_returns_the_composition():
    """On the CPU a norm told its quantized readers still returns the normed
    tensor, bit-equal to ``rms_norm``, and the readers apply to it as before."""
    cfg = get_config("smollm-135m").reduced()
    d = cfg.d_model
    norm = Norm(cfg, d)
    x, scale, _ = _inputs(6, d, torch.float32, 3)
    norm.scale.copy_(scale)
    readers = _quantized(d)
    out = norm(x.view(2, 3, d), readers)
    assert torch.is_tensor(out)
    assert torch.equal(out, rms_norm(x, scale, cfg.norm_eps).view(2, 3, d))
