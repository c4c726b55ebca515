"""The benchmark's arithmetic against hand-worked cases: TPOT, nearest-rank
percentiles, the union of intervals and the idle share, the rooflines and
the frozen counts at the 7B."""
import json
import math

import pytest

import tiny_cell  # noqa: F401  (puts bench/ and src/ on the path)
from benchkit import counts, devtrace, stats


def test_percentile_nearest_rank():
    v = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert stats.percentile(v, 50) == 3.0
    assert stats.percentile(v, 95) == 5.0
    assert stats.percentile(list(range(1, 101)), 95) == 95.0
    assert stats.percentile([1.0, 2.0, 3.0, 4.0], 50) == 2.0
    assert stats.percentile([], 95) is None
    assert stats.percentile([1.0] * 19 + [math.inf], 95) == 1.0
    assert stats.percentile([1.0] * 18 + [math.inf] * 2, 95) == math.inf


def test_tpot():
    assert stats.tpot(1.0, 3.0, 5) == pytest.approx(0.5)
    assert stats.tpot(1.0, 1.0, 1) is None


def test_union_covered_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 8)]
    assert stats.union(iv) == [(0, 3), (5, 6)]
    assert stats.covered(iv) == 4
    assert stats.gaps(iv, -1, 7) == [(-1, 0), (3, 5), (6, 7)]
    assert stats.clip(iv, 2, 5.6) == [(2, 3), (5, 5.6), (5.5, 5.6)]


def test_idle_share_and_idle_by_span():
    # a 10 µs window, kernels over 0-2, 1-4 and 7-8 µs: busy 5 µs
    tr = devtrace.DeviceTrace(0.0, 10.0, [("a", 0, 2), ("b", 1, 4), ("a", 7, 8)],
                              [("tick", 0, 10), ("prefill", 4, 6)])
    assert tr.busy_s == pytest.approx(5e-6)
    assert tr.window_s == pytest.approx(1e-5)
    assert tr.family_s(["a"]) == pytest.approx(3e-6)
    idle = dict(tr.idle_by_span())
    assert idle["prefill"] == pytest.approx(3e-6)     # 4-7: midpoint in prefill (4-6)
    assert idle["tick"] == pytest.approx(2e-6)        # 8-10
    assert dict(tr.top_ops())["a"] == pytest.approx(3e-6)


def test_kernel_short_names():
    assert devtrace._short("void (anonymous namespace)::int8_gemm_kernel<2, 64>(Args)") \
        == "int8_gemm_kernel"
    assert devtrace._short("at::native::elementwise_kernel<128, 2>(int)") \
        == "at::native::elementwise_kernel"


def test_roofline_share():
    # 1 GB moved and no operations: 1e9 / 3.35e12 s = 0.2985 ms least time;
    # done in 0.5970 ms, half the roofline
    w = counts.Work(nbytes=1e9)
    assert counts.share(w, 2e9 / counts.HBM_BW) == pytest.approx(50.0)
    # 1979e9 int8 ops and few bytes: 1 ms least time
    w = counts.Work(int8_ops=1979e9, nbytes=1.0)
    assert w.least_s == pytest.approx(1e-3)
    assert counts.share(counts.Work(), 1.0) is None


SEVEN_B = json.loads((tiny_cell.BENCH / "configs" / "quasar-paper-7b.json").read_text())["model"]


def test_frozen_counts_at_the_7b():
    d = counts.Dims.of(SEVEN_B)
    # per layer 4096*(4096+1024+1024) + 4096*4096 + 3*4096*12288 = 193 M; 36 layers,
    # embedding and lm_head 151936*4096 each, norms 73*4096
    assert SEVEN_B["num_layers"] == 36
    per_layer = 4096 * 4096 * 2 + 4096 * 1024 * 2 + 3 * 4096 * 12288
    assert per_layer == 192_937_984
    assert d.weight_params() == 36 * per_layer + 2 * 151936 * 4096 + 73 * 4096
    assert d.weight_params() / 1e9 == pytest.approx(8.19, abs=0.005)
    assert d.kv_bytes_per_token() == 147456           # 36 layers x K, V x 8 heads x 128 x bf16
    # int8 linears of one step: 36 layers' + lm_head, ~7.57 GB
    int8 = sum(a * b for a, b in d.dense_linears(True))
    assert int8 == 36 * per_layer + 4096 * 151936
    assert int8 / 1e9 == pytest.approx(7.57, abs=0.01)
    # a step of 32 live rows at 1024 keys each, window 6: the weights once,
    # the cache 32*1024*147456 B, the window's K/V written
    w = counts.verify_step(d, 6, 32, 32 * 1024)
    kv = 32 * 1024 * 147456
    lin = d.dense_linears(True)
    acts = 192 * sum(a + 4 + 2 * b for a, b in lin)       # codes in, bf16 out
    scales = 4 * sum(b for _, b in lin) + 4 * sum(a for a, _ in lin)
    attn_io = 32 * 2 * 6 * 4096 * 2 * 36                    # q read, output written
    by_hand = (int8 + kv + acts + scales + attn_io + 192 * 147456 + 192 * 4096 * 2
               + 73 * 4096 * 4)
    assert w.nbytes == pytest.approx(by_hand, rel=1e-3)
    assert w.int8_ops == pytest.approx(2.0 * 192 * int8)
