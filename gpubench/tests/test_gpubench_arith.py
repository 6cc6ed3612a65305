"""The metric arithmetic on synthetic inputs: whole-window rates, the
energy integral, the interval union behind the idle share, the trace's
reduction, and the frozen FLOPs and bytes against hand counts."""
from types import SimpleNamespace

import pytest

import gpubench_tiny  # noqa: F401  (puts the repo on the path)
from gpubench import cost, measure, trace
from gpubench.power import PowerSampler
from gpubench.work import dense


def ctx_of(kind, calls, window_s, **kw):
    return SimpleNamespace(driver=SimpleNamespace(kind=kind), calls=calls,
                           window_s=window_s,
                           tokens=sum(c.tokens for c in calls), **kw)


def test_rate_is_all_tokens_over_the_whole_window():
    calls = [SimpleNamespace(tokens=1000), SimpleNamespace(tokens=3000)]
    assert measure.rate(ctx_of("serve", calls, 8.0), "serve") == 500.0
    assert measure.rate(ctx_of("serve", calls, 8.0), "train") is None


def test_overheads_are_weighted_by_each_calls_time():
    rep = [SimpleNamespace(time_s=1.0, overheads={"accel": {"O_kl": 0.5}}),
           SimpleNamespace(time_s=3.0, overheads={"accel": {"O_kl": 0.1}})]
    calls = [SimpleNamespace(tokens=1, report=r) for r in rep]
    got = measure.overhead(ctx_of("train", calls, 4.0), "train", "O_kl")
    assert got == pytest.approx(100 * (0.5 + 0.3) / 4)


def test_energy_is_the_trapezoid_of_the_samples_over_the_window():
    p = PowerSampler("0")
    p.samples = [(10.0, 100.0), (11.0, 300.0), (12.0, 300.0)]
    # 10.5 -> 11: from 200 W to 300 W; 11 -> 11.5: 300 W
    assert p.energy_j(10.5, 11.5) == pytest.approx(125.0 + 150.0)
    assert p.energy_j(10.0, 12.0) == pytest.approx(200.0 + 300.0)


@pytest.mark.parametrize("samples", [[], [(10.0, 100.0)],
                                     [(13.0, 1.0), (14.0, 1.0)]])
def test_energy_without_samples_over_the_window_raises(samples):
    p = PowerSampler("0")
    p.samples = samples
    with pytest.raises(RuntimeError):
        p.energy_j(10.0, 12.0)


def test_union_and_gaps_of_intervals():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert trace.union_s(spans) == pytest.approx(3.0)
    assert trace.gaps(spans, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                            (4.0, 5.0)]


def test_reduce_counts_busy_time_kernels_and_idle_gaps():
    ev = [(False, "window", 0.0, 10.0),
          (False, "cudaGraphLaunch", 0.9, 1.1),
          (False, "fetch", 5.0, 8.0),
          (True, "void flash_decode_kernel<64, 1>(Args)", 1.0, 3.0),
          (True, "void flash_attention_wgmma_kernel<128>(...)", 2.0, 4.0),
          (True, "void ssd_scan_kernel(...)", 9.0, 10.0),
          (True, "ampere_bf16_gemm", 9.5, 9.5 + 1e-5)]
    s = trace.reduce(ev, 0.0, 10.0)
    assert s.busy_s == pytest.approx(4.0)
    assert s.idle_share == pytest.approx(0.6)
    assert {k: len(v) for k, v in s.kernels.items()} == {"k1": 1, "k2": 1,
                                                         "k3": 1}
    gaps = dict(s.idle_gaps)
    assert gaps["fetch"] == pytest.approx(5.0)       # 4 .. 9
    assert gaps["window"] == pytest.approx(1.0)      # 0 .. 1


def test_kernel_names():
    assert cost.kernel_of("void flash_attention_kernel<64>(x)") == "k1"
    assert cost.kernel_of("flash_attention_wgmma_kernel<96>") == "k1"
    assert cost.kernel_of("void flash_decode_kernel<64, 8>(Args)") == "k2"
    assert cost.kernel_of("ssd_scan_kernel") == "k3"
    assert cost.kernel_of("ssd_scan_kernel_bwd_other") is None
    assert cost.kernel_of("vectorized_elementwise_kernel") is None


def test_attention_work_by_hand():
    # causal 4 x 4: 10 pairs; offset 2 of 6 columns: rows see 3 and 4
    assert cost.attention_pairs(4, 4, True) == 10
    assert cost.attention_pairs(2, 6, True, 4) == 5 + 6
    assert cost.attention_pairs(3, 5, False) == 15
    assert cost.attention_flops(2, 4, 4, 3, 8) == 4 * 2 * 3 * 8 * 10
    # q, o (2 x 4 x 3 x 8 each) and k, v (2 x 4 x 1 x 8 each), bf16; L fp32
    assert cost.attention_bytes(2, 4, 4, 3, 1, 8, lse=True) == \
        2 * (2 * 192 + 2 * 64) + 4 * 24


def test_decode_and_ssd_work_by_hand():
    assert cost.decode_flops(rows_read=10, h=4, d=8) == 4 * 10 * 4 * 8
    assert cost.decode_bytes(2, 4, 2, 8, 10) == \
        2 * (2 * 64 + 2 * 10 * 16) + 8
    # one chunk of 4 steps: 10 lower-triangle pairs x 2 (N + P), plus
    # 4 L N P for C.S_in and the state update
    assert cost.ssd_flops(1, 4, 1, 2, 3, 4) == 10 * 2 * 5 + 4 * 4 * 3 * 2
    assert cost.ssd_flops(1, 6, 1, 2, 3, 4) == \
        cost.ssd_flops(1, 4, 1, 2, 3, 4) + 3 * 2 * 5 + 4 * 2 * 3 * 2
    assert cost.ssd_bytes(1, 4, 2, 8, 1, 3, False) == \
        2 * (2 * 64 + 2 * 12) + 4 * (8 + 2) + 4 * 48


CFG = {"n_layers": 3, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
       "head_dim": 4, "d_ff": 16, "vocab": 10}


def test_dense_serving_chunk_by_hand():
    k = dense.serve_kernels(CFG, b=2, prompt=5, decode=3)
    assert len(k["k1"]) == 3 and len(k["k2"]) == 2 * 3 and not k["k3"]
    # the second decode step reads pos + 1 = 7 rows of each of 2 requests
    assert k["k2"][-1] == (cost.decode_flops(14, 2, 4),
                           cost.decode_bytes(2, 2, 1, 4, 14))
    weights = 8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16
    one = 2 * 2 * 5 * weights + cost.attention_flops(2, 5, 5, 2, 4)
    assert dense.forward_flops(CFG, 2, 5, 0, 2) == 3 * one + 2 * 2 * 8 * 10
    assert dense.train_flops(CFG, 2, 5) == 3 * dense.forward_flops(
        CFG, 2, 5, 0, 10)


@pytest.mark.parametrize("seen,expect", [(1000, 50.0), (999, 50.0),
                                         (998, None), (1001, None)])
def test_roofline_checks_the_launches_the_profiler_saw(seen, expect):
    flops = int(cost.PEAK_BF16_FLOPS * 1e-6)         # bound 1 us each
    drv = SimpleNamespace(kind="serve", kernel_work=lambda calls: {
        "k1": [(flops, 0)] * 1000})
    ctx = SimpleNamespace(driver=drv, traced_calls=[], log=lambda s: None,
                          trace=SimpleNamespace(kernels={"k1": [2e-6] * seen}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(measure, "LOST", 1e-3)
        got = measure.roofline(ctx, "serve", "k1")
    assert got == (None if expect is None else pytest.approx(expect))


def test_a_line_cut_short_at_the_stop_is_not_counted():
    p = PowerSampler("0")
    p.samples = [(10.0, 100.0), (12.0, 100.0)]
    p.bad = ["2026/10/18 03:31:3"]
    assert p.energy_j(10.0, 12.0) == pytest.approx(200.0)
    p.bad = ["garbage", "2026/10/18 03:31:3"]
    with pytest.raises(RuntimeError):
        p.energy_j(10.0, 12.0)
