"""The readers' arithmetic on synthetic records: percentiles, rates,
interval unions, rooflines and MFU."""

import math

import pytest

from portbench import stats, trace
from portbench.run import reader

H100 = "NVIDIA H100 80GB HBM3"


def test_percentile_interpolates_and_counts_failures_last():
    assert stats.percentile(range(1, 101), 95) == pytest.approx(95.05)
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([], 95) is None
    assert stats.percentile([1.0, 2.0, math.inf], 50) == 2.0
    assert stats.percentile([1.0, 2.0, math.inf], 95) == math.inf


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert stats.union_length(iv) == 4
    assert stats.gaps(iv, 0, 10) == [(6, 10), (3, 5)]
    assert stats.gaps([], 0, 1) == [(0, 1)]


def test_histogram_median_and_count():
    bounds = [1.0, 2.0, 4.0]
    assert stats.histogram_median(bounds, [0, 0, 0, 0], [2, 2, 0, 0]) == 1.0
    assert stats.histogram_median(bounds, [1, 0, 0, 0], [1, 0, 4, 0]) == 3.0
    assert stats.histogram_median(bounds, [1, 1, 1, 1], [1, 1, 1, 1]) is None
    assert stats.count_in([0.5, 1.0, 1.5, 2.0], 1.0, 2.0) == 2


def _trace(kernels, lo=0, hi=2_000_000_000):
    return {"kernels": kernels, "host": [("aten::mm", 900_000_000,
                                          1_100_000_000)],
            "start_ns": lo, "end_ns": hi, "t0": 10.0, "t1": 12.0}


def test_busy_idle_and_breakdown():
    tr = _trace([("flash_fwd_bf16_kernel<64>", 0, 500_000_000),
                 ("sm90_xmma_gemm", 250_000_000, 750_000_000),
                 ("paged_decode_kernel<bf16>", 1_500_000_000, 2_000_000_000)])
    assert trace.busy_s(tr) == pytest.approx(1.25)
    assert reader("metrics", "device_idle.encoder")({"trace": tr}) == \
        pytest.approx(37.5)
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["K1 flash_attention", 0.5]
    assert b["idle_gaps"] == [["aten::mm", 0.75]]
    assert trace.kernel_group("void at::native::elementwise_kernel<128>") \
        == "at::native::elementwise_kernel"
    assert trace.kernel_group("void at::native::(anonymous namespace)::"
                              "cunn_SoftMaxForward<8, float>(float*)") \
        == "at::native::cunn_SoftMaxForward"


def test_rates_and_tails():
    rec = {"window": {"t0": 10.0, "t1": 20.0, "seconds": 10.0},
           "requests": [(9.0, 10.5, True), (10.0, 10.2, True),
                        (11.0, 11.3, True), (19.0, 21.0, True),
                        (12.0, 13.0, False)]}
    assert reader("e2e", "infer_per_s")(rec) == pytest.approx(0.3)
    # sent in the window: 200, 300, 2000 ms and one failure (infinite)
    assert reader("e2e", "latency_p95_ms")(rec) == math.inf
    rec["requests"].pop()
    assert reader("e2e", "latency_p95_ms")(rec) == pytest.approx(1830.0)
    gen = {"window": rec["window"], "requests": [
        {"send": 9.0, "times": [9.5, 10.5, 11.0]},
        {"send": 12.0, "times": [12.25, 19.0, 21.0]}]}
    assert reader("e2e", "output_tokens_per_s")(gen) == pytest.approx(0.4)
    assert reader("e2e", "ttft_p95_ms")(gen) == pytest.approx(250.0)


def test_k1_roofline_and_mfu_encoder():
    # 10 calls of 0.1 ms at B 256, L 128, H 12, D 64: 201 MB each
    kernels = [("flash_fwd_bf16_kernel", i * 1_000_000, i * 1_000_000 + 100_000)
               for i in range(10)]
    shape = {"bucket": 256, "seq": 128, "heads": 12, "head_dim": 64,
             "d": 768, "ff": 3072, "layers": 12}
    rec = {"device": {"kind": H100}, "trace": _trace(kernels), "shape": shape,
           "requests": [(0.0, 11.0, True)] * 1000}
    bound_ms = 4 * 256 * 128 * 12 * 64 * 2 / 3.35e12 * 1e3
    assert reader("metrics", "k1_roofline")(rec) == \
        pytest.approx(100 * bound_ms / 0.1)
    per = 12 * (4 * 768 ** 2 + 2 * 768 * 3072) * 2 * 128 + 12 * 4 * 128 ** 2 * 768
    assert reader("metrics", "mfu.encoder")(rec) == \
        pytest.approx(100 * 1000 * per / 2.0 / 989e12)
    rec["device"]["kind"] = "cpu"
    assert reader("metrics", "k1_roofline")(rec) is None
    rec["device"]["kind"] = H100
    rec["trace"]["kernels"] = []
    assert reader("metrics", "k1_roofline")(rec) is None


def test_k2_roofline_and_mfu_generate():
    shape = {"layers": 2, "d": 8, "heads": 4, "kv_heads": 2, "head_dim": 2,
             "ff": 16, "vocab": 10, "kv_bytes": 2}
    kernels = [("paged_decode_kernel<bf16>", 0, 1000)]
    reqs = [{"plen": 5, "send": 9.0, "times": [9.5, 10.5, 11.0, 13.0]}]
    rec = {"device": {"kind": H100}, "trace": _trace(kernels), "shape": shape,
           "requests": reqs,
           "slice": {"before": {"gen": {"prefill_tokens": 0}},
                     "after": {"gen": {"prefill_tokens": 0}}}}
    # tokens 1 and 2 land in [10, 12): contexts 6 and 7
    row, qo = 2 * 2 * 2 * 2, 2 * 4 * 2 * 2
    nbytes = 2 * ((6 * row + qo) + (7 * row + qo))
    assert reader("metrics", "k2_roofline")(rec) == \
        pytest.approx(100 * nbytes / 3.35e12 / 1e-6)
    layer = 2 * (8 * 4 * 2 + 8 * 2 * 2 * 2 + 4 * 2 * 8 + 3 * 8 * 16)
    flops = sum(2 * (layer + 32 * c) + 2 * 8 * 10 for c in (6, 7))
    assert reader("metrics", "mfu.generate")(rec) == \
        pytest.approx(100 * flops / 2.0 / 989e12)


def test_program_counters():
    before = {"execution_count": 10, "inference_stats": {
        "queue": {"count": 100, "ns": 1_000_000},
        "compute_infer": {"count": 100, "ns": 50_000_000}}}
    after = {"execution_count": 14, "inference_stats": {
        "queue": {"count": 200, "ns": 3_000_000},
        "compute_infer": {"count": 200, "ns": 150_000_000}}}
    rec = {"counters": {"before": before, "after": after}}
    assert reader("metrics", "batcher.queue_ms")(rec) == pytest.approx(0.02)
    assert reader("metrics", "model.compute_infer_ms")(rec) == \
        pytest.approx(25.0)
    eng = {"dispatch_by_kind": {"chunk": {"dispatches": 4, "host_s": 0.1}},
           "prefill_lane": {"chunks": 2}, "phase_seconds": {"prefill": 0.5}}
    eng2 = {"dispatch_by_kind": {"chunk": {"dispatches": 8, "host_s": 0.3}},
            "prefill_lane": {"chunks": 2}, "phase_seconds": {"prefill": 0.5}}
    g = {"counters": {
        "before": {"engine": eng, "gen": {"queue_wait": ([0, 0, 0], 0, 0)}},
        "after": {"engine": eng2, "gen": {"queue_wait": ([2, 2, 0], 0, 4)}}},
         "latency_buckets_ns": [1_000_000, 2_000_000]}
    assert reader("metrics", "engine.host_ms_per_chunk")(g) == \
        pytest.approx(50.0)
    assert reader("metrics", "lane.host_ms_per_dispatch")(g) is None
    assert reader("metrics", "engine.queue_wait_ms")(g) == pytest.approx(1.0)


def test_in_flight_and_kv_occupancy():
    from portbench.drivers.encoder_shm import in_flight_mean

    # two requests across the whole window, one for half of it
    rows = [(9.0, 21.0, True), (10.0, 20.0, True), (12.0, 17.0, True)]
    assert in_flight_mean(rows, 10.0, 20.0) == pytest.approx(2.5)
    rec = {"in_flight_mean": 2.5, "concurrency": 4}
    assert reader("metrics", "loop.in_flight_share")(rec) == \
        pytest.approx(62.5)
    kv = reader("metrics", "engine.kv_used_share")
    assert kv({"kv_samples": [(10, 100), (30, 100)]}) == pytest.approx(20.0)
    assert kv({"kv_samples": []}) is None and kv({}) is None
