"""The port's bench entry (client_tpu_torch.bench) on the CPU at a tiny
encoder and decoder: the same functions ``main`` runs, bench.py's JSON
keys, ``vs_baseline`` null, and a failing point raising instead of being
reported as an error field."""

import json
import os

import numpy as np
import pytest
import torch

from client_tpu_torch import bench
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.perf import bench_harness as tbh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = bench.Settings(max_batch=8, concurrency=16, lb_max_batch=4,
                      lb_concurrency=8, pipeline_depth=2, window_ms=300,
                      max_trials=4, stability=0.9, attempts=1)
ENCODER = tt.TransformerConfig(vocab_size=128, d_model=32, n_layers=2,
                               n_heads=2, head_dim=16, d_ff=64, max_seq=16,
                               causal=False, dtype=torch.float32)
DECODER = tt.TransformerConfig(vocab_size=64, d_model=32, n_layers=2,
                               n_heads=2, head_dim=16, d_ff=64, max_seq=48,
                               causal=True, dtype=torch.float32,
                               attn_impl="ref")


def _generation(jobs=None):
    jobs = jobs or tbh.ragged_generation_jobs(7, 64, 6, (2, 12), (3, 10), 48)
    return dict(cfg=DECODER, jobs=jobs, n_slots=4, chunk=4)


def _bench_py_keys() -> tuple:
    """The keys bench.py's main writes into its JSON line (its ``out``
    dict, its run_point and its generation point), read from its source:
    bench.py imports the JAX package at call time only."""
    src = open(os.path.join(REPO, "bench.py")).read()
    out = src[src.index("    out = {"):src.index("    out.update(primary)")]
    top = {line.split('"')[1] for line in out.splitlines()
           if line.strip().startswith('"')}
    return top | {"value", "latency_bounded", "generation"}


@pytest.fixture(scope="module")
def result():
    return bench.run_bench("cpu", TINY, encoder_cfg=ENCODER, seq=16,
                           generation=_generation())


def test_the_json_line_has_bench_py_keys(result):
    line = json.loads(json.dumps(result))
    assert _bench_py_keys() <= set(line)
    assert line["vs_baseline"] is None
    assert line["attn_impl"] == "flash"
    assert line["attn_fallback_reason"] is None
    assert line["device"] == {"name": "cpu", "power_limit": None}
    for point in (line, line["latency_bounded"]):
        for key in ("value", "mfu", "p50_latency_ms", "p99_latency_ms",
                    "stabilized", "concurrency", "client_rejected_count",
                    "stabilization", "server_infer_per_s"):
            assert key in point
        assert point["value"] > 0 and point["mfu"] is None
        assert point["client_rejected_count"] == 0
    lb = line["latency_bounded"]
    assert lb["max_batch"] == 4 and lb["target_p50_ms"] == 250.0
    assert isinstance(lb["meets_target"], bool)
    gen = line["generation"]
    assert set(gen) == {"metric", "value", "unit", "pass_rates", "n_jobs",
                        "n_slots", "useful_tokens"}
    assert gen["metric"] == "continuous_batching_ragged_tokens_per_s"
    assert gen["value"] > 0 and len(gen["pass_rates"]) == 2
    assert gen["n_jobs"] == 6 and gen["n_slots"] == 4


def test_settings_read_bench_py_variables():
    got = bench.Settings.from_env({"BENCH_WINDOW_MS": "2000",
                                   "BENCH_STABILITY": "0.1",
                                   "BENCH_LB_CONCURRENCY": "0"})
    assert (got.window_ms, got.stability, got.lb_concurrency) == \
        (2000, 0.1, 0)
    assert bench.Settings.from_env({}) == bench.Settings()
    assert bench.Settings() == bench.Settings(
        max_batch=256, concurrency=2560, lb_max_batch=128,
        lb_concurrency=768, pipeline_depth=8, window_ms=6000,
        max_trials=10, stability=0.07, attempts=5)


def test_the_generation_point_is_bench_py_s():
    cfg = bench.generation_config()
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers, cfg.n_heads,
            cfg.head_dim, cfg.d_ff, cfg.max_seq) == \
        (30528, 768, 12, 12, 64, 3072, 192)
    assert cfg.dtype == torch.bfloat16 and cfg.attn_impl == "ref"


def test_a_failing_generation_point_raises():
    """A job the engine refuses (a prompt that fills the context) fails
    the point: an exception, not an error field."""
    jobs = [(np.zeros(48, np.int32), 4)]
    with pytest.raises(RuntimeError, match="engine stream errors"):
        bench.run_generation_point("cpu", **_generation(jobs))


def test_main_needs_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
