"""Each driver end to end at a tiny width on the CPU (the CLI itself
refuses without a card), the reference against the program in float32,
the control against the program in bfloat16, and the faults the check
has to catch: an answer or a token altered where it is produced."""

import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import controls, env, run, trace

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11


def tiny_cell(cell: str, dtype: str = "bfloat16") -> tuple:
    wl = run.load_json("workloads", cell)
    config, wl = controls.tiny(run.load_json("configs", wl["config"]), wl)
    config["serving"]["dtype"] = dtype
    return config, wl


def drive(cell: str, dtype: str, seconds: float = 1.5,
          traced: bool = False) -> tuple:
    env.contain(run.ROOT)
    config, wl = tiny_cell(cell, dtype)
    driver = __import__(f"portbench.drivers.{wl['driver']}",
                        fromlist=["setup"])
    state = driver.setup(config, wl, SEED, CPU)
    rec = driver.run(state, seconds, trace.Slice() if traced else None)
    driver.release(state)
    return driver, state, rec


@pytest.fixture(scope="module")
def encoder_f32():
    return drive("bert-base.shm-c2560", "float32", traced=True)


@pytest.fixture(scope="module")
def generator_f32():
    return drive("mistral-7b.chat-c64", "float32", seconds=3.0, traced=True)


def test_encoder_end_to_end_matches_the_reference(encoder_f32):
    driver, state, rec = encoder_f32
    got = driver.check(state, rec)
    assert got["failed"] == 0 and got["missing"] == 0
    assert got["compared"] >= 16
    assert got["embed_err"] < 1e-4
    rec = dict(rec, setup_s=1.0)
    for name in ("infer_per_s", "latency_p95_ms", "setup_s"):
        assert run.reader("e2e", name)(rec) > 0
    assert rec["attempted"] > 0 and rec["stragglers"] == 0
    assert run.reader("metrics", "batcher.queue_ms")(rec) >= 0
    assert run.reader("metrics", "model.compute_infer_ms")(rec) > 0
    # every completion sends its slot's next request at once
    assert 90 < run.reader("metrics", "loop.in_flight_share")(rec) <= 100


def test_generator_end_to_end_matches_the_reference(generator_f32):
    driver, state, rec = generator_f32
    got = driver.check(state, rec)
    assert got["failed"] == 0 and got["compared"] >= 20
    # float32 on both sides: a greedy token's gap is rounding
    assert got["logit_gap"] < 1e-3
    rec = dict(rec, setup_s=1.0)
    for name in ("output_tokens_per_s", "ttft_p95_ms"):
        assert run.reader("e2e", name)(rec) > 0
    assert run.reader("metrics", "engine.host_ms_per_chunk")(rec) > 0
    assert run.reader("metrics", "lane.host_ms_per_dispatch")(rec) > 0
    assert run.reader("metrics", "engine.queue_wait_ms")(rec) >= 0
    assert rec["kv_samples"]
    assert 0 < run.reader("metrics", "engine.kv_used_share")(rec) <= 100


@pytest.mark.parametrize("cell,name", [("bert-base.shm-c2560", "embed_err"),
                                       ("mistral-7b.chat-c64", "logit_gap")])
def test_the_control_reads_far_above_the_program(cell, name):
    driver, state, rec = drive(cell, "bfloat16", seconds=3.0)
    program = driver.check(state, rec)[name]
    control = driver.control(state, rec)[name]
    assert control > 0 and control >= 3 * program


def run_tiny(cell: str, seconds: float) -> dict:
    """A whole run of the cell (set-up, window, check, judgement and
    metrics) on the CPU at a tiny width, skipping the look for a card."""
    env.contain(run.ROOT)
    config, wl = tiny_cell(cell, "float32")
    bench = run.manifest()
    held = json.loads((run.HERE / "held.json").read_text())
    for key in ("workloads", "end_to_end", "per_layer"):
        bench[key] = bench[key] + held[key]
    return run.run_cell(bench, wl, config, SEED, seconds, False, CPU)


def test_a_sound_run_is_correct():
    for cell, seconds in (("bert-base.shm-c2560", 1.5),
                          ("mistral-7b.chat-c64", 3.0)):
        result = run_tiny(cell, seconds)
        assert result["correct"], result["checks"]
        assert list(result)[-1] == "checks" and result["attempted"] > 0


def test_an_altered_answer_is_not_correct(monkeypatch):
    from client_tpu_torch.perf import bench_harness

    real = bench_harness.encoder_apply

    def altered(cfg, params, inputs, mesh=None):
        out = real(cfg, params, inputs, mesh)
        emb = out["embedding"].clone()
        emb[0] += 1.0
        return {"embedding": emb}

    monkeypatch.setattr(bench_harness, "encoder_apply", altered)
    result = run_tiny("bert-base.shm-c2560", 1.5)
    assert not result["correct"]
    assert result["checks"]["embed_err"]["value"] > 0.16


def test_an_altered_token_is_not_correct(monkeypatch):
    from client_tpu_torch.server.generation import ContinuousBatchingEngine

    real = ContinuousBatchingEngine.submit

    def altered(self, *args, **kwargs):
        for i, tok in enumerate(real(self, *args, **kwargs)):
            yield (tok + 1) % 512 if i == 2 else tok

    monkeypatch.setattr(ContinuousBatchingEngine, "submit", altered)
    result = run_tiny("mistral-7b.chat-c64", 3.0)
    assert not result["correct"]
    assert result["checks"]["logit_gap"]["value"] > 0.32


def test_the_cli_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "mistral-7b.chat-c64", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_a_bare_checkout_prints_no_result(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "mistral-7b.chat-c64", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())


def test_the_same_seed_gives_the_same_traffic_and_weights():
    from portbench.reference import arch_of
    from portbench.traffic import deal_requests
    from portbench.weights import make_params

    config, wl = tiny_cell("mistral-7b.chat-c64")
    a, b = (deal_requests(wl, SEED, 512) for _ in range(2))
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for ca, cb in zip(a, b) for x, y in zip(ca, cb))
    other = deal_requests(wl, SEED + 1, 512)
    # another seed deals the same sequences of sizes to the clients
    sequences = sorted(tuple((len(p), n) for p, n in c) for c in a)
    assert sequences == sorted(tuple((len(p), n) for p, n in c)
                               for c in other)
    assert any(not np.array_equal(x[0], y[0])
               for ca, cb in zip(a, other) for x, y in zip(ca, cb))
    # the lognormal draw keeps its bounds and the mix's cap on the sum
    for c in a:
        for p, n in c:
            assert wl["prompt"]["lo"] <= len(p) < wl["prompt"]["hi"]
            assert wl["output"]["lo"] <= n < wl["output"]["hi"]
            assert len(p) + n <= wl["max_total"]
    pa = make_params(arch_of(config), SEED, CPU)
    pb = make_params(arch_of(config), SEED, CPU)
    assert torch.equal(pa["layers"]["w1"], pb["layers"]["w1"])
    assert json.dumps(sorted(pa["layers"])) == json.dumps(sorted(pb["layers"]))
