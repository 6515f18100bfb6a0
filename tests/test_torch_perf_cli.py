"""The perf analyzer's network side in the port, on the CPU, held against
the JAX package's: the cases of ``tests/test_perf.py`` that the port
lacked, on the port's server.

- The request-rate managers: the same rate and seed give the same
  constant and Poisson schedule in both packages, a custom intervals file
  the same schedule and rate; ``profile_request_rate_range`` and
  ``profile_custom`` end to end (in process and over HTTP), and a SIGINT
  (``early_exit``) ends a rate sweep promptly.
- The CLI (``python -m client_tpu_torch.perf``): in process
  (``cuda_direct``), over HTTP with system and CUDA shared memory (regions
  on the CPU), at a request rate and from an intervals file with a CSV,
  over gRPC; ``-H`` headers on every request on the wire; the flag errors
  and the foreign kinds' exit 2; ``--retries`` against a shedding model.
- The HTTP and gRPC backends: the gRPC config unwrapping feeds the parser
  what the HTTP config does, in both packages against both servers.
- The report: the same statistics render the same text and the same CSV
  in both packages, block for block (the runtime block's heading names
  no XLA in the port).
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

from client_tpu.models import make_add_sub as jax_add_sub
from client_tpu.perf import client_backend as jcb
from client_tpu.perf import inference_profiler as jip
from client_tpu.perf import model_parser as jmp
from client_tpu.perf import report as jreport
from client_tpu.perf import request_rate_manager as jrrm
from client_tpu.server import TpuInferenceServer
from client_tpu_torch.models import make_add_sub
from client_tpu_torch.perf import client_backend as tcb
from client_tpu_torch.perf import inference_profiler as tip
from client_tpu_torch.perf import model_parser as tmp
from client_tpu_torch.perf import report as treport
from client_tpu_torch.perf import request_rate_manager as trrm
from client_tpu_torch.perf.__main__ import main
from client_tpu_torch.perf.data_loader import DataLoader
from client_tpu_torch.perf.perf_utils import early_exit
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server.config import ModelConfig, TensorSpec
from client_tpu_torch.server.http_server import HttpInferenceServer
from client_tpu_torch.server.model import PyModel
from client_tpu_torch.server.types import ServerError

# short windows: the CLI's stabilization at a CPU's pace
FAST = ["--sync", "-p", "150", "-s", "90", "-r", "3"]


@pytest.fixture(scope="module")
def server():
    core = TorchInferenceServer()
    core.register_model(make_add_sub("add_sub", 16, "INT32", device="cpu"))
    core.register_model(make_add_sub("add_sub_batch", 8, "FP32",
                                     max_batch_size=8,
                                     dynamic_batching=True, device="cpu"))
    http = HttpInferenceServer(core, port=0).start()
    yield core, http
    http.stop()
    core.stop()


@pytest.fixture
def factory(server):
    return tcb.ClientBackendFactory(tcb.BackendKind.INPROCESS,
                                    server=server[0])


def _parser(factory, model="add_sub", batch=1):
    backend = factory.create()
    p = tmp.ModelParser()
    p.init(backend, model, batch_size=batch)
    return p, backend


def _loaded(factory):
    p, backend = _parser(factory)
    d = DataLoader()
    d.generate_data(p.inputs)
    return p, backend, d


# ------------------------------------------------------ request-rate managers

@pytest.mark.parametrize("distribution", ["constant", "poisson"])
@pytest.mark.parametrize("rate,duration,seed", [(50.0, 0.15, 0),
                                                (333.0, 1.0, 4),
                                                (7.5, 3.0, 9)])
def test_schedules_equal_the_references(distribution, rate, duration, seed):
    got = []
    for mod in (jrrm, trrm):
        mgr = types.SimpleNamespace(distribution=distribution)
        mod.RequestRateManager.generate_schedule(mgr, rate, duration, seed)
        got.append((mgr.schedule, mgr.gen_duration_ns))
    assert got[1] == got[0]
    assert got[1][0] and got[1][0] == sorted(got[1][0])


def test_a_rate_must_be_positive():
    mgr = types.SimpleNamespace(distribution="constant")
    with pytest.raises(ValueError, match="positive"):
        trrm.RequestRateManager.generate_schedule(mgr, 0.0)


def test_custom_intervals_equal_the_references(tmp_path):
    path = tmp_path / "iv.txt"
    path.write_text("\n".join(["3000000", "", "5000000", "7000000"] * 10))
    got = []
    for mod in (jrrm, trrm):
        mgr = types.SimpleNamespace(intervals_file=str(path), schedule=[])
        mod.CustomLoadManager.init_custom_intervals(mgr)
        got.append((mgr.schedule, mgr.gen_duration_ns,
                    mod.CustomLoadManager.custom_request_rate(mgr)))
    assert got[1] == got[0]
    assert got[1][2] == pytest.approx(200.0)
    empty = tmp_path / "empty.txt"
    empty.write_text("\n")
    with pytest.raises(ValueError, match="no intervals"):
        trrm.CustomLoadManager.init_custom_intervals(
            types.SimpleNamespace(intervals_file=str(empty), schedule=[]))


def test_request_rate_profile(factory, tmp_path):
    p, backend, d = _loaded(factory)
    mgr = trrm.RequestRateManager(factory, p, d, async_mode=True,
                                  distribution="poisson")
    prof = tip.InferenceProfiler(mgr, p, backend, measurement_window_ms=150,
                                 stability_threshold=0.9, max_trials=4)
    try:
        results = prof.profile_request_rate_range(50, 50, 10)
    finally:
        mgr.cleanup()
    assert results[0].client_infer_per_sec > 0
    assert results[0].request_rate == 50
    csv_path = tmp_path / "out.csv"
    treport.write_csv(str(csv_path), results, p, mode="request_rate")
    header = csv_path.read_text().splitlines()[0]
    assert header.startswith("Request Rate,Inferences/Second")


def test_request_rate_profile_over_http(server):
    _, http = server
    factory = tcb.ClientBackendFactory(tcb.BackendKind.HTTP, url=http.url)
    p, backend, d = _loaded(factory)
    mgr = trrm.RequestRateManager(factory, p, d, async_mode=False)
    prof = tip.InferenceProfiler(mgr, p, backend, measurement_window_ms=200,
                                 stability_threshold=0.9, max_trials=4)
    try:
        results = prof.profile_request_rate_range(40, 80, 40)
    finally:
        mgr.cleanup()
        backend.close()
    assert [r.request_rate for r in results] == [40, 80]
    assert all(r.client_infer_per_sec > 0 for r in results)
    assert all(r.server.inference_count > 0 for r in results)
    assert all(r.metrics.scraped for r in results)


def test_request_rate_binary_and_none_search(factory):
    p, backend, d = _loaded(factory)
    mgr = trrm.RequestRateManager(factory, p, d, async_mode=True)
    prof = tip.InferenceProfiler(mgr, p, backend, measurement_window_ms=120,
                                 stability_threshold=0.9, max_trials=3)
    try:
        one = prof.profile_request_rate_range(60, 600, 10, "none")
        binary = prof.profile_request_rate_range(20, 60, 20, "binary")
    finally:
        mgr.cleanup()
    assert [r.request_rate for r in one] == [60]
    # no latency threshold: every level meets it, so the search climbs
    assert [r.request_rate for r in binary] == [40, 60]


def test_custom_intervals_profile(factory, tmp_path):
    p, backend, d = _loaded(factory)
    intervals = tmp_path / "iv.txt"
    intervals.write_text("\n".join(["5000000"] * 100))  # 5 ms -> 200/s
    mgr = trrm.CustomLoadManager(factory, p, d, async_mode=True,
                                 intervals_file=str(intervals))
    assert mgr.custom_request_rate() == pytest.approx(200.0)
    prof = tip.InferenceProfiler(mgr, p, backend, measurement_window_ms=150,
                                 stability_threshold=0.9, max_trials=3)
    try:
        results = prof.profile_custom()
    finally:
        mgr.cleanup()
    assert results[0].request_rate == pytest.approx(200.0)
    assert results[0].client_infer_per_sec > 0


def test_early_exit_rate_manager(factory):
    p, backend, d = _loaded(factory)
    mgr = trrm.RequestRateManager(factory=factory, parser=p, data_loader=d,
                                  async_mode=False)
    prof = tip.InferenceProfiler(mgr, p, backend,
                                 measurement_window_ms=30_000, max_trials=10)
    early_exit.clear()
    try:
        timer = threading.Timer(0.8, early_exit.set)
        timer.start()
        t0 = time.monotonic()
        results = prof.profile_request_rate_range(50, 500, 50, "linear")
        elapsed = time.monotonic() - t0
        timer.cancel()
        assert elapsed < 10
        assert len(results) >= 1
        assert not results[-1].stabilized
        assert "Throughput" in treport.render_report(results, p,
                                                     "request_rate")
    finally:
        early_exit.clear()
        mgr.cleanup()


# ----------------------------------------------------------------- the CLI

def test_cli_main_inprocess(server, capsys):
    rc = main(["-m", "add_sub", "--service-kind", "cuda_direct", *FAST,
               "--concurrency-range", "1"], server=server[0])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Throughput" in out and "Concurrency: 1" in out


@pytest.mark.parametrize("shm", ["none", "system", "cuda"])
def test_cli_over_http(server, capsys, shm):
    _, http = server
    rc = main(["-m", "add_sub", "-u", http.url, *FAST,
               "--concurrency-range", "1:2", "--shared-memory", shm,
               "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Concurrency: 1" in out and "Concurrency: 2" in out
    assert "Server metrics (/metrics)" in out
    # the regions are unregistered when the run ends
    assert server[0].cuda_shm.status() == []
    assert server[0].system_shm.status() == []


def test_cli_request_rate_and_intervals_with_csv(server, capsys, tmp_path):
    _, http = server
    csv_path = tmp_path / "rate.csv"
    rc = main(["-m", "add_sub", "-u", http.url, *FAST,
               "--request-rate-range", "40:80:40",
               "--request-distribution", "poisson", "-f", str(csv_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Request Rate: 40" in out and "Request Rate: 80" in out
    assert csv_path.read_text().startswith("Request Rate,Inferences/Second")
    intervals = tmp_path / "iv.txt"
    intervals.write_text("\n".join(["10000000"] * 50))   # 100/s
    rc = main(["-m", "add_sub", "-u", http.url, *FAST,
               "--request-intervals", str(intervals)])
    assert rc == 0
    assert "Request Rate: 100" in capsys.readouterr().out


def test_cli_custom_headers_reach_the_wire(server, capsys):
    """-H NAME:VALUE is on every HTTP request: the metadata fetch, the
    statistics snapshots and scrapes, and the inference calls."""
    _, http = server
    seen = []
    handler_cls = http._httpd.RequestHandlerClass
    orig = handler_cls.parse_request

    def recording_parse(self):
        ok = orig(self)
        if ok:
            seen.append((self.path, self.headers.get("X-Trace-Id")))
        return ok

    handler_cls.parse_request = recording_parse
    try:
        rc = main(["-m", "add_sub", "-u", http.url,
                   "-H", "X-Trace-Id: abc123", "-H", "X-Team: perf", *FAST,
                   "--concurrency-range", "1"])
        assert rc == 0
        assert "Throughput" in capsys.readouterr().out
    finally:
        handler_cls.parse_request = orig
    assert seen
    missing = [(p, h) for p, h in seen if h != "abc123"]
    assert not missing, f"requests without the -H header: {missing[:5]}"
    assert any(p.endswith("/infer") for p, _ in seen)
    assert any(p == "/metrics" for p, _ in seen)


def test_cli_flag_errors(server, capsys):
    _, http = server
    url = ["-u", http.url]
    assert main(["-m", "add_sub", *url, "-H", "no-colon-here"]) == 2
    assert main(["-m", "add_sub", *url, "-H", "X-A: 1", "-H", "X-A: 2"]) == 2
    assert main(["-m", "add_sub", "--service-kind", "cuda_direct",
                 "-H", "X-A: 1"], server=server[0]) == 2
    assert main(["-m", "add_sub", *url, "--streaming"]) == 2
    assert main(["-m", "add_sub", "--service-kind", "cuda_direct",
                 "--retries", "3"], server=server[0]) == 2
    assert main(["-m", "add_sub", "--service-kind", "cuda_direct"]) == 2
    err = capsys.readouterr().err
    assert "-H expects NAME:VALUE" in err and "duplicate -H" in err
    assert "--model-repository" in err
    for kind in ("tfserve", "torchserve"):
        assert main(["-m", "add_sub", "--service-kind", kind]) == 2
        assert "ROADMAP A5, foreign backends" in capsys.readouterr().err
    with pytest.raises(NotImplementedError, match="item 6"):
        main(["-m", "add_sub", "--service-kind", "cuda_direct",
              "--model-repository", "/nonexistent"])
    with pytest.raises(SystemExit) as ei:
        main(["-m", "add_sub", "--shared-memory", "tpu"])
    assert ei.value.code == 2
    for old in ("tpu_serve", "tpu_direct"):
        with pytest.raises(SystemExit):
            main(["-m", "add_sub", "--service-kind", old])


def test_cli_retries_a_shedding_model(server, capsys):
    core, http = server
    calls = {"n": 0}

    def fn(inputs):
        calls["n"] += 1
        if calls["n"] % 3 == 1:
            raise ServerError("shed", 503, retry_after=0.001)
        return {"OUTPUT0": inputs["INPUT0"]}

    core.register_model(PyModel(ModelConfig(
        name="shedding", inputs=(TensorSpec("INPUT0", "INT32", (4,)),),
        outputs=(TensorSpec("OUTPUT0", "INT32", (4,)),)), fn))
    # Retry-After rounds up to 1 s on HTTP: the windows outlast it
    rc = main(["-m", "shedding", "-u", http.url, "--sync", "-p", "1500",
               "-s", "90", "-r", "3", "--retries", "3",
               "--concurrency-range", "1"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "Retried count (client)" in out


def test_cli_over_grpc(capsys):
    pytest.importorskip("grpc")
    from client_tpu_torch.server.grpc_server import GrpcInferenceServer

    core = TorchInferenceServer()
    core.register_model(make_add_sub("add_sub", 16, "INT32", device="cpu"))
    srv = GrpcInferenceServer(core, port=0).start()
    try:
        rc = main(["-m", "add_sub", "-i", "grpc", "-u", srv.address, *FAST,
                   "--concurrency-range", "1", "-H", "x-team: perf"])
        assert rc == 0
        out = capsys.readouterr().out
        assert "Throughput" in out and "Server:" in out
    finally:
        srv.stop()
        core.stop()


# ------------------------------------------------------------ the backends

def test_model_parser_grpc_backend_unwraps_config():
    """gRPC's ModelConfig arrives wrapped in {"config": ...}: both
    packages' gRPC backends unwrap it, so both parsers see the same
    max_batch_size, scheduler and input dims from both servers."""
    pytest.importorskip("grpc")
    from client_tpu.server.grpc_server import GrpcInferenceServer as JGrpc
    from client_tpu_torch.server.grpc_server import GrpcInferenceServer

    jcore = TpuInferenceServer()
    jcore.register_model(jax_add_sub("add_sub_g", 8, "FP32",
                                     max_batch_size=8, dynamic_batching=True))
    tcore = TorchInferenceServer()
    tcore.register_model(make_add_sub("add_sub_g", 8, "FP32",
                                      max_batch_size=8,
                                      dynamic_batching=True, device="cpu"))
    srv = {"ref": JGrpc(jcore, port=0).start(),
           "port": GrpcInferenceServer(tcore, port=0).start()}
    try:
        seen = []
        for side in ("ref", "port"):
            for cb, mp in ((jcb, jmp), (tcb, tmp)):
                backend = cb.ClientBackendFactory(
                    cb.BackendKind.GRPC,
                    url=f"localhost:{srv[side].port}").create()
                p = mp.ModelParser()
                p.init(backend, "add_sub_g", "", 2)
                assert p.max_batch_size == 8
                assert p.scheduler_type.value == "dynamic"
                assert all(not i.is_dynamic() for i in p.inputs.values())
                seen.append({n: (t.datatype, t.dims)
                             for n, t in p.inputs.items()})
                backend.close()
        assert all(s == seen[0] for s in seen)
    finally:
        for s in srv.values():
            s.stop()
        jcore.stop()
        tcore.stop()


def test_http_backend_reads_what_the_inprocess_backend_reads(server):
    core, http = server
    net = tcb.ClientBackendFactory(tcb.BackendKind.HTTP, url=http.url,
                                   headers={"X-A": "1"},
                                   compression="gzip").create()
    local = tcb.ClientBackendFactory(tcb.BackendKind.INPROCESS,
                                     server=core).create()
    try:
        for fn in (lambda b: b.model_metadata("add_sub_batch"),
                   lambda b: b.model_config("add_sub_batch"),
                   lambda b: b.server_extensions()):
            assert fn(net) == fn(local)
        assert net.server_traces() is None      # no debug endpoints
        assert net.server_incidents() is None
        assert net.server_metrics()
        x = tcb.PerfInput("INPUT0", [16], "INT32")
        x.set_data_from_numpy(np.arange(16, dtype=np.int32))
        y = tcb.PerfInput("INPUT1", [16], "INT32")
        y.set_data_from_numpy(np.ones(16, np.int32))
        r = net.infer("add_sub", [x, y],
                      [tcb.PerfRequestedOutput("OUTPUT1")])
        np.testing.assert_array_equal(r.as_numpy("OUTPUT1"),
                                      np.arange(16, dtype=np.int32) - 1)
        done = threading.Event()
        got = {}
        net.async_infer(lambda res, err: (got.update(r=res, e=err),
                                          done.set()), "add_sub", [x, y])
        assert done.wait(30) and got["e"] is None
        np.testing.assert_array_equal(got["r"].as_numpy("OUTPUT0"),
                                      np.arange(16, dtype=np.int32) + 1)
    finally:
        net.close()


# -------------------------------------------------------------- the report

def _full_status(mod, k: int):
    """A status of ``mod``'s dataclasses with every reported field set, a
    value derived from ``k``."""
    lat = mod.LatencyStats(avg_us=1000.0 + k, std_us=12.5, min_us=3.0,
                           max_us=9000.0 + k,
                           percentiles_us={50: 900.0 + k, 99: 8000.0 + k})
    comp = mod.ServerSideStats(queue_time_us=3.0, compute_infer_time_us=7.0)
    server = mod.ServerSideStats(
        inference_count=100 + k, execution_count=40, cache_hit_count=3,
        rejected_count=2, queue_time_us=11.0, compute_input_time_us=2.0,
        compute_infer_time_us=555.0, compute_output_time_us=4.0,
        composing_models={"pre": comp})
    m = mod.ServerMetricsStats()
    values = {}
    for f in dataclasses.fields(m):
        cur = getattr(m, f.name)
        if isinstance(cur, bool):
            values[f.name] = True
        elif isinstance(cur, int):
            values[f.name] = 7 + k
        elif isinstance(cur, float):
            values[f.name] = 0.25 + k
    values.update(
        engine_phase_s={"retire_fetch": 0.5, "retire_deliver": 0.25},
        watchdog_incidents={"engine_stall": 1},
        slo_tenants={("t1", "gold"): {
            "ttft_p50_s": 0.1, "ttft_p95_s": 0.2, "ttft_p99_s": 0.3,
            "inter_token_p95_s": 0.01, "burn_rate": 1.5, "requests": 9,
            "shed": 1}},
        goodput_device_s={"chunk": 2.0, "spec_g4": 1.0},
        goodput_kind_useful_flops={"chunk": 3e12, "spec_g4": 1e12},
        goodput_dispatches={"chunk": 20, "spec_g4": 5})
    for name, v in values.items():
        setattr(m, name, v)
    gen = mod.GenerationClientStats(
        enabled=True, request_count=8, token_count=256,
        tokens_per_sec=99.5, ttft_avg_us=1200.0,
        ttft_percentiles_us={50: 1100.0, 99: 3000.0}, itl_avg_us=50.0,
        itl_percentiles_us={50: 45.0, 99: 90.0})
    return mod.PerfStatus(
        concurrency=4 + k, request_rate=50.0 + k, client_infer_per_sec=321.5,
        client_sequence_per_sec=2.5, valid_count=400, delayed_count=3,
        client_rejected_count=2, client_retried_count=1, latency=lat,
        server=server, metrics=m, generation=gen,
        slowest_requests=[{
            "trace_id": "abc", "total_us": 5000.0, "queue_us": 1000.0,
            "prefill_us": 2000.0, "handoff_us": 0.0, "decode_us": 1500.0,
            "fetch_us": 500.0, "replica": 1, "route_leg": "affinity",
            "in_window": True, "in_exemplars": True}],
        stabilized=bool(k % 2))


@pytest.mark.parametrize("mode", ["concurrency", "request_rate"])
def test_report_text_and_csv_equal_the_references(mode, tmp_path):
    parser = types.SimpleNamespace(model_name="m")
    got = {}
    for name, ip, rep in (("ref", jip, jreport), ("port", tip, treport)):
        results = [_full_status(ip, k) for k in range(2)]
        text = rep.render_report(results, parser, mode)
        path = tmp_path / f"{name}.csv"
        rep.write_csv(str(path), results, parser, mode)
        got[name] = (text, path.read_text())
    ref_lines = got["ref"][0].splitlines()
    port_lines = got["port"][0].splitlines()
    assert len(port_lines) == len(ref_lines) > 60
    differ = [(r, p) for r, p in zip(ref_lines, port_lines) if r != p]
    assert differ == [("  Runtime (XLA/HBM):", "  Runtime (compiles/HBM):")] * 2
    for block in ("Goodput / device time", "MFU:", "Kernel kind",
                  "Slowest request breakdown", "SLO (per tenant",
                  "Speculation:", "Fleet (replica router)"):
        assert block in got["port"][0]
    assert got["port"][1] == got["ref"][1]
