"""The port's perf analyzer on the CPU, held against the JAX package's: the
model parser, the data loader, the admission-rejection classifier, the
profiler's summarization and stabilization on scripted measurements, the
stabilized point's escalation on a scripted point function, and the
in-process profile end to end against the port's server (plain, system
shm and cuda shm)."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from client_tpu.models import make_add_sub as jax_add_sub
from client_tpu.perf import bench_harness as jbh
from client_tpu.perf import client_backend as jcb
from client_tpu.perf import data_loader as jdl
from client_tpu.perf import inference_profiler as jip
from client_tpu.perf import model_parser as jmp
from client_tpu.perf import perf_utils as jpu
from client_tpu.server import TpuInferenceServer
from client_tpu_torch.models import make_add_sub
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.perf import bench_harness as tbh
from client_tpu_torch.perf import client_backend as tcb
from client_tpu_torch.perf import data_loader as tdl
from client_tpu_torch.perf import inference_profiler as tip
from client_tpu_torch.perf import model_parser as tmp
from client_tpu_torch.perf import perf_utils as tpu
from client_tpu_torch.perf.concurrency_manager import ConcurrencyManager
from client_tpu_torch.perf.load_manager import LoadManager
from client_tpu_torch.server import TorchInferenceServer

PKGS = {"jax": (jcb, jmp, jdl, jip), "port": (tcb, tmp, tdl, tip)}


@pytest.fixture(scope="module")
def servers():
    jcore = TpuInferenceServer()
    jcore.register_model(jax_add_sub("add_sub", 16, "INT32"))
    jcore.register_model(jax_add_sub("add_sub_batch", 8, "FP32",
                                     max_batch_size=8,
                                     dynamic_batching=True))
    tcore = TorchInferenceServer()
    tcore.register_model(make_add_sub("add_sub", 16, "INT32", device="cpu"))
    tcore.register_model(make_add_sub("add_sub_batch", 8, "FP32",
                                      max_batch_size=8,
                                      dynamic_batching=True, device="cpu"))
    yield {"jax": jcore, "port": tcore}
    jcore.stop()
    tcore.stop()


def _parser(pkg, core, model="add_sub", batch=1):
    cb, mp, _, _ = PKGS[pkg]
    backend = cb.ClientBackendFactory(cb.BackendKind.INPROCESS,
                                      server=core).create()
    p = mp.ModelParser()
    p.init(backend, model, batch_size=batch)
    return p, backend


def _parser_fields(p):
    return {"name": p.model_name, "version": p.model_version,
            "max_batch": p.max_batch_size,
            "inputs": {n: (t.datatype, t.dims, t.optional)
                       for n, t in p.inputs.items()},
            "outputs": {n: (t.datatype, t.dims) for n, t in p.outputs.items()},
            "scheduler": p.scheduler_type.value, "decoupled": p.decoupled,
            "cache": p.response_cache_enabled,
            "composing": p.composing_models, "sequence": p.is_sequence()}


# ---------------------------------------------------------------- parser

@pytest.mark.parametrize("model,batch", [("add_sub", 1),
                                         ("add_sub_batch", 4)])
def test_model_parser_matches_the_jax_package(servers, model, batch):
    fields = {pkg: _parser_fields(_parser(pkg, servers[pkg], model, batch)[0])
              for pkg in PKGS}
    assert fields["port"] == fields["jax"]


@pytest.mark.parametrize("model,batch", [("add_sub_batch", 64),
                                         ("add_sub", 2)])
def test_model_parser_rejects_what_the_jax_package_rejects(servers, model,
                                                           batch):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            _parser(pkg, servers[pkg], model, batch)


class _ConfigBackend:
    """Serves model configs from a dict (the ensemble walk's sub-lookups)."""

    def __init__(self, configs):
        self.configs = configs

    def model_config(self, name, version=""):
        return self.configs[name]


@pytest.mark.parametrize("inner", ["plain", "sequence", "nested"])
def test_ensemble_walk_matches_the_jax_package(inner):
    configs = {
        "pre": {"name": "pre", "dynamic_batching": {"max_queue_delay_microseconds": 5}},
        "seq": {"name": "seq", "sequence_batching": {"direct": {}}},
        "inner": {"name": "inner", "ensemble_scheduling": {"step": [
            {"model_name": "seq", "model_version": -1}]}},
    }
    second = {"plain": "pre", "sequence": "seq", "nested": "inner"}[inner]
    top = {"name": "ens", "max_batch_size": 4, "ensemble_scheduling": {
        "step": [{"model_name": "pre", "model_version": "1"},
                 {"model_name": second}]}}
    meta = {"name": "ens", "versions": ["1"],
            "inputs": [{"name": "X", "datatype": "FP32",
                        "shape": ["-1", "3"]}],
            "outputs": [{"name": "Y", "datatype": "FP32",
                         "shape": [-1, 3]}]}
    fields = {}
    for pkg, (_, mp, _, _) in PKGS.items():
        p = mp.ModelParser()
        p.init_from(meta, top, backend=_ConfigBackend(configs))
        fields[pkg] = _parser_fields(p)
    assert fields["port"] == fields["jax"]
    assert fields["port"]["sequence"] == (inner != "plain")


# ------------------------------------------------------------ data loader

def _inputs(pkg, specs):
    mp = PKGS[pkg][1]
    return {n: mp.TensorInfo(n, dt, dims) for n, (dt, dims) in specs.items()}


SPECS = {"A": ("INT32", [4, 3]), "B": ("FP32", [5]), "C": ("BOOL", [2]),
         "D": ("BYTES", [3]), "P": ("INT64", [-1]), "MAX_TOKENS": ("INT32",
                                                                   [1])}


def _loader_case(pkg, case, tmp_path):
    dl = PKGS[pkg][2]
    d = dl.DataLoader()
    inputs = _inputs(pkg, SPECS)
    if case == "random":
        d.generate_data(inputs, seed=5)
    elif case == "zero":
        d.generate_data(inputs, zero_data=True)
    elif case == "string":
        d.generate_data(inputs, string_data="hello")
    elif case == "shared_prefix":
        d.generate_shared_prefix_data(inputs, prefix_len=6, suffix_len=3,
                                      n_streams=3, vocab=50, max_tokens=9,
                                      seed=2)
    elif case == "json":
        path = tmp_path / f"{pkg}.json"
        path.write_text(json.dumps({"data": [
            [{"A": list(range(12)), "B": {"content": [1, 2, 3, 4, 5],
                                          "shape": [5]}},
             {"A": [2] * 12, "D": ["x", "yy", "z"]}],
            {"B": [0.5] * 5}]}))
        d.read_data_from_json(str(path), inputs)
    else:  # dir
        (tmp_path / "A").write_text("\n".join(str(i) for i in range(12)))
        (tmp_path / "B").write_bytes(np.arange(5, dtype=np.float32)
                                     .tobytes())
        (tmp_path / "C").write_text("1\n0")
        (tmp_path / "D").write_bytes(b"a\nbb\nccc")
        (tmp_path / "P").write_text("3")
        (tmp_path / "MAX_TOKENS").write_text("7")
        d.read_data_from_dir(str(tmp_path), inputs)
    out = {"streams": d.num_streams}
    for s in range(d.num_streams):
        for step in range(d.num_steps(s)):
            for name in SPECS:
                try:
                    arr = d.get_input_data(name, s, step)
                except KeyError:
                    continue
                out[(s, step, name)] = (arr.dtype.str, arr.shape,
                                        arr.tolist(),
                                        d.get_input_shape(name, s, step))
    return out


@pytest.mark.parametrize("case", ["random", "zero", "string",
                                  "shared_prefix", "json", "dir"])
def test_data_loader_matches_the_jax_package(case, tmp_path):
    want = _loader_case("jax", case, tmp_path)
    got = _loader_case("port", case, tmp_path)
    assert got == want


def test_random_integers_stay_inside_a_small_vocab():
    """The loader's integers lie in [0, 127): a token gather on the card
    asserts on an index out of range, and the port adds no clamp."""
    d = tdl.DataLoader()
    d.generate_data(_inputs("port", {"ids": ("INT32", [4096])}), seed=1)
    ids = d.get_input_data("ids")
    assert ids.min() >= 0 and ids.max() < 127


# ----------------------------------------------------------- perf_utils

@pytest.mark.parametrize("text", [
    "request was rejected: exceeds maximum queue size 8 for model 'm'",
    "[14] request was rejected: timed out in queue after 1200 us",
    "failed to connect to all addresses",
    "generation engine stopped",
    "batch size 503 exceeds max_batch_size 256",
])
def test_admission_rejection_matches_the_jax_package(text):
    assert tpu.is_admission_rejection(RuntimeError(text)) \
        == jpu.is_admission_rejection(RuntimeError(text))


def test_sigint_handler_is_a_no_op_off_the_main_thread():
    got = []
    t = threading.Thread(target=lambda: got.append(
        tpu.install_sigint_handler()))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and callable(got[0])
    got[0]()


# -------------------------------------------------------------- profiler

class _Manager:
    batch_size = 1

    def check_health(self):
        pass


def _profiler(pkg, **kw):
    ip, mp = PKGS[pkg][3], PKGS[pkg][1]
    parser = mp.ModelParser()
    parser.model_name = "m"
    prof = ip.InferenceProfiler(_Manager(), parser, None, **kw)
    return prof


def _stats_doc(n, execs, ns):
    def dur(c, mult):
        return {"count": c, "ns": c * mult}

    return {"name": "m", "version": "1", "inference_count": n,
            "execution_count": execs, "inference_stats": {
                "success": dur(n, ns), "fail": dur(0, 0),
                "queue": dur(n, ns // 4), "compute_input": dur(execs, 700),
                "compute_infer": dur(execs, ns), "compute_output":
                    dur(execs, 300), "rejected": dur(1, 50)}}


def _perf_fields(status):
    lat = status.latency
    return {"valid": status.valid_count, "delayed": status.delayed_count,
            "ips": status.client_infer_per_sec,
            "sps": status.client_sequence_per_sec,
            "rejected": status.client_rejected_count,
            "retried": status.client_retried_count,
            "avg_request_us": status.avg_request_time_us,
            "window_s": status.window_s,
            "latency": (lat.avg_us, lat.std_us, lat.min_us, lat.max_us,
                        lat.percentiles_us),
            "server": {k: v for k, v in vars(status.server).items()}}


@pytest.mark.parametrize("case", ["filtering", "empty", "uniform"])
def test_summarize_matches_the_jax_package(case):
    """Valid-latency filtering, percentiles and server deltas from the
    same scripted timestamps and stats."""
    w0, w1 = 1_000_000, 3_000_000
    if case == "filtering":
        ts = [(w0 + 1000, w0 + 2000, False, False),   # valid
              (w0 - 1000, w0 + 2000, False, False),   # started before
              (w0 + 1000, w1 + 2000, False, False),   # ended after
              (w0 + 5000, w0 + 9000, True, False),    # a sequence end
              (w0 + 1000, w0 + 3000, False, True)]    # delayed
    elif case == "empty":
        ts = []
    else:
        rng = np.random.default_rng(0)
        starts = rng.integers(w0, w1 - 100_000, 200)
        ts = [(int(s), int(s + d), False, False)
              for s, d in zip(starts, rng.integers(1000, 90_000, 200))]
    fields = {}
    for pkg in PKGS:
        cb = PKGS[pkg][0]
        before, after = cb.ClientInferStat(), cb.ClientInferStat()
        after.completed_request_count = 7
        after.cumulative_total_request_time_ns = 7 * 4200
        after.rejected_request_count = 2
        prof = _profiler(pkg)
        status = prof._summarize(
            ts, w0, w1, {("m", "1"): _stats_doc(10, 2, 5000)},
            {("m", "1"): _stats_doc(74, 10, 5000)}, before, after)
        fields[pkg] = _perf_fields(status)
    assert fields["port"] == fields["jax"]


def _scripted(pkg, ips_lat):
    ip = PKGS[pkg][3]
    out = []
    for i, (ips, lat) in enumerate(ips_lat):
        s = ip.PerfStatus()
        s.valid_count = 0 if ips is None else 10
        s.client_infer_per_sec = ips or 0.0
        s.latency = ip.LatencyStats(avg_us=lat or 0.0,
                                    percentiles_us={50: lat or 0.0})
        s.concurrency = i   # which measurement came back
        out.append(s)
    return out


@pytest.mark.parametrize("case,seq,kw", [
    ("stable_on_third", [(100, 10), (101, 10), (99, 10.5)], {}),
    ("stable_after_outlier",
     [(100, 10), (300, 10), (100, 10), (100, 10), (100, 10)], {}),
    ("drifting", [(100, 10), (150, 10), (200, 10), (250, 10)],
     {"max_trials": 4}),
    ("latency_drift", [(100, 10), (100, 20), (100, 30), (100, 40)],
     {"max_trials": 4}),
    ("empty_windows", [(None, None)] * 3, {"max_trials": 3}),
    ("empty_then_stable", [(None, None), (50, 5), (50, 5), (50, 5)], {}),
    ("over_latency_threshold", [(100, 10), (100, 900)],
     {"latency_threshold_us": 500}),
    ("percentile_gate", [(100, 10), (100, 10), (100, 10)],
     {"stability_percentile": 50}),
])
def test_stabilization_matches_the_jax_package(case, seq, kw):
    """The window-of-3 verdict on the same scripted measurements: which
    measurement comes back, whether it is stabilized, or the error."""
    verdicts = {}
    for pkg in PKGS:
        prof = _profiler(pkg, stability_threshold=0.1,
                         max_trials=kw.get("max_trials", 10),
                         latency_threshold_us=kw.get(
                             "latency_threshold_us", 0),
                         stability_percentile=kw.get("stability_percentile"))
        queue = _scripted(pkg, seq)
        prof.measure = lambda q=queue: q.pop(0)
        status = prof._stabilize()
        verdicts[pkg] = (status.concurrency, status.stabilized,
                         status.error is None)
    assert verdicts["port"] == verdicts["jax"]


def test_latency_percentiles_match_the_jax_package():
    lat = [float(x) for x in np.random.default_rng(3).integers(1, 1000, 97)]
    want = _profiler("jax")._latency_stats(lat)
    got = _profiler("port")._latency_stats(lat)
    assert vars(got) == vars(want)


# ------------------------------------------------------------ escalation

def _fake_point(ips, stabilized):
    return {"infer_per_s": ips, "mfu": 0.4, "p50_latency_ms": 100.0,
            "p99_latency_ms": 200.0, "stabilized": stabilized,
            "concurrency": 0}


@pytest.mark.parametrize("case,attempts", [
    ("first_stable", 5), ("stable_on_fourth", 5), ("single_attempt", 1),
    ("exhausted", 5)])
def test_stabilized_point_escalates_as_the_jax_package_does(case, attempts):
    """The same scripted point function gives the same calls and history
    (as tests/test_bench_harness.py holds the reference's)."""
    script = {
        "first_stable": lambda n: _fake_point(1000.0, True),
        "stable_on_fourth": lambda n: _fake_point(1000.0 + n, n == 4),
        "single_attempt": lambda n: _fake_point(500.0, False),
        "exhausted": lambda n: _fake_point(
            [900.0, 1100.0, 1000.0, 950.0, 980.0][n - 1], False),
    }[case]
    runs = {}
    for pkg, mod in (("jax", jbh), ("port", tbh)):
        calls = []

        def fn(conc, stab):
            calls.append((conc, stab))
            return script(len(calls))

        point = mod.stabilized_point(None, "m", 1000, flops_per_infer=1,
                                     point_fn=fn, attempts=attempts)
        runs[pkg] = (calls, point)
    (jcalls, jpoint), (tcalls, tpoint) = runs["jax"], runs["port"]
    assert tcalls == jcalls
    assert tpoint == jpoint


def test_host_breakdown_groups_threads_by_role():
    """profile_serve_shm's host window reads each thread's CPU seconds and
    groups threads by the names the load manager and batcher give them."""
    from client_tpu_torch.perf import profile_serve_shm as pss

    assert [pss.thread_group(n) for n in (
        "perf-conc-3", "batcher-bert_base-0", "batcher-complete-bert_base_0",
        "MainThread")] == ["load_workers", "dispatcher",
                           "completion_workers", "other"]
    busy = threading.Thread(target=lambda: sum(range(3_000_000)),
                            name="perf-conc-0")
    before = pss._cpu_by_group()
    busy.start()
    busy.join(timeout=60)
    assert not busy.is_alive()
    assert pss._cpu_by_group()["other"] >= before["other"]


def test_mfu_needs_a_known_card():
    assert tbh.device_bf16_peak("cpu") is None
    assert tbh.card_peaks("NVIDIA H100 80GB HBM3")[1] == 989e12
    assert tbh.card_peaks("a card without published peaks") is None


# ------------------------------------------------------------ end to end

def _port_parser(core, model="add_sub"):
    factory = tcb.ClientBackendFactory(tcb.BackendKind.INPROCESS,
                                       server=core)
    backend = factory.create()
    p = tmp.ModelParser()
    p.init(backend, model)
    return factory, p, backend


def test_concurrency_profile_end_to_end(servers):
    """tests/test_perf.py::test_concurrency_profile_end_to_end against the
    port's server."""
    factory, p, backend = _port_parser(servers["port"])
    d = tdl.DataLoader()
    d.generate_data(p.inputs)
    mgr = ConcurrencyManager(factory, p, d, async_mode=False)
    prof = tip.InferenceProfiler(mgr, p, backend, measurement_window_ms=150,
                                 stability_threshold=0.9, max_trials=4)
    try:
        results = prof.profile_concurrency_range(1, 2, 1)
    finally:
        mgr.cleanup()
    assert len(results) == 2
    for r in results:
        assert r.client_infer_per_sec > 0
        assert r.latency.avg_us > 0
        assert r.server.inference_count > 0  # server-stat deltas flowed


@pytest.mark.parametrize("shm", ["system", "cuda"])
def test_shared_memory_load(servers, shm):
    """tests/test_perf.py::test_shared_memory_system_load against the
    port's server, and the same over the cuda plane (regions on the CPU);
    the batched model's async workers."""
    factory, p, backend = _port_parser(servers["port"], "add_sub_batch")
    d = tdl.DataLoader()
    d.generate_data(p.inputs)
    mgr = ConcurrencyManager(factory, p, d, async_mode=True,
                             shared_memory=shm, output_shm_size=32,
                             shm_device="cpu")
    prof = tip.InferenceProfiler(mgr, p, backend, measurement_window_ms=150,
                                 stability_threshold=0.9, max_trials=3)
    try:
        results = prof.profile_concurrency_range(4, 4, 1, "none")
        regions = getattr(mgr.shm_regions, shm)
        assert set(regions) == {"perf_in_INPUT0", "perf_in_INPUT1",
                                "perf_out_OUTPUT0", "perf_out_OUTPUT1"}
        out = regions["perf_out_OUTPUT0"]
        a, b = d.get_input_data("INPUT0"), d.get_input_data("INPUT1")
        if shm == "cuda":
            from client_tpu_torch.utils import cuda_shared_memory as cudashm
            got = cudashm.get_contents_as_numpy(out, np.float32, (1, 8))
        else:
            from client_tpu_torch.utils import shared_memory as sysshm
            got = sysshm.get_contents_as_numpy(out, np.float32, (1, 8))
        np.testing.assert_allclose(got[0], a + b, rtol=1e-6)
    finally:
        mgr.cleanup()
    assert results[0].client_infer_per_sec > 0
    assert servers["port"].cuda_shm.status() == []
    assert servers["port"].system_shm.status() == []


def test_run_point_serves_the_encoder_over_cuda_shm():
    """bench.py's headline path at a small size on the CPU: run_point over
    the in-process backend and cuda regions; every batch takes the
    pre-split path, and MFU is not reported without a card."""
    kw = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2,
              head_dim=16, d_ff=64, max_seq=16, causal=False)
    cfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **kw)
    params = tt.init_params(torch.Generator().manual_seed(0), cfg)
    model = tbh.make_encoder_model(cfg, params, 16, 8, name="enc",
                                   max_queue_delay_us=2000, device="cpu")
    core = TorchInferenceServer()
    core.register_model(model, warmup=True)
    try:
        calls = model.fused_split_calls
        point = tbh.run_point(core, "enc", 16, flops_per_infer=1,
                              window_ms=300, stability=0.9, max_trials=4,
                              output_shm_size=4 * 32, device="cpu")
        stats = core.statistics("enc")["model_stats"][0]
    finally:
        core.stop()
    assert point["infer_per_s"] > 0 and point["mfu"] is None
    assert point["client_rejected_count"] == 0
    assert stats["inference_stats"]["fail"]["count"] == 0
    # one pre-split call per served batch
    assert model.fused_split_calls - calls == stats["execution_count"] > 0


def test_streaming_worker_records_the_token_series(servers):
    """The streaming worker against a decoupled model's stream: TTFT and
    inter-token gaps per request, the request closed by its final flag."""

    class Result:
        def __init__(self, rid, final):
            self.doc = {"id": rid, "parameters": {
                "triton_final_response": final}}

        def get_response(self):
            return self.doc

    class StreamBackend(tcb.ClientBackend):
        def __init__(self):
            self.cb = None

        def start_stream(self, callback):
            self.cb = callback

        def async_stream_infer(self, model_name, inputs, outputs=None,
                               **options):
            rid = options["request_id"]

            def run():
                for _ in range(3):
                    time.sleep(0.002)
                    self.cb(Result(rid, False), None)
                self.cb(Result(rid, True), None)
            threading.Thread(target=run).start()

    factory, p, _ = _port_parser(servers["port"])
    p.decoupled = True
    factory.create = StreamBackend
    d = tdl.DataLoader()
    d.generate_data(p.inputs)
    mgr = ConcurrencyManager(factory, p, d, streaming=True)
    try:
        mgr.change_concurrency_level(2)
        deadline = time.time() + 10
        while mgr.count_collected_requests() < 4 and time.time() < deadline:
            time.sleep(0.01)
        ttft, itl, tokens = mgr.swap_generation_samples()
        mgr.check_health()
    finally:
        mgr.cleanup()
    # at least 4 requests closed, each after 3 tokens (2 gaps); later ones
    # may be mid-stream
    assert len(ttft) >= 4 and tokens >= 12 and len(itl) >= 8


@pytest.mark.parametrize("kind", ["http", "grpc", "tfserve", "torchserve"])
def test_network_backends_name_their_roadmap_item(kind):
    """Every network kind builds the port's backend: the client library's
    (ROADMAP A17) and the foreign services' (ROADMAP A5, whose TF-Serving
    backend needs grpcio); none connects before its first call."""
    from client_tpu_torch.perf import foreign

    factory = tcb.ClientBackendFactory(tcb.BackendKind(kind),
                                       url="localhost:1")
    if kind in ("grpc", "tfserve"):
        pytest.importorskip("grpc")
    backend = factory.create()
    assert backend.kind in (tcb.BackendKind(kind), kind)
    assert isinstance(backend, {
        "http": tcb.HttpBackend, "grpc": tcb.GrpcBackend,
        "tfserve": foreign.TfServeBackend,
        "torchserve": foreign.TorchServeBackend}[kind])
    backend.close()


def test_tpu_shared_memory_is_refused_by_name(servers):
    factory, p, _ = _port_parser(servers["port"])
    with pytest.raises(ValueError, match="'cuda'"):
        LoadManager(factory, p, tdl.DataLoader(), shared_memory="tpu")
