"""The model repository and ensembles in the port, on the CPU, held
against the JAX package's.

Each case builds both servers with the same models (the port's on
``device="cpu"``) and drives them with the port's HTTP and gRPC clients:

- index, load and unload of a factory model, with and without a config
  override (the override reaches the factory, and a config block built
  from it with ``config_from_dict`` reads the same in both model
  configs);
- a ``model.py`` repository (one temporary directory per package, the
  files equal apart from the import): listed unloaded, loaded, served,
  and re-executed on reload after an edit;
- the error statuses: an unknown model's load and unload, an override on
  a programmatic model, a second unload, an infer on an unloaded model;
- an ensemble of add_sub and identity: its outputs, each composing
  model's statistics row (one execution per request) and its own, its
  config and metadata (platform ``ensemble``), child traces linked to the
  ensemble's trace by ``parent_id``, and ``unload_dependents``.

Every index, status and error text equals the reference's; outputs are
integers and compared exactly.
"""

import json
import os

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

from client_tpu.models import add_sub as jadd  # noqa: E402
from client_tpu.models import streaming as jstream  # noqa: E402
from client_tpu.server import TpuInferenceServer  # noqa: E402
from client_tpu.server import config as jconfig  # noqa: E402
from client_tpu.server.grpc_server import (  # noqa: E402
    GrpcInferenceServer as RefGrpc,
)
from client_tpu.server.http_server import (  # noqa: E402
    HttpInferenceServer as RefHttp,
)
from client_tpu.server.model import ServedModel as JServed  # noqa: E402
from client_tpu_torch.client import grpc as tgrpc  # noqa: E402
from client_tpu_torch.client import http as thttp  # noqa: E402
from client_tpu_torch.models import (  # noqa: E402
    make_accumulator,
    make_add_sub,
    make_identity,
)
from client_tpu_torch.server import TorchInferenceServer  # noqa: E402
from client_tpu_torch.server import config as tconfig  # noqa: E402
from client_tpu_torch.server.grpc_server import (  # noqa: E402
    GrpcInferenceServer,
)
from client_tpu_torch.server.http_server import (  # noqa: E402
    HttpInferenceServer,
)
from client_tpu_torch.server.model import ServedModel  # noqa: E402

SIDES = ("ref", "port")
PROTOS = ("http", "grpc")

_MODEL_PY = """\
from {pkg}.models import make_add_sub


def create_model():
    return make_add_sub("repo_add", {size}, "INT32"{device})
"""


def _ensemble(side):
    cfg = jconfig if side == "ref" else tconfig
    spec = cfg.TensorSpec
    config = cfg.ModelConfig(
        name="ens",
        inputs=(spec("INPUT0", "INT32", (16,)),
                spec("INPUT1", "INT32", (16,))),
        outputs=(spec("SUM", "INT32", (16,)),
                 spec("DIFF", "INT32", (16,))),
        ensemble_steps=(
            cfg.EnsembleStep("add_sub",
                             input_map={"INPUT0": "INPUT0",
                                        "INPUT1": "INPUT1"},
                             output_map={"OUTPUT0": "_sum",
                                         "OUTPUT1": "DIFF"}),
            cfg.EnsembleStep("identity", input_map={"INPUT0": "_sum"},
                             output_map={"OUTPUT0": "SUM"})))
    return (JServed if side == "ref" else ServedModel)(config)


def _override_factory(side):
    """A factory that reads its load's config override: ``max_batch_size``
    and a ``sequence_batching`` block built with config_from_dict."""
    def factory(override):
        override = override or {}
        if "sequence_batching" in override:
            cfg = jconfig if side == "ref" else tconfig
            model = (jstream.make_accumulator("late_seq", 1, "INT32")
                     if side == "ref" else
                     make_accumulator("late_seq", 1, "INT32", device="cpu"))
            model.config.sequence_batching = cfg.config_from_dict(
                cfg.SequenceBatchingConfig, override["sequence_batching"])
            return model
        mbs = int(override.get("max_batch_size", 0))
        return (jadd.make_identity("late_seq", 4, "INT32",
                                   max_batch_size=mbs)
                if side == "ref" else
                make_identity("late_seq", 4, "INT32", max_batch_size=mbs,
                              device="cpu"))
    return factory


@pytest.fixture
def stack(tmp_path):
    """Both servers (HTTP and gRPC) with add_sub, identity and the
    ensemble registered, a plain and an override factory, and a
    ``model.py`` repository each; the port's clients to each."""
    cores, repos = {}, {}
    for side in SIDES:
        repo = tmp_path / side
        (repo / "repo_add").mkdir(parents=True)
        (repo / "_hidden").mkdir()
        (repo / "repo_add" / "model.py").write_text(_MODEL_PY.format(
            pkg="client_tpu" if side == "ref" else "client_tpu_torch",
            size=8, device="" if side == "ref" else ', device="cpu"'))
        repos[side] = repo
        if side == "ref":
            core = TpuInferenceServer(model_repository=str(repo))
            core.register_model(jadd.make_add_sub("add_sub", 16, "INT32"))
            core.register_model(jadd.make_identity("identity", 16, "INT32"))
            core.register_model_factory(
                "late", lambda: jadd.make_identity("late", 4, "FP32"))
        else:
            core = TorchInferenceServer(model_repository=str(repo))
            core.register_model(make_add_sub("add_sub", 16, "INT32",
                                             device="cpu"))
            core.register_model(make_identity("identity", 16, "INT32",
                                              device="cpu"))
            core.register_model_factory(
                "late", lambda: make_identity("late", 4, "FP32",
                                              device="cpu"))
        core.register_model(_ensemble(side))
        core.register_model_factory("late_seq", _override_factory(side))
        cores[side] = core
    http = {"ref": RefHttp(cores["ref"], port=0).start(),
            "port": HttpInferenceServer(cores["port"], port=0).start()}
    grpcs = {"ref": RefGrpc(cores["ref"], port=0).start(),
             "port": GrpcInferenceServer(cores["port"], port=0).start()}
    clients = {}
    for side in SIDES:
        clients[("http", side)] = thttp.InferenceServerClient(
            http[side].url)
        clients[("grpc", side)] = tgrpc.InferenceServerClient(
            grpcs[side].address)
    yield {"core": cores, "clients": clients, "repo": repos}
    for c in clients.values():
        c.close()
    for side in SIDES:
        http[side].stop()
        grpcs[side].stop()
        cores[side].stop()


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — compared across servers
        status = getattr(e, "status", None)
        return ("error", status() if callable(status) else None, str(e))
    return out


def _index(c, proto):
    """The index as the HTTP route's list (gRPC's JSON leaves out empty
    fields)."""
    if proto == "http":
        return c.get_model_repository_index()
    rows = c.get_model_repository_index(as_json=True).get("models", [])
    return [{k: r.get(k, "") for k in ("name", "version", "state",
                                       "reason")} for r in rows]


def _add_sub_inputs(mod, a, b):
    i0 = mod.InferInput("INPUT0", [16], "INT32")
    i0.set_data_from_numpy(a)
    i1 = mod.InferInput("INPUT1", [16], "INT32")
    i1.set_data_from_numpy(b)
    return [i0, i1]


def _both(stack, proto, fn):
    """``fn(client, module, side)`` against each server: {side: outcome}."""
    mod = thttp if proto == "http" else tgrpc
    return {side: _outcome(lambda: fn(stack["clients"][(proto, side)], mod,
                                      side))
            for side in SIDES}


@pytest.mark.parametrize("proto", PROTOS)
def test_index_load_unload_of_a_factory_model(stack, proto):
    x = np.arange(4, dtype=np.float32)

    def infer(c, mod):
        i0 = mod.InferInput("INPUT0", [4], "FP32")
        i0.set_data_from_numpy(x)
        return c.infer("late", [i0]).as_numpy("OUTPUT0").tolist()

    def scenario(c, mod, side):
        out = [_index(c, proto), c.is_model_ready("late")]
        c.load_model("late")
        out += [c.is_model_ready("late"), infer(c, mod), _index(c, proto)]
        c.unload_model("late")
        out += [c.is_model_ready("late"), _index(c, proto),
                _outcome(lambda: infer(c, mod))]
        c.load_model("late")
        out += [infer(c, mod), _index(c, proto)]
        return out

    got = _both(stack, proto, scenario)
    assert got["port"] == got["ref"]
    out = got["port"]
    assert out[1] is False and out[2] is True and out[5] is False
    assert out[3] == x.tolist() and out[8] == x.tolist()
    assert out[7][0] == "error" and "not ready" in out[7][2]


@pytest.mark.parametrize("proto", PROTOS)
def test_a_config_override_reaches_the_factory(stack, proto):
    def scenario(c, mod, side):
        cfg = (lambda: c.get_model_config("late_seq")) if proto == "http" \
            else (lambda: c.get_model_config("late_seq", as_json=True))
        c.load_model("late_seq", config=json.dumps({"max_batch_size": 4}))
        first = cfg()
        c.unload_model("late_seq")
        c.load_model("late_seq", config=json.dumps(
            {"sequence_batching": {"max_candidate_sequences": 3,
                                   "max_sequence_idle_microseconds": 5000}}))
        second = cfg()
        bad = _outcome(lambda: c.load_model(
            "late_seq", config=json.dumps({"sequence_batching": {
                "no_such_knob": 1}})))
        for d in (first, second):
            d = d.get("config", d)
            d["instance_group"][0].pop("kind", None)
            d.pop("platform", None)
            d.pop("backend", None)
        return first, second, bad

    got = _both(stack, proto, scenario)
    assert got["port"][:2] == got["ref"][:2]
    first, second, bad = got["port"]
    first = first.get("config", first)
    second = second.get("config", second)
    assert int(first["max_batch_size"]) == 4
    seq = second["sequence_batching"]
    assert int(seq["max_candidate_sequences"]) == 3
    assert int(seq["max_sequence_idle_microseconds"]) == 5000
    assert bad[0] == "error" and got["ref"][2][0] == "error"
    assert "no_such_knob" in bad[2] and "no_such_knob" in got["ref"][2][2]


@pytest.mark.parametrize("proto", PROTOS)
def test_a_model_py_repository(stack, proto):
    def infer(c, mod, size):
        a = np.arange(size, dtype=np.int32)
        i0 = mod.InferInput("INPUT0", [size], "INT32")
        i0.set_data_from_numpy(a)
        i1 = mod.InferInput("INPUT1", [size], "INT32")
        i1.set_data_from_numpy(a)
        return c.infer("repo_add", [i0, i1]).as_numpy("OUTPUT0").tolist()

    def scenario(c, mod, side):
        out = [_index(c, proto)]
        c.load_model("repo_add")
        out += [infer(c, mod, 8), _index(c, proto)]
        # an edit takes effect on reload: model.py runs anew
        path = stack["repo"][side] / "repo_add" / "model.py"
        path.write_text(path.read_text().replace(", 8,", ", 4,"))
        c.unload_model("repo_add")
        c.load_model("repo_add")
        out += [infer(c, mod, 4), _outcome(lambda: infer(c, mod, 8))]
        return out

    got = _both(stack, proto, scenario)
    assert got["port"] == got["ref"]
    index = got["port"][0]
    rows = [r for r in index if r["name"] == "repo_add"]
    assert rows == [{"name": "repo_add", "version": "", "state":
                     "UNAVAILABLE", "reason": "unloaded"}]
    assert not any(r["name"] == "_hidden" for r in index)
    assert got["port"][1] == list(range(0, 16, 2))
    assert got["port"][3] == [0, 2, 4, 6]
    assert got["port"][4][0] == "error"


@pytest.mark.parametrize("proto", PROTOS)
def test_repository_errors_read_the_same(stack, proto):
    def scenario(c, mod, side):
        return [_outcome(lambda: c.load_model("ghost")),
                _outcome(lambda: c.unload_model("ghost")),
                _outcome(lambda: c.load_model(
                    "add_sub", config=json.dumps({"max_batch_size": 2}))),
                _outcome(lambda: c.unload_model("late")),
                _outcome(lambda: c.unload_model("identity")),
                _outcome(lambda: c.unload_model("identity")),
                _outcome(lambda: c.load_model("identity"))]

    got = _both(stack, proto, scenario)
    assert got["port"] == got["ref"]
    err = "400" if proto == "http" else "INVALID_ARGUMENT"
    out = got["port"]
    assert out[0][:2] == ("error", err) and "no factory" in out[0][2]
    assert out[1][:2] == ("error", err) and "not loaded" in out[1][2]
    assert out[2][:2] == ("error", err) and "programmatically" in out[2][2]
    assert out[3][:2] == ("error", err)
    assert all(o is None for o in out[4:])


@pytest.mark.parametrize("proto", PROTOS)
def test_an_ensemble_and_its_dependents(stack, proto):
    rng = np.random.default_rng(9)
    a = rng.integers(-100, 100, 16).astype(np.int32)
    b = rng.integers(-100, 100, 16).astype(np.int32)

    def stats(c, name):
        j = (c.get_inference_statistics(name) if proto == "http"
             else c.get_inference_statistics(name, as_json=True))
        m = j["model_stats"][0]    # gRPC's JSON leaves out zeros
        return (int(m.get("inference_count", 0)),
                int(m.get("execution_count", 0)),
                int(m["inference_stats"].get("success", {}).get("count", 0)))

    def scenario(c, mod, side):
        before = [stats(c, n) for n in ("ens", "add_sub", "identity")]
        outs = []
        for _ in range(2):
            r = c.infer("ens", _add_sub_inputs(mod, a, b))
            outs.append((r.as_numpy("SUM").tolist(),
                         r.as_numpy("DIFF").tolist()))
        after = [stats(c, n) for n in ("ens", "add_sub", "identity")]
        if proto == "http":
            meta = c.get_model_metadata("ens")
            cfg = c.get_model_config("ens")
        else:
            meta = c.get_model_metadata("ens", as_json=True)
            cfg = c.get_model_config("ens", as_json=True)["config"]
        cfg["instance_group"][0].pop("kind")
        cfg.pop("backend")    # "jax" / "pytorch" by design
        c.unload_model("ens", unload_dependents=True)
        index = _index(c, proto)
        for name in ("add_sub", "identity", "ens"):
            c.load_model(name)
        again = c.infer("ens", _add_sub_inputs(mod, a, b)).as_numpy(
            "SUM").tolist()
        return outs, before, after, meta, cfg, index, again

    got = _both(stack, proto, scenario)
    assert got["port"] == got["ref"]
    outs, before, after, meta, cfg, index, again = got["port"]
    assert outs == [((a + b).tolist(), (a - b).tolist())] * 2
    assert again == (a + b).tolist()
    for (n0, e0, s0), (n1, e1, s1) in zip(before, after):
        assert (n1 - n0, e1 - e0, s1 - s0) == (2, 2, 2)
    assert meta["platform"] == "ensemble"
    assert cfg["platform"] == "ensemble"
    steps = (cfg["ensemble_scheduling"]["step"])
    assert [s["model_name"] for s in steps] == ["add_sub", "identity"]
    states = {r["name"]: (r["state"], r["reason"]) for r in index}
    for name in ("ens", "add_sub", "identity"):
        assert states[name] == ("UNAVAILABLE", "unloaded")


def test_ensemble_steps_are_child_traces(stack):
    """With every request traced, an ensemble request leaves one trace
    for itself and one per step, each step's ``parent_id`` the ensemble
    trace's id, with the same span names in both packages."""
    got = {}
    a = np.arange(16, dtype=np.int32)
    for side in SIDES:
        core = stack["core"][side]
        core.update_trace_settings("", {"trace_level": ["TIMESTAMPS"],
                                        "trace_rate": "1"})
        c = stack["clients"][("http", side)]
        n0 = len(core.tracer.completed)
        c.infer("ens", _add_sub_inputs(thttp, a, a))
        traces = [t.to_json() for t in list(core.tracer.completed)[n0:]]
        core.update_trace_settings("", {"trace_level": ["OFF"]})
        by_model = {t["model_name"]: t for t in traces}
        parent = by_model["ens"]
        got[side] = (sorted(by_model),
                     {m: t.get("parent_id") == parent["id"]
                      for m, t in by_model.items()},
                     {m: [s["name"] for s in t["timestamps"]]
                      for m, t in by_model.items()})
    assert got["port"] == got["ref"]
    names, linked, _ = got["port"]
    assert names == ["add_sub", "ens", "identity"]
    assert linked == {"add_sub": True, "ens": False, "identity": True}


def test_core_repository_calls_match_in_process(stack):
    """The core's own verbs, without a front end: the index (``ready``
    filter too) and the statuses of ServerError."""
    got = {}
    for side in SIDES:
        core = stack["core"][side]
        out = [core.repository_index(), core.repository_index(True)]
        core.load_model("repo_add")
        core.unload_model("repo_add")
        out.append(core.repository_index())
        try:
            core.unload_model("ghost")
        except Exception as e:  # noqa: BLE001
            out.append((e.status, str(e)))
        got[side] = out
    assert got["port"] == got["ref"]
    assert os.path.isdir(stack["repo"]["port"])


def _serve(argv, env):
    import subprocess
    import sys

    return subprocess.Popen([sys.executable, "-m", *argv], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)


def _wait_ready(url, grpc_url, proc, timeout_s=240):
    """Both front ends ready: the entry points start gRPC after HTTP."""
    import time
    import urllib.error
    import urllib.request

    from client_tpu_torch.utils import InferenceServerException

    deadline = time.time() + timeout_s
    while True:
        assert proc.poll() is None, f"the server at {url} exited"
        try:
            with urllib.request.urlopen(f"http://{url}/v2/health/ready",
                                        timeout=2) as r:
                if r.status == 200:
                    with tgrpc.InferenceServerClient(grpc_url) as c:
                        if c.is_server_ready():
                            return
        except (urllib.error.URLError, ConnectionError, OSError,
                InferenceServerException):
            pass
        assert time.time() < deadline, f"the server at {url} is not ready"
        time.sleep(0.5)


def test_both_entry_points_serve_the_same_models():
    """``python -m client_tpu.server --image-models --lm-models`` and
    ``python -m client_tpu_torch.server --device cpu`` with the same
    flags, each in a process of its own: the same index, and for every
    model the same
    metadata and HTTP config and the same gRPC config apart from the
    by-design fields (platform and backend, "pytorch" in the port, and
    the instance kind)."""
    import socket

    ports = []
    for _ in range(4):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    flags = ["--image-models", "--lm-models"]
    procs = {
        "ref": _serve(["client_tpu.server", *flags, "--http-port",
                       str(ports[0]), "--grpc-port", str(ports[1])], env),
        "port": _serve(["client_tpu_torch.server", "--device", "cpu",
                        *flags, "--http-port", str(ports[2]),
                        "--grpc-port", str(ports[3])], env)}
    urls = {"ref": f"127.0.0.1:{ports[0]}", "port": f"127.0.0.1:{ports[2]}"}
    grpc_urls = {"ref": f"127.0.0.1:{ports[1]}",
                 "port": f"127.0.0.1:{ports[3]}"}
    try:
        for side in SIDES:
            _wait_ready(urls[side], grpc_urls[side], procs[side])
        http = {s: thttp.InferenceServerClient(urls[s]) for s in SIDES}
        grpcc = {s: tgrpc.InferenceServerClient(grpc_urls[s]) for s in SIDES}
        try:
            index = {s: http[s].get_model_repository_index() for s in SIDES}
            assert index["port"] == index["ref"]
            names = [r["name"] for r in index["port"]]
            assert names == sorted([
                "accumulator", "add_sub", "add_sub_fp32", "add_sub_string",
                "identity", "repeat_int32", "preprocess", "resnet50",
                "preprocess_resnet50", "decoder_lm", "generator_lm",
                "continuous_lm"])
            for name in names:
                got = {}
                for s in SIDES:
                    meta = http[s].get_model_metadata(name)
                    cfg = http[s].get_model_config(name)
                    gcfg = grpcc[s].get_model_config(name,
                                                     as_json=True)["config"]
                    for d in (cfg, gcfg):
                        d["instance_group"][0].pop("kind", None)
                    # the host-declared repeat model reads the same
                    # platform and backend in both packages, the ensemble
                    # the same platform
                    if name != "repeat_int32":
                        for d in (meta, cfg, gcfg):
                            d.pop("backend", None)
                            if name != "preprocess_resnet50":
                                d.pop("platform", None)
                    got[s] = (meta, cfg, gcfg)
                assert got["port"] == got["ref"], name
        finally:
            for c in list(http.values()) + list(grpcc.values()):
                c.close()
    finally:
        for proc in procs.values():
            proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=30)
            except Exception:  # noqa: BLE001 — a hung server is killed
                proc.kill()
                proc.wait(timeout=30)
