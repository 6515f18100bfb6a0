"""Stateful sequences and the demo models in the port, on the CPU, held
against the JAX package's.

Both servers serve the reference's sequence and demo models: the
``accumulator`` (a running sum per correlation id, its state a tensor on
the model's device in the port), ``decoder_lm`` (one greedy decode step
per request, the KV cache carried per correlation id, at a tiny width
with the same f32 weights in both packages), ``repeat_int32`` (a
decoupled stream) and ``add_sub_string`` (BYTES). Both are driven with
the port's HTTP and gRPC clients, and every outcome (outputs, statuses,
error texts) is held to the reference's:

- the accumulator's running sums over four interleaved correlation ids,
  over HTTP, gRPC and the gRPC stream;
- ``decoder_lm``'s greedy NEXT_TOKEN stream over a prompt and its
  continuation, identical token for token to the JAX model's;
- the context guard at ``max_seq`` (the reference's sequence scheduler
  answers it as a 500 naming the guard's ServerError), with the
  sequence's state left as the reference leaves it (its position stays
  at ``max_seq``), and a START that resets a live id with a fresh state
  (new tensors: the port's step writes its KV cache in place);
- a request without a correlation id and an unknown id without START
  (400), a START past ``max_candidate_sequences`` (503 with Retry-After);
- idle eviction under an injected clock (``scheduler.now_ns`` in both
  packages);
- the response cache's sequence bypass (a cached model's sequence
  requests are neither hits nor misses);
- ``repeat_int32``'s stream and ``add_sub_string``'s strings;
- the perf analyzer's sequence mode (sync, sequence length 4,
  concurrency 2) against each server's accumulator, the port's CLI over
  HTTP and each package's CLI in process: no failed request, every
  sequence the server saw start also ended, none left live.

Tolerance: tokens, sums, strings and statuses exact; no float compared.
"""

import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

grpc = pytest.importorskip("grpc")

from client_tpu.models import add_sub as jadd  # noqa: E402
from client_tpu.models import decoder_lm as jlm  # noqa: E402
from client_tpu.models import streaming as jstream  # noqa: E402
from client_tpu.models import transformer as jt  # noqa: E402
from client_tpu.server import TpuInferenceServer  # noqa: E402
from client_tpu.server import scheduler as jsched  # noqa: E402
from client_tpu.server.config import (  # noqa: E402
    SequenceBatchingConfig as JSeqCfg,
)
from client_tpu.server.grpc_server import (  # noqa: E402
    GrpcInferenceServer as RefGrpc,
)
from client_tpu.server.http_server import (  # noqa: E402
    HttpInferenceServer as RefHttp,
)
from client_tpu.server.types import InferRequest as JReq  # noqa: E402
from client_tpu.server.types import InferTensor as JTensor  # noqa: E402
from client_tpu.server.types import ServerError as JServerError  # noqa: E402
from client_tpu_torch.client import grpc as tgrpc  # noqa: E402
from client_tpu_torch.client import http as thttp  # noqa: E402
from client_tpu_torch.models import (  # noqa: E402
    make_accumulator,
    make_add_sub_string,
    make_decoder_lm,
    make_repeat,
)
from client_tpu_torch.models import transformer as tt  # noqa: E402
from client_tpu_torch.perf.__main__ import main as perf_main  # noqa: E402
from client_tpu_torch.server import TorchInferenceServer  # noqa: E402
from client_tpu_torch.server import scheduler as tsched  # noqa: E402
from client_tpu_torch.server.config import (  # noqa: E402
    SequenceBatchingConfig as TSeqCfg,
)
from client_tpu_torch.server.grpc_server import (  # noqa: E402
    GrpcInferenceServer,
)
from client_tpu_torch.server.http_server import (  # noqa: E402
    HttpInferenceServer,
)
from client_tpu_torch.server.types import InferRequest as TReq  # noqa: E402
from client_tpu_torch.server.types import InferTensor as TTensor  # noqa: E402
from client_tpu_torch.server.types import ServerError  # noqa: E402

SIDES = ("ref", "port")
KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=16, causal=True)
PROMPT = [5, 11, 2, 40, 7]


def _register(core, side, jcfg, jparams, tcfg, tparams):
    if side == "ref":
        core.register_model(jstream.make_accumulator("accumulator", 1,
                                                     "INT32"))
        small = jstream.make_accumulator("acc_small", 1, "INT32")
        small.config.sequence_batching = JSeqCfg(max_candidate_sequences=2)
        cached = jstream.make_accumulator("acc_cached", 1, "INT32")
        cached.config.response_cache = True
        core.register_model(small)
        core.register_model(cached)
        core.register_model(jlm.make_decoder_lm(
            "decoder_lm", cfg=jcfg, params=jparams))
        core.register_model(jstream.make_repeat("repeat_int32"))
        core.register_model(jadd.make_add_sub_string("add_sub_string", 16))
        return
    core.register_model(make_accumulator("accumulator", 1, "INT32",
                                         device="cpu"))
    small = make_accumulator("acc_small", 1, "INT32", device="cpu")
    small.config.sequence_batching = TSeqCfg(max_candidate_sequences=2)
    cached = make_accumulator("acc_cached", 1, "INT32", device="cpu")
    cached.config.response_cache = True
    core.register_model(small)
    core.register_model(cached)
    core.register_model(make_decoder_lm("decoder_lm", cfg=tcfg,
                                        params=tparams, device="cpu"))
    core.register_model(make_repeat("repeat_int32"))
    core.register_model(make_add_sub_string("add_sub_string", 16))


@pytest.fixture(scope="module")
def weights():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(3), jcfg)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="ref", **KW)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    return jcfg, jparams, tcfg, tparams


@pytest.fixture(scope="module")
def servers(weights):
    cores = {"ref": TpuInferenceServer(), "port": TorchInferenceServer()}
    for side in SIDES:
        _register(cores[side], side, *weights)
    http = {"ref": RefHttp(cores["ref"], port=0).start(),
            "port": HttpInferenceServer(cores["port"], port=0).start()}
    grpcs = {"ref": RefGrpc(cores["ref"], port=0).start(),
             "port": GrpcInferenceServer(cores["port"], port=0).start()}
    yield {"core": cores, "http": http, "grpc": grpcs}
    for side in SIDES:
        http[side].stop()
        grpcs[side].stop()
        cores[side].stop()


@pytest.fixture(scope="module")
def clients(servers):
    made = {}
    for side in SIDES:
        made[("http", side)] = thttp.InferenceServerClient(
            servers["http"][side].url)
        made[("grpc", side)] = tgrpc.InferenceServerClient(
            servers["grpc"][side].address)
    yield made
    for c in made.values():
        c.close()


def _mod(proto):
    return thttp if proto == "http" else tgrpc


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — compared across servers
        status = getattr(e, "status", None)
        return ("error", status() if callable(status) else None, str(e))


def _int_input(mod, name, values):
    arr = np.asarray(values, np.int32)
    t = mod.InferInput(name, list(arr.shape), "INT32")
    t.set_data_from_numpy(arr)
    return t


# ------------------------------------------------------------ accumulator

@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_accumulator_running_sums(clients, proto):
    """Four correlation ids interleaved, each starting and ending on its
    own step: every answer is its own id's running sum, on both
    servers."""
    mod = _mod(proto)
    rng = np.random.default_rng(7)
    values = rng.integers(-20, 20, (4, 5)).astype(np.int32)
    got = {}
    for side in SIDES:
        c = clients[(proto, side)]
        out = np.zeros((4, 5), np.int32)
        for step in range(5):
            for sid in range(4):
                r = c.infer("accumulator",
                            [_int_input(mod, "INPUT", [values[sid, step]])],
                            sequence_id=100 + sid,
                            sequence_start=(step == 0),
                            sequence_end=(step == 4))
                out[sid, step] = r.as_numpy("OUTPUT")[0]
        got[side] = out
    np.testing.assert_array_equal(got["port"], np.cumsum(values, axis=1))
    np.testing.assert_array_equal(got["port"], got["ref"])


def test_accumulator_over_the_grpc_stream(clients):
    """A sequence sent over ModelStreamInfer, string correlation ids,
    both servers."""
    got = {}
    for side in SIDES:
        c = clients[("grpc", side)]
        results, done = [], threading.Event()

        def cb(result, error, results=results, done=done):
            results.append(error if error is not None
                           else int(result.as_numpy("OUTPUT")[0]))
            if len(results) == 6:
                done.set()

        c.start_stream(cb)
        try:
            for i, v in enumerate([3, 4, 5, 6, 7, 8]):
                c.async_stream_infer(
                    "accumulator", [_int_input(tgrpc, "INPUT", [v])],
                    sequence_id=f"s-{side}", sequence_start=(i == 0),
                    sequence_end=(i == 5))
            assert done.wait(30)
        finally:
            c.stop_stream()
        got[side] = results
    assert got["port"] == [3, 7, 12, 18, 25, 33] == got["ref"]


@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_sequence_errors_read_the_same(clients, proto):
    """No correlation id and an unknown id without START are 400s; a
    START past max_candidate_sequences is a 503."""
    mod = _mod(proto)
    got = {}
    for side in SIDES:
        c = clients[(proto, side)]
        x = [_int_input(mod, "INPUT", [1])]
        out = [_outcome(lambda: c.infer("accumulator", x)),
               _outcome(lambda: c.infer("accumulator", x,
                                        sequence_id=999_999))]
        for sid in (1, 2):
            c.infer("acc_small", x, sequence_id=sid, sequence_start=True)
        out.append(_outcome(lambda: c.infer("acc_small", x, sequence_id=3,
                                            sequence_start=True)))
        for sid in (1, 2):
            c.infer("acc_small", x, sequence_id=sid, sequence_end=True)
        got[side] = out
    assert got["port"] == got["ref"]
    statuses = [o[1] for o in got["port"]]
    assert statuses == (["400", "400", "503"] if proto == "http" else
                        ["INVALID_ARGUMENT", "INVALID_ARGUMENT",
                         "UNAVAILABLE"])
    assert "correlation id" in got["port"][0][2]
    assert "no START request" in got["port"][1][2]
    assert "max_candidate_sequences exceeded" in got["port"][2][2]


def test_a_503_past_max_candidates_carries_retry_after(servers):
    def post(url, body):
        req = urllib.request.Request(
            url + "/v2/models/acc_small/infer",
            data=json.dumps(body).encode(), method="POST")
        try:
            with urllib.request.urlopen(req) as r:
                return r.status, None
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Retry-After")

    def body(sid, start=False, end=False):
        return {"inputs": [{"name": "INPUT", "shape": [1],
                            "datatype": "INT32", "data": [1]}],
                "parameters": {"sequence_id": sid, "sequence_start": start,
                               "sequence_end": end}}

    got = {}
    for side in SIDES:
        url = servers["http"][side].url
        if not url.startswith("http"):
            url = "http://" + url
        answers = [post(url, body(sid, start=True)) for sid in (11, 12, 13)]
        answers += [post(url, body(sid, end=True)) for sid in (11, 12)]
        got[side] = answers
    assert got["port"] == got["ref"]
    assert got["port"][2] == (503, "1")


def test_idle_sequences_are_evicted_under_an_injected_clock(
        servers, monkeypatch):
    """A sequence idle past max_sequence_idle_microseconds is dropped at
    the next submit: its id then needs a START again."""
    clock = {"ns": 10**12}
    fake = lambda: clock["ns"]  # noqa: E731
    monkeypatch.setattr(jsched, "now_ns", fake)
    monkeypatch.setattr(tsched, "now_ns", fake)
    got = {}
    for side, Req, Tensor, Err in (("ref", JReq, JTensor, JServerError),
                                   ("port", TReq, TTensor, ServerError)):
        core = (TpuInferenceServer() if side == "ref"
                else TorchInferenceServer())
        model = (jstream.make_accumulator("acc_idle", 1, "INT32")
                 if side == "ref" else
                 make_accumulator("acc_idle", 1, "INT32", device="cpu"))
        model.config.sequence_batching = (JSeqCfg if side == "ref"
                                          else TSeqCfg)(
            max_sequence_idle_microseconds=1000)
        core.register_model(model)
        entry = core._entry("acc_idle")

        def step(v, start=False):
            req = Req(model_name="acc_idle", inputs=[
                Tensor("INPUT", "INT32", (1,),
                       data=np.array([v], np.int32))],
                sequence_id=5, sequence_start=start)
            try:
                return int(core.infer(req).output("OUTPUT").data[0])
            except Err as e:
                return (e.status, str(e))

        try:
            out = [step(2, start=True), step(3)]
            clock["ns"] += 999_000          # idle just under the limit
            out.append(step(4))
            live = [entry.scheduler.live_sequences()]
            clock["ns"] += 1_001_000        # idle past it
            out.append(step(5))
            live.append(entry.scheduler.live_sequences())
            out.append(step(6, start=True))
            got[side] = (out, live)
        finally:
            core.stop()
    assert got["port"] == got["ref"]
    out, live = got["port"]
    assert out[:3] == [2, 5, 9] and out[4] == 6
    assert out[3][0] == 400 and "no START request" in out[3][1]
    assert live == [1, 0]


def test_sequence_requests_bypass_the_response_cache(clients, servers):
    """A cached model's sequence requests are never looked up nor stored:
    repeated identical inputs keep adding up, and the cache statistics
    stay at zero, on both servers."""
    got = {}
    for side in SIDES:
        c = clients[("http", side)]
        sums = [int(c.infer("acc_cached", [_int_input(thttp, "INPUT", [2])],
                            sequence_id=77, sequence_start=(i == 0),
                            sequence_end=(i == 3)).as_numpy("OUTPUT")[0])
                for i in range(4)]
        st = c.get_inference_statistics("acc_cached")["model_stats"][0]
        got[side] = (sums, st["inference_stats"]["cache_hit"]["count"],
                     st["inference_stats"]["cache_miss"]["count"],
                     st["inference_count"])
    assert got["port"] == got["ref"] == ([2, 4, 6, 8], 0, 0, 4)


# ------------------------------------------------------------- decoder_lm

def _lm_stream(c, mod, sid, prompt, n_more):
    """Feed ``prompt`` token by token, then ``n_more`` of the model's own
    tokens; the NEXT_TOKEN of every step."""
    out, tok = [], None
    for i in range(len(prompt) + n_more):
        feed = prompt[i] if i < len(prompt) else tok
        r = c.infer("decoder_lm", [_int_input(mod, "TOKEN", [feed])],
                    sequence_id=sid, sequence_start=(i == 0))
        tok = int(r.as_numpy("NEXT_TOKEN")[0])
        out.append(tok)
    return out


@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_decoder_lm_tokens_match_the_jax_model(clients, proto, weights):
    mod = _mod(proto)
    got = {side: _lm_stream(clients[(proto, side)], mod,
                            f"lm-{proto}-{side}", PROMPT, 6)
           for side in SIDES}
    assert got["port"] == got["ref"]
    # the offline loop over the port's decode_step, the same tokens
    _, _, tcfg, tparams = weights
    state = tt.init_decode_state(tcfg, 1, "cpu")
    offline, tok = [], None
    with torch.inference_mode():
        for i in range(len(PROMPT) + 6):
            feed = PROMPT[i] if i < len(PROMPT) else tok
            logits, state = tt.decode_step(
                tcfg, tparams, torch.tensor([feed], dtype=torch.int32),
                state)
            tok = int(logits.argmax(-1)[0])
            offline.append(tok)
    assert got["port"] == offline


def test_the_context_guard_and_a_start_on_a_live_id(clients, servers,
                                                    weights):
    """Steps up to max_seq run; the next one is refused by the guard
    (answered 500 by both sequence schedulers, the guard's message
    kept), and the state stays as it was (position max_seq). A START on
    the live id then gives it a fresh state (new tensors in the port) and
    the same tokens as a new id."""
    _, _, tcfg, _ = weights
    c_port = clients[("http", "port")]
    got = {}
    for side in SIDES:
        c = clients[("http", side)]
        sid = 4242
        toks = _lm_stream(c, thttp, sid, PROMPT, KW["max_seq"] - len(PROMPT))
        over = _outcome(lambda: c.infer(
            "decoder_lm", [_int_input(thttp, "TOKEN", [1])],
            sequence_id=sid))
        again = _outcome(lambda: c.infer(
            "decoder_lm", [_int_input(thttp, "TOKEN", [1])],
            sequence_id=sid))
        sched = servers["core"][side]._entry("decoder_lm").scheduler
        pos = int(np.asarray(sched._sequences[sid].state["pos"]).reshape(-1)
                  [0])
        old = sched._sequences[sid].state
        restart = _lm_stream(c, thttp, sid, PROMPT, 3)
        fresh = _lm_stream(c, thttp, sid + 1, PROMPT, 3)
        got[side] = (toks, over, again, pos, restart, fresh)
        if side == "port":
            new = sched._sequences[sid].state
            assert new["k"].data_ptr() != old["k"].data_ptr()
            assert new["v"].data_ptr() != old["v"].data_ptr()
    assert got["port"] == got["ref"]
    toks, over, again, pos, restart, fresh = got["port"]
    assert len(toks) == tcfg.max_seq
    assert over[1] == "500" and "max context length" in over[2]
    assert again == over
    assert pos == tcfg.max_seq
    assert restart == fresh == toks[:len(PROMPT) + 3]
    c_port.infer("decoder_lm", [_int_input(thttp, "TOKEN", [1])],
                 sequence_id=4242, sequence_end=True)


# ------------------------------------------------------------ demo models

def test_repeat_int32_streams_the_same(clients):
    got = {}
    for side in SIDES:
        c = clients[("grpc", side)]
        results, done = [], threading.Event()

        def cb(result, error, results=results, done=done):
            if error is not None:
                results.append(("error", str(error)))
                done.set()
                return
            out = result.as_numpy("OUT")
            final = result.get_response().parameters.get(
                "triton_final_response")
            if out is not None:
                results.append(int(out[0]))
            if final is not None and final.bool_param:
                done.set()

        c.start_stream(cb)
        try:
            c.async_stream_infer(
                "repeat_int32",
                [_int_input(tgrpc, "IN", [4, 8, 15, 16, 23]),
                 _int_input(tgrpc, "WAIT", [0, 1000, 0, 1000, 0])],
                parameters={"triton_enable_empty_final_response": True})
            assert done.wait(30)
        finally:
            c.stop_stream()
        got[side] = results
    assert got["port"] == got["ref"] == [4, 8, 15, 16, 23]


@pytest.mark.parametrize("proto", ["http", "grpc"])
def test_add_sub_string_reads_the_same(clients, proto):
    mod = _mod(proto)
    a = np.array([str(i).encode() for i in range(16)], dtype=np.object_)
    b = np.array([str(3 * i - 7).encode() for i in range(16)],
                 dtype=np.object_)
    got = {}
    for side in SIDES:
        c = clients[(proto, side)]
        i0 = mod.InferInput("INPUT0", [16], "BYTES")
        i0.set_data_from_numpy(a)
        i1 = mod.InferInput("INPUT1", [16], "BYTES")
        i1.set_data_from_numpy(b)
        r = c.infer("add_sub_string", [i0, i1])
        got[side] = (r.as_numpy("OUTPUT0").tolist(),
                     r.as_numpy("OUTPUT1").tolist(),
                     c.get_model_metadata("add_sub_string", as_json=True)
                     if proto == "grpc" else
                     c.get_model_metadata("add_sub_string"))
    assert got["port"][:2] == got["ref"][:2]
    assert got["port"][0] == [str(int(x) + int(y)).encode()
                              for x, y in zip(a, b)]
    meta = {side: dict(got[side][2]) for side in SIDES}
    for side in SIDES:
        meta[side].pop("platform")   # "jax" / "pytorch" by design
    assert meta["port"] == meta["ref"]


@pytest.mark.parametrize("model", ["accumulator", "decoder_lm",
                                   "repeat_int32", "add_sub_string"])
def test_configs_and_metadata_read_the_same(clients, model):
    """The HTTP config and metadata of each model, and the gRPC config's
    sequence block, equal the reference's; only the by-design fields
    differ (platform/backend of the non-host models, the instance kind)."""
    http = {s: clients[("http", s)] for s in SIDES}
    cfg = {s: http[s].get_model_config(model) for s in SIDES}
    meta = {s: http[s].get_model_metadata(model) for s in SIDES}
    for s in SIDES:
        cfg[s]["instance_group"][0].pop("kind")
        if model != "repeat_int32":
            for d in (cfg[s], meta[s]):
                d.pop("platform")
                d.pop("backend", None)
    assert cfg["port"] == cfg["ref"]
    assert meta["port"] == meta["ref"]
    g = {s: clients[("grpc", s)].get_model_config(model).config
         for s in SIDES}
    assert g["port"].sequence_batching == g["ref"].sequence_batching
    assert g["port"].HasField("sequence_batching") == (
        model in ("accumulator", "decoder_lm"))


# --------------------------------------------------------- perf analyzer

_SEQ_ARGS = ["-m", "accumulator", "--sync", "-p", "150", "-s", "90", "-r",
             "3", "--concurrency-range", "2", "--sequence-length", "4",
             "--num-of-sequences", "2"]


def _counted_run(core, run) -> dict:
    """``run()`` with the accumulator's scheduler counting every START and
    END it is sent; the counts, the live sequences after and the failed
    requests."""
    sched = core._entry("accumulator").scheduler
    seen = {"start": 0, "end": 0}
    submit = sched.submit

    def counting(pending):
        seen["start"] += bool(pending.request.sequence_start)
        seen["end"] += bool(pending.request.sequence_end)
        submit(pending)

    before = core.statistics("accumulator")["model_stats"][0]
    sched.submit = counting
    try:
        rc = run()
    finally:
        del sched.submit
    after = core.statistics("accumulator")["model_stats"][0]
    return {"rc": rc, **seen, "live": sched.live_sequences(),
            "failed": after["inference_stats"]["fail"]["count"]
            - before["inference_stats"]["fail"]["count"]}


@pytest.mark.parametrize("how", ["http", "in_process"])
def test_perf_sequence_mode_against_both_servers(servers, capsys, how):
    """Sequence mode against each server's accumulator: the port's CLI
    over HTTP against both servers, and in process each package's own CLI
    against its own server (``cuda_direct`` / ``tpu_direct``). Every
    request is answered, every sequence the server saw start also ended
    (the load manager drains its live sequences at the end), none is left
    live. How many sequences a run makes depends on its windows' timing,
    so the counts are held to these invariants, not to each other."""
    from client_tpu.perf.__main__ import main as ref_main

    for side in SIDES:
        core = servers["core"][side]
        if how == "http":
            run = (lambda core=core, side=side: perf_main(
                [*_SEQ_ARGS, "-u", servers["http"][side].url]))
        elif side == "port":
            run = (lambda core=core: perf_main(
                [*_SEQ_ARGS, "--service-kind", "cuda_direct"], server=core))
        else:
            run = (lambda core=core: ref_main(
                [*_SEQ_ARGS, "--service-kind", "tpu_direct"], server=core))
        got = _counted_run(core, run)
        report = capsys.readouterr().out
        assert got["rc"] == 0, (side, got)
        assert "Request count" in report
        assert got["start"] > 0 and got["start"] == got["end"], (side, got)
        assert got["live"] == 0 and got["failed"] == 0, (side, got)
