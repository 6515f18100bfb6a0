"""The port's client retry policy (client_tpu_torch.client.retry) against
the JAX package's, and end to end through the port's clients and server.

- The policy: the reference's ``TestRetryPolicy`` cases
  (``tests/test_fault_tolerance.py``) on the port's copy, and the same
  seed drawing the same full-jitter delays in both packages. Backoffs are
  never slept on the real clock: ``call_with_retry`` gets a fake
  ``sleep`` that records each delay.
- End to end: the reference's ``TestClientRetryEndToEnd`` cases on the
  port's HTTP and gRPC clients against the port's server, with the port's
  own fault injector: the 503's ``Retry-After`` header and the gRPC
  ``retry-after`` trailer reach the exception, a policy retries a shed
  model until it answers (the server's hint taken as the floor of each
  recorded sleep), and injected transport resets are absorbed by the
  pool's stale-socket retry or by the policy. A sequence request is never
  replayed after a dropped connection.
"""

import functools
import http.client
import json

import numpy as np
import pytest

from client_tpu.client import retry as jretry
from client_tpu_torch.client import http as httpclient
from client_tpu_torch.client import retry as tretry
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import faultinject
from client_tpu_torch.server.config import ModelConfig, TensorSpec
from client_tpu_torch.server.http_server import HttpInferenceServer
from client_tpu_torch.server.model import PyModel
from client_tpu_torch.server.types import ServerError
from client_tpu_torch.utils import InferenceServerException


def _policy(**kw):
    kw.setdefault("seed", 0)
    return tretry.RetryPolicy(**kw)


class _Sleeps(list):
    """A fake ``sleep``: records each delay, never waits."""

    def __call__(self, seconds):
        self.append(seconds)


# ---------------------------------------------------------------- the policy

def test_default_retryable_codes():
    p = _policy()
    assert tretry.DEFAULT_RETRYABLE == jretry.DEFAULT_RETRYABLE
    assert p.is_retryable("503") and p.is_retryable("UNAVAILABLE")
    assert p.is_retryable("502")
    assert not p.is_retryable("500") and not p.is_retryable("400")
    assert not p.is_retryable(None)


def test_full_jitter_bounds_and_growth():
    p = _policy(backoff_s=0.1, backoff_mult=2.0, backoff_max_s=0.5)
    for attempt, ceiling in ((0, 0.1), (1, 0.2), (2, 0.4), (5, 0.5)):
        for _ in range(50):
            assert 0.0 <= p.delay_s(attempt) <= ceiling


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_jitter_draws_equal_the_references(seed):
    kw = dict(seed=seed, backoff_s=0.05, backoff_mult=3.0, backoff_max_s=2.0)
    port, ref = tretry.RetryPolicy(**kw), jretry.RetryPolicy(**kw)
    hints = [None, 0.5, None, 3.0, None, None, 0.01]
    for attempt, hint in enumerate(hints):
        assert port.delay_s(attempt, hint) == ref.delay_s(attempt, hint)


def test_bad_knobs_raise_like_the_reference():
    for kw in (dict(max_attempts=0), dict(backoff_s=0),
               dict(backoff_max_s=-1), dict(backoff_mult=0.5)):
        with pytest.raises(ValueError) as port_err:
            tretry.RetryPolicy(**kw)
        with pytest.raises(ValueError) as ref_err:
            jretry.RetryPolicy(**kw)
        assert str(port_err.value) == str(ref_err.value)


def test_retry_after_is_a_floor():
    p = _policy(backoff_s=0.01)
    assert p.delay_s(0, retry_after_s=2.5) >= 2.5
    p2 = _policy(backoff_s=0.01, honor_retry_after=False)
    assert p2.delay_s(0, retry_after_s=2.5) <= 0.01


def test_call_with_retry_recovers_and_counts():
    p = _policy(max_attempts=3, backoff_s=0.001)
    ref = jretry.RetryPolicy(max_attempts=3, backoff_s=0.001, seed=0)
    attempts, sleeps = [], _Sleeps()

    def flaky():
        attempts.append(1)
        if len(attempts) < 3:
            raise InferenceServerException("shed", "503")
        return "ok"

    assert tretry.call_with_retry(p, flaky, sleep=sleeps) == "ok"
    assert len(attempts) == 3
    assert p.stats() == {"retries": 2, "giveups": 0}
    assert sleeps == [ref.delay_s(0), ref.delay_s(1)]


def test_call_with_retry_gives_up_after_budget():
    p = _policy(max_attempts=2, backoff_s=0.001)
    sleeps = _Sleeps()

    def always_shed():
        raise InferenceServerException("shed", "503")

    with pytest.raises(InferenceServerException):
        tretry.call_with_retry(p, always_shed, sleep=sleeps)
    assert p.stats() == {"retries": 1, "giveups": 1}
    assert len(sleeps) == 1


def test_non_retryable_passes_through_immediately():
    p = _policy(max_attempts=5, backoff_s=0.001)
    attempts, sleeps = [], _Sleeps()

    def bad_request():
        attempts.append(1)
        raise InferenceServerException("nope", "400")

    with pytest.raises(InferenceServerException):
        tretry.call_with_retry(p, bad_request, sleep=sleeps)
    assert len(attempts) == 1 and p.stats()["retries"] == 0
    assert sleeps == []


def test_none_policy_is_a_plain_call():
    assert tretry.call_with_retry(None, lambda: 42) == 42


def test_connection_errors_are_retried_by_default():
    p = _policy(max_attempts=3, backoff_s=0.001)
    attempts = []

    def resets_then_ok():
        attempts.append(1)
        if len(attempts) < 3:
            raise ConnectionResetError("peer reset")
        return "ok"

    assert tretry.call_with_retry(p, resets_then_ok,
                                  sleep=_Sleeps()) == "ok"
    assert p.stats()["retries"] == 2
    # opt-out restores fail-fast on raw transport errors
    p2 = _policy(max_attempts=3, backoff_s=0.001,
                 retry_connection_errors=False)

    def always_resets():
        raise ConnectionResetError("peer reset")

    with pytest.raises(ConnectionResetError):
        tretry.call_with_retry(p2, always_resets, sleep=_Sleeps())
    assert p2.stats()["retries"] == 0
    # per call: a request that is not safe to replay never replays on a
    # raw transport error, even under the default policy
    p3 = _policy(max_attempts=3, backoff_s=0.001)
    with pytest.raises(ConnectionResetError):
        tretry.call_with_retry(p3, always_resets, sleep=_Sleeps(),
                               connection_errors=False)
    assert p3.stats()["retries"] == 0


def test_replay_unsafe_requires_server_advertised_shed():
    p = _policy(max_attempts=3, backoff_s=0.001)
    attempts = []

    def bare_unavailable():
        attempts.append(1)
        raise InferenceServerException("conn dropped", "UNAVAILABLE")

    with pytest.raises(InferenceServerException):
        tretry.call_with_retry(p, bare_unavailable, sleep=_Sleeps(),
                               connection_errors=False)
    assert len(attempts) == 1 and p.stats()["retries"] == 0

    hinted = []

    def hinted_shed():
        hinted.append(1)
        if len(hinted) < 2:
            e = InferenceServerException("shed", "UNAVAILABLE")
            e.retry_after_s = 0.01  # server-advertised: pre-execution
            raise e
        return "ok"

    p2 = _policy(max_attempts=3, backoff_s=0.001)
    sleeps = _Sleeps()
    assert tretry.call_with_retry(p2, hinted_shed, sleep=sleeps,
                                  connection_errors=False) == "ok"
    assert p2.stats()["retries"] == 1 and sleeps[0] >= 0.01


# ---------------------------------------------------------------- end to end

def _flaky_model(name, fail_times, retry_after=7.0):
    """A model that sheds its first ``fail_times`` calls with a retryable
    503, then echoes INPUT0."""
    calls = {"n": 0}

    def fn(inputs):
        calls["n"] += 1
        if calls["n"] <= fail_times:
            raise ServerError("engine overloaded; request shed", 503,
                              retry_after=retry_after)
        return {"OUTPUT0": inputs["INPUT0"]}

    cfg = ModelConfig(
        name=name,
        inputs=(TensorSpec("INPUT0", "INT32", (4,)),),
        outputs=(TensorSpec("OUTPUT0", "INT32", (4,)),))
    return PyModel(cfg, fn), calls


@pytest.fixture(scope="module")
def flaky_server():
    core = TorchInferenceServer()
    http_srv = HttpInferenceServer(core, port=0).start()
    yield core, http_srv
    http_srv.stop()
    core.stop()


@pytest.fixture(scope="module")
def flaky_grpc(flaky_server):
    pytest.importorskip("grpc")
    from client_tpu_torch.server.grpc_server import GrpcInferenceServer

    srv = GrpcInferenceServer(flaky_server[0], port=0).start()
    yield srv
    srv.stop()


@pytest.fixture
def sleeps(monkeypatch):
    """Every client's call_with_retry sleeps through a recorder."""
    rec = _Sleeps()
    monkeypatch.setattr(tretry, "call_with_retry", functools.partial(
        tretry.call_with_retry, sleep=rec))
    return rec


@pytest.fixture
def injector():
    inj = faultinject.get_injector()
    yield inj
    inj.clear()


def _x(mod):
    x = mod.InferInput("INPUT0", (4,), "INT32")
    x.set_data_from_numpy(np.arange(4, dtype=np.int32))
    return x


def test_http_503_carries_retry_after_header(flaky_server):
    core, http_srv = flaky_server
    model, _ = _flaky_model("flaky_hdr", fail_times=10**9, retry_after=7.0)
    core.register_model(model)
    conn = http.client.HTTPConnection("127.0.0.1", http_srv.port, timeout=30)
    body = json.dumps({"inputs": [{
        "name": "INPUT0", "datatype": "INT32", "shape": [4],
        "data": [0, 0, 0, 0]}]}).encode()
    conn.request("POST", "/v2/models/flaky_hdr/infer", body=body,
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    resp.read()
    assert resp.status == 503
    assert resp.getheader("Retry-After") == "7"
    conn.close()


def test_http_client_retries_until_success(flaky_server, sleeps):
    core, http_srv = flaky_server
    model, calls = _flaky_model("flaky_http", fail_times=2,
                                retry_after=0.25)
    core.register_model(model)
    policy = tretry.RetryPolicy(max_attempts=4, backoff_s=0.01, seed=1)
    client = httpclient.InferenceServerClient(http_srv.url,
                                              retry_policy=policy)
    result = client.infer("flaky_http", [_x(httpclient)])
    assert np.array_equal(result.as_numpy("OUTPUT0"),
                          np.arange(4, dtype=np.int32))
    assert calls["n"] == 3
    assert policy.stats() == {"retries": 2, "giveups": 0}
    # the server's hint, whole seconds on HTTP (Retry-After 1 for 0.25 s),
    # is each sleep's floor
    assert sleeps == [1.0, 1.0]
    client.close()


def test_http_client_gives_up_and_counts(flaky_server, sleeps):
    core, http_srv = flaky_server
    model, calls = _flaky_model("flaky_giveup", fail_times=10**9,
                                retry_after=0.5)
    core.register_model(model)
    policy = tretry.RetryPolicy(max_attempts=3, backoff_s=0.01, seed=2)
    client = httpclient.InferenceServerClient(http_srv.url,
                                              retry_policy=policy)
    with pytest.raises(InferenceServerException) as ei:
        client.infer("flaky_giveup", [_x(httpclient)])
    assert ei.value.status() == "503"
    assert calls["n"] == 3 and sleeps == [1.0, 1.0]
    assert policy.stats() == {"retries": 2, "giveups": 1}
    client.close()


def test_http_client_without_policy_fails_fast(flaky_server):
    core, http_srv = flaky_server
    model, calls = _flaky_model("flaky_fast", fail_times=1, retry_after=3.0)
    core.register_model(model)
    client = httpclient.InferenceServerClient(http_srv.url)
    x = httpclient.InferInput("INPUT0", (4,), "INT32")
    x.set_data_from_numpy(np.zeros(4, np.int32))
    with pytest.raises(InferenceServerException) as ei:
        client.infer("flaky_fast", [x])
    assert ei.value.status() == "503"
    assert ei.value.retry_after_s == 3.0  # the parsed header rides along
    assert calls["n"] == 1
    client.close()


def test_http_control_plane_stays_fail_fast(flaky_server, sleeps):
    _, http_srv = flaky_server
    policy = tretry.RetryPolicy(max_attempts=4, backoff_s=0.01, seed=1)
    client = httpclient.InferenceServerClient(http_srv.url,
                                              retry_policy=policy)
    with pytest.raises(InferenceServerException) as ei:
        client.get_model_metadata("no_such_model")
    assert ei.value.status() == "404"
    assert sleeps == [] and policy.stats()["retries"] == 0
    client.close()


def test_grpc_client_retries_and_reads_metadata_hint(flaky_server,
                                                     flaky_grpc, sleeps):
    from client_tpu_torch.client import grpc as grpcclient

    core, _ = flaky_server
    model, calls = _flaky_model("flaky_grpc", fail_times=2,
                                retry_after=0.25)
    core.register_model(model)
    policy = tretry.RetryPolicy(max_attempts=4, backoff_s=0.01, seed=1)
    client = grpcclient.InferenceServerClient(flaky_grpc.address,
                                              retry_policy=policy)
    result = client.infer("flaky_grpc", [_x(grpcclient)])
    assert np.array_equal(result.as_numpy("OUTPUT0"),
                          np.arange(4, dtype=np.int32))
    assert calls["n"] == 3
    # the trailer carries the hint as given
    assert policy.stats()["retries"] == 2 and sleeps == [0.25, 0.25]
    client.close()


def test_grpc_unavailable_carries_retry_after_metadata(flaky_server,
                                                       flaky_grpc):
    from client_tpu_torch.client import grpc as grpcclient

    core, _ = flaky_server
    model, _ = _flaky_model("flaky_meta", fail_times=10**9, retry_after=5.0)
    core.register_model(model)
    client = grpcclient.InferenceServerClient(flaky_grpc.address)
    x = grpcclient.InferInput("INPUT0", (4,), "INT32")
    x.set_data_from_numpy(np.zeros(4, np.int32))
    with pytest.raises(InferenceServerException) as ei:
        client.infer("flaky_meta", [x])
    assert ei.value.status() == "UNAVAILABLE"
    assert ei.value.retry_after_s == 5.0
    client.close()


def test_http_transport_reset_injection_survived_by_retry(flaky_server,
                                                          injector):
    core, http_srv = flaky_server
    model, _ = _flaky_model("reset_http", fail_times=0)
    core.register_model(model)
    client = httpclient.InferenceServerClient(http_srv.url)
    client.infer("reset_http", [_x(httpclient)])  # the pooled conn is used
    injector.arm([{"point": "transport_reset", "times": 1}])
    # the stale-socket policy retries ONCE on a fresh connection, which
    # absorbs exactly one injected reset
    result = client.infer("reset_http", [_x(httpclient)])
    assert np.array_equal(result.as_numpy("OUTPUT0"),
                          np.arange(4, dtype=np.int32))
    client.close()


def test_http_double_reset_needs_the_retry_policy(flaky_server, injector,
                                                  sleeps):
    core, http_srv = flaky_server
    model, _ = _flaky_model("reset2_http", fail_times=0)
    core.register_model(model)
    policy = tretry.RetryPolicy(max_attempts=4, backoff_s=0.01, seed=3)
    client = httpclient.InferenceServerClient(http_srv.url,
                                              retry_policy=policy)
    client.infer("reset2_http", [_x(httpclient)])  # the pooled conn used
    # TWO resets: the pool's stale-socket retry absorbs the first; the
    # second is a raw connection error on a FRESH socket, which only the
    # policy's connection-error retry covers
    injector.arm([{"point": "transport_reset", "times": 2}])
    result = client.infer("reset2_http", [_x(httpclient)])
    assert np.array_equal(result.as_numpy("OUTPUT0"),
                          np.arange(4, dtype=np.int32))
    assert policy.stats()["retries"] >= 1 and len(sleeps) >= 1
    client.close()


def test_http_sequence_request_is_not_replayed_after_a_reset(
        flaky_server, injector, sleeps):
    """A sequence step may have run before the connection dropped: the
    client passes connection_errors=False, so the policy gives the reset
    back instead of replaying it."""
    core, http_srv = flaky_server
    model, _ = _flaky_model("reset_seq", fail_times=0)
    core.register_model(model)
    policy = tretry.RetryPolicy(max_attempts=4, backoff_s=0.01, seed=4)
    client = httpclient.InferenceServerClient(http_srv.url,
                                              retry_policy=policy)
    client.infer("reset_seq", [_x(httpclient)])
    injector.arm([{"point": "transport_reset", "times": 2}])
    with pytest.raises(ConnectionError):
        client.infer("reset_seq", [_x(httpclient)], sequence_id=9,
                     sequence_start=True)
    assert policy.stats()["retries"] == 0 and sleeps == []
    client.close()


def test_grpc_transport_reset_injection_retried_by_policy(
        flaky_server, flaky_grpc, injector, sleeps):
    from client_tpu_torch.client import grpc as grpcclient

    core, _ = flaky_server
    model, _ = _flaky_model("reset_grpc", fail_times=0)
    core.register_model(model)
    policy = tretry.RetryPolicy(max_attempts=3, backoff_s=0.01, seed=2)
    client = grpcclient.InferenceServerClient(flaky_grpc.address,
                                              retry_policy=policy)
    injector.arm([{"point": "transport_reset", "times": 1}])
    result = client.infer("reset_grpc", [_x(grpcclient)])
    assert np.array_equal(result.as_numpy("OUTPUT0"),
                          np.arange(4, dtype=np.int32))
    assert policy.stats()["retries"] == 1 and len(sleeps) == 1
    client.close()
