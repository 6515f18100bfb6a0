"""The port's response cache against the JAX package's, on the CPU.

- ``ResponseCache`` alone: the same keys for the same inputs (numeric and
  BYTES), and the same hits, misses, evictions, entries and bytes for the
  same sequence of lookups and inserts.
- Through the serving core: a model with ``response_cache`` answers a
  repeated request from the cache in both packages, with the same outputs,
  the same statistics rows (``cache_hit`` / ``cache_miss``), the same
  ``client_tpu_cache_*`` samples and, for a traced request, the same
  ``CACHE_HIT`` span sequence. The port keys host-resident requests only:
  a request with an input tensor (a CUDA region resolves to one) or an
  output directed into a region is never looked up.
"""

import json

import numpy as np
import pytest
import torch

from client_tpu.models import add_sub as jadd
from client_tpu.server import TpuInferenceServer
from client_tpu.server import cache as jcache
from client_tpu.server import types as jtypes
from client_tpu_torch.models import make_add_sub
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import cache as tcache
from client_tpu_torch.server import metrics as tm
from client_tpu_torch.server import types as ttypes

CACHES = {"ref": jcache.ResponseCache, "port": tcache.ResponseCache}


def _inputs(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"A": rng.integers(0, 9, size=(2, 3)).astype(np.int32),
            "B": np.asarray([b"x", "yé", b""], dtype=np.object_),
            "C": rng.standard_normal(4).astype(np.float32)}


def test_keys_match_the_reference():
    for seed in range(3):
        inputs = _inputs(seed)
        keys = {side: cls.key("m", "1", inputs)
                for side, cls in CACHES.items()}
        assert keys["port"] == keys["ref"]
    a, b = _inputs(0), _inputs(1)
    assert tcache.ResponseCache.key("m", "1", a) != \
        tcache.ResponseCache.key("m", "1", b)
    assert tcache.ResponseCache.key("m", "1", a) != \
        tcache.ResponseCache.key("m", "2", a)


def _sequence(cache) -> list:
    out = []
    blob = {"o": np.zeros(8, np.int32)}      # 32 bytes
    for step in ("a", "a", "b", "c", "a", "c", "d", "d", "b"):
        hit = cache.lookup(step)
        out.append(hit is not None)
        if hit is None:
            cache.insert(step, dict(blob))
        out.append(cache.stats())
    cache.insert("d", dict(blob))            # present: no change
    out.append(cache.stats())
    cache.clear()
    out.append(cache.stats())
    return out


@pytest.mark.parametrize("limits,evictions", [(dict(max_entries=2), 4),
                                              (dict(max_bytes=96), 2),
                                              (dict(max_entries=16), 0)])
def test_lookup_insert_evict_match_the_reference(limits, evictions):
    got = {side: _sequence(cls(**limits)) for side, cls in CACHES.items()}
    assert got["port"] == got["ref"]
    assert got["port"][-2]["evictions"] == evictions


def _core(side: str):
    if side == "ref":
        core = TpuInferenceServer(cache_bytes=64)
        model = jadd.make_add_sub("add_sub", 4, "INT32",
                                  response_cache=True)
    else:
        core = TorchInferenceServer(cache_bytes=64)
        model = make_add_sub("add_sub", 4, "INT32", response_cache=True,
                             device="cpu")
    core.register_model(model)
    return core


def _request(types, x: int, **kw):
    a = np.full(4, x, np.int32)
    return types.InferRequest(model_name="add_sub", inputs=[
        types.InferTensor("INPUT0", "INT32", (4,), data=a),
        types.InferTensor("INPUT1", "INT32", (4,), data=a)], **kw)


def _outputs(resp) -> list:
    return [(t.name, t.datatype, list(t.shape), np.asarray(t.data).tolist())
            for t in resp.outputs]


def test_served_requests_hit_like_the_reference():
    """Each response is 32 bytes and the cache holds 64: the sequence
    misses, hits, evicts and hits again the same way in both packages."""
    seq = [1, 1, 2, 3, 1, 3, 3, 2]
    got = {}
    for side, types in (("ref", jtypes), ("port", ttypes)):
        core = _core(side)
        try:
            core.update_trace_settings(settings={
                "trace_level": ["TIMESTAMPS"], "trace_rate": "1"})
            outs = []
            for x in seq:
                outs.append(_outputs(core.infer(_request(types, x))))
            # the async path answers a hit through the callback
            cb = []
            core.infer(_request(types, 3),
                       response_callback=lambda r, f: cb.append(
                           (_outputs(r), f)))
            stats = core.statistics("add_sub")["model_stats"][0]
            parsed = tm.parse_prometheus_text(core.metrics_text())
            spans = [[s[0] for s in t.timestamps]
                     for t in core.tracer.completed]
        finally:
            core.stop()
        ist = stats["inference_stats"]
        got[side] = {
            "outputs": outs, "callback": cb,
            "cache": core.cache.stats(),
            "rows": {k: ist[k]["count"] for k in ("cache_hit", "cache_miss",
                                                   "success")},
            "inference_count": stats["inference_count"],
            "execution_count": stats["execution_count"],
            "metrics": sorted((n, v) for n, _l, v in parsed["samples"]
                              if n.startswith("client_tpu_cache_")),
            "spans": spans}
    assert got["port"] == got["ref"]
    port = got["port"]
    assert port["cache"] == {"hits": 4, "misses": 5, "evictions": 3,
                             "entries": 2, "bytes": 64}
    assert port["rows"] == {"cache_hit": 4, "cache_miss": 5, "success": 9}
    assert port["execution_count"] == 5
    assert port["callback"][0][1] is True
    hit_spans = ["REQUEST_START", "CACHE_HIT", "REQUEST_END"]
    assert port["spans"].count(hit_spans) == 4


def test_tensor_inputs_and_region_outputs_are_never_keyed():
    core = _core("port")
    try:
        a = torch.full((4,), 5, dtype=torch.int32)
        for _ in range(2):
            req = ttypes.InferRequest(model_name="add_sub", inputs=[
                ttypes.InferTensor("INPUT0", "INT32", (4,), device_array=a),
                ttypes.InferTensor("INPUT1", "INT32", (4,),
                                   device_array=a)])
            assert np.asarray(core.infer(req).outputs[0].data).tolist() \
                == [10] * 4
        assert core.cache.stats()["misses"] == 0
        req = _request(ttypes, 2, outputs=[ttypes.RequestedOutput(
            name="OUTPUT0", shm_region="nowhere", shm_byte_size=16)])
        with pytest.raises(ttypes.ServerError, match="not registered"):
            core.infer(req)
        assert core.cache.stats() == {"hits": 0, "misses": 0,
                                      "evictions": 0, "entries": 0,
                                      "bytes": 0}
    finally:
        core.stop()


def test_config_json_advertises_the_cache():
    core = _core("port")
    try:
        assert core.model_config("add_sub")["response_cache"] == \
            {"enable": True}
        plain = make_add_sub("p", 4, "INT32", device="cpu").config.to_json()
        assert "response_cache" not in plain
        assert json.dumps(core.metadata()).count("response_cache") == 1
    finally:
        core.stop()
