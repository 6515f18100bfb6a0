"""The port's metrics plane against the JAX package's, on the CPU.

- The registry: a fixed registry renders byte-identical text in both
  packages, both parsers read it to equal dicts, label escaping round-trips
  and every registration-contract violation raises in both.
- ``/metrics`` after a generation round: the same small generator (the same
  weights, carried across by ``params_from_jax``) in each engine
  configuration, the same greedy jobs one after another through each
  package's core. The reference's naming lint
  (``scripts/check_metrics_names.py:check``, imported, not edited) finds
  nothing in the port's text; the port's family set equals the reference's
  (the watchdog, the goodput families, the runtime namespace with its
  compile set and, under supervision, the restart families included; the
  device-memory gauge is absent on the CPU in both); and the counters the
  parity tests hold equal (tokens, completions, prefix hits and saved
  tokens, handoffs, speculation rounds and accepted tokens, request
  successes, the compile counters) render equal.
- The shared-memory gauges label the device plane ``kind="cuda"``.
"""

import json
import os
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from client_tpu.models import decoder_lm as jlm
from client_tpu.models import transformer as jt
from client_tpu.server import TpuInferenceServer
from client_tpu.server import metrics as jm
from client_tpu.server import types as jtypes
from client_tpu_torch.models import decoder_lm as tlm
from client_tpu_torch.models import transformer as tt
from client_tpu_torch.server import TorchInferenceServer
from client_tpu_torch.server import http_server as thttp
from client_tpu_torch.server import metrics as tm
from client_tpu_torch.server import types as ttypes

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "scripts"))
import check_metrics_names  # noqa: E402  (the reference's lint)

MODS = {"ref": jm, "port": tm}
# a card's memory gauge: absent on the CPU, in both packages
ABSENT = ("client_tpu_runtime_device_memory_bytes",)
COUNTERS = (
    "client_tpu_runtime_compiles_total",
    "client_tpu_runtime_unexpected_compiles_total",
    "client_tpu_runtime_warmup_compiles_total",
    "client_tpu_generation_tokens_total",
    "client_tpu_generation_requests_total",
    "client_tpu_generation_failures_total",
    "client_tpu_generation_prefix_cache_hits_total",
    "client_tpu_generation_prefix_cache_misses_total",
    "client_tpu_generation_prefix_cache_saved_tokens_total",
    "client_tpu_generation_prefill_lane_handoffs_total",
    "client_tpu_generation_lane_batch_dispatches_total",
    "client_tpu_generation_spec_rounds_total",
    "client_tpu_generation_spec_accepted_total",
    "client_tpu_generation_spec_proposed_total",
    "client_tpu_generation_tier_hits_total",
    "client_tpu_sched_preemptions_total",
    "client_tpu_slo_requests_total",
    "client_tpu_slo_admitted_total",
    "client_tpu_inference_request_success_total",
    "client_tpu_inference_count_total",
    "client_tpu_cache_hits_total",
)


# ---------------------------------------------------------------- registry

def _fixed_registry(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("client_tpu_test_requests_total", "Requests served",
                    ("model", "version"))
    c.labels("m", "1").set(3)
    c.labels('a"b\\c\nd', "2").inc(2.5)
    c.labels(model="m", version="3").inc()
    reg.gauge("client_tpu_test_depth", "Queue depth").labels().set(7)
    h = reg.histogram("client_tpu_generation_ttft_seconds", "TTFT",
                      ("model", "version"))
    child = h.labels("m", "1")
    for v in (0.0002, 0.003, 0.3, 20.0):
        child.observe(v)
    # a well-formed exemplar renders; a malformed trace id is dropped
    child.load_exemplars({2: ("abc123", 0.0004, 1700000000.0),
                          5: ("bad id!", 0.004, 1700000001.0)})
    h.labels("m", "2").load([1] * 17, 1.5, 17)
    tenants = reg.gauge("client_tpu_test_tenant_depth", "Per tenant",
                        ("model", "tenant"), tenant_cap=2)
    for i in range(4):
        tenants.labels("m", f"t{i}").set(i)
    reg.counter("client_tpu_test_bytes", "Bytes").labels().set(1e20)
    return reg


def test_a_fixed_registry_renders_byte_identical_text():
    text = {side: _fixed_registry(mod).render()
            for side, mod in MODS.items()}
    assert text["port"].encode() == text["ref"].encode()
    assert '# {trace_id="abc123"} 0.0004 1700000000.000' in text["port"]
    assert "bad id!" not in text["port"]
    assert 'tenant="__other__"' in text["port"]


def test_both_parsers_read_the_render_alike():
    text = _fixed_registry(tm).render()
    parsed = {side: mod.parse_prometheus_text(text)
              for side, mod in MODS.items()}
    assert parsed["port"] == parsed["ref"]
    assert parsed["port"]["exemplars"]
    for side, mod in MODS.items():
        assert mod.sample_value(parsed[side], "client_tpu_test_depth") == 7
        assert mod.sample_value(parsed[side], "client_tpu_nope") is None


def test_label_escaping_round_trips():
    raw = 'a"b\\c\nd\\n'
    for mod in MODS.values():
        reg = mod.MetricsRegistry()
        reg.gauge("client_tpu_test_esc", "Escaping", ("x",)).labels(raw) \
            .set(1)
        (sample,) = tm.parse_prometheus_text(reg.render())["samples"]
        assert sample == ("client_tpu_test_esc", {"x": raw}, 1.0)


VIOLATIONS = {
    "bad_name": lambda reg: reg.gauge("tpu_depth", "x"),
    "upper_case": lambda reg: reg.gauge("client_tpu_Depth", "x"),
    "counter_suffix": lambda reg: reg.counter("client_tpu_requests", "x"),
    "uncapped_tenant": lambda reg: reg.gauge("client_tpu_t", "x",
                                             ("tenant",)),
    "uncapped_replica": lambda reg: reg.gauge("client_tpu_r", "x",
                                              ("replica",)),
    "duplicate": lambda reg: (reg.gauge("client_tpu_d", "x"),
                              reg.gauge("client_tpu_d", "x")),
    "label_count": lambda reg: reg.gauge("client_tpu_l", "x",
                                         ("model",)).labels("a", "b"),
}


@pytest.mark.parametrize("case", sorted(VIOLATIONS))
def test_contract_violations_raise_in_both(case):
    for mod in MODS.values():
        with pytest.raises(ValueError):
            VIOLATIONS[case](mod.MetricsRegistry())


# ---------------------------------------------------------- /metrics parity

KW = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, head_dim=16,
          d_ff=64, max_seq=48, causal=True)
PAGED = dict(kv_layout="paged", kv_block_len=8)
PREFIX = dict(prefix_cache=True, prefix_block_len=8)
CONFIGS = {
    "slot_token": {},
    "slot_batched": dict(prefill_mode="batched"),
    "slot_chunked": dict(prefill_mode="chunked", prefill_chunk=8),
    "paged_token": PAGED,
    "paged_chunked": dict(prefill_mode="chunked", prefill_chunk=8, **PAGED),
    "prefix_slot": dict(prefix_blocks=32, **PREFIX),
    "prefix_paged": dict(PAGED, **PREFIX),
    "speculation": dict(speculative_gamma=2, draft=True),
    "scheduler_tier": dict(scheduler=True, host_tier_bytes=1 << 20,
                           kv_pool_blocks=24, **PAGED, **PREFIX),
    "lane": dict(prefill_mode="chunked", prefill_chunk=8, prefill_slots=2,
                 prefill_lane_width=8, **PAGED, **PREFIX),
    "lane_batch": dict(prefill_mode="chunked", prefill_chunk=8,
                       prefill_slots=2, prefill_lane_width=8,
                       prefill_lane_batch=2, **PAGED, **PREFIX),
    "int8": dict(kv_quant=True),
}
# the counter each configuration must move (the comparison above is not
# vacuous)
MOVES = {
    "prefix_slot": "client_tpu_generation_prefix_cache_hits_total",
    "prefix_paged": "client_tpu_generation_prefix_cache_hits_total",
    "scheduler_tier": "client_tpu_generation_prefix_cache_saved_tokens_total",
    "speculation": "client_tpu_generation_spec_rounds_total",
    "lane": "client_tpu_generation_prefill_lane_handoffs_total",
    "lane_batch": "client_tpu_generation_lane_batch_dispatches_total",
}
RNG = np.random.default_rng(11)
BASE = RNG.integers(0, 64, size=20).astype(np.int32)
# a repeated prompt (prefix hits), a long one (lane chunks), a short one
JOBS = [(BASE, 6), (BASE, 5),
        (RNG.integers(0, 64, size=27).astype(np.int32), 4),
        (RNG.integers(0, 64, size=3).astype(np.int32), 6)]


@pytest.fixture(scope="module")
def weights():
    jcfg = jt.TransformerConfig(dtype=jnp.float32, attn_impl="ref", **KW)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu",
                                 torch.float32)
    tcfg = tt.TransformerConfig(dtype=torch.float32, attn_impl="flash", **KW)
    return jcfg, jparams, tcfg, tparams


def _core(side: str, weights, config: dict):
    import dataclasses

    jcfg, jparams, tcfg, tparams = weights
    kw = dict(config)
    quant = kw.pop("kv_quant", False)
    if side == "ref":
        cfg, params = dataclasses.replace(jcfg, kv_quant=quant), \
            dict(jparams)
        core, lm, extra = TpuInferenceServer(), jlm, {}
    else:
        cfg, params = dataclasses.replace(tcfg, kv_quant=quant), tparams
        core, lm, extra = TorchInferenceServer(), tlm, {"device": "cpu"}
    if kw.pop("draft", False):
        kw["speculative_draft"] = (cfg, params)
    core.register_model(lm.make_continuous_generator(
        "lm", cfg=cfg, params=params, n_slots=2, chunk_size=4, **kw,
        **extra))
    return core


def _serve(core, types) -> list:
    """The jobs one after another through ``core.infer``; each stream's
    tokens."""
    out = []
    for prompt, budget in JOBS:
        toks = []

        def cb(resp, final):
            assert resp.error is None, resp.error
            if resp.outputs:
                toks.append(int(np.asarray(resp.outputs[0].data)[0]))

        core.infer(types.InferRequest(model_name="lm", inputs=[
            types.InferTensor("PROMPT", "INT32", (len(prompt),),
                              data=prompt),
            types.InferTensor("MAX_TOKENS", "INT32", (1,),
                              data=np.asarray([budget], np.int32))]),
            response_callback=cb)
        out.append(toks)
    return out


def _scrape(side: str, weights, config: dict) -> tuple:
    core = _core(side, weights, config)
    try:
        toks = _serve(core, jtypes if side == "ref" else ttypes)
        text = core.metrics_text()
    finally:
        core.stop()
    return toks, text


@pytest.mark.parametrize("config", list(CONFIGS))
def test_metrics_match_the_reference(weights, config):
    runs = {side: _scrape(side, weights, CONFIGS[config])
            for side in ("ref", "port")}
    assert runs["port"][0] == runs["ref"][0]
    text = runs["port"][1]
    assert check_metrics_names.check(text) == []
    parsed = {side: tm.parse_prometheus_text(runs[side][1])
              for side in runs}
    fams = {side: set(p["families"]) for side, p in parsed.items()}
    assert fams["port"] == fams["ref"]
    assert "client_tpu_runtime_compiles_total" in fams["port"]
    assert not any(f.startswith(ABSENT) for f in fams["port"] | fams["ref"])
    counters = {side: sorted((n, sorted(lab.items()), v)
                             for n, lab, v in p["samples"]
                             if n in COUNTERS)
                for side, p in parsed.items()}
    assert counters["port"] == counters["ref"]
    p = parsed["port"]
    assert tm.sample_value(p, "client_tpu_engine_up",
                           {"model": "lm"}) == 1
    assert tm.sample_value(p, "client_tpu_generation_tokens_total",
                           {"model": "lm"}) == sum(b for _, b in JOBS)
    assert tm.sample_value(p, "client_tpu_generation_slot_busy_seconds",
                           {"model": "lm"}) > 0
    if config in MOVES:
        assert tm.sample_value(p, MOVES[config], {"model": "lm"}) > 0
    assert {lab["kind"] for n, lab, _ in p["samples"]
            if n == "client_tpu_shm_regions"} == {"system", "cuda"}


def test_metrics_over_http_after_a_generation_round(weights):
    """``GET /metrics`` serves the same text the core renders, in the
    exposition content type, and it lints clean."""
    core = _core("port", weights, CONFIGS["prefix_paged"])
    srv = thttp.HttpInferenceServer(core, port=0).start()
    try:
        _serve(core, ttypes)
        with urllib.request.urlopen(f"http://{srv.url}/metrics",
                                    timeout=60) as r:
            ctype = r.headers["Content-Type"]
            text = r.read().decode()
        with urllib.request.urlopen(f"http://{srv.url}/v2",
                                    timeout=60) as r:
            ext = json.loads(r.read())["extensions"]
    finally:
        srv.stop()
        core.stop()
    assert ctype.startswith("text/plain; version=0.0.4")
    assert check_metrics_names.check(text) == []
    parsed = tm.parse_prometheus_text(text)
    assert tm.sample_value(parsed, "client_tpu_generation_prefix_cache_"
                           "hits_total", {"model": "lm"}) >= 1
    for name in ("trace", "metrics", "response_cache"):
        assert name in ext
